"""PyTorch and CUDA port of modulatedgps_tpu: the SMGP and SMGPModified
(Gaussian, MultiClass or Bernoulli experts) serving path, joint posterior
sampling, and the Adam train step with checkpoints and multi-start,
whitened or not; the VGP with scipy's L-BFGS; the data loaders, the host
utilities (k-means, metrics, evaluation, plotting, profiling), the demo
CLIs (``python -m modulatedgps_tpu_torch.demos.<name>``) and reading the
JAX package's npz checkpoints.

The JAX package beside this one is the reference each ported part is held
against.  Plain tensor code is PyTorch; each of the JAX package's Pallas
kernels has a CUDA kernel for Hopper here (csrc/), built with nvcc on first
use.
On CPU tensors each kernel wrapper runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.  Models are created on the card
unless the caller passes ``device="cpu"``.

TF32 is switched off for every float32 matmul and convolution: the products
that feed the Cholesky (Kmm, Linv @ Kmn, the posterior sandwich) ran at
HIGHEST precision on the TPU, and TF32 keeps only ~3 decimal digits, which
the jittered f32 Cholesky of Kmm cannot absorb.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import config, params  # noqa: E402
from .config import (config_context, default_float, default_jitter,  # noqa: E402
                     enable_debug_checks, set_default_jitter)
from .convert import load_numpy_, smgp_from_numpy, smgp_to_numpy  # noqa: E402
from .likelihoods import Bernoulli, Gaussian, MultiClass, RobustMax  # noqa: E402
from .models import (SGP, SMGP, SVGP, VGP, SMGPModified,  # noqa: E402
                     precompute_posterior, precompute_smgp)
from .ops import launch_counts, mean_functions, reset_launch_counts  # noqa: E402
from .ops.kernels import (Constant, Matern12, Matern32, Matern52,  # noqa: E402
                          Product, SquaredExponential, Sum, White)
from .params import print_summary, set_trainable, trainable_mask  # noqa: E402
from .training import (Adam, make_train_step, restore_checkpoint,  # noqa: E402
                       run_adam, run_adam_multistart, run_scipy,
                       save_checkpoint)

__all__ = ["Adam", "Bernoulli", "Constant", "Gaussian", "Matern12", "Matern32",
           "Matern52", "MultiClass", "Product", "RobustMax", "SGP", "SMGP",
           "SMGPModified", "SVGP", "SquaredExponential", "Sum", "VGP", "White",
           "config", "config_context", "default_float", "default_jitter",
           "enable_debug_checks", "launch_counts", "load_numpy_",
           "make_train_step", "mean_functions", "params",
           "precompute_posterior", "precompute_smgp", "print_summary",
           "reset_launch_counts", "restore_checkpoint", "run_adam",
           "run_adam_multistart", "run_scipy", "save_checkpoint",
           "set_default_jitter",
           "set_trainable", "smgp_from_numpy", "smgp_to_numpy",
           "trainable_mask"]
