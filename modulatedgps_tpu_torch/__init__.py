"""PyTorch and CUDA port of modulatedgps_tpu: the SMGP serving path, joint
posterior sampling, and the Adam train step with checkpoints and
multi-start, whitened or not.

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

from .convert import smgp_from_numpy, smgp_to_numpy  # noqa: E402
from .likelihoods import Gaussian  # noqa: E402
from .models import SGP, SMGP, SVGP, precompute_posterior, precompute_smgp  # noqa: E402
from .ops import launch_counts, reset_launch_counts  # noqa: E402
from .ops.kernels import Matern32, SquaredExponential  # noqa: E402
from .training import (Adam, make_train_step, restore_checkpoint,  # noqa: E402
                       run_adam, run_adam_multistart, save_checkpoint)

__all__ = ["Adam", "Gaussian", "SGP", "SMGP", "SVGP", "Matern32",
           "SquaredExponential", "launch_counts", "make_train_step",
           "precompute_posterior", "precompute_smgp", "reset_launch_counts",
           "restore_checkpoint", "run_adam", "run_adam_multistart",
           "save_checkpoint", "smgp_from_numpy", "smgp_to_numpy"]
