#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SMGP serving path, train step, joint
posterior sampling, the unwhitened SMGP, the joint posterior's gradient,
the multiclass SMGPModified, the VGP with scipy's L-BFGS, the demo CLIs
and the parallel paths once on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; one card
    python3 chip_smoke.py --against DIR   # only the build and the A/B below
    python3 chip_smoke.py --cold-grads    # only the build and the study below
    python3 chip_smoke.py --golden        # only the build and the golden runs

With ``--against DIR`` (a checkout of another commit, e.g. the parent) it
builds both, times the Cholesky, the tril forward and backward kernels (and
this checkout's 3-pass split forward against the parent's one pass), the
TRSM (#2, #4), the pullback's products (#10/#11), the fused q_sqrt
quadratic (#17), K(X, Z) and its pullback (#1) and the KL forward sums
(#12) of the two in turns on the same inputs and compares their outputs,
and prints no last line.  ``--cold-grads`` prints what the assignment
leaves' tolerances at tau = 1e-2 and the split on both SMGP layers rest on
(phase_cold_grads: seeds, split layers, kernel swaps, step times), checks
nothing and prints no last line.  ``--golden`` trains the seven reference
demo families at their full iteration counts (2000 / 4000 / 2000 / 2000 /
2000 / 10000 / 2000) at seed 0 on the card and prints each family's row
with both golden tiers' checks and its ELBO aggregate, in GOLDEN_r04.json's
layout (phase_golden); it checks nothing and prints no last line.

Phases, each printing its own lines:
  1. the card (nvidia-smi name and power limit) and the nvcc build of the
     kernels in modulatedgps_tpu_torch/csrc;
  2. each CUDA kernel against its plain PyTorch version on the card, at
     small ragged shapes and at its main-path shape, with CUDA-event
     medians of the kernel, the plain version and, where one exists, one
     PyTorch call computing the same function, beside the kernel's bound;
     the tril backward kernels (#6-#9) at aligned, padded and M=1 shapes
     with NaN above L's diagonal, #6/#7 on the split operands at the train
     step's shapes (dL over K=8, dA over 3K=24 latents, N=8192; their
     rows) and at path B's (N=2048);
     the TRSM (#2, #4) on wide right sides (csrc/trsm.cu's wide kernel) at
     ragged shapes, [4096, 8192] and [4096, 32768], and #2 on the KL's
     lower-triangular right side with and without tril_rhs (equal); on
     narrow ones and the inverse (the wavefront kernel) at ragged shapes,
     M=1 and [4096, 8]; the pullback's split pass bit for bit;
     K(X, Z)'s pullback (#1) against its closed form and the f64 gradient
     at ragged shapes and at Kmn [4096, 8192] and Kmm [4096, 4096];
     the blocked Cholesky (#15/#16) also against f64 and cuSOLVER on both
     north-star Kmm at M = 1, 70, 1000, 1024 and 4096, with its device time
     by kernel at M=4096;
  3. the north-star SMGP (M=4096, K=8, D=4, f32) at a seeded, perturbed
     state: 8 request batches of 8192 through precompute_smgp ->
     predict_y / predict_assign / predict_density and 2 through the
     training-path predict_y, with each serving kernel's launch count > 0
     (the Cholesky and the fused q_sqrt quadratic #17 among them);
     predict_assign (the assignment layer's mean alone) and
     predict_density bit-equal to the composition on the full assignment
     marginal, and the device ms of one predict_mean beside one predict_f;
  4. the same model at M=1024, batch 2048 on the card against the port's
     plain path in float64 on the CPU, the Cholesky and #17 launched;
  5. the train step at the north-star width (S=16, batch 8192, lr 5e-3,
     Adam): 6 steps with every train-path kernel's launch count > 0 (the
     3-pass split q_sqrt term on both layers, the tril KL #12/#13, the tril
     Adam #14 and the Cholesky included), finite losses, q_sqrt and its
     Adam moments exactly 0 above the diagonal, ms per step, peak memory
     and a torch.profiler breakdown of one more step, with no cuSOLVER
     factorization in it; then 2 steps of a plain SVGP regression with 8
     latents (the one-pass q_sqrt term: #3 forward, #8/#9 backward, at
     their rows' shapes);
  6. the loss and the gradient of every raw leaf at M=1024, batch 2048 on
     the card against the port's f64 CPU path (the f32 CPU path beside),
     with the same noise, at the north-star temperature 1e-2 (the
     assignment layer's leaves at GRAD_TOL_COLD) and at 1;
  7. joint posterior sampling at M=4096 on a grid of N=2048 points, 16
     draws: predict_f(full_cov=True), predict_f_samples, predict_samples
     and sample_W (trained and served model), with the f32 tril forward #5
     launched, the covariance finite and symmetric, the draws finite;
  8. the joint posterior's mean and [K, N, N] covariance at M=1024, N=512
     on the card against the f64 CPU path;
  9. run_adam at M=1024, batch 2048: 4 steps against 2, a checkpoint, a
     restore into a fresh model (bit for bit) and 2 more;
 10. run_adam_multistart at M=1024: 2 replicas, 2 probe steps, the winner
     continued and held against a single run of that replica;
 11. path A, the unwhitened SMGP (whiten=False) at M=4096 at the state of
     phase 3's whitened one carried over (q_mu' = L q_mu, q_sqrt'_k =
     L q_sqrt_k, L = chol(Kmm) in f64): 2 served batches and one
     training-path predict_y against the whitened model's, then 4 train
     steps with the transposed TRSM #4 launched forward and backward,
     finite losses, upper triangles exactly 0, ms per step, peak memory and
     a profiler breakdown of one more step (no cuSOLVER factorization);
 12. path A at M=1024, batch 2048: outputs and raw-leaf gradients of the
     card against the f64 CPU path, beside the f32 CPU path's distance;
 13. path B, the gradient of the joint posterior at M=4096 on N=2048
     points: a seeded weighted sum of the [K, N, N] covariance and of 16
     joint draws, backward to every raw leaf of the prediction layer, with
     #5 forward and #6/#7 backward launched;
 14. path B at M=1024, N=512 against the f64 CPU path;
 15. path C, the multiclass SMGPModified of demos/_runner.py (MultiClass
     RobustMax experts with Gauss-Hermite quadrature, a Gaussian likelihood
     on the assignment layer) at M=4096, K=8, D=4, S=16, batch 8192, its
     state loaded by load_numpy_, labels a seeded function of X: 4 train
     steps with every train-path kernel launched (as phase 5 checks them,
     with the quadrature's own kernels in the breakdown and the likelihood
     timed alone), then precompute_smgp (an SMGPModified), 4 served batches
     with #17 launched (class probabilities summing to 1 within 2e-3,
     densities within [log(eps/(K-1)), log(1-eps)]) and 16 draws;
 16. path C at M=1024, batch 2048 against the f64 CPU path (the f32 CPU
     path beside): loss and raw-leaf gradients at temperatures 1e-2 and 1,
     outputs of both routes; the same for the demo_multiclass_svgp kernel
     (Sum(Matern32, White) + Linear, White's variance and Z frozen), then
     2 Adam steps of it on the card with K(X, Z) forward and pullback
     launched as Matern32 and the frozen leaves bit-equal;
 17. the VGP with a Bernoulli likelihood and scipy's L-BFGS: the 7-point
     demo through modulatedgps_tpu_torch.demos.demo_vgp_bernoulli.main
     (--platform gpu), classified as tests/test_vgp_scipy.py requires; then
     N=4096, D=4, f32 for 10 iterations: the ELBO rising and finite, K(X,
     X) and its pullback, the Cholesky and its pullback (#2, #10/#11) and
     the KL (#12/#13) launched, raw q_sqrt above the diagonal bit-equal to
     its seeded garbage, ms per evaluation and scipy's host ms per
     iteration, a profiler breakdown of one evaluation (K(X, X)'s forward in
     it), peak memory; then predict_y on 8192 points and
     predict_f(full_cov=True) on 2048 with #3 and #5 launched;
 18. the VGP at N=512 on the card against the f64 CPU path (the f32 CPU
     path beside): the ELBO, every raw leaf's gradient, predict_f,
     predict_y and predict_log_density;
 19. the demo layer at the reference demos' own configurations (M=25,
     batch 500, S=25, K=2-4, D=1-2, f32): each of the nine CLIs of
     modulatedgps_tpu_torch/demos through its main(argv) for 50 iterations
     with --predict-samples 10, its ELBOs finite and every kernel it should
     launch launched (DEMO_KERNELS; the 1-D and 2-D figures written where
     matplotlib is installed); the flagship demo_multimodal_1d for its 2000
     iterations held to the golden robustness tier (purity >= 0.45, max
     branch RMSE <= 0.2, the smoothed ELBO within that tier's tolerance of
     -0.1), the figure tier printed beside it; the flagship's model's step
     regime: ms an Adam step, kernel ms a step and the busy share from
     kernel-level events, launches a step by family, a served predict_y of
     500 points, and the fit's seconds; the phase's wall time;
 20. modulatedgps_tpu_torch.parallel at one rank on an NCCL group over a
     file:// store (destroyed at the end), phase 5's shapes: (a) 3
     replicated make_parallel_train_step steps against 3 make_train_step
     steps from the same state and seed (bit equality printed; within
     GRAD_TOL), (b) the inducing-sharded ELBO against the single-device
     one, its gradient and 3 inducing-sharded steps with #1, its pullback,
     #2, #4, #10/#11, #15 and #14 launched, q_sqrt and its Adam moments 0
     above the global diagonal, a profile with no library solver in it;
     (c) the sharded loss, gradients and predict_f at M=1024 against the
     f64 CPU path; (d) step ms of (a), (b) and the single-device step,
     peak memory.  The expert-sharded step needs an expert axis over 1, so
     it is checked on the CPU only (tests/test_torch_parallel.py).
The line before the last is a JSON object with every kernel's launches
(on the path that runs it: the train step, sampling for #5, path A for #4,
the served batches for #17, phase 5's SVGP regression for the one-pass
#3/#8/#9), errors, times and bounds;
the last is {"ok": true, "device": {...}}.  Any failure exits non-zero
without that last line.
Without CUDA it exits non-zero before doing anything.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

KERNEL_SOURCES = {
    "kxz": ("modulatedgps_tpu_torch/csrc/kxz.cu",
            "modulatedgps_tpu/ops/pallas_kernels.py:94"),
    "kxz_vjp": ("modulatedgps_tpu_torch/csrc/kxz.cu",
                "modulatedgps_tpu/ops/pallas_kernels.py:155"),
    "trsm_lower": ("modulatedgps_tpu_torch/csrc/trsm.cu",
                   "modulatedgps_tpu/ops/pallas_linalg.py:313"),
    "tril_sq_fwd": ("modulatedgps_tpu_torch/csrc/tril_fwd.cu",
                    "modulatedgps_tpu/ops/pallas_tril.py:402"),
    "tril_sq_fwd_split": ("modulatedgps_tpu_torch/csrc/tril_fwd.cu",
                          "modulatedgps_tpu/ops/pallas_tril.py:402"),
    "tril_sq_dl": ("modulatedgps_tpu_torch/csrc/tril_bwd.cu",
                   "modulatedgps_tpu/ops/pallas_tril.py:455"),
    "tril_sq_da": ("modulatedgps_tpu_torch/csrc/tril_bwd.cu",
                   "modulatedgps_tpu/ops/pallas_tril.py:505"),
    "tri_tt_matmul": ("modulatedgps_tpu_torch/csrc/trimm.cu",
                      "modulatedgps_tpu/ops/pallas_trimm.py:125"),
    "tri_nt_matmul": ("modulatedgps_tpu_torch/csrc/trimm.cu",
                      "modulatedgps_tpu/ops/pallas_trimm.py:182"),
    "kl_sq_logdiag": ("modulatedgps_tpu_torch/csrc/kl_tril.cu",
                      "modulatedgps_tpu/ops/pallas_kl.py:45"),
    "kl_bwd_scale": ("modulatedgps_tpu_torch/csrc/kl_tril.cu",
                     "modulatedgps_tpu/ops/pallas_kl.py:108"),
    "adam_tril_": ("modulatedgps_tpu_torch/csrc/adam_tril.cu",
                   "modulatedgps_tpu/training/fused_adam.py:89"),
    "tril_fwd_f32": ("modulatedgps_tpu_torch/csrc/tril_fwd.cu",
                     "modulatedgps_tpu/ops/pallas_tril.py:176"),
    "trsm_lower_t": ("modulatedgps_tpu_torch/csrc/trsm.cu",
                     "modulatedgps_tpu/ops/pallas_linalg.py:341"),
    "tril_dl": ("modulatedgps_tpu_torch/csrc/tril_bwd.cu",
                "modulatedgps_tpu/ops/pallas_tril.py:224"),
    "tril_da": ("modulatedgps_tpu_torch/csrc/tril_bwd.cu",
                "modulatedgps_tpu/ops/pallas_tril.py:276"),
    "cholesky_factor": ("modulatedgps_tpu_torch/csrc/chol.cu",
                        "modulatedgps_tpu/ops/pallas_linalg.py:87, "
                        "modulatedgps_tpu/ops/pallas_linalg.py:171"),
    "qsqrt_sq_colsum": ("modulatedgps_tpu_torch/csrc/quad.cu",
                        "modulatedgps_tpu/ops/pallas_quad.py:43"),
}
# The kernels each path must launch (the JSON line takes each kernel's
# launches from the path that runs it: tril_fwd_f32 from sampling,
# trsm_lower_t from path A's train steps, tril_dl / tril_da from the train
# step, qsqrt_sq_colsum from the served batches of phase 3, the one-pass
# tril_sq_fwd / tril_sq_dl / tril_sq_da from phase 5's plain SVGP
# regression: the SMGP's layers take the 3-pass split instead).
SERVING_KERNELS = ("kxz", "trsm_lower", "tril_sq_fwd_split", "cholesky_factor",
                   "qsqrt_sq_colsum")
TRAIN_KERNELS = ("kxz", "kxz_vjp", "trsm_lower", "tril_sq_fwd_split",
                 "tril_dl", "tril_da", "tri_tt_matmul", "tri_nt_matmul",
                 "kl_sq_logdiag", "kl_bwd_scale", "adam_tril_",
                 "cholesky_factor")
SAMPLING_KERNELS = ("kxz", "trsm_lower", "tril_sq_fwd_split", "tril_fwd_f32",
                    "cholesky_factor")
UNWHITENED_SERVING_KERNELS = ("kxz", "trsm_lower", "trsm_lower_t",
                              "tril_sq_fwd_split", "cholesky_factor",
                              "qsqrt_sq_colsum")
UNWHITENED_TRAIN_KERNELS = ("kxz", "kxz_vjp", "trsm_lower", "trsm_lower_t",
                            "tril_sq_fwd_split", "tril_dl", "tril_da",
                            "tri_tt_matmul", "tri_nt_matmul", "adam_tril_",
                            "cholesky_factor")
JOINT_GRAD_KERNELS = ("kxz", "kxz_vjp", "trsm_lower", "tril_fwd_f32", "tril_dl",
                      "tril_da", "tri_tt_matmul", "tri_nt_matmul",
                      "cholesky_factor")
# Phase 4 (M=1024, the size of #15's TPU kernel) launches these on the card.
REFERENCE_KERNELS = ("cholesky_factor", "qsqrt_sq_colsum")
M_FULL, K_EXPERTS, D_IN, BATCH = 4096, 8, 4, 8192
M_REF, BATCH_REF = 1024, 2048
# The f32 jitter floor: the whitened state is carried to the unwhitened one
# through chol(Kmm) at the jitter both models are evaluated at.
JITTER = 1e-4
UNWHITENED_STEPS = 4
SERVED_BATCHES = 8
# Joint sampling: a plotting grid of N_GRID points at full model width,
# SAMPLE_DRAWS joint draws per expert; its f64 reference at M_REF, N_GRID_REF.
N_GRID, SAMPLE_DRAWS, N_GRID_REF = 2048, 16, 512
NUM_SAMPLES, NUM_DATA, LR, TRAIN_STEPS = 16, 1_000_000, 5e-3, 6
# (variance, lengthscale) of the north-star layers (bench.py:94-99).
PRED_SE, ASSIGN_SE = (0.5, 0.5), (0.1, 1.0)
LIK_VARIANCE = 0.5
# Published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet).
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12

failures: list[str] = []


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    log(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        failures.append(what)


def cuda_ms(fns, reps):
    """Median CUDA-event milliseconds of each fn, timed in turns."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for i, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def device_ms(fn, subs, reps=20):
    """Device milliseconds of one call of fn from torch.profiler: the self
    device time of the kernels and memsets whose names hold one of subs,
    over reps calls after a warm-up (cuda_ms's events also take the
    wrapper's host time when that is longer than the device's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and any(sub in ev.key for sub in subs))
    return total / reps / 1e3


def bound(nbytes, flops, kind):
    """The least time the card could take: {"bound_ms", "bound_by"}."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def allclose_report(got, want, rtol, atol):
    """(max |got - want|, number of entries outside atol + rtol |want|)."""
    diff = (got.double() - want.double()).abs()
    bad = int((diff > atol + rtol * want.double().abs()).sum())
    finite = bool(torch.isfinite(got).all())
    return float(diff.max()), bad + (0 if finite else 1)


def softplus_inv(y):
    y = np.asarray(y, np.float64)
    return y + np.log(-np.expm1(-y))


def smgp_arrays(M, seed=0):
    """Raw leaves of the north-star SMGP at a perturbed state, keyed as the
    JAX pytree paths, and a generator for request batches.

    At the whitened init (q_mu = 0, q_sqrt = I) the q_sqrt term cancels
    exactly, so the state is perturbed: q_mu ~ 0.5 N(0, 1) and
    q_sqrt = I + 0.05 tril(N(0, 1)) with a positive diagonal.
    """
    rng = np.random.default_rng(seed)
    K, D = K_EXPERTS, D_IN
    arrays = {"likelihood.variance.raw":
              softplus_inv(np.full((1, K), LIK_VARIANCE))}
    for name, (var, ls) in (("pred_layer", PRED_SE),
                            ("assign_layer", ASSIGN_SE)):
        q_sqrt = np.eye(M)[None] + 0.05 * np.tril(rng.normal(size=(K, M, M)))
        idx = np.arange(M)
        q_sqrt[:, idx, idx] = np.abs(q_sqrt[:, idx, idx])
        arrays.update({
            f"{name}.kernel.variance.raw": softplus_inv(var),
            f"{name}.kernel.lengthscales.raw": softplus_inv(ls),
            f"{name}.Z.raw": rng.normal(size=(M, D)),
            f"{name}.q_mu.raw": 0.5 * rng.normal(size=(M, K)),
            f"{name}.q_sqrt.raw": q_sqrt,
        })
    return arrays, rng


def build_model(pt, arrays, device, dtype, jitter=None, temperature=1e-2,
                whiten=True):
    return pt.smgp_from_numpy(arrays, K=K_EXPERTS, num_samples=NUM_SAMPLES,
                              num_data=NUM_DATA, temperature=temperature,
                              device=device, dtype=dtype, jitter=jitter,
                              whiten=whiten)


def unwhitened_arrays(arrays, device="cpu"):
    """The raw leaves of the unwhitened SMGP at the state of the whitened
    ``arrays``: q_mu' = L q_mu and q_sqrt'_k = L q_sqrt_k with L =
    chol(Kmm), Kmm = K(Z, Z) + JITTER I of each layer's SE kernel, in
    float64 on ``device``.  Both parameterize the same posterior
    (tests/test_models.py's whiten-consistency identity)."""
    out = dict(arrays)
    for name in ("pred_layer", "assign_layer"):
        get = lambda key: torch.as_tensor(np.asarray(arrays[f"{name}.{key}.raw"]),
                                          dtype=torch.float64, device=device)
        var, ls = (torch.logaddexp(get(k), torch.zeros((), dtype=torch.float64,
                                                      device=device))
                   for k in ("kernel.variance", "kernel.lengthscales"))
        Z = get("Z") / ls
        sq = (Z[:, None, :] - Z[None, :, :]).square().sum(-1)
        Kmm = var * torch.exp(-0.5 * sq) + JITTER * torch.eye(
            Z.shape[0], dtype=torch.float64, device=device)
        L = torch.linalg.cholesky(Kmm)
        out[f"{name}.q_mu.raw"] = (L @ get("q_mu")).cpu().numpy()
        out[f"{name}.q_sqrt.raw"] = (L @ get("q_sqrt")).cpu().numpy()
    return out


def phase_device_and_build(native):
    log("== phase 1: device and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(line, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")
    path, seconds = native.build()
    native.library()
    log(f"build: {seconds:.1f} s -> {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry",
                                   "Performance Loss")):
            log(f"  ptxas: {line.strip()}")


def phase_kernels():
    from modulatedgps_tpu_torch import _native
    from modulatedgps_tpu_torch.ops import (kxz_kernel, tril_kernel, trimm_kernel,
                                            trsm_kernel)
    from modulatedgps_tpu_torch.ops.linalg import cholesky
    log("== phase 2: kernels against their plain versions on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    rows = {}

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)

    # --- kxz: rtol 1e-5, atol 1e-6 * variance (the exp tail is near 0).
    def kxz_case(label, N, M, D, ls, var, kind, record):
        X = (6 * torch.rand(N, D, generator=g) - 3).to(dev)
        Z = rand(M, D)
        ls_t = torch.as_tensor(ls, dtype=torch.float32, device=dev)
        var_t = torch.tensor(var, dtype=torch.float32, device=dev)
        got = kxz_kernel.kxz(Z, X, ls_t, var_t, kind=kind)
        torch.cuda.synchronize()
        want = kxz_kernel.kxz_plain(Z, X, ls_t, var_t, kind=kind)
        err, bad = allclose_report(got, want, 1e-5, 1e-6 * var)
        check(bad == 0, f"kxz {label} {kind} [{M},{D}]x[{N},{D}]: max_abs_err "
              f"{err:.3e}, {bad} outside rtol 1e-5 atol {1e-6 * var:.1e}")
        if record:
            call = lambda: kxz_kernel.kxz(Z, X, ls_t, var_t, kind=kind)
            ms, plain_ms = cuda_ms(
                [call,
                 lambda: kxz_kernel.kxz_plain(Z, X, ls_t, var_t, kind=kind)], 20)
            dev_ms = device_ms(call, ("kxz_kernel",))
            log(f"  kxz [{M},{D}]x[{N},{D}]: kernel {ms:.4f} ms ({dev_ms:.4f} "
                f"ms device), plain {plain_ms:.4f} ms")
            # One fp32 pass per output: the D-term cross product, two norm
            # adds, the clamp, the scale, the exp and the variance.
            return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                    "plain_ms": plain_ms,
                    **bound(4 * (N * D + M * D + D + 1 + N * M),
                            N * M * (2 * D + 5), "fp32"),
                    "library_ms": None}
        return None

    kxz_case("ragged", 301, 37, 3, [0.5, 0.9, 1.4], 0.7, "rbf", False)
    kxz_case("ragged", 301, 37, 3, [0.5, 0.9, 1.4], 0.7, "matern32", False)
    kxz_case("ragged, scalar l", 300, 1, 8, 0.8, 0.7, "rbf", False)
    kxz_case("ragged, generic D", 130, 77, 11, 1.3, 0.7, "matern32", False)
    kxz_case("ragged, generic D", 301, 77, 130, 12.0, 0.7, "rbf", False)
    kxz_case("ragged, generic D", 301, 77, 130, KXZ_WIDE_LS, 0.7, "matern32",
             False)
    kxz_case("main", M_FULL, M_FULL, D_IN, PRED_SE[1], PRED_SE[0], "rbf", True)
    rows["kxz"] = kxz_case("main", BATCH, M_FULL, D_IN, PRED_SE[1], PRED_SE[0],
                           "rbf", True)
    rows.update(kxz_vjp_rows(g))

    # --- trsm_lower: the repo's on-chip protocol -- the kernel's residual
    # max|L X - I| is within 3x of the plain version's on the same L.
    def spd_chol(M):
        Z = rand(M, D_IN)
        ls = torch.tensor(PRED_SE[1], device=dev)
        var = torch.tensor(PRED_SE[0], device=dev)
        Kmm = kxz_kernel.kxz_plain(Z, Z, ls, var) + 1e-4 * torch.eye(M, device=dev)
        return cholesky(Kmm)

    def trsm_case(label, M, Nb, record):
        L = spd_chol(M)
        L_noisy = (L + torch.triu(rand(M, M), 1)).contiguous()  # upper garbage
        B = None if Nb is None else rand(M, Nb)
        got = trsm_kernel.trsm_lower(L_noisy, B)
        torch.cuda.synchronize()
        want = trsm_kernel.trsm_lower_plain(L_noisy, B)   # reads the lower part
        rhs = torch.eye(M, device=dev) if B is None else B
        res_k = float((L @ got - rhs).abs().max())
        res_p = float((L @ want - rhs).abs().max())
        err = float((got - want).abs().max())
        check(res_k <= 3 * res_p and bool(torch.isfinite(got).all()),
              f"trsm_lower {label} M={M} rhs={'I' if B is None else Nb}: "
              f"residual kernel {res_k:.3e} vs plain {res_p:.3e} (<= 3x), "
              f"max_abs_err {err:.3e}, max|X| {float(want.abs().max()):.3e}")
        if record:
            eye = torch.eye(M, device=dev)
            ms, plain_ms, lib_ms = cuda_ms(
                [lambda: trsm_kernel.trsm_lower(L_noisy, B),
                 lambda: trsm_kernel.trsm_lower_plain(L_noisy, B),
                 lambda: torch.linalg.solve_triangular(L, eye, upper=False)],
                10)
            log(f"  trsm_lower inverse M={M}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, solve_triangular {lib_ms:.4f} ms")
            # The inverse of a triangular matrix: M^3 / 3 fp32 operations.
            return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    **bound(4 * (M * (M + 1) // 2 + M * M), M ** 3 / 3,
                            "fp32"),
                    "library_ms": lib_ms}
        return None

    trsm_case("ragged", 200, None, False)
    trsm_case("ragged", 200, 77, False)
    rows["trsm_lower"] = trsm_case("main", M_FULL, None, True)

    # --- tril_sq_fwd: rtol 2e-2, atol 1e-2 * max (tests/test_pallas_tril.py).
    # L carries garbage and NaN above its diagonal.  The kernel's TMA needs
    # 8-aligned rows: N=77 takes the padded A, M=197 the padded L too, and
    # M=136, N=264 and the main shape neither.
    def tril_case(label, M, N, K, record):
        A = rand(M, N, scale=1 / math.sqrt(M))
        L = (torch.eye(M, device=dev) + 0.05 * rand(K, M, M)  # upper garbage
             + nan_above(K, M, dev))
        A16, L16 = A.to(torch.bfloat16), L.to(torch.bfloat16)
        got = tril_kernel.tril_sq_fwd(A16, L16)
        torch.cuda.synchronize()
        want = tril_kernel.tril_sq_fwd_plain(A16, L16)
        scale = float(want.float().abs().max())
        err, bad = allclose_report(got.float(), want.float(), 2e-2, 1e-2 * scale)
        extra_k = got.float().square().sum(-1)
        extra_p = want.float().square().sum(-1)
        e_err, e_bad = allclose_report(extra_k, extra_p, 2e-2,
                                       1e-2 * float(extra_p.max()))
        check(bad == 0 and e_bad == 0,
              f"tril_sq_fwd {label} M={M} N={N} K={K}: B16 max_abs_err "
              f"{err:.3e} ({bad} outside), extra max_abs_err {e_err:.3e} "
              f"({e_bad} outside), NaN above L's diagonal")
        if record:
            ms, plain_ms, lib_ms = cuda_ms(
                [lambda: tril_kernel.tril_sq_fwd(A16, L16),
                 lambda: tril_kernel.tril_sq_fwd_plain(A16, L16),
                 lambda: torch.matmul(A16.T, L16)], 5)
            macs = K * N * (M * (M + 1) / 2)
            log(f"  tril_sq_fwd M={M} N={N} K={K}: kernel {ms:.4f} ms "
                f"({2 * macs / ms / 1e9:.1f} TFLOP/s useful), plain "
                f"{plain_ms:.4f} ms, bf16 matmul {lib_ms:.4f} ms")
            return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    **bound(2 * (M * N + K * M * (M + 1) // 2 + K * N * M),
                            2 * macs, "bf16"),
                    "library_ms": lib_ms}
        return None

    tril_case("ragged, padded A", 200, 77, 3, False)
    tril_case("ragged, aligned", 136, 264, 2, False)
    tril_case("ragged, padded A and L", 197, 333, 2, False)
    rows["tril_sq_fwd"] = tril_case("main", M_FULL, BATCH, K_EXPERTS, True)
    for args in (("ragged, padded A", 200, 77, 3), ("ragged, aligned", 136, 264, 2),
                 ("ragged, padded A and L", 197, 333, 2), ("ragged", 1, 5, 2)):
        tril_split_case(rand, *args, record=False)
    rows["tril_sq_fwd_split"] = tril_split_case(rand, "main", M_FULL, BATCH,
                                                K_EXPERTS, record=True)

    # --- tril_sq_dl / tril_sq_da: 1e-3 of the largest magnitude (rtol and
    # atol) and dL exactly 0 above the diagonal.  The JAX suite's 3e-2
    # (tests/test_pallas_tril.py) holds a bf16 kernel against an f32
    # product; the plain versions here round W = bf16(B16 G) the same way
    # and accumulate in fp32 too (both sat within 4e-5 of the maximum on an
    # H100), so 3e-2 would pass a dropped tile of the m'-run.  L carries NaN
    # above its diagonal.  The kernels' TMA needs 8-aligned rows: N=77 takes
    # the padded A16 and G, M=197 the padded L16 and B16 too, M=136, N=264
    # and the main shape neither.
    def tril_bwd_case(label, M, N, K, record):
        A = rand(M, N, scale=1 / math.sqrt(M))
        L = (torch.eye(M, device=dev) + 0.05 * rand(K, M, M))  # upper garbage
        A16 = A.to(torch.bfloat16)
        L16 = (L + nan_above(K, M, dev)).to(torch.bfloat16)
        B16 = tril_kernel.tril_sq_fwd_plain(A16, L16)
        G = 2.0 * rand(K, N)
        out = {}
        for name, fn, plain, x16 in (
                ("tril_sq_dl", tril_kernel.tril_sq_dl,
                 tril_kernel.tril_sq_dl_plain, A16),
                ("tril_sq_da", tril_kernel.tril_sq_da,
                 tril_kernel.tril_sq_da_plain, L16)):
            got = fn(x16, B16, G)
            torch.cuda.synchronize()
            out[name] = bwd_check(name, label, M, N, K, got,
                                  plain(x16, B16, G))
        if not record:
            return None
        W16 = (B16.float() * G[:, :, None]).to(torch.bfloat16)
        Lcat16 = torch.tril(L16).permute(1, 0, 2).reshape(M, K * M)
        Wcat16 = W16.transpose(1, 2).reshape(K * M, N)
        macs = K * N * (M * (M + 1) / 2)
        res = {}
        for name, fn, plain, lib, x16, nbytes in (
                ("tril_sq_dl", tril_kernel.tril_sq_dl,
                 tril_kernel.tril_sq_dl_plain, lambda: A16 @ W16, A16,
                 2 * (M * N + K * N * M) + 4 * K * N + 4 * K * M * M),
                ("tril_sq_da", tril_kernel.tril_sq_da,
                 tril_kernel.tril_sq_da_plain, lambda: Lcat16 @ Wcat16, L16,
                 2 * (K * M * (M + 1) // 2 + K * N * M) + 4 * K * N
                 + 4 * M * N)):
            ms, plain_ms, lib_ms = cuda_ms(
                [lambda: fn(x16, B16, G), lambda: plain(x16, B16, G), lib], 5)
            log(f"  {name} M={M} N={N} K={K}: kernel {ms:.4f} ms "
                f"({2 * macs / ms / 1e9:.1f} TFLOP/s useful), plain "
                f"{plain_ms:.4f} ms, bf16 matmul {lib_ms:.4f} ms")
            res[name] = {"max_abs_err": out[name], "ms": ms,
                         "plain_ms": plain_ms,
                         **bound(nbytes, 2 * macs, "bf16"),
                         "library_ms": lib_ms}
        return res

    tril_bwd_case("ragged, padded A", 200, 77, 3, False)
    tril_bwd_case("ragged, aligned", 136, 264, 2, False)
    tril_bwd_case("ragged, padded A and L", 197, 333, 2, False)
    tril_bwd_case("ragged", 1, 5, 2, False)
    rows.update(tril_bwd_case("main", M_FULL, BATCH, K_EXPERTS, True))

    # --- tri_tt_matmul / tri_nt_matmul: 2e-3 of the largest magnitude, the
    # pullback 5e-3 against the f64 dense oracle (tests/test_pallas_trimm.py).
    # The split's lo part must carry the product: its error against f64 is
    # held to 1/50 of one bf16 pass's on the same inputs.
    def trimm_case(label, M, record):
        L = spd_chol(M)
        Linv = trsm_kernel.trsm_lower_plain(L)
        Lbar = torch.tril(rand(M, M))
        S = rand(M, M)
        garbage = lambda X: (X + torch.triu(rand(M, M), 1)).contiguous()
        Lg, Linvg, Lbarg = garbage(L), garbage(Linv), garbage(Lbar)
        calls = {
            "tri_tt_matmul": (lambda: trimm_kernel.tri_tt_matmul(
                Linvg, Lbarg, tril_out=False), lambda: trimm_kernel.
                tri_tt_matmul_plain(Linvg, Lbarg, tril_out=False),
                Linv.double().T @ Lbar.double(),
                Linv.T.bfloat16().double() @ Lbar.bfloat16().double()),
            "tri_tt_matmul tril_out": (lambda: trimm_kernel.tri_tt_matmul(
                Lg, Lbarg, tril_out=True), lambda: trimm_kernel.
                tri_tt_matmul_plain(Lg, Lbarg, tril_out=True),
                torch.tril(L.double().T @ Lbar.double()),
                torch.tril(L.T.bfloat16().double() @ Lbar.bfloat16().double())),
            "tri_nt_matmul": (lambda: trimm_kernel.tri_nt_matmul(S, Linvg),
                              lambda: trimm_kernel.tri_nt_matmul_plain(S, Linvg),
                              S.double() @ Linv.double(),
                              S.bfloat16().double() @ Linv.bfloat16().double()),
        }
        errs = {}
        for name, (fn, plain, exact, one_pass) in calls.items():
            got = fn()
            torch.cuda.synchronize()
            want = plain()
            scale = float(want.abs().max())
            err, bad = allclose_report(got, want, 2e-3, 2e-3 * scale)
            err64 = float((got.double() - exact).abs().max())
            err1 = float((one_pass - exact).abs().max())
            upper = upper_nonzero(got) if "tril_out" in name else 0
            check(bad == 0 and upper == 0 and err64 < err1 / 50,
                  f"{name} {label} M={M}: max_abs_err {err:.3e} of max "
                  f"{scale:.3e} vs plain (2e-3); vs f64 {err64:.3e}, one bf16 "
                  f"pass {err1:.3e} (need < 1/50)"
                  + (f"; {upper} non-zero above the diagonal"
                     if "tril_out" in name else ""))
            errs[name] = err
        # The split pass (csrc/trimm.cu's first launch), read back from the
        # workspace of a direct call: bit-equal to its plain version.
        lib = _native.library()
        for nt, (A, B) in ((False, (Linvg, Lbarg)), (True, (S, Linvg))):
            ws = torch.zeros(trimm_kernel.workspace_shape(M),
                             dtype=torch.bfloat16, device=dev)
            C = torch.empty(M, M, device=dev)
            args = (A.data_ptr(), B.data_ptr(), C.data_ptr(), ws.data_ptr(), M)
            entry = lib.mgp_tri_nt if nt else lib.mgp_tri_tt
            _native.check(entry(*args, *(() if nt else (0,)),
                                _native.stream_ptr(dev)), "trimm split")
            torch.cuda.synchronize()
            want = trimm_kernel.split_operands_plain(A, B, nt=nt)
            check(torch.equal(ws.view(torch.int16), want.view(torch.int16)),
                  f"{'tri_nt' if nt else 'tri_tt'} split pass {label} M={M}: hi "
                  f"and lo copies bit-equal to split_operands_plain")
        got = trimm_kernel.chol_pullback_structured(Lg, Linvg, Lbarg)
        torch.cuda.synchronize()
        want = trimm_kernel.chol_pullback_dense(L.double(), Linv.double(),
                                                Lbar.double())
        scale = float(want.abs().max())
        err, bad = allclose_report(got, want, 5e-3, 5e-3 * scale)
        check(bad == 0 and bool((got == got.T).all()),
              f"chol_pullback_structured {label} M={M}: max_abs_err "
              f"{err:.3e} of max {scale:.3e} vs f64 dense (5e-3), symmetric")
        if not record:
            return None
        ms_tt, plain_tt, lib_tt, ms_tt1, ms_nt, plain_nt, lib_nt, ms_pb, \
            dense_pb = cuda_ms([
                calls["tri_tt_matmul"][0], calls["tri_tt_matmul"][1],
                lambda: Linv.T @ Lbar, calls["tri_tt_matmul tril_out"][0],
                calls["tri_nt_matmul"][0], calls["tri_nt_matmul"][1],
                lambda: S @ Linv,
                lambda: trimm_kernel.chol_pullback_structured(Lg, Linvg, Lbarg),
                lambda: trimm_kernel.chol_pullback_dense(L, Linv, Lbar)], 5)
        # Useful multiply-adds of the band, times 3 bf16 passes.
        idx = torch.arange(M, dtype=torch.float64)
        macs_tt = float(((2 * idx + 1) * (M - idx)).sum())
        macs_tt1 = float(((idx + 1) * (M - idx)).sum())
        macs_nt = M * M * (M + 1) / 2
        log(f"  tri_tt_matmul M={M}: kernel {ms_tt:.4f} ms "
            f"({2 * macs_tt / ms_tt / 1e9:.1f} TFLOP/s useful), tril_out "
            f"{ms_tt1:.4f} ms ({2 * macs_tt1 / ms_tt1 / 1e9:.1f}), plain "
            f"{plain_tt:.4f} ms, fp32 matmul {lib_tt:.4f} ms")
        log(f"  tri_nt_matmul M={M}: kernel {ms_nt:.4f} ms "
            f"({2 * macs_nt / ms_nt / 1e9:.1f} TFLOP/s useful), plain "
            f"{plain_nt:.4f} ms, fp32 matmul {lib_nt:.4f} ms")
        log(f"  chol pullback M={M}: structured {ms_pb:.4f} ms, dense fp32 "
            f"{dense_pb:.4f} ms")
        # Bytes: the operands and C, and the split's bf16 workspace written
        # once and read once.
        tri = 4 * M * (M + 1) // 2
        ws = 2 * 2 * math.prod(trimm_kernel.workspace_shape(M))
        return {"tri_tt_matmul": {
                    "max_abs_err": errs["tri_tt_matmul"], "ms": ms_tt,
                    "plain_ms": plain_tt,
                    **bound(2 * tri + 4 * M * M + ws, 6 * macs_tt, "bf16"),
                    "library_ms": lib_tt},
                "tri_nt_matmul": {
                    "max_abs_err": errs["tri_nt_matmul"], "ms": ms_nt,
                    "plain_ms": plain_nt,
                    **bound(tri + 8 * M * M + ws, 6 * macs_nt, "bf16"),
                    "library_ms": lib_nt}}

    trimm_case("ragged", 200, False)
    trimm_case("ragged", 197, False)
    trimm_case("ragged", 600, False)
    rows.update(trimm_case("main", M_FULL, True))

    # --- tril_fwd_f32: rtol and atol 1e-4 of the largest magnitude.  The
    # kernel and its plain version multiply the same bf16 operands exactly
    # and sum in fp32, in other orders (~1e-6 apart); a dropped tile of the
    # m-run would move entries by a sizeable fraction.
    def tril_f32_case(label, M, N, K, record):
        A = rand(M, N, scale=1 / math.sqrt(M))
        L = (torch.eye(M, device=dev) + 0.05 * rand(K, M, M)  # upper garbage
             + nan_above(K, M, dev))
        A16, L16 = A.to(torch.bfloat16), L.to(torch.bfloat16)
        got = tril_kernel.tril_fwd_f32(A16, L16)
        torch.cuda.synchronize()
        want = tril_kernel.tril_fwd_f32_plain(A16, L16)
        scale = float(want.abs().max())
        err, bad = allclose_report(got, want, 1e-4, 1e-4 * scale)
        check(bad == 0 and got.dtype == torch.float32,
              f"tril_fwd_f32 {label} M={M} N={N} K={K}: max_abs_err {err:.3e} "
              f"of max {scale:.3e} ({bad} outside rtol 1e-4, atol 1e-4 max), "
              f"NaN above L's diagonal")
        if not record:
            return None
        Lt16 = torch.tril(L16)
        ms, plain_ms, lib_ms = cuda_ms(
            [lambda: tril_kernel.tril_fwd_f32(A16, L16),
             lambda: tril_kernel.tril_fwd_f32_plain(A16, L16),
             lambda: torch.matmul(A16.T, Lt16)], 5)
        macs = K * N * (M * (M + 1) / 2)
        log(f"  tril_fwd_f32 M={M} N={N} K={K}: kernel {ms:.4f} ms "
            f"({2 * macs / ms / 1e9:.1f} TFLOP/s useful), plain {plain_ms:.4f} "
            f"ms, bf16 matmul A16^T tril(L16) {lib_ms:.4f} ms")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bound(2 * (M * N + K * M * (M + 1) // 2) + 4 * K * N * M,
                        2 * macs, "bf16"),
                "library_ms": lib_ms}

    tril_f32_case("ragged", 200, 77, 3, False)
    tril_f32_case("ragged", 136, 264, 2, False)
    tril_f32_case("ragged", 1, 5, 2, False)
    rows["tril_fwd_f32"] = tril_f32_case("main", M_FULL, N_GRID, K_EXPERTS,
                                         True)
    rows.update(kl_adam_rows(rand, g))
    rows.update(trsm_t_tril_w_rows(rand, spd_chol))
    trsm_wide_rows(rand, spd_chol)
    trsm_wave_rows(rand, spd_chol)
    rows.update(chol_quad_rows(rand))
    return rows


def tril_split_case(rand, label, M, N, K, record):
    """The 3-pass split forward (tril_sq_fwd_split) against its plain
    version: B and extra within 1e-4 of their largest magnitude (the same
    bf16 products summed in fp32 in other orders); against the f64 product
    of the fp32 operands, B's error under 1/20 of one bf16 pass's (a
    dropped lo pass would not be).  L carries NaN above its diagonal."""
    from modulatedgps_tpu_torch.ops import tril_kernel
    dev = torch.device("cuda")
    A = rand(M, N, scale=1 / math.sqrt(M))
    L = torch.eye(M, device=dev) + 0.05 * rand(K, M, M)
    A2, L3 = tril_kernel._split_operands(A, L + nan_above(K, M, dev))
    L2 = L3[:2 * K]
    B, extra = tril_kernel.tril_sq_fwd_split(A2, L2)
    torch.cuda.synchronize()
    want, want_extra = tril_kernel.tril_sq_fwd_split_plain(A2, L2)
    scale, e_scale = float(want.abs().max()), float(want_extra.max())
    err, bad = allclose_report(B, want, 1e-4, 1e-4 * scale)
    e_err, e_bad = allclose_report(extra, want_extra, 1e-4, 1e-4 * e_scale)
    exact = A.double().T @ torch.tril(L.double())
    split64 = float((B.double() - exact).abs().max())
    one64 = float((tril_kernel.tril_fwd_f32_plain(
        A.bfloat16(), L.bfloat16()).double() - exact).abs().max())
    check(bad + e_bad == 0 and split64 < one64 / 20,
          f"tril_sq_fwd_split {label} M={M} N={N} K={K}: B max_abs_err "
          f"{err:.3e} of max {scale:.3e}, extra {e_err:.3e} of max "
          f"{e_scale:.3e} (rtol, atol 1e-4 max); vs f64 {split64:.3e}, one "
          f"bf16 pass {one64:.3e} (need < 1/20); NaN above L's diagonal")
    if not record:
        return None
    Lt = torch.tril(L)
    ms, plain_ms, lib_ms = cuda_ms(
        [lambda: tril_kernel.tril_sq_fwd_split(A2, L2),
         lambda: tril_kernel.tril_sq_fwd_split_plain(A2, L2),
         lambda: torch.matmul(A.T, Lt)], 5)
    macs = 3 * K * N * (M * (M + 1) / 2)
    log(f"  tril_sq_fwd_split M={M} N={N} K={K}: kernel {ms:.4f} ms "
        f"({2 * macs / ms / 1e9:.1f} TFLOP/s of its 3 passes), plain "
        f"{plain_ms:.4f} ms, fp32 matmul A^T tril(L) {lib_ms:.4f} ms")
    # Three bf16 passes; A2 and L2's triangles read, B (f32) and extra
    # written.
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound(2 * (2 * M * N + 2 * K * M * (M + 1) // 2)
                    + 4 * (K * N * M + K * N), 2 * macs, "bf16"),
            "library_ms": lib_ms}


# The pullback's gradients, each held to 5e-5 of its f64 gradient's largest
# entry (the f32 closed form reaches 3e-7 to 1.2e-5 of it on the CPU at the
# main shapes, for both kinds).
KXZ_VJP_TOL = 5e-5
KXZ_LEAVES = ("X", "X2", "lengthscales", "variance")
# An ARD lengthscale for the D = 130 cases of #1's generic path (D over 8,
# staged 8 coordinates at a time): d2 stays a few units at that width.
KXZ_WIDE_LS = [float(v) for v in np.linspace(9.0, 15.0, 130)]


def kxz_eager_pullback(X, X2, ls, var, Kbar, kind, needs):
    """The pullback as autograd computes it from the dense formula (what
    kxz's backward ran before it had a kernel)."""
    from modulatedgps_tpu_torch.ops import kxz_kernel
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip((X, X2, ls, var), needs)]
        K = kxz_kernel.kxz_plain(*leaves, kind=kind)
        grads = iter(torch.autograd.grad(
            K, [t for t, n in zip(leaves, needs) if n], Kbar))
    return [next(grads) if n else None for n in needs]


def kxz_vjp_rows(g):
    """Phase 2's rows for the pullback of #1 (csrc/kxz.cu's kxz_vjp_kernel
    and kxz_vjp_sum_kernel): at ragged shapes (N, M and D not multiples of
    the tiles, D = 11 and 130 on the generic path, M = 1, a scalar and an ARD
    lengthscale, every subset of the gradients asked for) and at the train
    step's Kmn [4096, 8192] and Kmm [4096, 4096] (one tensor on both sides),
    both kinds: each gradient against the closed form in f32
    (kxz_vjp_plain) and the f64 autograd gradient, within KXZ_VJP_TOL of
    the latter's largest entry, and the same bits on a second launch.  The
    Kmn row is timed beside the closed form and the eager autograd pullback
    it replaced."""
    from modulatedgps_tpu_torch.ops import kxz_kernel
    dev = torch.device("cuda")
    rows = {}

    # Rows: inducing points ~ N(0, 1); columns: data in [-3, 3] (Kmn), or
    # the rows' own tensor (Kmm: autograd adds the two gradients).
    def case(label, N, M, D, ls, var, kind, same, needs, record=False):
        X = torch.randn(N, D, generator=g).to(dev)
        X2 = X if same else (6 * torch.rand(M, D, generator=g) - 3).to(dev)
        M = X2.shape[0]
        ls_t = torch.as_tensor(ls, dtype=torch.float32, device=dev)
        var_t = torch.tensor(var, dtype=torch.float32, device=dev)
        Kbar = torch.randn(N, M, generator=g).to(dev)
        ins = (X, X2, ls_t, var_t)
        got = kxz_kernel.kxz_vjp(*ins, Kbar, kind=kind, needs=needs)
        again = kxz_kernel.kxz_vjp(*ins, Kbar, kind=kind, needs=needs)
        torch.cuda.synchronize()
        plain = kxz_kernel.kxz_vjp_plain(*ins, Kbar, kind, needs)
        exact = kxz_eager_pullback(*(t.double() for t in ins), Kbar.double(),
                                   kind, needs)
        errs, ok = {}, True
        for name, a, b, p, e in zip(KXZ_LEAVES, got, again, plain, exact):
            if e is None:
                ok = ok and a is None and b is None
                continue
            scale = float(e.abs().max())
            err = float((a.double() - e).abs().max())
            err_p = float((a - p).abs().max())
            err_32 = float((p.double() - e).abs().max())
            errs[name] = err
            good = (a.shape == e.shape and finite(a) and same_bits(a, b)
                    and err <= KXZ_VJP_TOL * scale
                    and err_p <= KXZ_VJP_TOL * scale)
            ok = ok and good
            log(f"    {name}: vs f64 {err:.3e}, vs plain f32 {err_p:.3e} of max "
                f"{scale:.3e} (plain f32 vs f64 {err_32:.3e}); same bits "
                f"twice {same_bits(a, b)}")
        check(ok, f"kxz_vjp {label} {kind} [{N},{D}]x[{M},{D}] "
              f"{'K(Z, Z) ' if same else ''}needs {needs}: every gradient within "
              f"{KXZ_VJP_TOL:g} of its f64 maximum, against f64 and plain f32, "
              f"the same bits twice")
        if not record:
            return None
        call = lambda: kxz_kernel.kxz_vjp(*ins, Kbar, kind=kind, needs=needs)
        ms, plain_ms, eager_ms = cuda_ms(
            [call, lambda: kxz_kernel.kxz_vjp_plain(*ins, Kbar, kind, needs),
             lambda: kxz_eager_pullback(*ins, Kbar, kind, needs)], 20)
        dev_ms = device_ms(call, ("kxz_vjp", "Memset"))
        eager_dev_ms = device_ms(
            lambda: kxz_eager_pullback(*ins, Kbar, kind, needs), ("",), 5)
        log(f"  kxz_vjp [{N},{D}]x[{M},{D}] {kind} needs {needs}: kernel "
            f"{ms:.4f} ms ({dev_ms:.4f} ms device), plain (closed form) "
            f"{plain_ms:.4f} ms, eager autograd pullback {eager_ms:.4f} ms "
            f"({eager_dev_ms:.4f} ms device)")
        # Bytes the gradient needs: Kbar read once, X, X2, l and var read,
        # the gradients written.  The workspace's partials (written once and
        # read once) are this design's, not the function's: logged apart.
        n_row, n_col, n_block = kxz_kernel.vjp_workspace(N, M, D, needs)
        outs = sum(n * size for n, size in zip(needs, (N * D, M * D, D, 1)))
        nbytes = 4 * (N * M + (N + M) * D + D + 1 + outs)
        ws_bytes = 2 * (4 * (n_row + n_col) + 8 * n_block)
        log(f"    bytes the gradient needs {nbytes / 1e6:.1f} MB; the "
            f"workspace's partials add {ws_bytes / 1e6:.1f} MB (not in the "
            f"bound)")
        # Per entry: the D-term cross product, the clamp and the epilogue,
        # W, the row and column sums (1 + D each) and the variance's.
        return {"max_abs_err": max(errs.values()), "ms": ms,
                "device_ms": dev_ms, "plain_ms": plain_ms,
                "eager_ms": eager_ms, "eager_device_ms": eager_dev_ms,
                **bound(nbytes, N * M * (6 * D + 12), "fp32"),
                "library_ms": None}

    for kind in ("rbf", "matern32"):
        case("ragged", 301, 37, 3, [0.5, 0.9, 1.4], 0.7, kind, False,
             (True, True, True, True))
        case("ragged", 301, None, 3, 0.6, 0.7, kind, True,
             (True, True, True, True))
        case("ragged, generic D", 130, 77, 11, 1.3, 0.7, kind, False,
             (True, True, True, True))
        case("ragged, generic D", 301, 77, 130, KXZ_WIDE_LS, 0.7, kind, False,
             (True, True, True, True))
        case("ragged, generic D", 301, None, 130, 12.0, 0.7, kind, True,
             (True, True, True, True))
    for needs in ((True, False, False, False), (False, True, False, False),
                  (False, False, True, False), (False, False, False, True),
                  (True, False, True, True), (False, True, True, False)):
        case("ragged", 257, 129, 4, 0.5, 1.1, "rbf", False, needs)
    case("ragged", 1, 1, 4, [0.5, 0.9, 1.4, 2.0], 0.7, "rbf", False,
         (True, True, True, True))
    case("ragged", 3, 1, 2, 0.9, 0.7, "matern32", False,
         (True, True, True, True))
    kmn_needs = (True, False, True, True)     # Z, l and var; not the data
    for kind in ("rbf", "matern32"):
        row = case("main Kmn", M_FULL, BATCH, D_IN, PRED_SE[1], PRED_SE[0],
                   kind, False, kmn_needs, record=kind == "rbf")
        rows.setdefault("kxz_vjp", row)
        case("main Kmm", M_FULL, None, D_IN, PRED_SE[1], PRED_SE[0], kind,
             True, (True, True, True, True), record=kind == "rbf")
    return rows


def trsm_t_tril_w_rows(rand, spd_chol):
    """Phase 2's rows for the transposed TRSM (#4) and atl_matmul's backward
    (#6, #7): ragged shapes, M=1 and the main shapes, with NaN above L's
    diagonal, which no kernel may read."""
    from modulatedgps_tpu_torch.ops import tril_kernel, trsm_kernel
    dev = torch.device("cuda")
    rows = {}

    # --- trsm_lower_t: the kernel's residual max|L^T X - B| within 3x of
    # the plain version's on the same L (the protocol of #2's rows).
    def trsm_t_case(label, M, Nb, record):
        L = spd_chol(M) if M > 1 else torch.full((1, 1), 0.7, device=dev)
        L_nan = (L + nan_above(1, M, dev)[0]).contiguous()
        B = rand(M, Nb)
        got = trsm_kernel.trsm_lower_t(L_nan, B)
        torch.cuda.synchronize()
        want = trsm_kernel.trsm_lower_t_plain(L_nan, B)
        res_k = float((L.T @ got - B).abs().max())
        res_p = float((L.T @ want - B).abs().max())
        err = float((got - want).abs().max())
        floor = 1e-6 * float(B.abs().max())   # a few ulps: M=1 may be exact
        check(res_k <= 3 * res_p + floor and finite(got),
              f"trsm_lower_t {label} M={M} Nb={Nb}: residual kernel "
              f"{res_k:.3e} vs plain {res_p:.3e} (<= 3x + {floor:.1e}), "
              f"max_abs_err "
              f"{err:.3e}, max|X| {float(want.abs().max()):.3e}")
        if not record:
            return None
        Lt = L.T
        ms, plain_ms, lib_ms = cuda_ms(
            [lambda: trsm_kernel.trsm_lower_t(L_nan, B),
             lambda: trsm_kernel.trsm_lower_t_plain(L_nan, B),
             lambda: torch.linalg.solve_triangular(Lt, B, upper=True)], 5)
        log(f"  trsm_lower_t M={M} Nb={Nb}: kernel {ms:.4f} ms "
            f"({M * M * Nb / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"solve_triangular {lib_ms:.4f} ms")
        # M^2 Nb / 2 multiply-adds: M^2 Nb fp32 operations.
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bound(4 * (M * (M + 1) // 2 + 2 * M * Nb), M * M * Nb,
                        "fp32"),
                "library_ms": lib_ms}

    trsm_t_case("ragged", 200, 77, False)
    trsm_t_case("ragged", 1, 5, False)
    trsm_t_case("ragged", 130, 16, False)
    rows["trsm_lower_t"] = trsm_t_case("main", M_FULL, BATCH, True)

    # --- tril_dl / tril_da: 1e-3 of the largest magnitude (rtol and atol),
    # as #8/#9's rows; dL exactly 0 above the diagonal.  With ``split`` the
    # operands are the 3-pass split's, as atl_sq_colsum(split=True)'s
    # backward gives them on the train step: dL on (A_hi, W_hi) over K
    # latents, dA on [L_hi; L_lo; L_hi] against [W_hi; W_hi; W_lo] over 3K.
    def tril_w_case(label, M, N, K, record, split=False):
        A = rand(M, N, scale=1 / math.sqrt(M))
        L = torch.eye(M, device=dev) + 0.05 * rand(K, M, M)
        L_nan = L + nan_above(K, M, dev)
        if split:
            A2, L3 = tril_kernel._split_operands(A, L_nan)
            A16, L16 = A2[0], L3
            W16 = torch.empty((3 * K, N, M), dtype=torch.bfloat16, device=dev)
            tril_kernel.split_bf16(rand(K, N, M), W16[K:].view(2, K, N, M))
            W16[:K].copy_(W16[K:2 * K])
            Wl16 = W16[:K]
            Lt16 = torch.tril(torch.cat([L, L - L.bfloat16().float(), L])
                              .bfloat16())
        else:
            A16, L16 = A.to(torch.bfloat16), L_nan.to(torch.bfloat16)
            W16 = Wl16 = rand(K, N, M).to(torch.bfloat16)
            Lt16 = torch.tril(L.to(torch.bfloat16))
        Ka = L16.shape[0]
        errs = {}
        for name, fn, plain, x16, w16, k in (
                ("tril_dl", tril_kernel.tril_dl, tril_kernel.tril_dl_plain,
                 A16, Wl16, K),
                ("tril_da", tril_kernel.tril_da, tril_kernel.tril_da_plain,
                 L16, W16, Ka)):
            got = fn(x16, w16)
            torch.cuda.synchronize()
            errs[name] = bwd_check(name, label, M, N, k, got, plain(x16, w16))
            del got
        if not record:
            return None
        Lcat16 = Lt16.permute(1, 0, 2).reshape(M, Ka * M)
        Wcat16 = W16.transpose(1, 2).reshape(Ka * M, N)
        res = {}
        for name, fn, plain, lib, x16, w16, k in (
                ("tril_dl", tril_kernel.tril_dl, tril_kernel.tril_dl_plain,
                 lambda: A16 @ Wl16, A16, Wl16, K),
                ("tril_da", tril_kernel.tril_da, tril_kernel.tril_da_plain,
                 lambda: Lcat16 @ Wcat16, L16, W16, Ka)):
            macs = k * N * (M * (M + 1) / 2)
            nbytes = (2 * (M * N + k * N * M) + 4 * k * M * M
                      if name == "tril_dl" else
                      2 * (k * M * (M + 1) // 2 + k * N * M) + 4 * M * N)
            ms, plain_ms, lib_ms = cuda_ms(
                [lambda: fn(x16, w16), lambda: plain(x16, w16), lib], 5)
            log(f"  {name} {label} M={M} N={N} K={k}: kernel {ms:.4f} ms "
                f"({2 * macs / ms / 1e9:.1f} TFLOP/s useful), plain "
                f"{plain_ms:.4f} ms, bf16 matmul {lib_ms:.4f} ms")
            res[name] = {"max_abs_err": errs[name], "ms": ms,
                         "plain_ms": plain_ms,
                         **bound(nbytes, 2 * macs, "bf16"),
                         "library_ms": lib_ms}
        return res

    tril_w_case("ragged, padded A", 200, 77, 3, False)
    tril_w_case("ragged, aligned", 136, 264, 2, False)
    tril_w_case("ragged, padded A and L", 197, 333, 2, False)
    tril_w_case("ragged", 1, 5, 2, False)
    tril_w_case("ragged, split", 197, 333, 2, False, split=True)
    # path B's shape (the joint posterior's gradient), timed and logged; the
    # rows are the train step's, where both SMGP layers run the split.
    tril_w_case("path B", M_FULL, N_GRID, K_EXPERTS, True)
    rows.update(tril_w_case("train step, split", M_FULL, BATCH, K_EXPERTS,
                            True, split=True))
    return rows


def trsm_wide_rows(rand, spd_chol):
    """Phase 2's rows for the TRSM kernels on a wide right side (Nb >=
    trsm_kernel.WIDE_MIN_NB takes csrc/trsm.cu's wide kernel): #2 and #4 at
    ragged shapes and at path A's [4096, 8192] and [4096, 32768], #2 on
    the KL's lower-triangular right side with and without ``tril_rhs``
    (equal results), all with NaN above L's diagonal.  Gate: the residual
    max|op(L) X - B| within 3x of the plain version's (+ a few ulps of
    max|B|); each timed row prints a JSON line with its bound."""
    from modulatedgps_tpu_torch.ops import trsm_kernel
    dev = torch.device("cuda")
    wide = trsm_kernel.WIDE_MIN_NB
    ops = {"trsm_lower": (trsm_kernel.trsm_lower, trsm_kernel.trsm_lower_plain,
                          lambda L: L),
           "trsm_lower_t": (trsm_kernel.trsm_lower_t,
                            trsm_kernel.trsm_lower_t_plain, lambda L: L.T)}

    def case(name, label, M, Nb, record, tril_K=0):
        fn, plain, op = ops[name]
        L = spd_chol(M) if M > 1 else torch.full((1, 1), 0.7, device=dev)
        L_nan = (L + nan_above(1, M, dev)[0]).contiguous()
        if tril_K:      # K lower-triangular [M, M] blocks side by side
            B = torch.tril(rand(tril_K, M, M)).permute(1, 0, 2).reshape(
                M, tril_K * M).contiguous()
        else:
            B = rand(M, Nb)
        kw = {"tril_rhs": True} if tril_K else {}
        got = fn(L_nan, B, **kw)
        torch.cuda.synchronize()
        want = plain(L_nan, B)
        res_k = float((op(L) @ got - B).abs().max())
        res_p = float((op(L) @ want - B).abs().max())
        floor = 1e-6 * float(B.abs().max())
        ok = res_k <= 3 * res_p + floor and finite(got)
        extra = ""
        if tril_K:
            full = fn(L_nan, B)
            torch.cuda.synchronize()
            same = torch.equal(got, full)
            ok = ok and same
            extra = f"; tril_rhs and the unskipped walk equal: {same}"
        check(ok, f"{name} {label} M={M} Nb={Nb}{' tril_rhs' if tril_K else ''}"
              f": residual kernel {res_k:.3e} vs plain {res_p:.3e} (<= 3x + "
              f"{floor:.1e}), max_abs_err {float((got - want).abs().max()):.3e}, "
              f"NaN above L's diagonal{extra}")
        if not record:
            return
        Lop = op(L).contiguous()
        fns = [lambda: fn(L_nan, B, **kw), lambda: plain(L_nan, B),
               lambda: torch.linalg.solve_triangular(Lop, B,
                                                     upper=name.endswith("_t"))]
        if tril_K:
            fns.append(lambda: fn(L_nan, B))
        times = cuda_ms(fns, 3)
        # M^2 Nb / 2 multiply-adds; a triangular right side needs K M^3 / 6.
        macs = tril_K * M ** 3 / 6 if tril_K else M * M * Nb / 2
        row = {"max_abs_err": float((got - want).abs().max()), "ms": times[0],
               "plain_ms": times[1],
               **bound(4 * (M * (M + 1) // 2 + 2 * M * Nb), 2 * macs, "fp32"),
               "library_ms": times[2]}
        log(f"  {name} M={M} Nb={Nb}{' tril_rhs' if tril_K else ''}: kernel "
            f"{times[0]:.4f} ms ({2 * macs / times[0] / 1e9:.1f} TFLOP/s), plain "
            f"{times[1]:.4f} ms, solve_triangular {times[2]:.4f} ms"
            + (f", without tril_rhs {times[3]:.4f} ms" if tril_K else ""))
        log(f"  {name} M={M} Nb={Nb}{' tril_rhs' if tril_K else ''} row: "
            f"{json.dumps(row)}")
        del B, got, want

    for name in ops:
        case(name, "ragged, wide", 1, wide + 5, False)
        case(name, "ragged, wide", 130, wide + 16, False)
        case(name, "ragged, wide", 200, wide + 3, False)
    case("trsm_lower", "ragged, narrow", 200, 3 * 200, False, tril_K=3)
    case("trsm_lower", "ragged, wide", 200, 21 * 200, False, tril_K=21)
    case("trsm_lower", "ragged, wide", 130, 32 * 130, False, tril_K=32)
    for name in ops:
        case(name, "main", M_FULL, BATCH, True)
        case(name, "main", M_FULL, K_EXPERTS * M_FULL, True)
    case("trsm_lower", "main", M_FULL, K_EXPERTS * M_FULL, True,
         tril_K=K_EXPERTS)


def trsm_wave_rows(rand, spd_chol):
    """Phase 2's rows for csrc/trsm.cu's wavefront kernel, which takes the
    inverse and every right side narrower than trsm_kernel.WIDE_MIN_NB, both
    ways: ragged M and Nb (8-column strips below NARROW_MAX_NB, 64-column
    ones above, an Nb just under WIDE_MIN_NB), M=1, the inverse at a ragged
    M, and the main path's [4096, 8] (q_mu's solve and its pullback), all
    with NaN above L's diagonal.  Gate: trsm_case's residual rule, the
    residual max|op(L) X - B| within 3x of the plain version's (+ a few ulps
    of max|B|); each timed row prints a JSON line with its bound."""
    from modulatedgps_tpu_torch.ops import trsm_kernel
    dev = torch.device("cuda")
    ops = {"trsm_lower": (trsm_kernel.trsm_lower, trsm_kernel.trsm_lower_plain,
                          lambda L: L),
           "trsm_lower_t": (trsm_kernel.trsm_lower_t,
                            trsm_kernel.trsm_lower_t_plain, lambda L: L.T)}

    def case(name, label, M, Nb, record):
        fn, plain, op = ops[name]
        L = spd_chol(M) if M > 1 else torch.full((1, 1), 0.7, device=dev)
        L_nan = (L + nan_above(1, M, dev)[0]).contiguous()
        B = None if Nb is None else rand(M, Nb)
        rhs = torch.eye(M, device=dev) if B is None else B
        got = fn(L_nan, B)
        torch.cuda.synchronize()
        want = plain(L_nan, rhs)
        res_k = float((op(L) @ got - rhs).abs().max())
        res_p = float((op(L) @ want - rhs).abs().max())
        floor = 1e-6 * float(rhs.abs().max())
        err = float((got - want).abs().max())
        check(res_k <= 3 * res_p + floor and finite(got),
              f"{name} {label} M={M} rhs={'I' if B is None else Nb}: residual "
              f"kernel {res_k:.3e} vs plain {res_p:.3e} (<= 3x + {floor:.1e}), "
              f"max_abs_err {err:.3e}, NaN above L's diagonal")
        if not record:
            return
        Lop = op(L).contiguous()
        times = cuda_ms([lambda: fn(L_nan, B), lambda: plain(L_nan, B),
                         lambda: torch.linalg.solve_triangular(
                             Lop, B, upper=name.endswith("_t"))], 10)
        # M^2 Nb / 2 multiply-adds, against L's triangle, B and X.
        row = {"max_abs_err": err, "ms": times[0], "plain_ms": times[1],
               **bound(4 * (M * (M + 1) // 2 + 2 * M * Nb), M * M * Nb, "fp32"),
               "library_ms": times[2]}
        log(f"  {name} M={M} Nb={Nb}: kernel {times[0]:.4f} ms, plain "
            f"{times[1]:.4f} ms, solve_triangular {times[2]:.4f} ms")
        log(f"  {name} M={M} Nb={Nb} row: {json.dumps(row)}")

    under = trsm_kernel.WIDE_MIN_NB - 1
    for name in ops:
        for M in (1, 65, 200):
            for Nb in (1, 8, 77):
                case(name, "ragged", M, Nb, False)
        case(name, "ragged, just under the wide kernel", 130, under, False)
    for M in (1, 65, 452):
        case("trsm_lower", "ragged inverse", M, None, False)
    for name in ops:
        case(name, "main", M_FULL, K_EXPERTS, True)


def bwd_check(name, label, M, N, K, got, want):
    """A backward kernel's output within 1e-3 of the plain version's
    maximum (rtol and atol), dL exactly 0 above the diagonal; returns the
    max abs error."""
    scale = float(want.abs().max())
    err, bad = allclose_report(got, want, 1e-3, 1e-3 * scale)
    upper = upper_nonzero(got) if name.endswith("dl") else 0
    check(bad == 0 and upper == 0,
          f"{name} {label} M={M} N={N} K={K}: max_abs_err {err:.3e} of max "
          f"{scale:.3e} ({bad} outside rtol 1e-3, atol 1e-3 max)"
          + (f", {upper} non-zero above the diagonal"
             if name.endswith("dl") else "") + ", NaN above L's diagonal")
    return err


def inv_residual(L, Inv):
    """max_j |Inv_j L_jj - I| over the diagonal blocks, L padded with the
    identity as the kernel pads a ragged tail."""
    nblk, B, _ = Inv.shape
    M = L.shape[0]
    Lp = torch.eye(nblk * B, dtype=L.dtype, device=L.device)
    Lp[:M, :M] = L
    blocks = torch.stack([Lp[j * B:(j + 1) * B, j * B:(j + 1) * B]
                          for j in range(nblk)])
    return float((Inv @ blocks - torch.eye(B, dtype=L.dtype, device=L.device))
                 .abs().max())


def chol_quad_rows(rand, dev="cuda"):
    """Phase 2's rows for the blocked Cholesky (#15/#16) and the fused q_sqrt
    quadratic (#17)."""
    from modulatedgps_tpu_torch.ops import chol_kernel, quad_kernel, trsm_kernel
    dev = torch.device(dev)
    rows = {}

    # --- cholesky_factor: distances as max|X - Y| / max|L64| over the
    # matrix ("whole") and as max_ij |X - Y|_ij / max_i |L64_ij| (each
    # column on its own scale, so an error in the late columns, whose
    # entries are far below max|L64|, is not hidden).  Against f64 truth the
    # kernel's factor within 2x cuSOLVER's distance (whole, + 2 ulps of the
    # maximum, 2.4e-7).  Against the plain version, on both scales, within
    # 2x the plain version's own distance to f64 (+ 2.4e-7): the triangle
    # inequality's bound when the kernel lands no further from f64 than the
    # plain version.  Every Inv_j L_jj within 3x of the plain version's
    # residual from I (+ 1e-6); exact zeros above the diagonal; NaN (no
    # exception) from a failed pivot's column on, the columns before it
    # finite; trsm_lower fed Inv gives the same bits.
    def chol_case(label, M, layer, name, record):
        K = north_star_kmm(M, layer, dev)
        L, Inv = chol_kernel.cholesky_factor(K)
        torch.cuda.synchronize()
        Lp, Invp = chol_kernel.cholesky_factor_plain(K)
        L64 = torch.linalg.cholesky(K.double())
        scale = float(L64.abs().max())
        col_scale = L64.abs().amax(0)

        def dist(X, Y=L64):
            d = (X.double() - Y.double()).abs()
            return float(d.max()) / scale, float((d / col_scale).max())

        (e_k, c_k), (e_p, c_p) = dist(L), dist(Lp)
        e_lib, _ = dist(torch.linalg.cholesky(K))
        e_kp, c_kp = dist(L, Lp)
        err = e_kp * scale
        r_k, r_p = inv_residual(L, Inv), inv_residual(Lp, Invp)
        check(finite(L) and finite(Inv) and upper_nonzero(L) == 0
              and e_k <= 2 * e_lib + 2.4e-7 and e_kp <= 2 * e_p + 2.4e-7
              and c_kp <= 2 * c_p + 2.4e-7 and r_k <= 3 * r_p + 1e-6,
              f"cholesky_factor {label} M={M} {name} Kmm: vs f64 whole "
              f"{e_k:.3e} (cuSOLVER {e_lib:.3e}, plain {e_p:.3e}; <= 2x "
              f"cuSOLVER), by column {c_k:.3e} (plain {c_p:.3e}); vs plain "
              f"whole {e_kp:.3e}, by column {c_kp:.3e} (each <= 2x the plain "
              f"version's to f64); max|Inv_j L_jj - I| {r_k:.3e} (plain "
              f"{r_p:.3e}, <= 3x + 1e-6); 0 above the diagonal")
        c0 = M // 2
        K_bad = K.clone()
        K_bad[c0, c0] = -1.0
        nan_ok = []
        for fn in (chol_kernel.cholesky_factor,
                   chol_kernel.cholesky_factor_plain):
            L_bad, _ = fn(K_bad)
            torch.cuda.synchronize()
            nan_ok.append(bool(torch.isnan(L_bad[c0, c0]))
                          and finite(L_bad[:, :c0]))
        B = rand(M, 77)
        pairs = [(trsm_kernel.trsm_lower(L, B, inv=Inv),
                  trsm_kernel.trsm_lower(L, B)),
                 (trsm_kernel.trsm_lower(L, inv=Inv), trsm_kernel.trsm_lower(L)),
                 (trsm_kernel.trsm_lower_t(L, B, inv=Inv),
                  trsm_kernel.trsm_lower_t(L, B))]
        same = [torch.equal(a, b) for a, b in pairs]
        check(all(nan_ok) and all(same),
              f"cholesky_factor {label} M={M} {name}: a pivot of -1 at column "
              f"{c0} gives NaN from it on, finite before, no exception "
              f"(kernel, plain): {nan_ok}; trsm_lower(L, B, inv=Inv), the "
              f"inverse and trsm_lower_t bit-equal to recomputing Inv: {same}"
              + ("" if all(same) else " (max |diff| "
                 f"{max(float((a - b).abs().max()) for a, b in pairs):.3e})"))
        if not record:
            return None
        ms, plain_ms, lib_ms = cuda_ms(
            [lambda: chol_kernel.cholesky_factor(K),
             lambda: chol_kernel.cholesky_factor_plain(K),
             lambda: torch.linalg.cholesky_ex(K)], 10)
        log(f"  cholesky_factor M={M}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, torch.linalg.cholesky_ex (cuSOLVER) {lib_ms:.4f} ms")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bound(2 * 4 * M * M, M ** 3 / 3, "fp32"),
                "library_ms": lib_ms}

    for M in (1, 70, 1000):
        for name, layer in (("pred", PRED_SE), ("assign", ASSIGN_SE)):
            chol_case("ragged", M, layer, name, False)
    for M in (M_REF, M_FULL):
        chol_case("main", M, ASSIGN_SE, "assign", False)
        row = chol_case("main", M, PRED_SE, "pred", True)
        log(f"  cholesky_factor M={M} row: {json.dumps(row)}")
    rows["cholesky_factor"] = row
    for M in (M_REF, M_FULL):
        chol_phase_times(north_star_kmm(M, PRED_SE, dev))

    # --- qsqrt_sq_colsum: rtol 1e-4, atol 1e-5 of the largest output
    # against its plain version (both multiply the same bf16 operands
    # exactly and sum in fp32, in other orders; a dropped tile of an m-run
    # moves an output by far more); NaN above S's diagonal has no effect;
    # two launches give the same bits.
    def quad_case(label, K, M, N, record):
        S16 = (torch.eye(M, device=dev) + 0.05 * rand(K, M, M)
               + nan_above(K, M, dev)).to(torch.bfloat16)
        A = rand(M, N, scale=1 / math.sqrt(M))
        got = quad_kernel.qsqrt_sq_colsum(S16, A)
        again = quad_kernel.qsqrt_sq_colsum(S16, A)
        torch.cuda.synchronize()
        want = quad_kernel.qsqrt_sq_colsum_plain(S16, A)
        scale = float(want.abs().max())
        err, bad = allclose_report(got, want, 1e-4, 1e-5 * scale)
        repeat = same_bits(got, again)
        check(bad == 0 and repeat and got.shape == (K, N)
              and got.dtype == torch.float32,
              f"qsqrt_sq_colsum {label} K={K} M={M} N={N}: max_abs_err "
              f"{err:.3e} of max {scale:.3e} ({bad} outside rtol 1e-4, atol "
              f"1e-5 max), NaN above S's diagonal; same bits twice: {repeat}")
        if not record:
            return None
        A16 = A.to(torch.bfloat16)
        St16 = torch.tril(S16).transpose(-1, -2)
        ms, plain_ms, lib_ms = cuda_ms(
            [lambda: quad_kernel.qsqrt_sq_colsum(S16, A),
             lambda: quad_kernel.qsqrt_sq_colsum_plain(S16, A),
             lambda: (St16 @ A16).float().square().sum(-2)], 5)
        macs = K * N * (M * (M + 1) / 2)
        log(f"  qsqrt_sq_colsum K={K} M={M} N={N}: kernel {ms:.4f} ms "
            f"({2 * macs / ms / 1e9:.1f} TFLOP/s useful), plain {plain_ms:.4f} "
            f"ms, bf16 matmul + square-sum {lib_ms:.4f} ms")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bound(2 * (K * M * (M + 1) // 2 + M * N) + 4 * K * N,
                        2 * macs, "bf16"),
                "library_ms": lib_ms}

    quad_case("ragged", 3, 200, 77, False)
    quad_case("ragged", 2, 136, 264, False)
    quad_case("ragged", 2, 1, 5, False)
    quad_case("ragged", 1, 257, 300, False)
    rows["qsqrt_sq_colsum"] = quad_case("main", K_EXPERTS, M_FULL, BATCH, True)
    return rows


def north_star_kmm(M, layer, dev="cuda"):
    """K(Z, Z) + JITTER I of a north-star layer (SE (variance,
    lengthscale)), Z ~ N(0, 1) as smgp_arrays draws it, in f32."""
    from modulatedgps_tpu_torch.ops import kxz_kernel
    var, ls = layer
    Z = torch.as_tensor(np.random.default_rng(M).normal(size=(M, D_IN)),
                        dtype=torch.float32, device=dev)
    return (kxz_kernel.kxz_plain(Z, Z, torch.tensor(ls, device=dev),
                                 torch.tensor(var, device=dev))
            + JITTER * torch.eye(M, device=dev))


def chol_phase_times(K):
    """Device ms of one cholesky_factor call by kernel: the copy, the
    persistent task-graph kernel (diagonal tiles, panels and trailing
    updates) and the block inverses (trsm.cu's diag_inv_kernel), and the
    number of launches; then, from the task graph's own trace (one more
    call), its CTA-time by task type and waiting."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from modulatedgps_tpu_torch.ops import chol_kernel
    chol_kernel.cholesky_factor(K)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chol_kernel.cholesky_factor(K)
        torch.cuda.synchronize()
    phases = {}
    for ev in prof.key_averages():
        tag = next((t for t in ("chol_", "diag_inv") if t in ev.key), None)
        if ev.device_type == DeviceType.CUDA and tag:
            name = ev.key[ev.key.index(tag):].split("(")[0]
            ms, n = phases.get(name, (0.0, 0))
            phases[name] = (ms + ev.self_device_time_total / 1e3, n + ev.count)
    log(f"  cholesky_factor M={K.shape[0]} by kernel (device ms, launches): "
        + ", ".join(f"{k} {ms:.4f} ({n})" for k, (ms, n) in phases.items())
        + f"; {sum(n for _, n in phases.values())} launches a factorization")
    trace = torch.tensor(chol_kernel.TRACE_INIT, dtype=torch.int64,
                         device=K.device)
    chol_kernel.cholesky_factor(K, trace=trace)
    torch.cuda.synchronize()
    t = chol_kernel.trace_summary(trace)
    busy = {name: t[f"{name}_ms"] for name in ("diag", "panel", "update")}
    total = t["wait_ms"] + sum(busy.values())
    log(f"  chol_dag_kernel M={K.shape[0]} by task (device clock, CTA-ms summed "
        f"over {total / t['span_ms']:.0f} CTAs over a {t['span_ms']:.4f} ms "
        f"span): waiting {t['wait_ms']:.3f} ({t['wait_ms'] / total:.1%}), "
        + ", ".join(f"{name} {ms:.3f} ({ms / total:.1%}; {t[name]} tasks, "
                    f"{1e3 * ms / max(t[name], 1):.2f} us each)"
                    for name, ms in busy.items())
        + "; a diagonal task's parts (us each): "
        + ", ".join(f"{name} {1e3 * t[f'{name}_ms'] / max(t['diag'], 1):.2f}"
                    for name in chol_kernel.DIAG_PARTS))


def nan_above(K, M, dev):
    """[K, M, M]: NaN strictly above the diagonal, 0 elsewhere (added to an
    input, it shows a kernel never reads its upper triangle)."""
    nan = torch.full((M, M), float("nan"), device=dev)
    return torch.triu(nan, 1).expand(K, M, M)


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def dense_kl_bwd(Lq, g):
    """The dense KL backward the tril kernel replaces (ops/kl.py, f64)."""
    d = g * Lq
    d.diagonal(dim1=-2, dim2=-1).sub_(g / torch.diagonal(Lq, dim1=-2, dim2=-1))
    return d


def kl_adam_rows(rand, g):
    """Phase 2's rows for the KL kernels (#12, #13) and the tril Adam (#14),
    each at ragged shapes (M odd, M=1, M not a multiple of 4: the scalar
    path) and at the train step's K=8, M=4096.  Their inputs hold NaN above
    the diagonal, which no kernel may read."""
    from modulatedgps_tpu_torch.ops import kl_kernel
    from modulatedgps_tpu_torch.training import fused_adam
    dev = torch.device("cuda")
    rows = {}

    def kl_input(K, M):
        diag = torch.diag_embed(1.0 + 0.5 * torch.rand(K, M, generator=g))
        return (torch.tril(0.05 * rand(K, M, M), -1) + diag.to(dev)
                + nan_above(K, M, dev))

    # --- kl_sq_logdiag against an f64 sum of the same f32 entries at 1e-5
    # of the sum of the terms' magnitudes (the JAX suite's 1e-5,
    # tests/test_conditionals_kl.py), the same bits on a second launch;
    # kl_bwd_scale against its plain version at 1e-6 of the maximum, and
    # exactly 0 above the diagonal of a torch.empty output.
    def kl_case(label, K, M, record):
        Lq = kl_input(K, M)
        sq, ld = kl_kernel.kl_sq_logdiag(Lq)
        sq2, ld2 = kl_kernel.kl_sq_logdiag(Lq)
        g0 = torch.tensor(0.7, device=dev)
        dL = kl_kernel.kl_bwd_scale(Lq, g0)
        torch.cuda.synchronize()
        low = torch.tril(Lq).double()
        logd = torch.log(torch.diagonal(low, dim1=-2, dim2=-1).abs())
        sq64, ld64 = float(low.square().sum()), float(logd.sum())
        e_sq = abs(float(sq) - sq64) / sq64
        e_ld = abs(float(ld) - ld64) / max(float(logd.abs().sum()), 1e-30)
        p_sq, p_ld = kl_kernel.kl_sq_logdiag_plain(Lq)
        repeat = same_bits(sq, sq2) and same_bits(ld, ld2)
        check(e_sq <= 1e-5 and e_ld <= 1e-5 and repeat,
              f"kl_sq_logdiag {label} K={K} M={M}: sumsq rel err {e_sq:.2e}, "
              f"logdiag {e_ld:.2e} vs f64 (plain f32: "
              f"{abs(float(p_sq) - sq64) / sq64:.2e}, "
              f"{abs(float(p_ld) - ld64) / max(float(logd.abs().sum()), 1e-30):.2e}"
              f"); same bits twice: {repeat}")
        want = kl_kernel.kl_bwd_scale_plain(Lq, g0)
        scale = float(want.abs().max())
        err, bad = allclose_report(torch.tril(dL), want, 1e-6, 1e-6 * scale)
        upper = upper_nonzero(dL)
        check(bad == 0 and upper == 0,
              f"kl_bwd_scale {label} K={K} M={M}: max_abs_err {err:.3e} of max "
              f"{scale:.3e} ({bad} outside 1e-6), {upper} non-zero above the "
              f"diagonal")
        if not record:
            return {}
        Lt = torch.tril(Lq)
        ms_f, plain_f, lib_f, ms_b, plain_b, lib_b = cuda_ms(
            [lambda: kl_kernel.kl_sq_logdiag(Lq),
             lambda: kl_kernel.kl_sq_logdiag_plain(Lq),
             lambda: (Lt.square().sum(), torch.log(torch.diagonal(
                 Lt, dim1=-2, dim2=-1).abs()).sum()),
             lambda: kl_kernel.kl_bwd_scale(Lq, g0),
             lambda: kl_kernel.kl_bwd_scale_plain(Lq, g0),
             lambda: dense_kl_bwd(Lt, g0)], 10)
        dev_f = device_ms(lambda: kl_kernel.kl_sq_logdiag(Lq),
                          ("kl_fwd_kernel", "Memset"))
        log(f"  kl_sq_logdiag K={K} M={M}: kernel {ms_f:.4f} ms ({dev_f:.4f} "
            f"ms device), plain {plain_f:.4f} ms, dense sum + diagonal log "
            f"{lib_f:.4f} ms")
        dev_b = device_ms(lambda: kl_kernel.kl_bwd_scale(Lq, g0),
                          ("kl_bwd_kernel",))
        log(f"  kl_bwd_scale K={K} M={M}: kernel {ms_b:.4f} ms ({dev_b:.4f} "
            f"ms device), plain {plain_b:.4f} ms, dense backward {lib_b:.4f} ms")
        tri = K * M * (M + 1) // 2
        return {"kl_sq_logdiag": {
                    "max_abs_err": abs(float(sq) - sq64), "ms": ms_f,
                    "device_ms": dev_f,
                    "plain_ms": plain_f,
                    **bound(4 * tri + 8, 2 * tri + K * M, "fp32"),
                    "library_ms": lib_f},
                "kl_bwd_scale": {
                    "max_abs_err": err, "ms": ms_b, "device_ms": dev_b,
                    "plain_ms": plain_b,
                    **bound(4 * tri + 4 + 4 * K * M * M, tri + 2 * K * M,
                            "fp32"),
                    "library_ms": lib_b}}

    kl_case("ragged", 3, 197, False)
    kl_case("ragged", 2, 1, False)
    kl_case("ragged", 1, 130, False)
    rows.update(kl_case("main", K_EXPERTS, M_FULL, True))

    # --- adam_tril_: one step at count 3 against its plain version, rtol
    # and atol 1e-6 of each output's maximum on and below the diagonal (the
    # two round the same f32 operations in the same order; an FMA the
    # compiler or torch fuses moves an ulp); above it, p, m and v keep
    # their bits (NaN included).
    def adam_case(label, K, M, record):
        nan = nan_above(K, M, dev)
        state = (rand(K, M, M) + nan, 0.1 * torch.tril(rand(K, M, M)) + nan,
                 torch.tril(rand(K, M, M)).square() + nan)
        grad = torch.tril(rand(K, M, M))
        c1, c2 = 1.0 / (1.0 - 0.9 ** 3), 1.0 / (1.0 - 0.999 ** 3)
        got = [t.clone() for t in state]
        want = [t.clone() for t in state]
        kernel = lambda: fused_adam.adam_tril_(got[0], grad, got[1], got[2],
                                               LR, c1, c2)
        plain = lambda: fused_adam.adam_tril_plain_(want[0], grad, want[1],
                                                    want[2], LR, c1, c2)
        kernel()
        torch.cuda.synchronize()
        plain()
        errs = []
        for name, a, b, old in zip("pmv", got, want, state):
            lo_a, lo_b = torch.tril(a), torch.tril(b)
            scale = float(lo_b.abs().max())
            err, bad = allclose_report(lo_a, lo_b, 1e-6, 1e-6 * scale)
            kept = same_bits(torch.triu(a.view(torch.int32), 1),
                             torch.triu(old.view(torch.int32), 1))
            errs.append(err)
            check(bad == 0 and kept,
                  f"adam_tril_ {label} K={K} M={M} {name}': max_abs_err "
                  f"{err:.3e} of max {scale:.3e} ({bad} outside 1e-6); upper "
                  f"triangle bit-identical: {kept}")
        if not record:
            return {}
        leaf = torch.nn.Parameter(torch.tril(state[0]))
        leaf.grad = grad
        lib = torch.optim.Adam([leaf], lr=LR, fused=True)
        ms, plain_ms, lib_ms = cuda_ms([kernel, plain, lib.step], 10)
        dev_ms = device_ms(kernel, ("adam_tril_kernel",), 10)
        log(f"  adam_tril_ K={K} M={M}: kernel {ms:.4f} ms ({dev_ms:.4f} ms "
            f"device), plain {plain_ms:.4f} ms, torch.optim.Adam(fused=True) "
            f"{lib_ms:.4f} ms")
        tri = K * M * (M + 1) // 2
        return {"adam_tril_": {"max_abs_err": max(errs), "ms": ms,
                               "device_ms": dev_ms, "plain_ms": plain_ms,
                               **bound(7 * 4 * tri, 10 * tri, "fp32"),
                               "library_ms": lib_ms}}

    adam_case("ragged", 2, 197, False)
    adam_case("ragged", 1, 1, False)
    adam_case("ragged", 3, 130, False)
    rows.update(adam_case("main", K_EXPERTS, M_FULL, True))
    return rows


def serve_batch(model, X, Y):
    mean, var = model.predict_y(X)
    pi = model.predict_assign(X)
    dens = model.predict_density(X, Y)
    return mean[0], var[0], pi, dens


def batch_checks(label, mean, var, pi, dens):
    ok = (all(bool(torch.isfinite(t).all()) for t in (mean, var, pi, dens))
          and bool((var > 0).all())
          and float((pi.sum(-1) - 1).abs().max()) < 1e-5
          and mean.shape == var.shape == pi.shape == (mean.shape[0], K_EXPERTS)
          and dens.shape == (mean.shape[0],))
    check(ok, f"{label}: finite, var > 0, assign rows sum to 1, shapes")


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


class GcTimes:
    """A gc.callbacks hook: (generation, ms) of every collection of Python's
    cyclic garbage collector while it is installed."""

    def __init__(self):
        self.runs, self._t0 = [], 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.runs.append((info["generation"],
                              round((time.perf_counter() - self._t0) * 1e3, 3)))


def allocator_counts(on_card):
    """Cumulative cudaMalloc / cudaFree calls and allocation retries of
    PyTorch's caching allocator (zeros off the card)."""
    stats = torch.cuda.memory_stats() if on_card else {}
    return [stats.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                      "num_alloc_retries")]


def mean_only_checks(served, X, Y, pi, dens, on_card):
    """The served predict_assign (the assignment layer's predict_mean) bit
    for bit the softmax of the full cached marginal's mean, and
    predict_density bit for bit its own value with predict_assign served
    so; on the card the device ms of one predict_mean beside one predict_f
    of the assignment layer, by kernel."""
    layer = served.assign_layer
    pi_full = lambda X: torch.softmax(layer.predict_f(X)[0], dim=-1)
    served.predict_assign = pi_full
    try:
        dens_full = served.predict_density(X, Y)
    finally:
        del served.predict_assign
    check(same_bits(pi, pi_full(X)) and same_bits(dens, dens_full),
          "predict_assign and predict_density bit-equal to the composition "
          "on the full assignment marginal (softmax of predict_f's mean)")
    if not on_card:
        return
    from modulatedgps_tpu_torch.utils.profiling import kernel_times
    for what, fn in (("predict_mean", lambda: layer.predict_mean(X)),
                     ("predict_f", lambda: layer.predict_f(X))):
        rows, _ = kernel_times(fn)
        log(f"assignment layer {what}, one call: "
            f"{sum(ms for ms, _, _ in rows):.4f} device ms; by kernel "
            f"{[(round(ms, 4), n, name[:60]) for ms, n, name in rows]}")


def phase_slice(pt, dev="cuda", M=M_FULL, batch=BATCH, n_batches=SERVED_BATCHES):
    log(f"== phase 3: serving slice M={M} K={K_EXPERTS} D={D_IN} "
        f"batch={batch} f32")
    arrays, rng = smgp_arrays(M)
    model = build_model(pt, arrays, dev, torch.float32)
    batches = [(torch.as_tensor(rng.uniform(-3, 3, size=(batch, D_IN)),
                                dtype=torch.float32, device=dev),
                torch.as_tensor(rng.normal(size=(batch, 1)),
                                dtype=torch.float32, device=dev))
               for _ in range(n_batches)]
    sync(dev)
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gc_times = GcTimes()
    with torch.inference_mode():
        pt.reset_launch_counts()
        t0 = time.perf_counter()
        served = pt.precompute_smgp(model)
        sync(dev)
        t_pre = (time.perf_counter() - t0) * 1e3
        served_out, lat_served, lat_served_y = [], [], []
        gc.callbacks.append(gc_times)
        for i, (X, Y) in enumerate(batches):
            # host ms of each call (each ends in a sync), the collector's
            # runs and the allocator's device calls during the batch: what
            # a slow batch spent its time on
            gc_times.runs.clear()
            alloc0 = allocator_counts(on_card)
            t0 = time.perf_counter()
            mean, var = served.predict_y(X)
            sync(dev)
            t1 = time.perf_counter()
            pi = served.predict_assign(X)
            sync(dev)
            t2 = time.perf_counter()
            dens = served.predict_density(X, Y)
            sync(dev)
            t3 = time.perf_counter()
            lat_served_y.append((t1 - t0) * 1e3)
            lat_served.append((t3 - t0) * 1e3)
            alloc = [b - a for a, b in zip(alloc0, allocator_counts(on_card))]
            log(f"served batch {i}: {lat_served[-1]:.3f} ms (predict_y "
                f"{(t1 - t0) * 1e3:.3f}, predict_assign {(t2 - t1) * 1e3:.3f}, "
                f"predict_density {(t3 - t2) * 1e3:.3f}); gc runs (generation, "
                f"ms) {gc_times.runs}; cudaMalloc {alloc[0]}, cudaFree "
                f"{alloc[1]}, allocator retries {alloc[2]}")
            out = (mean[0], var[0], pi, dens)
            batch_checks(f"served batch {i}", *out)
            served_out.append(out)
        gc.callbacks.remove(gc_times)
        lat_train = []
        for i, (X, _) in enumerate(batches[:2]):
            t0 = time.perf_counter()
            mean, var = model.predict_y(X)
            sync(dev)
            lat_train.append((time.perf_counter() - t0) * 1e3)
            mean, var = mean[0], var[0]
            s_mean, s_var = served_out[i][0], served_out[i][1]
            m_err, m_bad = allclose_report(mean, s_mean, 1e-3,
                                           1e-3 * float(s_mean.abs().max()))
            v_err, v_bad = allclose_report(var, s_var, 2e-2, 0.0)
            check(m_bad == 0 and v_bad == 0 and bool((var > 0).all()),
                  f"routes agree, batch {i}: fmean max_abs_err {m_err:.3e} "
                  f"(rtol 1e-3, atol 1e-3 max), var max_abs_err {v_err:.3e} "
                  f"(rtol 2e-2: bf16 B)")
        counts = {name: n for name, n in pt.launch_counts().items()
                  if name in SERVING_KERNELS}
        mean_only_checks(served, *batches[0], *served_out[0][2:], on_card)
    log(f"launches in the serving run: {counts}")
    for name, n in counts.items():
        check(n > 0, f"{name} launched {n} times on the main path")
    log(f"precompute_smgp: {t_pre:.3f} ms")
    log(f"served batch (predict_y + predict_assign + predict_density), ms: "
        f"{[round(t, 3) for t in lat_served]}")
    log(f"served predict_y alone, ms: {[round(t, 3) for t in lat_served_y]}")
    log(f"training-path predict_y batch, ms: {[round(t, 3) for t in lat_train]}")
    if on_card:
        log(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


# (rtol, atol as a fraction of the output's largest magnitude) of the f32
# card against the f64 CPU reference at M=1024, jitter 1e-4 in both (a
# whitened model is evaluated at its own jitter).  The f32 path through
# L^-1 bounds the means and mixture weights (the port's own f32 plain path
# on a CPU lands within 2e-5 of 1.27 on the means, 1e-4 relative on the
# weights); the bf16 B of the training path's q_sqrt term bounds the
# variances (0.64% relative there) and through them the density (0.15%).
REF_TOL = {"predict_y.mean": (1e-3, 1e-3), "predict_y.var": (2e-2, 0.0),
           "predict_assign": (1e-3, 1e-4), "predict_density": (1e-2, 1e-3)}


def reference_outputs(pt, arrays, X, Y, device, dtype, whiten=True):
    model = build_model(pt, arrays, device, dtype, jitter=JITTER,
                        whiten=whiten)
    X = torch.as_tensor(X, dtype=dtype, device=device)
    Y = torch.as_tensor(Y, dtype=dtype, device=device)
    with torch.inference_mode():
        served = pt.precompute_smgp(model)
        out = {"served": serve_batch(served, X, Y),
               "train": serve_batch(model, X, Y)}
    return {route: dict(zip(REF_TOL, (t.double().cpu() for t in vals)))
            for route, vals in out.items()}


def compare_to_reference(label, got, ref):
    """Both routes of ``got`` against the reference's training path."""
    for route in ("served", "train"):
        for name, (rtol, atol_frac) in REF_TOL.items():
            want = ref["train"][name]
            atol = atol_frac * float(want.abs().max())
            err, bad = allclose_report(got[route][name], want, rtol, atol)
            check(bad == 0, f"{label} {route} {name}: max_abs_err {err:.3e} "
                  f"(rtol {rtol:g}, atol {atol:.2e})")


def phase_reference(pt, dev="cuda"):
    log(f"== phase 4: {dev} f32 vs CPU f64 reference, M={M_REF} "
        f"batch={BATCH_REF}")
    arrays, rng = smgp_arrays(M_REF)
    X = rng.uniform(-3, 3, size=(BATCH_REF, D_IN))
    Y = rng.normal(size=(BATCH_REF, 1))
    ref = reference_outputs(pt, arrays, X, Y, "cpu", torch.float64)
    pt.reset_launch_counts()
    got = reference_outputs(pt, arrays, X, Y, dev, torch.float32)
    counts = {name: n for name, n in pt.launch_counts().items()
              if name in REFERENCE_KERNELS}
    log(f"launches in the M={M_REF} run: {counts}")
    for name, n in counts.items():
        check(n > 0, f"{name} launched {n} times at M={M_REF}")
    compare_to_reference(f"{dev} f32 vs cpu f64", got, ref)
    return counts


def upper_nonzero(t):
    return int(torch.triu(t, 1).count_nonzero())


# Kernel-name substrings -> op family, for the device-time breakdown.
FAMILIES = (("kl_fwd", "KL forward (#12)"), ("kl_bwd_kernel", "KL backward (#13)"),
            ("adam_tril_kernel", "Adam tril (#14)"),
            ("tril_fwd_split_kernel", "tril forward, 3-pass split (#3)"),
            ("tril_fwd_kernel", "tril forward (#3)"),
            ("tril_dl_kernel<true", "tril dL (#8)"),
            ("tril_da_kernel<true", "tril dA (#9)"),
            ("tril_dl_kernel<false", "tril dL (#6)"),
            ("tril_da_kernel<false", "tril dA (#7)"),
            ("tri_mm_kernel", "pullback products tt / nt (#10/#11)"),
            ("trimm_split_kernel", "pullback split (#10/#11)"),
            ("kxz_vjp", "kxz pullback (#1)"),
            ("kxz_kernel", "kxz (#1)"),
            ("wide_solve_kernel<true", "trsm transposed, wide B (#4)"),
            ("wide_solve_kernel<false", "trsm, wide B (#2)"),
            ("wave_solve_kernel<true", "trsm transposed, wavefront (#4)"),
            ("wave_solve_kernel<false", "trsm, wavefront (#2)"),
            # the main paths' solves all take the Cholesky's block inverses,
            # so diag_inv_kernel runs only as the factor's last launch
            ("diag_inv_kernel", "cholesky (#15/#16)"),
            ("chol_", "cholesky (#15/#16)"),
            ("quad_kernel", "q_sqrt quadratic (#17)"),
            ("gemm", "fp32 matmul (cuBLAS)"),
            ("getrf", "cholesky (cuSOLVER)"), ("potrf", "cholesky (cuSOLVER)"),
            ("triu_tril", "tril / triu masks"), ("reduce", "reductions"))


def by_family(rows, families=FAMILIES):
    """{family: [device ms, launches]} of profile rows."""
    out: dict[str, list] = {}
    for ms, count, key in rows:
        fam = next((f for sub, f in families if sub in key),
                   "elementwise and other")
        acc = out.setdefault(fam, [0.0, 0])
        acc[0] += ms
        acc[1] += count
    return out


def profile_kernels(fn, what, families=FAMILIES, top=12):
    """torch.profiler over one call of fn through
    utils.profiling.kernel_times: logs the device ms and launches by op
    family and the largest kernels, from kernel-level events only (an
    autograd Function's range would count its kernels twice); returns (the
    events grouped by input shape, [(self device ms, calls, kernel name)]).
    Stand-in kernels open the schedule's warm-up and the recorded step and
    fn starts 50 ms after them: a profile loses the launches of its first
    milliseconds now and then (a step's K(X, Z) forwards and Cholesky, one
    VGP evaluation's K(X, X); --profile-misses measures it).  fn itself
    runs once, so a profiled train step advances the model by
    one step, as it did before."""
    from modulatedgps_tpu_torch.utils.profiling import kernel_times
    rows, by_shape = kernel_times(fn)
    total = sum(r[0] for r in rows)
    log(f"profiled {what}: {total:.3f} ms of kernel time; by family (ms, "
        f"share, launches):")
    for fam, (ms, count) in sorted(by_family(rows, families).items(),
                                   key=lambda kv: -kv[1][0]):
        log(f"  {ms:9.3f} {ms / total:6.1%} {count:6d}  {fam}")
    log("largest kernels (self device ms, calls, name):")
    for ms, count, key in rows[:top]:
        log(f"  {ms:9.3f} {count:5d}  {key[:100]}")
    return by_shape, rows


def profile_step(step, model, gen, X, Y, top=12, families=FAMILIES):
    """torch.profiler over one train step: device ms and launches by op
    family and by kernel (kernel-level events only, so nothing is counted
    twice).  Every K(X, Z) of the step (Kmn and Kmm of each layer, and the
    unwhitened KL's Kmm) was pulled back by the pullback kernel, and no eager
    exp, clamp_min or where ran over an operand of [M, M] entries or more
    (the dense formula's autograd)."""
    by_shape, rows = profile_kernels(lambda: step(model, gen, X, Y), "step",
                                     families, top)
    M = model.pred_layer.q_mu.raw.shape[0]
    eager = [(ev.key, ev.input_shapes, ev.count)
             for ev in by_shape
             if ev.key in ("aten::exp", "aten::clamp_min", "aten::where")
             and any(s and math.prod(s) >= M * M for s in ev.input_shapes)]
    forwards = sum(n for _, n, key in rows if "kxz_kernel<" in key)
    pullbacks = sum(n for _, n, key in rows if "kxz_vjp_kernel" in key)
    check(0 < forwards == pullbacks and not eager,
          f"every K(X, Z) of the step was pulled back by kxz_vjp_kernel "
          f"({forwards} forward launches, {pullbacks} pullbacks) and no eager "
          f"exp / clamp_min / where ran over [{M}, {M}] entries or more "
          f"({eager[:3]})")
    solver = [key for _, _, key in rows if "potrf" in key or "getrf" in key]
    check(not solver, f"no cuSOLVER factorization in the profiled step "
          f"({len(solver)} kernels: {[k[:60] for k in solver[:3]]})")
    # The Cholesky and the tril forward (the 3-pass split) ran
    # as this repo's kernels, and no library GEMM in bf16 (where a tril
    # forward would land) ran.
    ours = {sub: sum(n for _, n, key in rows if sub in key)
            for sub in ("chol_dag_kernel", "tril_fwd_split_kernel")}
    bf16_gemm = [key for _, _, key in rows
                 if "gemm" in key.lower() and "bf16" in key.lower()]
    check(all(ours.values()) and not bf16_gemm,
          f"the profiled step ran the Cholesky and the tril forward as "
          f"csrc kernels (launches {ours}) and no bf16 library GEMM "
          f"({[k[:60] for k in bf16_gemm[:3]]})")


def phase_train(pt, dev="cuda", M=M_FULL, batch=BATCH, steps=TRAIN_STEPS):
    log(f"== phase 5: train step M={M} K={K_EXPERTS} S={NUM_SAMPLES} "
        f"D={D_IN} batch={batch} f32, Adam lr {LR}")
    arrays, rng = smgp_arrays(M)
    model = build_model(pt, arrays, dev, torch.float32)
    X = torch.as_tensor(rng.uniform(-3, 3, size=(batch, D_IN)),
                        dtype=torch.float32, device=dev)
    Y = torch.as_tensor(rng.normal(size=(batch, 1)), dtype=torch.float32,
                        device=dev)
    return train_steps(pt, model, X, Y, dev, steps, TRAIN_KERNELS)


SVGP_REGRESSION_KERNELS = ("tril_sq_fwd", "tril_sq_dl", "tril_sq_da")


def phase_svgp_regression(pt, dev="cuda", M=M_FULL, batch=BATCH, steps=2):
    """A plain SVGP regression (demos/demo_svgp.py's loss, E_q[log p(y|f)]
    - KL / N, Gaussian(0.1)) with K_EXPERTS latents at phase 5's
    prediction-layer state: ``steps`` Adam steps with the one-pass q_sqrt
    variance term (#3 forward, #8/#9 backward, at phase 2's shapes for
    them) launched and finite losses."""
    log(f"== phase 5, a plain SVGP regression: M={M} batch={batch}, "
        f"{K_EXPERTS} latents, {steps} Adam steps")
    arrays, rng = smgp_arrays(M)
    X = torch.as_tensor(rng.uniform(-3, 3, size=(batch, D_IN)),
                        dtype=torch.float32, device=dev)
    Y = torch.as_tensor(rng.normal(size=(batch, K_EXPERTS)),
                        dtype=torch.float32, device=dev)
    opts = dict(dtype=torch.float32, device=dev)
    layer = pt.SVGP.create(pt.SquaredExponential.create(*PRED_SE, **opts),
                           arrays["pred_layer.Z.raw"], K_EXPERTS, **opts)
    with torch.no_grad():
        layer.q_mu.raw.copy_(torch.as_tensor(arrays["pred_layer.q_mu.raw"]))
        layer.q_sqrt.raw.copy_(torch.as_tensor(arrays["pred_layer.q_sqrt.raw"]))
    lik = pt.Gaussian.create(0.1, dtype=torch.float32, device=dev)
    model = torch.nn.ModuleDict({"svgp": layer, "likelihood": lik})

    def loss_fn(m, generator, Xb, Yb):
        fmu, fvar = m["svgp"].predict_f(Xb)
        ve = m["likelihood"].variational_expectations(fmu, fvar, Yb)
        return -(ve.sum() * NUM_DATA / Xb.shape[0]
                 - m["svgp"].prior_kl()) / NUM_DATA

    step = pt.make_train_step(pt.Adam(model, LR), loss_fn)
    gen = torch.Generator(device=dev).manual_seed(0)
    pt.reset_launch_counts()
    losses = [float(step(model, gen, X, Y)) for _ in range(steps)]
    counts = {name: n for name, n in pt.launch_counts().items()
              if name in SVGP_REGRESSION_KERNELS}
    check(all(n > 0 for n in counts.values())
          and all(math.isfinite(x) for x in losses),
          f"plain SVGP regression, {steps} Adam steps: launches {counts}, "
          f"losses {[round(x, 6) for x in losses]}")
    return counts


def train_steps(pt, model, X, Y, dev, steps, kernels, families=FAMILIES):
    """``steps`` Adam steps of ``model`` on (X, Y): every kernel of
    ``kernels`` launched, finite losses, q_sqrt and its Adam moments exactly
    0 above the diagonal, ms per step, peak memory and a profiler breakdown
    of one more step (by ``families``).  Returns the launch counts of the
    steps."""
    gen = torch.Generator(device=dev).manual_seed(0)
    opt = pt.Adam(model, LR)
    step = pt.make_train_step(opt)
    on_card = torch.device(dev).type == "cuda"
    sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    pt.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(model, gen, X, Y)
        sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = {name: n for name, n in pt.launch_counts().items()
              if name in kernels}
    log(f"launches in the train run ({steps} steps): {counts}")
    for name, n in counts.items():
        check(n > 0, f"{name} launched {n} times on the train path")
    check(all(math.isfinite(x) for x in losses),
          f"loss finite at every step: {[round(x, 6) for x in losses]}")
    names = {id(p): name for name, p in model.named_parameters()}
    for p, m, v in zip(opt.params, opt.m, opt.v):
        name = names[id(p)]
        if name.endswith("q_sqrt.raw"):
            nz = [upper_nonzero(t) for t in (p, m, v)]
            check(nz == [0, 0, 0], f"{name}, its m and v: {nz} non-zero "
                  f"entries above the diagonal after {steps} steps")
    log(f"train step ms (host clock to synchronize), steps 2-{steps}: "
        f"{[round(t, 3) for t in step_ms[1:]]}; median "
        f"{statistics.median(step_ms[1:]):.3f} (step 1: {step_ms[0]:.3f})"
        if steps > 1 else f"train step ms: {step_ms}")
    if on_card:
        log(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile_step(step, model, gen, X, Y, families=families)
    return counts


# Loss and raw-leaf gradients of the f32 card against the port's f64 CPU
# path, M=1024, batch 2048, jitter 1e-4 and the same (z, g), at two
# temperatures.  Each entry: leaf -> tolerance on max|got - want| /
# max|want|, about 4-6x the port's own f32 CPU path's distance from f64.
# At tau = 1 the f32 CPU path is 1.7e-3 (the assignment layer's kernel
# variance), 1.1e-3 (lengthscales), 2.5e-3 (Z), 7.0e-5 (q_mu) and 3.7e-3
# (q_sqrt) off f64; scaling the output of any one of kernels #6, #7, #10
# or #11 by 1.03 moves a gradient past its tolerance
# (tests/test_torch_grad_tolerance.py).  At the north-star tau = 1e-2 the
# assignment layer's leaves are held to GRAD_TOL_COLD below.
GRAD_TOL = {"loss": 1e-4,
            "likelihood.variance.raw": 1e-3,
            "pred_layer.kernel.variance.raw": 3e-4,
            "pred_layer.kernel.lengthscales.raw": 1e-3,
            "pred_layer.Z.raw": 2e-2,
            "pred_layer.q_mu.raw": 5e-2,
            "pred_layer.q_sqrt.raw": 3e-2,
            "assign_layer.kernel.variance.raw": 3e-3,
            "assign_layer.kernel.lengthscales.raw": 1e-2,
            "assign_layer.Z.raw": 1.5e-2,
            "assign_layer.q_mu.raw": 1e-2,
            "assign_layer.q_sqrt.raw": 1.5e-2}
GRAD_TEMPERATURES = (1e-2, 1.0)
# At tau = 1e-2 the assignment weights are one-hot to f32 rounding and f32
# flips near-ties: the assignment layer's leaves are held to GRAD_TOL_COLD,
# 2x the f32 CPU path's distance from f64 (since SMGP takes the q_sqrt
# variance term by the 3-pass split; in one bf16 pass it was 0.26-0.29):
# Z 7.84e-3, q_mu 7.50e-3, q_sqrt 2.90e-2 (a dense f32 variance term gives
# 2.86e-2: the f32 floor at this size).  The two scalar leaves are wider:
# the kernel variance (f32 CPU 6.20e-3) and lengthscale (1.85e-3) sum over
# every flipped point, and an H100 80GB HBM3 (700 W) lands 1.77e-2 and
# 5.99e-3 off, 2.9x and 3.2x the CPU's: 4x the CPU's.  That excess is no
# one kernel's (--cold-grads): over five seeds the card's distance on these
# two leaves runs 0.06x to 10.7x the CPU's, and with any one kernel family
# run as its plain version the seed-0 variance lands 1.0e-2 to 4.1e-2 off.
GRAD_TOL_COLD = {"assign_layer.kernel.variance.raw": 2.5e-2,
                 "assign_layer.kernel.lengthscales.raw": 7.5e-3,
                 "assign_layer.Z.raw": 1.5e-2,
                 "assign_layer.q_mu.raw": 1.5e-2,
                 "assign_layer.q_sqrt.raw": 5.5e-2}


def grad_inputs(M=M_REF, batch=BATCH_REF, seed=0):
    """(arrays, X, Y, z, g) of phase 6's references: smgp_arrays(M, seed),
    a batch and its noise, drawn from the same generator in that order."""
    arrays, rng = smgp_arrays(M, seed)
    X = rng.uniform(-3, 3, size=(batch, D_IN))
    Y = rng.normal(size=(batch, 1))
    z = rng.normal(size=(NUM_SAMPLES, batch, K_EXPERTS))
    g = rng.gumbel(size=(NUM_SAMPLES, batch, K_EXPERTS))
    return arrays, X, Y, z, g


def loss_and_grads(pt, arrays, X, Y, z, g, device, dtype, temperature,
                   whiten=True):
    model = build_model(pt, arrays, device, dtype, jitter=JITTER,
                        temperature=temperature, whiten=whiten)
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    kl = model.pred_layer.prior_kl() + model.assign_layer.prior_kl()
    loss = -(model.E_log_p_Y_from_noise(to(X), to(Y), to(z), to(g)).mean()
             - kl / model.num_data)
    loss.backward()
    out = {name: p.grad.double().cpu() for name, p in model.named_parameters()}
    out["loss"] = loss.detach().double().cpu()
    return out


def phase_grad_reference(pt, dev="cuda"):
    """Phase 6; returns the CPU runs ({tau: {"cpu f32": ..., "f64": ...}}),
    which phase 20 (c) takes as its references: the same state, batch and
    noise."""
    log(f"== phase 6: loss and gradients, {dev} f32 vs CPU f64 (the f32 CPU "
        f"path beside), M={M_REF} batch={BATCH_REF} S={NUM_SAMPLES}")
    arrays, X, Y, z, g = grad_inputs()
    runs = {dev: (dev, torch.float32), "cpu f32": ("cpu", torch.float32),
            "f64": ("cpu", torch.float64)}
    cpu_runs = {}
    for tau in GRAD_TEMPERATURES:
        log(f"  temperature {tau:g}")
        grads = {label: loss_and_grads(pt, arrays, X, Y, z, g, d, t, tau)
                 for label, (d, t) in runs.items()}
        compare_grads("", grads, dev, GRAD_TOL, GRAD_TOL_COLD, tau)
        cpu_runs[tau] = {k: grads[k] for k in ("cpu f32", "f64")}
    return cpu_runs


def rel_dist(runs, key, name):
    """max|runs[key][name] - f64| / max|f64|."""
    want = runs["f64"][name]
    return float((runs[key][name] - want).abs().max() / want.abs().max())


def compare_grads(label, runs, dev, grad_tol, cold_tol, temperature,
                  beside=(("cpu f32", "f32 CPU"),)):
    """Each gradient of ``runs[dev]`` against ``runs["f64"]`` (max|err| /
    max|f64|), the distance of each run in ``beside`` (key, label) printed
    with it: the assignment layer's leaves at ``cold_tol`` below
    temperature 1, every leaf at ``grad_tol`` otherwise."""
    for name, tol in grad_tol.items():
        if temperature < 1.0 and name.startswith("assign_layer."):
            tol = cold_tol[name]
        rel = rel_dist(runs, dev, name)
        others = "; ".join(f"{what} {rel_dist(runs, key, name):.3e}"
                           for key, what in beside)
        check(rel <= tol and finite(runs[dev][name]),
              f"{label}{name}: max|err| / max|f64| {rel:.3e} ({others}; "
              f"tolerance {tol:g})")


def finite(t):
    return bool(torch.isfinite(t).all())


def phase_sampling(pt, dev="cuda", M=M_FULL, N=N_GRID, S=SAMPLE_DRAWS):
    log(f"== phase 7: joint posterior sampling M={M} K={K_EXPERTS} D={D_IN} "
        f"N={N} S={S} f32")
    arrays, rng = smgp_arrays(M)
    model = build_model(pt, arrays, dev, torch.float32)
    X = torch.as_tensor(rng.uniform(-3, 3, size=(N, D_IN)), dtype=torch.float32,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}

    def timed(name, fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        times[name] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    with torch.inference_mode():
        served = pt.precompute_smgp(model)
        pt.reset_launch_counts()
        mean, cov = timed("predict_f(full_cov=True)",
                          lambda: model.pred_layer.predict_f(X, full_cov=True))
        f = timed("predict_f_samples",
                  lambda: model.pred_layer.predict_f_samples(gen, X, S))
        draws = {"": timed("predict_samples",
                           lambda: model.predict_samples(gen, X, S)),
                 "served ": timed("served predict_samples",
                                  lambda: served.predict_samples(gen, X, S))}
        Ws = {"": timed("sample_W", lambda: model.sample_W(gen, X, S)),
              "served ": timed("served sample_W",
                               lambda: served.sample_W(gen, X, S))}
        counts = {name: n for name, n in pt.launch_counts().items()
                  if name in SAMPLING_KERNELS}
        _, var = model.pred_layer.predict_f(X, split=True)
    log(f"launches in the sampling run: {counts}")
    for name, n in counts.items():
        check(n > 0, f"{name} launched {n} times on the sampling path")
    K = K_EXPERTS
    asym = float((cov - cov.transpose(-1, -2)).abs().max())
    scale = float(cov.abs().max())
    check(cov.shape == (K, N, N) and mean.shape == (N, K) and finite(cov)
          and finite(mean) and asym <= 1e-5 * scale,
          f"predict_f(full_cov=True): mean {tuple(mean.shape)}, cov "
          f"{tuple(cov.shape)}, finite, max|C - C^T| {asym:.2e} of max "
          f"{scale:.2e} (<= 1e-5)")
    diag = torch.diagonal(cov, dim1=-2, dim2=-1).T
    err, bad = allclose_report(diag, var, 2e-2, 0.0)
    check(bad == 0, f"diag of the joint covariance (f32 B) vs the marginal "
          f"variance (bf16 B): max_abs_err {err:.3e} (rtol 2e-2)")
    check(f.shape == (S, N, K) and finite(f),
          f"predict_f_samples: {tuple(f.shape)}, finite")
    for route, (ys, fs) in draws.items():
        check(ys.shape == fs.shape == (S, N, 1) and finite(ys) and finite(fs),
              f"{route}predict_samples: y and f {tuple(ys.shape)}, finite")
    for route, W in Ws.items():
        rows_err = float((W.sum(-1) - 1).abs().max())
        check(W.shape == (S, N, K) and finite(W) and rows_err < 1e-5,
              f"{route}sample_W: {tuple(W.shape)}, finite, rows sum to 1 "
              f"(max err {rows_err:.1e})")
    log(f"sampling ms (host clock to synchronize): {times}")
    return counts


# Largest |card f32 - cpu f64| over the largest |f64| of the joint posterior
# at M=1024, N=512 (jitter 1e-4 in both), per layer and output: about 5x
# the port's own f32 CPU path's distance from f64, which is 1.9e-5 and
# 1.9e-4 on the means and 5.2e-3 and 4.9e-3 on the covariances (pred,
# assign; phase_sampling_reference(pt, dev="cpu") prints them).  The
# covariance carries the bf16 operands of #5 into its q_sqrt term.
SAMPLE_TOL = {"pred_layer.mean": 1e-4, "pred_layer.cov": 2.5e-2,
              "assign_layer.mean": 1e-3, "assign_layer.cov": 2.5e-2}


def joint_posterior(pt, arrays, X, device, dtype):
    model = build_model(pt, arrays, device, dtype, jitter=1e-4)
    X = torch.as_tensor(X, dtype=dtype, device=device)
    out = {}
    with torch.inference_mode():
        for layer in ("pred_layer", "assign_layer"):
            mean, cov = getattr(model, layer).predict_f(X, full_cov=True)
            out[f"{layer}.mean"] = mean.double().cpu()
            out[f"{layer}.cov"] = cov.double().cpu()
    return out


def phase_sampling_reference(pt, dev="cuda"):
    log(f"== phase 8: joint posterior, {dev} f32 vs CPU f64, M={M_REF} "
        f"N={N_GRID_REF}")
    arrays, rng = smgp_arrays(M_REF)
    X = rng.uniform(-3, 3, size=(N_GRID_REF, D_IN))
    want = joint_posterior(pt, arrays, X, "cpu", torch.float64)
    got = joint_posterior(pt, arrays, X, dev, torch.float32)
    rels = {}
    for name, tol in SAMPLE_TOL.items():
        rel = float((got[name] - want[name]).abs().max()
                    / want[name].abs().max())
        rels[name] = rel
        check(rel <= tol and finite(got[name]),
              f"{name}: max|err| / max|f64| {rel:.3e} (tolerance {tol:g})")
    return rels


def same_state(a, b):
    """(bit for bit, largest |a - b| over the largest |b|) of two modules'
    parameters."""
    pa = {k: p.detach() for k, p in a.named_parameters()}
    pb = {k: p.detach() for k, p in b.named_parameters()}
    bitwise = all(torch.equal(pa[k], pb[k]) for k in pb)
    rel = max(float((pa[k] - pb[k]).abs().max() / pb[k].abs().max().clamp_min(
        1e-30)) for k in pb)
    return bitwise, rel


def phase_resume(pt, dev="cuda", M=M_REF, batch=BATCH_REF, steps=4):
    log(f"== phase 9: checkpoint and resume, M={M} batch={batch}, {steps} "
        f"steps, saved at {steps // 2}")
    arrays, rng = smgp_arrays(M)
    X = torch.as_tensor(rng.uniform(-3, 3, size=(batch, D_IN)),
                        dtype=torch.float32, device=dev)
    Y = torch.as_tensor(rng.normal(size=(batch, 1)), dtype=torch.float32,
                        device=dev)
    half = steps // 2

    def fresh():
        return (build_model(pt, arrays, dev, torch.float32),
                torch.Generator(device=dev).manual_seed(0))

    def run(n, **kw):
        model, gen = fresh()
        opt = pt.Adam(model, LR)
        _, iters, elbos = pt.run_adam(model, n, iter(lambda: (X, Y), None), LR,
                                      generator=gen, log_every=1,
                                      verbose=False, optimizer=opt, **kw)
        return model, opt, gen, iters, elbos

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        model_a, _, _, _, elbo_a = run(steps)
        model_b, opt_b, gen_b, _, elbo_b = run(half, checkpoint_path=path,
                                               checkpoint_every=half)
        model_c, gen_c = fresh()
        opt_c = pt.Adam(model_c, LR)
        step = pt.restore_checkpoint(path, model_c, opt_c, gen_c)
        sd_b, sd_c = model_b.state_dict(), model_c.state_dict()
        exact = (step == half and opt_c.count == opt_b.count
                 and all(same_bits(sd_b[k], sd_c[k]) for k in sd_b)
                 and all(same_bits(x, y) for x, y in zip(opt_b.m + opt_b.v,
                                                         opt_c.m + opt_c.v))
                 and torch.equal(gen_b.get_state(), gen_c.get_state()))
        check(exact, f"save at step {half} and restore into a fresh model: "
              f"parameters, Adam count/m/v and generator bit for bit")
        model_d, _, _, iters_d, elbo_d = run(steps, checkpoint_path=path,
                                             checkpoint_every=half,
                                             resume=True)
    losses = elbo_b + elbo_d
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(losses, elbo_a))
    bitwise, rel = same_state(model_d, model_a)
    bitwise = bitwise and losses == elbo_a
    log(f"  ELBOs uninterrupted {elbo_a}, resumed {losses}")
    check(iters_d == list(range(half + 1, steps + 1)) and all(
        map(math.isfinite, losses)) and (bitwise or (loss_rel <= 1e-5
                                                     and rel <= 1e-4)),
          f"resumed run vs uninterrupted: "
          + ("bit for bit" if bitwise else
             f"largest ELBO difference {loss_rel:.2e} (relative, <= 1e-5), "
             f"parameters {rel:.2e} of their maxima (<= 1e-4)"))


def phase_multistart(pt, dev="cuda", M=M_REF, batch=BATCH_REF, num_iter=4,
                     probe_iters=2, num_starts=2):
    log(f"== phase 10: multi-start, {num_starts} replicas, {probe_iters} "
        f"probe steps, {num_iter} in all, M={M} batch={batch}")
    arrays, _ = smgp_arrays(M)

    def make_iter(s):
        r = np.random.default_rng(100 + s)
        X = torch.as_tensor(r.uniform(-3, 3, size=(batch, D_IN)),
                            dtype=torch.float32, device=dev)
        Y = torch.as_tensor(r.normal(size=(batch, 1)), dtype=torch.float32,
                            device=dev)
        return iter(lambda: (X, Y), None)

    model = build_model(pt, arrays, dev, torch.float32)
    won, iters, elbos, info = pt.run_adam_multistart(
        model, num_iter, make_iter, LR, num_starts=num_starts,
        probe_iters=probe_iters, eval_keys=2, log_every=1, verbose=False)
    w = info["winner"]
    ref = build_model(pt, arrays, dev, torch.float32)
    pt.run_adam(ref, num_iter, make_iter(w), LR,
                generator=torch.Generator(device=dev).manual_seed(w),
                log_every=num_iter, verbose=False)
    bitwise, rel = same_state(won, ref)
    log(f"  probe ELBOs {info['probe_scores']}, winner {w}; continued "
        f"ELBOs {elbos}")
    check(0 <= w < num_starts and all(map(math.isfinite, info["probe_scores"]))
          and iters == list(range(probe_iters + 1, num_iter + 1))
          and all(map(math.isfinite, elbos)) and (bitwise or rel <= 1e-4),
          f"multi-start picked replica {w} and continued it; against a single "
          f"run of that replica: " + ("bit for bit" if bitwise else
                                      f"{rel:.2e} of the maxima (<= 1e-4)"))


# The unwhitened model against the whitened one at the same state, both f32
# at M=4096 (phase 11): (rtol, atol as a fraction of the whitened output's
# largest magnitude) per route and output.  The two differ only by f32
# rounding on the way.  On the port's f32 CPU path (256 points) the served
# outputs lie within 2.7e-4 of the maximum (means) and 2.8e-4 relative
# (weights); the training path's variance within 1.4% relative: its q_sqrt
# term rounds Kmm^-1 Kmn and L q_sqrt to bf16 and cancels, where the
# whitened one rounds L^-1 Kmn and q_sqrt.  The served variance's q_sqrt
# term (#17) takes bf16 operands too: the whitened cache rounds q_sqrt,
# the unwhitened one L^-1 (L q_sqrt), equal to it up to f32 rounding, so
# entries next to a bf16 boundary round apart.  unwhitened_spread(pt,
# range(8)) on an H100 80GB HBM3 (700 W) put the two served variances
# 7.6e-4 to 2.08e-3 apart relative over seeds 0-7, the largest at seed 0,
# this phase's state; rtol 3e-3.
UNWHITE_TOL = {
    "served": {"predict_y.mean": (1e-3, 2e-3), "predict_y.var": (3e-3, 0.0),
               "predict_assign": (1e-3, 1e-3),
               "predict_density": (1e-3, 1e-3)},
    "train": {"predict_y.mean": (1e-3, 2e-3), "predict_y.var": (5e-2, 0.0)}}


def unwhitened_spread(pt, seeds, dev="cuda", M=M_FULL, batch=BATCH):
    """Phase 11's served comparison of the variance over several seeds: for
    each seed's state, the largest |unwhitened - whitened| / |whitened| of
    predict_y.var over two batches (the rtol that UNWHITE_TOL's entry needs
    there)."""
    worst = []
    for seed in seeds:
        arrays, rng = smgp_arrays(M, seed)
        Xs = [torch.as_tensor(rng.uniform(-3, 3, size=(batch, D_IN)),
                              dtype=torch.float32, device=dev)
              for _ in range(2)]
        var = []
        for whiten in (True, False):
            leaves = arrays if whiten else unwhitened_arrays(arrays, dev)
            model = build_model(pt, leaves, dev, torch.float32, jitter=JITTER,
                                whiten=whiten)
            with torch.inference_mode():
                served = pt.precompute_smgp(model)
                var.append([served.predict_y(X)[1][0] for X in Xs])
            del model, served
        worst.append(max(float(((u - w).abs() / w.abs()).max())
                         for w, u in zip(*var)))
        log(f"seed {seed}: served predict_y.var, unwhitened against "
            f"whitened, largest relative difference {worst[-1]:.3e}")
    return worst


def compare_outputs(label, got, want, tol):
    """serve_batch outputs ``got`` against ``want``, per output name."""
    for name, a, b in zip(tol, got, want):
        rtol, atol_frac = tol[name]
        atol = atol_frac * float(b.abs().max())
        err, bad = allclose_report(a, b, rtol, atol)
        check(bad == 0, f"{label} {name}: max_abs_err {err:.3e} (rtol "
              f"{rtol:g}, atol {atol:.2e})")


def phase_unwhitened(pt, dev="cuda", M=M_FULL, batch=BATCH,
                     steps=UNWHITENED_STEPS):
    log(f"== phase 11: path A, the unwhitened SMGP M={M} K={K_EXPERTS} "
        f"D={D_IN} batch={batch} f32: serving, then {steps} train steps")
    arrays, rng = smgp_arrays(M)
    white = build_model(pt, arrays, dev, torch.float32, jitter=JITTER)
    model = build_model(pt, unwhitened_arrays(arrays, dev), dev, torch.float32,
                        jitter=JITTER, whiten=False)
    batches = [(torch.as_tensor(rng.uniform(-3, 3, size=(batch, D_IN)),
                                dtype=torch.float32, device=dev),
                torch.as_tensor(rng.normal(size=(batch, 1)),
                                dtype=torch.float32, device=dev))
               for _ in range(2)]
    on_card = torch.device(dev).type == "cuda"
    with torch.inference_mode():
        served_white = pt.precompute_smgp(white)
        want = [serve_batch(served_white, X, Y) for X, Y in batches]
        want_train = [t[0] for t in white.predict_y(batches[0][0])]
        del served_white
        sync(dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        pt.reset_launch_counts()
        t0 = time.perf_counter()
        served = pt.precompute_smgp(model)
        sync(dev)
        t_pre = (time.perf_counter() - t0) * 1e3
        got, lat = [], []
        for X, Y in batches:
            t0 = time.perf_counter()
            got.append(serve_batch(served, X, Y))
            sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        got_train = [t[0] for t in model.predict_y(batches[0][0])]
        sync(dev)
        t_train = (time.perf_counter() - t0) * 1e3
        counts = {name: n for name, n in pt.launch_counts().items()
                  if name in UNWHITENED_SERVING_KERNELS}
    log(f"launches in the unwhitened serving run: {counts}")
    for name, n in counts.items():
        check(n > 0, f"{name} launched {n} times on the unwhitened serving path")
    for i, (g, w) in enumerate(zip(got, want)):
        batch_checks(f"unwhitened served batch {i}", *g)
        compare_outputs(f"unwhitened vs whitened, served batch {i}", g, w,
                        UNWHITE_TOL["served"])
    compare_outputs("unwhitened vs whitened, training-path",
                    got_train, want_train, UNWHITE_TOL["train"])
    log(f"precompute_smgp {t_pre:.3f} ms; served batch ms "
        f"{[round(t, 3) for t in lat]}; training-path predict_y {t_train:.3f} ms")
    if on_card:
        log(f"peak device memory (serving): "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del served, white

    # One loss and gradient by hand: #4 runs in the forward (the second
    # solve) and in the backward (the pullback of every forward solve).
    X, Y = batches[0]
    pt.reset_launch_counts()
    loss = model.training_loss(torch.Generator(device=dev).manual_seed(1), X, Y)
    sync(dev)
    fwd = pt.launch_counts()["trsm_lower_t"]
    loss.backward()
    sync(dev)
    bwd = pt.launch_counts()["trsm_lower_t"] - fwd
    value = float(loss.detach())
    check(fwd > 0 and bwd > 0 and math.isfinite(value),
          f"trsm_lower_t launched {fwd} times in the forward and {bwd} in the "
          f"backward of one unwhitened loss ({value:.6f})")
    model.zero_grad(set_to_none=True)
    del loss
    return train_steps(pt, model, X, Y, dev, steps, UNWHITENED_TRAIN_KERNELS)


# Path A at M=1024 (phase 12), card f32 against the f64 CPU path, jitter
# 1e-4 in both.  Outputs take phase 4's REF_TOL: the unwhitened f32 CPU path
# lands as close to f64 as the whitened one (training-path variance 0.73%
# relative against 0.64%).  Gradients: the tolerance on max|got - want| /
# max|want| per leaf, 4-7x the f32 CPU path's own distance from f64 at the
# worse of the two temperatures (phase_unwhitened_reference(pt, dev="cpu")
# prints it: loss 1.3e-5, q_sqrt 1.5e-2 / 1.0e-2, Z 3.6e-3 / 6.4e-3, ...).
# The assignment layer's kernel variance is a scalar sum that the card
# resolves less well than any CPU: 2.7e-3 off f64 on an H100 (1.5e-3 for
# the whitened model in phase 6), against 5.4e-5 to 6.9e-4 for the f32 CPU
# path on two hosts; its entry is 1e-2.  At temperature 1e-2 the
# assignment leaves are held to UNWHITE_GRAD_TOL_COLD.
UNWHITE_GRAD_TOL = {"loss": 1e-4,
                    "likelihood.variance.raw": 1e-3,
                    "pred_layer.kernel.variance.raw": 1e-4,
                    "pred_layer.kernel.lengthscales.raw": 1e-3,
                    "pred_layer.Z.raw": 2e-2,
                    "pred_layer.q_mu.raw": 2e-2,
                    "pred_layer.q_sqrt.raw": 6e-2,
                    "assign_layer.kernel.variance.raw": 1e-2,
                    "assign_layer.kernel.lengthscales.raw": 1e-3,
                    "assign_layer.Z.raw": 3e-2,
                    "assign_layer.q_mu.raw": 1e-2,
                    "assign_layer.q_sqrt.raw": 5e-2}


# Path A at tau = 1e-2: 2x the f32 CPU path's distance from f64 (kernel
# variance 3.27e-3, lengthscale 1.90e-3, Z 2.95e-2, q_mu 1.82e-2, q_sqrt
# 2.74e-2; the H100 within 1.31x of each).
UNWHITE_GRAD_TOL_COLD = {"assign_layer.kernel.variance.raw": 6.5e-3,
                         "assign_layer.kernel.lengthscales.raw": 3.8e-3,
                         "assign_layer.Z.raw": 5.9e-2,
                         "assign_layer.q_mu.raw": 3.6e-2,
                         "assign_layer.q_sqrt.raw": 5.4e-2}


def phase_unwhitened_reference(pt, dev="cuda"):
    log(f"== phase 12: path A, {dev} f32 vs CPU f64 (the f32 CPU path "
        f"beside), M={M_REF} batch={BATCH_REF} S={NUM_SAMPLES}")
    arrays, rng = smgp_arrays(M_REF)
    arrays = unwhitened_arrays(arrays)
    X = rng.uniform(-3, 3, size=(BATCH_REF, D_IN))
    Y = rng.normal(size=(BATCH_REF, 1))
    z = rng.normal(size=(NUM_SAMPLES, BATCH_REF, K_EXPERTS))
    g = rng.gumbel(size=(NUM_SAMPLES, BATCH_REF, K_EXPERTS))
    runs = {dev: (dev, torch.float32), "cpu f32": ("cpu", torch.float32),
            "f64": ("cpu", torch.float64)}
    outs = {label: reference_outputs(pt, arrays, X, Y, d, t, whiten=False)
            for label, (d, t) in runs.items()}
    for route in ("served", "train"):
        for name, (rtol, atol_frac) in REF_TOL.items():
            want = outs["f64"]["train"][name]
            atol = atol_frac * float(want.abs().max())
            err, bad = allclose_report(outs[dev][route][name], want, rtol, atol)
            cpu_err, _ = allclose_report(outs["cpu f32"][route][name], want,
                                         rtol, atol)
            check(bad == 0, f"{route} {name}: max_abs_err {err:.3e} (rtol "
                  f"{rtol:g}, atol {atol:.2e}; f32 CPU {cpu_err:.3e})")
    for tau in GRAD_TEMPERATURES:
        log(f"  temperature {tau:g}")
        grads = {label: loss_and_grads(pt, arrays, X, Y, z, g, d, t, tau,
                                       whiten=False)
                 for label, (d, t) in runs.items()}
        compare_grads("", grads, dev, UNWHITE_GRAD_TOL, UNWHITE_GRAD_TOL_COLD,
                      tau)


JOINT_LEAVES = ("kernel.variance.raw", "kernel.lengthscales.raw", "Z.raw",
                "q_mu.raw", "q_sqrt.raw")


def joint_inputs(M, N, S):
    """The state, the grid and the seeded weights of path B's loss."""
    arrays, rng = smgp_arrays(M)
    X = rng.uniform(-3, 3, size=(N, D_IN))
    wm = rng.normal(size=(N, K_EXPERTS))
    wcov = np.abs(rng.normal(size=(K_EXPERTS, N, N))) / N
    wf = rng.normal(size=(S, N, K_EXPERTS))
    return arrays, X, wm, wcov, wf


def joint_loss(layer, X, wm, wcov, wf, S, generator=None, z=None):
    """sum(wm * mean) + sum(wcov * cov) [+ sum(wf * f)]: mean [N, K] and
    cov [K, N, N] from predict_f(full_cov=True); f [S, N, K] joint draws
    (left out for wf=None) from predict_f_samples(generator), or, given z
    [S, K, N, 1], the same draw written out (mean + chol(cov + JITTER I) z,
    predict_f_samples' formula at f32's jitter) so that any device and
    dtype can take the same z."""
    mean, cov = layer.predict_f(X, full_cov=True)
    loss = (wm * mean).sum() + (wcov * cov).sum()
    if wf is None:
        return loss
    if z is None:
        f = layer.predict_f_samples(generator, X, S)
    else:
        eye = torch.eye(X.shape[0], dtype=cov.dtype, device=cov.device)
        Lc = torch.linalg.cholesky(cov + JITTER * eye)
        f = mean[None] + (Lc @ z[..., 0].permute(1, 2, 0)).permute(2, 1, 0)
    return loss + (wf * f).sum()


def phase_joint_grad(pt, dev="cuda", M=M_FULL, N=N_GRID, S=SAMPLE_DRAWS):
    log(f"== phase 13: path B, the joint posterior's gradient M={M} "
        f"K={K_EXPERTS} D={D_IN} N={N} S={S} f32")
    arrays, X, wm, wcov, wf = joint_inputs(M, N, S)
    layer = build_model(pt, arrays, dev, torch.float32).pred_layer
    to = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    X, wm, wcov, wf = to(X), to(wm), to(wcov), to(wf)
    gen = torch.Generator(device=dev).manual_seed(0)
    on_card = torch.device(dev).type == "cuda"
    sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    pt.reset_launch_counts()
    t0 = time.perf_counter()
    loss = joint_loss(layer, X, wm, wcov, wf, S, generator=gen)
    sync(dev)
    t_fwd = (time.perf_counter() - t0) * 1e3
    loss.backward()
    sync(dev)
    t_all = (time.perf_counter() - t0) * 1e3
    counts = {name: n for name, n in pt.launch_counts().items()
              if name in JOINT_GRAD_KERNELS}
    log(f"launches in the joint-gradient run: {counts}")
    for name, n in counts.items():
        check(n > 0, f"{name} launched {n} times on the joint-gradient path")
    grads = {name: p.grad for name, p in layer.named_parameters()}
    value = float(loss.detach())
    check(math.isfinite(value) and set(grads) == set(JOINT_LEAVES)
          and all(t is not None and finite(t) for t in grads.values())
          and upper_nonzero(grads["q_sqrt.raw"]) == 0,
          f"loss {value:.6e} finite; gradients of "
          f"{sorted(grads)} finite, q_sqrt's exactly 0 above the diagonal")
    log(f"joint loss ms (host clock to synchronize): forward {t_fwd:.3f}, "
        f"forward and backward {t_all:.3f}")
    if on_card:
        log(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


# Path B at M=1024, N=512 (phase 14), card f32 against the f64 CPU path,
# for two losses: the mean and covariance terms alone, and with the draws.
# Each leaf (and the loss) is held to max|got - want| / max|want| <= the
# larger of its entry here, about 5x the f32 CPU path's own distance on one
# host (phase_joint_grad_reference(pt, dev="cpu") prints it), and
# JOINT_CPU_FACTOR times that distance measured in the same run.  The
# second term is there because the draws run through the pullback of each
# [N, N] covariance's Cholesky (+1e-4 I), where f32 resolves a scalar
# leaf's sum only to 0.1-15% depending on the weights and the host's BLAS
# (an earlier set of weights: the f32 CPU path 1.5e-2 and 1.4e-1 off f64 on
# the lengthscale on two hosts, the card 7.7e-2).
JOINT_GRAD_TOL = {
    "cov": {"loss": 6e-4, "kernel.variance.raw": 5e-4,
            "kernel.lengthscales.raw": 3e-3, "Z.raw": 1e-3,
            "q_mu.raw": 1.5e-4, "q_sqrt.raw": 2e-2},
    "cov+draws": {"loss": 4e-3, "kernel.variance.raw": 7e-3,
                  "kernel.lengthscales.raw": 1e-2, "Z.raw": 1e-2,
                  "q_mu.raw": 1e-4, "q_sqrt.raw": 3e-2}}
JOINT_CPU_FACTOR = 4


def joint_grads(pt, inputs, S, device, dtype, draws=True, seed=0, z=None):
    """Loss and raw-leaf gradients of joint_loss on ``inputs`` (joint_inputs'
    tuple), the draws from a generator seeded ``seed`` or from ``z``."""
    arrays, X, wm, wcov, wf = inputs
    layer = build_model(pt, arrays, device, dtype, jitter=JITTER).pred_layer
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    gen = None if z is not None else torch.Generator(
        device=device).manual_seed(seed)
    loss = joint_loss(layer, to(X), to(wm), to(wcov), to(wf) if draws else None,
                      S, generator=gen, z=None if z is None else to(z))
    loss.backward()
    out = {name: p.grad.double().cpu() for name, p in layer.named_parameters()}
    out["loss"] = loss.detach().double().cpu()
    return out


def phase_joint_grad_reference(pt, dev="cuda", M=M_REF, N=N_GRID_REF,
                               S=SAMPLE_DRAWS):
    log(f"== phase 14: path B, {dev} f32 vs CPU f64 (the f32 CPU path "
        f"beside), M={M} N={N} S={S}")
    inputs = joint_inputs(M, N, S)
    # predict_f_samples draws z first from a fresh generator: the same z.
    z = torch.randn((S, K_EXPERTS, N, 1), dtype=torch.float32, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    z = z.cpu().numpy()
    rels = {}
    for terms, tols in JOINT_GRAD_TOL.items():
        draws = terms == "cov+draws"
        log(f"  loss: {terms}")
        got = joint_grads(pt, inputs, S, dev, torch.float32, draws, seed=0)
        cpu = joint_grads(pt, inputs, S, "cpu", torch.float32, draws, z=z)
        want = joint_grads(pt, inputs, S, "cpu", torch.float64, draws, z=z)
        for name, tol in tols.items():
            rel, cpu_rel = (float((t[name] - want[name]).abs().max()
                                  / want[name].abs().max()) for t in (got, cpu))
            rels[terms, name] = rel
            limit = max(tol, JOINT_CPU_FACTOR * cpu_rel)
            check(rel <= limit and finite(got[name]),
                  f"{name}: max|err| / max|f64| {rel:.3e} (f32 CPU "
                  f"{cpu_rel:.3e}; limit {limit:.3g})")
    return rels


# -- path C: the multiclass SMGPModified (phases 15-16) -----------------------
# demos/_runner.py:56-68's multiclass model at bench.py's widths: MultiClass
# (RobustMax) experts, a Gaussian(0.5, D=K) likelihood on the assignment
# layer, both layers SE.  The second model of phase 16 puts the
# demo_multiclass_svgp kernel on the prediction layer (Sum(Matern32(1, 1),
# White(0.01)), White's variance and Z frozen, a Linear mean function).
PATH_C_STEPS, PATH_C_BATCHES, PATH_C_DEMO_STEPS = 4, 4, 2
PATH_C_SERVING_KERNELS = ("kxz", "trsm_lower", "cholesky_factor",
                          "qsqrt_sq_colsum")
ROBUSTMAX_EPS = 1e-3
DEMO_FROZEN = ("pred_layer.kernel.kernels.1.variance.raw", "pred_layer.Z.raw")
# Kernel-name substrings of the MultiClass quadrature's own launches, ahead
# of phase 5's families in phase 15's breakdown (its multiplies and adds
# stay under "elementwise and other").
QUAD_FAMILIES = (("erf_kernel", "MultiClass quadrature: erf"),
                 ("prod_kernel", "MultiClass quadrature: class products"),
                 ("kernel_scan", "MultiClass pullback: cumprod")) + FAMILIES


def path_c_arrays(M, seed=0, demo_kernel=False):
    """Raw leaves of path C keyed as the JAX pytree paths (phase 3's
    perturbed state, the Gaussian variance moved to ``assign_likelihood``;
    MultiClass has no leaves) and the generator for data."""
    arrays, rng = smgp_arrays(M, seed)
    arrays["assign_likelihood.variance.raw"] = arrays.pop(
        "likelihood.variance.raw")
    if demo_kernel:
        del arrays["pred_layer.kernel.variance.raw"]
        del arrays["pred_layer.kernel.lengthscales.raw"]
        arrays.update({
            "pred_layer.kernel.kernels.0.variance.raw": softplus_inv(1.0),
            "pred_layer.kernel.kernels.0.lengthscales.raw": softplus_inv(1.0),
            "pred_layer.kernel.kernels.1.variance.raw": softplus_inv(0.01),
            "pred_layer.mean_function.A.raw":
                0.3 * rng.normal(size=(D_IN, K_EXPERTS)),
            "pred_layer.mean_function.b.raw": 0.1 * rng.normal(size=K_EXPERTS),
        })
    return arrays, rng


def class_labels(rng, X, seed=0):
    """Labels as float [N, 1]: the argmax over classes of a fixed seeded
    linear map of X plus noise."""
    W = np.random.default_rng(seed + 1000).normal(size=(X.shape[1], K_EXPERTS))
    noisy = np.asarray(X) @ W + 0.5 * rng.normal(size=(len(X), K_EXPERTS))
    return np.argmax(noisy, axis=1).astype(np.float64)[:, None]


def build_path_c(pt, arrays, device, dtype, jitter=None, temperature=1e-2,
                 demo_kernel=False):
    """The port's SMGPModified built with its constructors, its state
    loaded by load_numpy_ (the demo kernel's leaves frozen with
    set_trainable)."""
    opts = dict(dtype=dtype, device=device)
    M = np.shape(arrays["pred_layer.Z.raw"])[0]

    def layer(kernel, mean=None):
        return pt.SVGP.create(kernel, np.zeros((M, D_IN)), K_EXPERTS,
                              mean_function=mean, jitter=jitter, **opts)

    if demo_kernel:
        pred = layer(pt.Sum([pt.Matern32.create(1.0, 1.0, **opts),
                             pt.White.create(0.01, **opts)]),
                     pt.mean_functions.Linear.create(
                         np.zeros((D_IN, K_EXPERTS)), **opts))
    else:
        pred = layer(pt.SquaredExponential.create(*PRED_SE, **opts))
    model = pt.SMGPModified(
        pt.MultiClass.create(K_EXPERTS), pred,
        layer(pt.SquaredExponential.create(*ASSIGN_SE, **opts)),
        assign_likelihood=pt.Gaussian.create(LIK_VARIANCE, D=K_EXPERTS,
                                             **opts),
        K=K_EXPERTS, num_samples=NUM_SAMPLES, num_data=NUM_DATA,
        temperature=temperature)
    pt.load_numpy_(model, arrays)
    if demo_kernel:
        pt.set_trainable(model.pred_layer.kernel.kernels[1].variance, False)
        pt.set_trainable(model.pred_layer.Z, False)
    return model


def multiclass_checks(label, probs, var, pi, dens, probs64, sums_fine):
    """The served class probabilities ``probs`` equal the same quadrature
    evaluated in float64 on the same marginals (``probs64``) within 1e-5;
    that quadrature with 100 points instead of 20 (``sums_fine``, its row
    sums) sums to 1 within 2e-3 (the JAX suite's bound,
    tests/test_likelihoods.py:120-131; the 20-point rows, printed, miss it by
    up to a few percent where one class's variance is several times the
    others'); variances p - p^2 >= 0; the mixture weights sum to 1; each
    log-density within [log(eps/(K-1)), log(1 - eps)] up to 1e-5 of float32
    rounding; all finite."""
    lo = math.log(ROBUSTMAX_EPS / (K_EXPERTS - 1)) - 1e-5
    hi = math.log(1.0 - ROBUSTMAX_EPS) + 1e-5
    row_err = float((probs.double().sum(-1) - 1).abs().max())
    fine_err = float((sums_fine - 1).abs().max())
    f64_err = float((probs.double() - probs64).abs().max())
    ok = (all(finite(t) for t in (probs, var, pi, dens))
          and f64_err <= 1e-5 and fine_err <= 2e-3 and bool((var >= 0).all())
          and float((pi.sum(-1) - 1).abs().max()) < 1e-5
          and bool((dens >= lo).all()) and bool((dens <= hi).all())
          and probs.shape == var.shape == pi.shape
          == (probs.shape[0], K_EXPERTS) and dens.shape == (probs.shape[0],))
    check(ok, f"{label}: finite; class probabilities {f64_err:.2e} from the "
          f"float64 quadrature (limit 1e-5), rows sum to 1 within "
          f"{fine_err:.2e} at 100 points (limit 2e-3; 20 points, as served, "
          f"{row_err:.2e}); var >= 0; assign rows sum to 1; densities in "
          f"[{lo:.4f}, {hi:.6f}] (min {float(dens.min()):.4f}, max "
          f"{float(dens.max()):.6f}); shapes")


def quadrature_ms(model, X, Y):
    """CUDA-event ms of the MultiClass likelihood alone at this batch's
    prediction marginals: variational_expectations forward and backward to
    (Fmu, Fvar), and predict_mean_and_var (its K quadratures)."""
    with torch.no_grad():
        fmu, fvar = model.pred_layer.predict_f(X, split=True)
    fmu.requires_grad_(True)
    fvar.requires_grad_(True)
    lik = model.likelihood

    def ve():
        out = lik.variational_expectations(fmu, fvar, Y).sum()
        out.backward()
        fmu.grad = fvar.grad = None

    def pmv():
        with torch.no_grad():
            lik.predict_mean_and_var(fmu, fvar)

    return cuda_ms([ve, pmv], 10)


def phase_path_c(pt, dev="cuda", M=M_FULL, batch=BATCH, steps=PATH_C_STEPS,
                 n_batches=PATH_C_BATCHES, draws=SAMPLE_DRAWS):
    log(f"== phase 15: path C, the multiclass SMGPModified M={M} "
        f"K={K_EXPERTS} S={NUM_SAMPLES} D={D_IN} batch={batch} f32: {steps} "
        f"train steps, then {n_batches} served batches and {draws} draws")
    arrays, rng = path_c_arrays(M)
    model = build_path_c(pt, arrays, dev, torch.float32)
    Xn = rng.uniform(-3, 3, size=(batch, D_IN))
    X = torch.as_tensor(Xn, dtype=torch.float32, device=dev)
    Y = torch.as_tensor(class_labels(rng, Xn), dtype=torch.float32,
                        device=dev)
    per_class = np.bincount(Y.cpu().numpy()[:, 0].astype(int),
                            minlength=K_EXPERTS)
    log(f"labels: class counts {per_class.tolist()}")
    counts = train_steps(pt, model, X, Y, dev, steps, TRAIN_KERNELS,
                         families=QUAD_FAMILIES)
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        ve_ms, pmv_ms = quadrature_ms(model, X, Y)
        log(f"MultiClass likelihood alone at batch {batch}: "
            f"variational_expectations forward + backward {ve_ms:.3f} ms, "
            f"predict_mean_and_var ({K_EXPERTS} quadratures) {pmv_ms:.3f} ms")

    batches = []
    for _ in range(n_batches):
        Xn = rng.uniform(-3, 3, size=(batch, D_IN))
        batches.append((torch.as_tensor(Xn, dtype=torch.float32, device=dev),
                        torch.as_tensor(class_labels(rng, Xn),
                                        dtype=torch.float32, device=dev)))
    sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        pt.reset_launch_counts()
        t0 = time.perf_counter()
        served = pt.precompute_smgp(model)
        sync(dev)
        t_pre = (time.perf_counter() - t0) * 1e3
        check(type(served) is pt.SMGPModified
              and served.assign_likelihood is model.assign_likelihood
              and type(model.pred_layer) is pt.SVGP,
              f"precompute_smgp returned {type(served).__name__} with the "
              f"model's assign_likelihood; the trained model unchanged")
        lat = []
        fine_lik = pt.MultiClass.create(K_EXPERTS,
                                        num_gauss_hermite_points=100)
        for i, (Xb, Yb) in enumerate(batches):
            t0 = time.perf_counter()
            probs, var = served.predict_y(Xb)
            sync(dev)
            t1 = time.perf_counter()
            pi = served.predict_assign(Xb)
            sync(dev)
            t2 = time.perf_counter()
            dens = served.predict_density(Xb, Yb)
            sync(dev)
            t3 = time.perf_counter()
            lat.append((t3 - t0) * 1e3)
            log(f"served batch {i}: {lat[-1]:.3f} ms (predict_y "
                f"{(t1 - t0) * 1e3:.3f}, predict_assign {(t2 - t1) * 1e3:.3f}, "
                f"predict_density {(t3 - t2) * 1e3:.3f})")
            fmu, fvar = (t.double() for t in served.pred_layer.predict_f(Xb))
            probs64, _ = served.likelihood.predict_mean_and_var(fmu, fvar)
            fine, _ = fine_lik.predict_mean_and_var(fmu, fvar)
            multiclass_checks(f"served batch {i}", probs[0], var[0], pi, dens,
                              probs64, fine.sum(-1))
        gen = torch.Generator(device=dev).manual_seed(5)
        t0 = time.perf_counter()
        sy, sf = served.predict_samples(gen, batches[0][0], S=draws)
        sync(dev)
        t_draw = (time.perf_counter() - t0) * 1e3
        counts_served = {name: n for name, n in pt.launch_counts().items()
                         if name in PATH_C_SERVING_KERNELS}
    check(finite(sy) and finite(sf)
          and sy.shape == sf.shape == (draws, batch, 1),
          f"predict_samples: {draws} draws of [{batch}, 1], finite "
          f"({t_draw:.3f} ms)")
    log(f"launches in the path C serving run: {counts_served}")
    for name, n in counts_served.items():
        check(n > 0, f"{name} launched {n} times on path C's served route")
    log(f"path C precompute_smgp {t_pre:.3f} ms; served batch ms "
        f"{[round(t, 3) for t in lat]}")
    if on_card:
        log(f"peak device memory (serving): "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


# Path C at M=1024 (phase 16), card f32 against the f64 CPU path, jitter
# 1e-4 in both, the f32 CPU path's distance printed beside.  Outputs: phase
# 4's REF_TOL for the mixture weights and the densities (the f32 CPU path at
# 0.06 and 0.26 of those bounds).  The class probabilities and their
# variances p - p^2 carry the bf16 variance term's 0.64% through the
# quadrature: the f32 CPU path is 1.0% (SE) and 1.6% (demo kernel) off f64
# on both at worst, 7.7e-4 absolute on the probabilities, 0.86 and 0.79 of
# REF_TOL's bounds; PATH_C_REF_TOL allows about three times that.
PATH_C_REF_TOL = dict(REF_TOL, **{"predict_y.mean": (3e-3, 3e-3),
                                  "predict_y.var": (5e-2, 0.0)})
# The loss and raw-leaf gradients (max|got - want| / max|want| per leaf):
# phase 6's GRAD_TOL where the f32 CPU path of path C sits well inside it
# (loss 5e-7, the assignment likelihood's variance 4.4e-5, the prediction
# layer's lengthscale 3.4e-4, Z 8.1e-4, q_mu 7.8e-4, q_sqrt 2.1e-3; at tau =
# 1 the assignment layer's lengthscale 5.2e-4 (2.2e-3 with the demo
# kernel), Z 2.0e-3, q_mu 1.2e-4, q_sqrt 3.5e-3).  Widened, each beside the
# f32 CPU path's own distance:
#  - the prediction layer's kernel variance: MultiClass's gradient there
#    is a near cancellation, 7.25e-6 in f64 against 4.1e-2 for the
#    lengthscale; the bf16 variance term moves it by 3.3e-6, so the f32 CPU
#    path is 0.43-0.46 off f64 (1.3% with that term in f32), an H100 80GB
#    HBM3 (700 W) 0.63-0.65.  The entry, 1.0, still catches a wrong sign or
#    a gradient larger than the value;
#  - the assignment layer's kernel variance, a scalar sum the card resolves
#    less well than a CPU (phase 12): f32 CPU 2.6e-3 (SE), 5.2e-3 (demo
#    kernel) at tau = 1, the H100 2.4e-3 and 9.3e-3; 2e-2.
PATH_C_GRAD_TOL = {name.replace("likelihood.variance.raw",
                                "assign_likelihood.variance.raw"): tol
                   for name, tol in GRAD_TOL.items()}
PATH_C_GRAD_TOL.update({"pred_layer.kernel.variance.raw": 1.0,
                        "assign_layer.kernel.variance.raw": 2e-2})
# The demo kernel's model: its own leaves (the frozen ones have no
# gradient), about 5x the f32 CPU path's distance: kernels.0.variance
# 1.6e-4, kernels.0.lengthscales 1.2e-3, the Linear mean's A 1.0e-4, b
# 1.9e-4.
PATH_C_DEMO_GRAD_TOL = {
    name: tol for name, tol in PATH_C_GRAD_TOL.items()
    if name not in ("pred_layer.kernel.variance.raw",
                    "pred_layer.kernel.lengthscales.raw", "pred_layer.Z.raw")}
PATH_C_DEMO_GRAD_TOL.update({
    "pred_layer.kernel.kernels.0.variance.raw": 1e-3,
    "pred_layer.kernel.kernels.0.lengthscales.raw": 5e-3,
    "pred_layer.mean_function.A.raw": 1e-3,
    "pred_layer.mean_function.b.raw": 1e-3})


# Path C (SE) at tau = 1e-2: at most 2x the f32 CPU path's distance from
# f64, the 3-pass split on the assignment layer only (SMGPModified's), as
# --cold-grads (3) measured it on the CPU of an H100 host: kernel variance
# 9.91e-4, lengthscale 1.58e-3, Z 2.02e-3, q_mu 6.78e-4, q_sqrt 1.14e-2;
# the H100 within 1.47x of each.
PATH_C_GRAD_TOL_COLD = {"assign_layer.kernel.variance.raw": 1.9e-3,
                        "assign_layer.kernel.lengthscales.raw": 3.1e-3,
                        "assign_layer.Z.raw": 4.0e-3,
                        "assign_layer.q_mu.raw": 1.3e-3,
                        "assign_layer.q_sqrt.raw": 2.2e-2}


def path_c_outputs(pt, model, X, Y):
    """serve_batch's outputs of both routes, keyed as REF_TOL."""
    with torch.inference_mode():
        served = pt.precompute_smgp(model)
        out = {"served": serve_batch(served, X, Y),
               "train": serve_batch(model, X, Y)}
    return {route: dict(zip(REF_TOL, (t.double().cpu() for t in vals)))
            for route, vals in out.items()}


def path_c_grads(pt, model, X, Y, z, g):
    """Loss and raw-leaf gradients of ``model`` with the given noise."""
    kl = model.pred_layer.prior_kl() + model.assign_layer.prior_kl()
    loss = -(model.E_log_p_Y_from_noise(X, Y, z, g).mean()
             - kl / model.num_data)
    loss.backward()
    out = {name: p.grad.double().cpu() for name, p in model.named_parameters()
           if p.grad is not None}
    out["loss"] = loss.detach().double().cpu()
    model.zero_grad(set_to_none=True)
    return out


def phase_path_c_reference(pt, dev="cuda", M=M_REF, batch=BATCH_REF):
    log(f"== phase 16: path C, {dev} f32 vs CPU f64 (the f32 CPU path "
        f"beside), M={M} batch={batch} S={NUM_SAMPLES}; the demo kernel "
        f"Sum(Matern32, White) + Linear, {PATH_C_DEMO_STEPS} Adam steps")
    runs = {dev: (dev, torch.float32), "cpu f32": ("cpu", torch.float32),
            "f64": ("cpu", torch.float64)}
    for demo in (False, True):
        label = "demo kernel" if demo else "SE"
        arrays, rng = path_c_arrays(M, demo_kernel=demo)
        Xn = rng.uniform(-3, 3, size=(batch, D_IN))
        Yn = class_labels(rng, Xn)
        z = rng.normal(size=(NUM_SAMPLES, batch, K_EXPERTS))
        g = rng.gumbel(size=(NUM_SAMPLES, batch, K_EXPERTS))
        outs, grads = {}, {}
        for tau in (GRAD_TEMPERATURES if not demo else (1.0,)):
            for key, (d, t) in runs.items():
                to = lambda a: torch.as_tensor(a, dtype=t, device=d)
                model = build_path_c(pt, arrays, d, t, jitter=JITTER,
                                     temperature=tau, demo_kernel=demo)
                if tau == 1.0:
                    outs[key] = path_c_outputs(pt, model, to(Xn), to(Yn))
                grads[key] = path_c_grads(pt, model, to(Xn), to(Yn), to(z),
                                          to(g))
            log(f"  {label}, temperature {tau:g}")
            compare_grads(f"{label} ", grads, dev,
                          PATH_C_DEMO_GRAD_TOL if demo else PATH_C_GRAD_TOL,
                          PATH_C_GRAD_TOL_COLD, tau)
        for route in ("served", "train"):
            for name, (rtol, atol_frac) in PATH_C_REF_TOL.items():
                want = outs["f64"]["train"][name]
                atol = atol_frac * float(want.abs().max())
                err, bad = allclose_report(outs[dev][route][name], want, rtol,
                                           atol)
                cpu_err, _ = allclose_report(outs["cpu f32"][route][name],
                                             want, rtol, atol)
                check(bad == 0, f"{label} {route} {name}: max_abs_err "
                      f"{err:.3e} (rtol {rtol:g}, atol {atol:.2e}; f32 CPU "
                      f"{cpu_err:.3e})")
        if demo:
            phase_demo_steps(pt, dev, arrays, Xn, Yn)


def phase_demo_steps(pt, dev, arrays, Xn, Yn, steps=PATH_C_DEMO_STEPS):
    """The demo kernel's model on ``dev``: ``steps`` Adam steps under
    torch.profiler, K(X, Z) forward and pullback launched as Matern32
    (template kind 1 of csrc/kxz.cu), the frozen leaves bit-equal."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model = build_path_c(pt, arrays, dev, torch.float32, demo_kernel=True)
    X = torch.as_tensor(Xn, dtype=torch.float32, device=dev)
    Y = torch.as_tensor(Yn, dtype=torch.float32, device=dev)
    params = dict(model.named_parameters())
    frozen = {name: params[name].detach().clone() for name in DEMO_FROZEN}
    check(sorted(n for n, t in pt.trainable_mask(model).items() if not t)
          == sorted(DEMO_FROZEN), f"frozen leaves: {list(DEMO_FROZEN)}")
    opt = pt.Adam(model, LR)
    step = pt.make_train_step(opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    on_card = torch.device(dev).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    pt.reset_launch_counts()
    with profile(activities=activities) as prof:
        losses = [float(step(model, gen, X, Y)) for _ in range(steps)]
        sync(dev)
    counts = {name: n for name, n in pt.launch_counts().items()
              if name in ("kxz", "kxz_vjp")}
    check(all(math.isfinite(x) for x in losses),
          f"demo kernel: loss finite at each of {steps} Adam steps "
          f"{[round(x, 6) for x in losses]}")
    check(all(torch.equal(params[name], frozen[name]) for name in frozen),
          f"demo kernel: the frozen leaves bit-equal after {steps} steps")
    if on_card:
        names = [(ev.key, ev.count) for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA]
        matern = {sub: sum(n for key, n in names if sub in key)
                  for sub in ("kxz_kernel<1,", "kxz_vjp_kernel<1,")}
        log(f"demo kernel launches: {counts}; Matern32 kernels {matern}")
        check(all(n > 0 for n in counts.values()) and all(matern.values()),
              f"K(X, Z) launched as Matern32, forward and pullback, through "
              f"the Sum kernel ({matern})")


# Phases 17-18: the VGP (models/vgp.py) with scipy's L-BFGS
# (training/scipy_opt.py), Bernoulli likelihood, SE(1, 1) kernel, f32 at
# the 1e-4 jitter floor.  X is uniform on [-5, 5]^4, so that K(X, X) +
# 1e-4 I of 4096 points (a nearest neighbour about one lengthscale away)
# factors in f32; the labels are a seeded smooth function of X plus noise.
VGP_N, VGP_D, VGP_MAXITER, VGP_REF_N = 4096, 4, 10, 512
VGP_KERNELS = ("kxz", "kxz_vjp", "trsm_lower", "tri_tt_matmul",
               "tri_nt_matmul", "kl_sq_logdiag", "kl_bwd_scale",
               "cholesky_factor")
VGP_PREDICT_KERNELS = ("kxz", "trsm_lower", "tril_sq_fwd", "tril_fwd_f32",
                       "cholesky_factor")
VGP_LEAVES = ("kernel.variance.raw", "kernel.lengthscales.raw", "q_mu.raw",
              "q_sqrt.raw")


def vgp_data(N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-5, 5, size=(N, VGP_D))
    f = np.sin(X[:, 0]) + np.cos(X[:, 1]) + 0.3 * (X[:, 2] - X[:, 3])
    Y = (f + 0.3 * rng.normal(size=N) > 0).astype(np.float64)[:, None]
    return X, Y, rng


def build_vgp(pt, X, Y, device, dtype, state=None):
    model = pt.VGP.create(pt.SquaredExponential.create(1.0, 1.0, dtype=dtype,
                                                       device=device),
                          pt.Bernoulli(), X, Y, num_latent_gps=1, dtype=dtype,
                          device=device)
    if state is not None:
        pt.load_numpy_(model, state)
    return model


class ScipyClock:
    """Wraps scipy.optimize.minimize for the run_scipy calls inside the
    block: the wall ms of each evaluation of the objective (the vector's
    copy to the model's device, the loss and gradient, the copy back; it
    ends in a host read, so the device has finished) and the wall ms of
    each whole minimize (the rest is scipy's own host work)."""

    def __enter__(self):
        import scipy.optimize
        self.module, self.minimize = scipy.optimize, scipy.optimize.minimize
        self.evals, self.losses, self.totals = [], [], []

        def minimize(fun, x0, **kw):
            def timed(x):
                t0 = time.perf_counter()
                out = fun(x)
                self.evals.append((time.perf_counter() - t0) * 1e3)
                self.losses.append(float(out[0]))
                return out
            t0 = time.perf_counter()
            res = self.minimize(timed, x0, **kw)
            self.totals.append((time.perf_counter() - t0) * 1e3)
            return res

        scipy.optimize.minimize = minimize
        return self

    def __exit__(self, *exc):
        self.module.minimize = self.minimize


def phase_vgp(pt, dev="cuda", N=VGP_N, maxiter=VGP_MAXITER, n_pred=BATCH,
              n_joint=N_GRID):
    from modulatedgps_tpu_torch.demos import demo_vgp_bernoulli
    log(f"== phase 17: VGP + Bernoulli with scipy L-BFGS: the 7-point demo, "
        f"then N={N} D={VGP_D} f32 for maxiter {maxiter}, then predictions on "
        f"{n_pred} and (full_cov) {n_joint} points")
    on_card = torch.device(dev).type == "cuda"
    dtype = torch.float32 if on_card else torch.float64
    X7 = np.array([2.0, 4, 7, 9, 17, 19, 21])[:, None]
    Y7 = np.array([1.0, 1, 1, 1, 0, 0, 0])[:, None]
    with torch.no_grad():
        elbo0 = float(build_vgp(pt, X7, Y7, dev, dtype).elbo())
    out = demo_vgp_bernoulli.main(["--platform", "gpu" if on_card else "cpu",
                                   "--no-plot"])
    p = out["p"]
    check(bool(np.all(p[:4] > 0.5) and np.all(p[4:] < 0.5))
          and out["elbo"] > elbo0,
          f"demo_vgp_bernoulli on {dev}: p(y=1|x) {np.round(p, 4)} (> 0.5 on "
          f"the first four, < 0.5 on the rest), ELBO {elbo0:.6f} -> "
          f"{out['elbo']:.6f}, nit {out['result'].nit}")

    X, Y, rng = vgp_data(N)
    model = build_vgp(pt, X, Y, dev, torch.float32)
    with torch.no_grad():   # garbage above the diagonal: the tril transform
        model.q_sqrt.raw.add_(torch.triu(torch.as_tensor(
            rng.normal(size=(1, N, N)), dtype=torch.float32, device=dev), 1))
        upper0 = torch.triu(model.q_sqrt.raw, 1).clone()
        elbo0 = float(model.elbo())
    sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    pt.reset_launch_counts()
    with ScipyClock() as clock:
        model, res = pt.run_scipy(model, maxiter=maxiter)
    counts = {name: n for name, n in pt.launch_counts().items()
              if name in VGP_KERNELS}
    log(f"launches in run_scipy ({res.nfev} evaluations): {counts}")
    for name, n in counts.items():
        check(n > 0, f"{name} launched {n} times in run_scipy")
    with torch.no_grad():
        elbo1 = float(model.elbo())
    check(all(math.isfinite(x) for x in [elbo0, elbo1, *clock.losses])
          and elbo1 > elbo0,
          f"ELBO finite and rising: {elbo0:.4f} -> {elbo1:.4f} (nit "
          f"{res.nit}, nfev {res.nfev}, {res.message})")
    check(torch.equal(torch.triu(model.q_sqrt.raw.detach(), 1), upper0),
          "raw q_sqrt above the diagonal bit-equal to its start (seeded "
          "garbage there)")
    evals = clock.evals
    host = (clock.totals[0] - sum(evals)) / max(res.nit, 1)
    log(f"run_scipy N={N}: {clock.totals[0]:.1f} ms for {res.nit} iterations, "
        f"{len(evals)} evaluations ({len(evals) / max(res.nit, 1):.2f} an "
        f"iteration); an evaluation {statistics.median(evals):.3f} ms median "
        f"({min(evals):.3f}-{max(evals):.3f}; copy in, loss and gradient on "
        f"{dev}, copy out), scipy's host work {host:.3f} ms an iteration")
    n = sum(p.numel() for p in model.parameters() if p.requires_grad)
    x = np.zeros(n)
    t0 = time.perf_counter()
    vec = torch.from_numpy(x).to(dev, torch.float32)
    sync(dev)
    t1 = time.perf_counter()
    vec.cpu().numpy().astype(np.float64)
    t2 = time.perf_counter()
    log(f"  the vector's {n} entries: copy in {(t1 - t0) * 1e3:.3f} ms, copy "
        f"out {(t2 - t1) * 1e3:.3f} ms (host clock)")
    if on_card:
        log(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        params = [p for p in model.parameters() if p.requires_grad]
        _, rows = profile_kernels(
            lambda: torch.autograd.grad(model.training_loss(), params),
            "one evaluation's loss and gradient")
        solver = [key for _, _, key in rows if "potrf" in key or "getrf" in key]
        check(not solver, f"no cuSOLVER factorization in the evaluation "
              f"({[k[:60] for k in solver[:3]]})")
        kxx = sum(n for _, n, key in rows if "kxz_kernel<" in key)
        check(kxx > 0, f"the evaluation's profile holds K(X, X)'s forward, "
              f"its first kernel ({kxx} kxz_kernel launches)")

    pt.reset_launch_counts()
    Xp = torch.as_tensor(rng.uniform(-5, 5, size=(n_pred, VGP_D)),
                         dtype=torch.float32, device=dev)
    Xj = Xp[:n_joint]
    with torch.no_grad():
        t0 = time.perf_counter()
        mean, var = model.predict_y(Xp)
        sync(dev)
        t1 = time.perf_counter()
        fmean, fcov = model.predict_f(Xj, full_cov=True)
        sync(dev)
        t2 = time.perf_counter()
    pred = {name: n for name, n in pt.launch_counts().items()
            if name in VGP_PREDICT_KERNELS}
    log(f"predict_y on {n_pred} points {(t1 - t0) * 1e3:.3f} ms, predict_f("
        f"full_cov=True) on {n_joint} {(t2 - t1) * 1e3:.3f} ms (first calls, "
        f"host clock); launches {pred}")
    for name, k in pred.items():
        check(k > 0, f"{name} launched {k} times in the predictions")
    sym = float((fcov - fcov.transpose(-1, -2)).abs().max())
    check(finite(mean) and finite(var) and finite(fcov)
          and mean.shape == var.shape == (n_pred, 1)
          and bool(((mean >= 0) & (mean <= 1) & (var >= 0)).all())
          and fcov.shape == (1, n_joint, n_joint) and sym <= 1e-5,
          f"predictions finite, p in [0, 1], var >= 0, shapes, covariance "
          f"symmetric (max |C - C^T| {sym:.2e})")
    return {**counts, **pred}


# Phase 18: the card's f32 against the f64 CPU path at N=512 (the f32 CPU
# path beside), each entry on max|got - want| / max|want|, about 5x the f32
# CPU path's distance: ELBO 2.4e-5, the raw leaves' gradients 7.0e-5
# (kernel variance), 3.3e-4 (lengthscale), 1.0e-4 (q_mu), 2.6e-4
# (q_sqrt); predict_f 6.2e-4 (mean) and 7.0e-3 (variance: #3's bf16 B at
# K=1), predict_y 4.5e-4 / 6.1e-4, the log density 7.8e-4.  An H100 80GB
# HBM3 (700 W) lands within 1.1x of each.
VGP_REF_TOL = {"elbo": 1.2e-4, "kernel.variance.raw": 4e-4,
               "kernel.lengthscales.raw": 1.6e-3, "q_mu.raw": 5e-4,
               "q_sqrt.raw": 1.3e-3, "predict_f.mean": 3e-3,
               "predict_f.var": 3.5e-2, "predict_y.mean": 2.2e-3,
               "predict_y.var": 3e-3, "predict_log_density": 4e-3}


def vgp_reference(pt, X, Y, state, Xs, Ys, device, dtype):
    """The ELBO, the raw leaves' gradients of the negative ELBO and the
    predictions of one VGP, as float64 CPU tensors."""
    model = build_vgp(pt, X, Y, device, dtype, state)
    loss = model.training_loss()
    loss.backward()
    out = {name: p.grad.double().cpu() for name, p in model.named_parameters()
           if p.grad is not None}
    out["elbo"] = -loss.detach().double().cpu()
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    with torch.no_grad():
        fm, fv = model.predict_f(to(Xs))
        ym, yv = model.predict_y(to(Xs))
        lp = model.predict_log_density(to(Xs), to(Ys))
    for name, t in (("predict_f.mean", fm), ("predict_f.var", fv),
                    ("predict_y.mean", ym), ("predict_y.var", yv),
                    ("predict_log_density", lp)):
        out[name] = t.double().cpu()
    return out


def phase_vgp_reference(pt, dev="cuda", N=VGP_REF_N):
    log(f"== phase 18: VGP N={N}, {dev} f32 vs CPU f64 (the f32 CPU path "
        f"beside): ELBO, raw-leaf gradients, predictions")
    X, Y, rng = vgp_data(N, seed=1)
    q_sqrt = np.eye(N)[None] + 0.05 * np.tril(rng.normal(size=(1, N, N)))
    idx = np.arange(N)
    q_sqrt[:, idx, idx] = np.abs(q_sqrt[:, idx, idx])
    state = {"kernel.variance.raw": softplus_inv(1.3),
             "kernel.lengthscales.raw": softplus_inv(1.2), "X.raw": X,
             "Y.raw": Y, "q_mu.raw": 0.5 * rng.normal(size=(N, 1)),
             "q_sqrt.raw": q_sqrt}
    Xs, Ys, _ = vgp_data(2 * N, seed=2)
    runs = {dev: (dev, torch.float32), "cpu f32": ("cpu", torch.float32),
            "f64": ("cpu", torch.float64)}
    outs = {label: vgp_reference(pt, X, Y, state, Xs, Ys, d, t)
            for label, (d, t) in runs.items()}
    want = outs["f64"]
    for name, tol in VGP_REF_TOL.items():
        rel, cpu_rel = (float((outs[k][name] - want[name]).abs().max()
                              / want[name].abs().max()) for k in (dev, "cpu f32"))
        check(rel <= tol and finite(outs[dev][name]),
              f"{name}: max|err| / max|f64| {rel:.3e} (f32 CPU {cpu_rel:.3e}; "
              f"tolerance {tol:g})")


# --cold-grads: the seeds of phase 6's state it scores, and the layers the
# 3-pass split variance term may run on (SMGP ships "both").
COLD_SEEDS = (0, 1, 2, 3, 4)
SPLIT_CHOICES = ("both", "assign", "none")


@contextlib.contextmanager
def split_layers(pt, which):
    """Every SMGP's and SMGPModified's SVGP layers take the 3-pass split
    q_sqrt variance term on ``which`` of them: "both" (the SMGP's as
    shipped), "assign" (the assignment layer only: the SMGPModified's as
    shipped) or "none" (one bf16 pass on both)."""
    shipped = {cls: cls.__dict__["_marginals"]
               for cls in (pt.SMGP, pt.SMGPModified)}

    def marginals(self, layer, Xnew):
        if not isinstance(layer, pt.SVGP):
            return layer.predict_f(Xnew)
        return layer.predict_f(Xnew, split=which == "both" or (
            which == "assign" and layer is self.assign_layer))

    for cls in shipped:
        cls._marginals = marginals
    try:
        yield
    finally:
        for cls, fn in shipped.items():
            cls._marginals = fn


def plain_swaps():
    """Kernel family -> [(module, name, plain version)]: the wrappers that
    the SMGP step calls, each to be replaced by its plain version on the
    card."""
    from modulatedgps_tpu_torch.ops import (chol_kernel, kl, kl_kernel,
                                            kxz_kernel, linalg, tril_kernel,
                                            trimm_kernel, trsm_kernel)
    return {
        "K(X, Z) and its pullback (#1)": [
            (kxz_kernel, "kxz_launch", kxz_kernel.kxz_plain),
            (kxz_kernel, "kxz_vjp", kxz_kernel.kxz_vjp_plain)],
        "Cholesky (#15/#16)": [
            (linalg, "cholesky_factor",
             lambda K, trace=None: chol_kernel.cholesky_factor_plain(K))],
        "TRSM (#2, #4)": [
            (linalg, "trsm_lower", lambda L, B=None, *, inv=None,
             tril_rhs=False: trsm_kernel.trsm_lower_plain(L, B)),
            (linalg, "trsm_lower_t", lambda L, B, *, inv=None:
             trsm_kernel.trsm_lower_t_plain(L, B))],
        "split tril forward (#3), dL / dA (#6/#7)": [
            (tril_kernel, name, getattr(tril_kernel, name + "_plain"))
            for name in ("tril_sq_fwd_split", "tril_dl", "tril_da")],
        "pullback products (#10/#11)": [
            (trimm_kernel, "tri_tt_matmul", trimm_kernel.tri_tt_matmul_plain),
            (trimm_kernel, "tri_nt_matmul", trimm_kernel.tri_nt_matmul_plain)],
        "KL (#12/#13)": [
            (kl, "kl_sq_logdiag", kl_kernel.kl_sq_logdiag_plain),
            (kl, "kl_bwd_scale", kl_kernel.kl_bwd_scale_plain)],
    }


@contextlib.contextmanager
def swapped(entries):
    """Each (module, name, fn) of ``entries`` set for the block, its
    outputs made contiguous as the kernels give them."""
    def contiguous(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            if isinstance(out, tuple):
                return tuple(t.contiguous() if torch.is_tensor(t) else t
                             for t in out)
            return out.contiguous()
        return run

    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in entries]
    for mod, name, fn in entries:
        setattr(mod, name, contiguous(fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_cold_grads(pt, dev="cuda"):
    """What GRAD_TOL_COLD, INDUCING_COLD_FACTOR and the split on both SMGP
    layers rest on, printed and not checked: (1) phase 6's assignment
    leaves at tau = 1e-2 (M=1024, batch 2048) for each of COLD_SEEDS, the
    card's and the f32 CPU path's distance from f64 with the split on each
    of SPLIT_CHOICES, and phase 20 (c)'s sharded program's on the card and
    in f32 on the CPU (one-rank groups); (2) at seed
    0, the card with one kernel family at a time run as its plain version;
    (3) phase 16's SE model at tau = 1e-2 with the split on both layers and
    on the assignment layer only; (4) phase 5's step at M=4096 for each
    choice, in turns, with its peak memory."""
    f32 = torch.float32
    leaves = list(GRAD_TOL_COLD)
    short = [k.split(".", 1)[1].replace(".raw", "") for k in leaves]

    def dist(got, want, names=leaves):
        return [float((got[k] - want[k]).abs().max() / want[k].abs().max())
                for k in names]

    def fmt(d):
        return " ".join(f"{v:.3e}" for v in d)

    log(f"== --cold-grads (1): phase 6's assignment leaves at tau = 1e-2, "
        f"M={M_REF} batch={BATCH_REF} S={NUM_SAMPLES}, max|err| / max|f64| "
        f"({', '.join(short)}) by seed and split layers")
    from modulatedgps_tpu_torch import parallel as par
    for seed in COLD_SEEDS:
        inputs = grad_inputs(seed=seed)

        def run(d, t):
            return loss_and_grads(pt, *inputs, d, t, 1e-2)

        def run_sharded(d):
            with one_rank_group(par, d) as mesh:
                return sharded_loss_and_grads(pt, par, mesh, *inputs, d, 1e-2)

        want = run("cpu", torch.float64)
        for which in SPLIT_CHOICES:
            with split_layers(pt, which):
                card, cpu = dist(run(dev, f32), want), dist(run("cpu", f32),
                                                            want)
            log(f"  seed {seed}, split {which:6s}: card {fmt(card)} | f32 CPU "
                f"{fmt(cpu)} | card / CPU "
                f"{' '.join(f'{a / b:.2f}' for a, b in zip(card, cpu))}")
        card, cpu = dist(run_sharded(dev), want), dist(run_sharded("cpu"), want)
        log(f"  seed {seed}, sharded     : card {fmt(card)} | f32 CPU "
            f"{fmt(cpu)} | card / CPU "
            f"{' '.join(f'{a / b:.2f}' for a, b in zip(card, cpu))}")
        if seed == COLD_SEEDS[0]:
            log("  (2) seed 0, split both, one kernel family as its plain "
                "version on the card:")
            for family, entries in plain_swaps().items():
                with swapped(entries):
                    log(f"    {family}: {fmt(dist(run(dev, f32), want))}")

    arrays, rng = path_c_arrays(M_REF)
    Xn = rng.uniform(-3, 3, size=(BATCH_REF, D_IN))
    Yn = class_labels(rng, Xn)
    z = rng.normal(size=(NUM_SAMPLES, BATCH_REF, K_EXPERTS))
    g = rng.gumbel(size=(NUM_SAMPLES, BATCH_REF, K_EXPERTS))
    names = list(PATH_C_GRAD_TOL_COLD) + ["pred_layer.kernel.variance.raw"]

    def run_c(d, t):
        to = lambda a: torch.as_tensor(a, dtype=t, device=d)
        model = build_path_c(pt, arrays, d, t, jitter=JITTER, temperature=1e-2)
        return path_c_grads(pt, model, to(Xn), to(Yn), to(z), to(g))

    want = run_c("cpu", torch.float64)
    log(f"== --cold-grads (3): phase 16's SE model at tau = 1e-2, the "
        f"assignment leaves and the prediction kernel variance "
        f"({', '.join(k.replace('.raw', '') for k in names)})")
    for which in ("both", "assign"):
        with split_layers(pt, which):
            card, cpu = (dist(run_c(d, f32), want, names)
                         for d in (dev, "cpu"))
        log(f"  split {which:6s}: card {fmt(card)} | f32 CPU {fmt(cpu)}")

    log(f"== --cold-grads (4): phase 5's step (M={M_FULL}, batch {BATCH}) "
        f"by split layers, 3 steps after one a turn, 3 turns")
    arrays, rng = smgp_arrays(M_FULL)
    model = build_model(pt, arrays, dev, f32)
    X = torch.as_tensor(rng.uniform(-3, 3, size=(BATCH, D_IN)), dtype=f32,
                        device=dev)
    Y = torch.as_tensor(rng.normal(size=(BATCH, 1)), dtype=f32, device=dev)
    step = pt.make_train_step(pt.Adam(model, LR))
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = {which: [] for which in SPLIT_CHOICES}
    peak = {}
    for _ in range(3):
        for which in SPLIT_CHOICES:
            with split_layers(pt, which):
                step(model, gen, X, Y)
                sync(dev)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(3):
                    step(model, gen, X, Y)
                sync(dev)
                ms[which].append((time.perf_counter() - t0) / 3 * 1e3)
                peak[which] = torch.cuda.max_memory_allocated() / 2**30
    for which in SPLIT_CHOICES:
        log(f"  split {which:6s}: step ms {[round(t, 3) for t in ms[which]]}, "
            f"median {statistics.median(ms[which]):.3f}; peak "
            f"{peak[which]:.2f} GiB")


def phase_against(parent: str) -> None:
    """The Cholesky (#15/#16), the tril forward (#3/#5), the tril backward
    (#6-#9), the TRSM (#2: the inverse, [4096, 8] and [4096, 8192]; #4 at
    both widths), the Cholesky pullback's products (#10/#11), the fused
    q_sqrt quadratic (#17), K(X, Z) and its pullback (#1) and the KL
    forward sums (#12) of this checkout against those of another one
    (``parent``, e.g. a checkout of the parent commit), both packages
    loaded in this process: CUDA-event medians at the main shapes, timed
    in turns (parent, this, this, parent) over the same inputs, the
    factors, the forwards' and the solves' outputs compared bit for bit,
    the backwards' within 1e-3 of the parent's maximum, #10/#11 within
    1e-4 of it and #17's within rtol 1e-4 (#1 and #12: against_kxz_kl)."""
    import importlib
    import importlib.util
    from modulatedgps_tpu_torch.ops import (chol_kernel, quad_kernel, tril_kernel,
                                            trimm_kernel, trsm_kernel)
    root = Path(parent).resolve() / "modulatedgps_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_port", root / "__init__.py",
        submodule_search_locations=[str(root)])
    sys.modules["parent_port"] = module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    p_native = importlib.import_module("parent_port._native")
    path, seconds = p_native.build()
    p_native.library()
    log(f"== against {parent}: its build {seconds:.1f} s -> {path.name}")
    pchol = importlib.import_module("parent_port.ops.chol_kernel")
    ptril = importlib.import_module("parent_port.ops.tril_kernel")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)

    def turns(what, parent_fn, this_fn, reps, device=False):
        """Per-call event medians in turns; with device, also the device
        time of each call's kernels (torch.profiler), in the same order."""
        p1, t1, t2, p2 = cuda_ms([parent_fn, this_fn, this_fn, parent_fn], reps)
        log(f"  {what}: parent {p1:.4f} / {p2:.4f} ms, this {t1:.4f} / "
            f"{t2:.4f} ms (parent, this, this, parent; {reps} turns)")
        if device:
            p1, t1, t2, p2 = (device_ms(fn, ("",), reps) for fn in
                              (parent_fn, this_fn, this_fn, parent_fn))
            log(f"  {what}, device: parent {p1:.4f} / {p2:.4f} ms, this "
                f"{t1:.4f} / {t2:.4f} ms (every kernel of the call)")

    for M in (M_REF, M_FULL):
        for name, layer in (("assign", ASSIGN_SE), ("pred", PRED_SE)):
            K = north_star_kmm(M, layer)
            (Lp, Ip), (L, Inv) = pchol.cholesky_factor(K), chol_kernel.cholesky_factor(K)
            torch.cuda.synchronize()
            check(torch.equal(L, Lp) and torch.equal(Inv, Ip),
                  f"cholesky_factor M={M} {name} Kmm: L and Inv bit-equal to "
                  f"the parent's (max |dL| {float((L - Lp).abs().max()):.3e})")
        turns(f"cholesky_factor M={M} pred Kmm", lambda: pchol.cholesky_factor(K),
              lambda: chol_kernel.cholesky_factor(K), 10)
    M = M_FULL
    for what, N, this_fn, parent_fn in (
            ("tril_sq_fwd", BATCH, tril_kernel.tril_sq_fwd, ptril.tril_sq_fwd),
            ("tril_fwd_f32", N_GRID, tril_kernel.tril_fwd_f32,
             ptril.tril_fwd_f32)):
        A16 = (torch.randn(M, N, generator=g) / math.sqrt(M)).to(dev, torch.bfloat16)
        L16 = (torch.eye(M) + 0.05 * torch.randn(K_EXPERTS, M, M, generator=g)
               ).to(dev, torch.bfloat16)
        got, want = this_fn(A16, L16), parent_fn(A16, L16)
        torch.cuda.synchronize()
        diff = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want), f"{what} M={M} N={N} K={K_EXPERTS}: "
              f"bit-equal to the parent's (max |this - parent| {diff:.3e})")
        turns(f"{what} M={M} N={N} K={K_EXPERTS}",
              lambda: parent_fn(A16, L16), lambda: this_fn(A16, L16), 5)
        del A16, L16, got, want
    # The SMGP layers' q_sqrt variance term: this checkout's 3-pass split
    # (tril_sq_fwd_split; forward and backward of atl_sq_colsum with split)
    # against the parent's one bf16 pass (#3; #8/#9), on the same fp32
    # operands, in turns.
    A = (torch.randn(M, BATCH, generator=g) / math.sqrt(M)).to(dev)
    L = (torch.eye(M) + 0.05 * torch.tril(torch.randn(K_EXPERTS, M, M,
                                                      generator=g))).to(dev)
    A2, L3 = tril_kernel._split_operands(A, L)
    A16, L2 = A2[0].contiguous(), L3[:2 * K_EXPERTS]
    B, extra = tril_kernel.tril_sq_fwd_split(A2, L2)
    one = ptril.tril_sq_fwd(A16, L3[:K_EXPERTS]).float().square().sum(-1)
    exact = (A.double().T @ L.double()).square().sum(-1)
    e_split = float((extra.double() - exact).abs().max() / exact.max())
    e_one = float((one.double() - exact).abs().max() / exact.max())
    check(e_split < e_one / 20, f"tril_sq_fwd_split M={M} N={BATCH} "
          f"K={K_EXPERTS}: the square sums {e_split:.3e} off f64, the "
          f"parent's one pass {e_one:.3e} (need < 1/20)")
    turns(f"tril_sq_fwd_split (this) / tril_sq_fwd (parent) M={M} N={BATCH} "
          f"K={K_EXPERTS}", lambda: ptril.tril_sq_fwd(A16, L3[:K_EXPERTS]),
          lambda: tril_kernel.tril_sq_fwd_split(A2, L2), 5)
    Ag, Lg = A.clone().requires_grad_(), L.clone().requires_grad_()
    w = torch.randn(K_EXPERTS, BATCH, generator=g).to(dev)

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad((w * fn(Ag, Lg)).sum(), (Ag, Lg))

    turns(f"atl_sq_colsum forward and backward, split (this) / one pass "
          f"(parent) M={M} N={BATCH} K={K_EXPERTS}",
          fwd_bwd(ptril.atl_sq_colsum),
          fwd_bwd(lambda a, l: tril_kernel.atl_sq_colsum(a, l, True)), 5)
    del A, L, A2, L3, A16, L2, B, extra, one, exact, Ag, Lg
    # The backward kernels (#8/#9 at the batch, #6/#7 at the sampling grid):
    # within 1e-3 of the parent's maximum (the summation order changed).
    for N, names in ((BATCH, ("tril_sq_dl", "tril_sq_da")),
                     (N_GRID, ("tril_dl", "tril_da"))):
        A16 = (torch.randn(M, N, generator=g) / math.sqrt(M)).to(dev, torch.bfloat16)
        L16 = (torch.eye(M) + 0.05 * torch.randn(K_EXPERTS, M, M, generator=g)
               ).to(dev, torch.bfloat16)
        B16 = tril_kernel.tril_sq_fwd(A16, L16)
        G = (2.0 * torch.randn(K_EXPERTS, N, generator=g)).to(dev)
        W16 = torch.randn(K_EXPERTS, N, M, generator=g).to(dev, torch.bfloat16)
        for what in names:
            x16 = A16 if what.endswith("dl") else L16
            args = (x16, B16, G) if what.startswith("tril_sq") else (x16, W16)
            this_fn, parent_fn = getattr(tril_kernel, what), getattr(ptril, what)
            got, want = this_fn(*args), parent_fn(*args)
            torch.cuda.synchronize()
            diff = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(diff <= 1e-3 * scale, f"{what} M={M} N={N} K={K_EXPERTS}: "
                  f"max |this - parent| {diff:.3e} of max {scale:.3e} (1e-3)")
            turns(f"{what} M={M} N={N} K={K_EXPERTS}",
                  lambda: parent_fn(*args), lambda: this_fn(*args), 5)
            del got, want
        del A16, L16, B16, G, W16
    # The TRSM (#2: the inverse and a wide B; #4) bit-equal to the parent's,
    # and #17 within rtol 1e-4 (atol 1e-5 of the maximum) of the parent's,
    # with NaN above L's and S's diagonals.
    ptrsm = importlib.import_module("parent_port.ops.trsm_kernel")
    pquad = importlib.import_module("parent_port.ops.quad_kernel")
    L, Inv = chol_kernel.cholesky_factor(north_star_kmm(M, PRED_SE))
    L_nan = L + nan_above(1, M, dev)[0]
    B = torch.randn(M, BATCH, generator=g).to(dev)
    Bq = torch.randn(M, K_EXPERTS, generator=g).to(dev)   # q_mu's width
    for what, fn, pfn, args, kw in (
            ("trsm_lower inverse", trsm_kernel.trsm_lower, ptrsm.trsm_lower,
             (L_nan,), {"inv": Inv}),
            (f"trsm_lower [{M}, {K_EXPERTS}]", trsm_kernel.trsm_lower,
             ptrsm.trsm_lower, (L_nan, Bq), {"inv": Inv}),
            (f"trsm_lower_t [{M}, {K_EXPERTS}]", trsm_kernel.trsm_lower_t,
             ptrsm.trsm_lower_t, (L_nan, Bq), {"inv": Inv}),
            (f"trsm_lower [{M}, {BATCH}]", trsm_kernel.trsm_lower,
             ptrsm.trsm_lower, (L_nan, B), {"inv": Inv}),
            (f"trsm_lower_t [{M}, {BATCH}]", trsm_kernel.trsm_lower_t,
             ptrsm.trsm_lower_t, (L_nan, B), {"inv": Inv})):
        got, want = fn(*args, **kw), pfn(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{what}: bit-equal to the parent's "
              f"(max |this - parent| {float((got - want).abs().max()):.3e})")
        turns(what, lambda: pfn(*args, **kw), lambda: fn(*args, **kw), 5)
        del got, want
    # The Cholesky pullback's products (#10, #11): within 1e-4 of the
    # parent's largest magnitude (the summation order may change), with
    # garbage and NaN above the triangular operands' diagonals.
    ptrimm = importlib.import_module("parent_port.ops.trimm_kernel")
    Linv = trsm_kernel.trsm_lower(L, inv=Inv)
    Lbar = torch.tril(torch.randn(M, M, generator=g).to(dev))
    S = torch.randn(M, M, generator=g).to(dev)
    nan = nan_above(1, M, dev)[0]
    Lg, Linvg, Lbarg = ((X + nan).contiguous() for X in (L, Linv, Lbar))
    for what, call in (
            ("tri_tt_matmul",
             lambda t: t.tri_tt_matmul(Linvg, Lbarg, tril_out=False)),
            ("tri_tt_matmul tril_out",
             lambda t: t.tri_tt_matmul(Lg, Lbarg, tril_out=True)),
            ("tri_nt_matmul", lambda t: t.tri_nt_matmul(S, Linvg))):
        got, want = call(trimm_kernel), call(ptrimm)
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(diff <= 1e-4 * scale and finite(got),
              f"{what} M={M}: max |this - parent| {diff:.3e} of max {scale:.3e} "
              f"(1e-4)")
        turns(f"{what} M={M}", lambda: call(ptrimm), lambda: call(trimm_kernel), 10)
        del got, want
    S16 = (torch.eye(M, device=dev) + 0.05 * torch.randn(
        K_EXPERTS, M, M, generator=g).to(dev)
        + nan_above(K_EXPERTS, M, dev)).to(torch.bfloat16)
    A = (torch.randn(M, BATCH, generator=g) / math.sqrt(M)).to(dev)
    got, want = quad_kernel.qsqrt_sq_colsum(S16, A), pquad.qsqrt_sq_colsum(S16, A)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err, bad = allclose_report(got, want, 1e-4, 1e-5 * scale)
    check(bad == 0, f"qsqrt_sq_colsum K={K_EXPERTS} M={M} N={BATCH}: max "
          f"|this - parent| {err:.3e} of max {scale:.3e} (rtol 1e-4, atol "
          f"1e-5 max)")
    turns(f"qsqrt_sq_colsum K={K_EXPERTS} M={M} N={BATCH}",
          lambda: pquad.qsqrt_sq_colsum(S16, A),
          lambda: quad_kernel.qsqrt_sq_colsum(S16, A), 5)
    del S16, A, got, want
    against_kxz_kl(importlib, dev, g, turns)


def against_kxz_kl(importlib, dev, g, turns):
    """--against, #1 and #12: the forward bit-equal to the parent's at Kmn
    [4096, 8192] and Kmm [4096, 4096] (both kinds), and at D = 130 on the
    generic path; the pullback of Z, l
    and var within KXZ_VJP_TOL of the largest entry of the parent's eager
    gradient; the KL forward sums within 1e-6 relative of the parent's (the
    order of summation changed); each timed in turns."""
    from modulatedgps_tpu_torch.ops import kl_kernel, kxz_kernel
    pkxz = importlib.import_module("parent_port.ops.kxz_kernel")
    pkl = importlib.import_module("parent_port.ops.kl_kernel")
    M = M_FULL
    Zi = torch.randn(M, D_IN, generator=g).to(dev)
    Xd = (6 * torch.rand(BATCH, D_IN, generator=g) - 3).to(dev)
    ls = torch.tensor(PRED_SE[1], device=dev)
    var = torch.tensor(PRED_SE[0], device=dev)
    for what, X2 in (("Kmn", Xd), ("Kmm", Zi)):
        N2 = X2.shape[0]
        for kind in ("rbf", "matern32"):
            got = kxz_kernel.kxz(Zi, X2, ls, var, kind=kind)
            want = pkxz.kxz(Zi, X2, ls, var, kind=kind)
            torch.cuda.synchronize()
            diff = float((got - want).abs().max())
            check(torch.equal(got, want), f"kxz {what} {kind} [{M}, {N2}]: "
                  f"bit-equal to the parent's (max |this - parent| {diff:.3e})")
            del got, want
        turns(f"kxz {what} rbf [{M}, {N2}]", lambda: pkxz.kxz(Zi, X2, ls, var),
              lambda: kxz_kernel.kxz(Zi, X2, ls, var), 20, device=True)
        Kbar = torch.randn(M, N2, generator=g).to(dev)
        with torch.enable_grad():
            leaves = [t.clone().requires_grad_() for t in (Zi, ls, var)]
            x2 = leaves[0] if X2 is Zi else X2
            graphs = [mod.kxz(leaves[0], x2, leaves[1], leaves[2])
                      for mod in (pkxz, kxz_kernel)]
        pull = lambda K: torch.autograd.grad(K, leaves, Kbar, retain_graph=True)
        want, got = pull(graphs[0]), pull(graphs[1])
        torch.cuda.synchronize()
        for name, a, b in zip(("Z", "lengthscales", "variance"), got, want):
            diff = float((a - b).abs().max())
            scale = float(b.abs().max())
            check(diff <= KXZ_VJP_TOL * scale and finite(a),
                  f"kxz pullback {what} [{M}, {N2}] {name}: max |this - parent| "
                  f"{diff:.3e} of max {scale:.3e} ({KXZ_VJP_TOL:g})")
        turns(f"kxz pullback {what} [{M}, {N2}] (Z, l, var)",
              lambda: pull(graphs[0]), lambda: pull(graphs[1]), 10, device=True)
        peaks = []
        for K in graphs:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            pull(K)
            torch.cuda.synchronize()
            peaks.append((torch.cuda.max_memory_allocated() - base) / 2**20)
        log(f"  kxz pullback {what} [{M}, {N2}]: peak memory above the graph "
            f"{peaks[0]:.1f} MiB (parent) / {peaks[1]:.1f} MiB (this)")
        del graphs, leaves, Kbar
    K = K_EXPERTS
    diag = torch.diag_embed(1.0 + 0.5 * torch.rand(K, M, generator=g))
    Lq = (torch.tril(0.05 * torch.randn(K, M, M, generator=g), -1) + diag
          ).to(dev) + nan_above(K, M, dev)
    got, want = kl_kernel.kl_sq_logdiag(Lq), pkl.kl_sq_logdiag(Lq)
    torch.cuda.synchronize()
    rel = [abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(got, want)]
    check(max(rel) <= 1e-6, f"kl_sq_logdiag K={K} M={M}: relative |this - "
          f"parent| {rel[0]:.2e} (sum of squares), {rel[1]:.2e} (log sum) "
          f"(1e-6)")
    turns(f"kl_sq_logdiag K={K} M={M}", lambda: pkl.kl_sq_logdiag(Lq),
          lambda: kl_kernel.kl_sq_logdiag(Lq), 20, device=True)
    # #1's generic path (D over 8, staged a chunk at a time): bit-equal too.
    Zg = torch.randn(301, 130, generator=g).to(dev)
    Xg = (6 * torch.rand(77, 130, generator=g) - 3).to(dev)
    for kind, lsg in (("rbf", torch.tensor(12.0, device=dev)),
                      ("matern32", torch.tensor(KXZ_WIDE_LS, device=dev))):
        got = kxz_kernel.kxz(Zg, Xg, lsg, var, kind=kind)
        want = pkxz.kxz(Zg, Xg, lsg, var, kind=kind)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"kxz generic D {kind} [301, 130]x[77, "
              f"130]: bit-equal to the parent's (max |this - parent| "
              f"{float((got - want).abs().max()):.3e})")


# Phase 19 (a) also holds every kernel wrapper the demos launched against
# its plain version at the demos' own shapes and on their own data: the
# first call at each (wrapper, argument shapes and options) the nine CLIs
# make is copied on the card as it happens (ops reached through the
# package's modules, utils.profiling.intercepting) and replayed after the
# runs, the kernel beside its plain version, at phase 2's tolerance for
# that kernel.  Those replays are not the runs' launches: the counts are
# read before them.
def _copy(x, memo):
    """x with every tensor copied (one copy for a tensor passed twice)."""
    if isinstance(x, torch.Tensor):
        if id(x) not in memo:
            memo[id(x)] = x.detach().clone()
        return memo[id(x)]
    if isinstance(x, (tuple, list)):
        return type(x)(_copy(v, memo) for v in x)
    return x


def _signature(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    return x if isinstance(x, (bool, int, str, type(None))) else type(x).__name__


@contextlib.contextmanager
def recording_wrapper_calls():
    """Inside, the first call of each kernel wrapper at each signature is
    copied (before it runs: adam_tril_ writes its operands) into the dict
    this yields, {(name, signature): (args, kwargs)}."""
    from modulatedgps_tpu_torch.utils.profiling import intercepting
    calls = {}

    def record(fn, *args, **kwargs):
        key = (fn.__name__, _signature(args),
               _signature(tuple(sorted(kwargs.items()))))
        if key not in calls:
            memo = {}
            calls[key] = (_copy(args, memo), _copy(kwargs, memo))
        return fn(*args, **kwargs)

    with intercepting(record):
        yield calls


def _close(got, want, rel):
    """(ok, max |got - want|) with rtol and atol ``rel`` of max |want|."""
    err, bad = allclose_report(got, want, rel, rel * float(want.abs().max()))
    return bad == 0, err


def _replay_kxz(a, kw):
    from modulatedgps_tpu_torch.ops import kxz_kernel
    got = kxz_kernel.kxz(*a, **kw)
    err, bad = allclose_report(got, kxz_kernel.kxz_plain(*a, **kw), 1e-5,
                               1e-6 * float(a[3]))
    return bad == 0, err


def _replay_kxz_vjp(a, kw):
    from modulatedgps_tpu_torch.ops import kxz_kernel
    kind, needs = kw.get("kind", "rbf"), kw.get("needs", (True,) * 4)
    got = kxz_kernel.kxz_vjp(*a, **kw)
    plain = kxz_kernel.kxz_vjp_plain(*a, kind, needs)
    a64 = [t.double() for t in a[:4]]
    exact = kxz_eager_pullback(*a64, a[4].double(), kind, needs)
    # The pullback of |K_bar|: for the lengthscale and the variance, whose
    # dK / d(theta) is >= 0 entrywise, the sum of |terms| of their gradient.
    absum = kxz_eager_pullback(*a64, a[4].double().abs(), kind, needs)
    ok, worst = True, 0.0
    for leaf, g, p, e, s in zip(KXZ_LEAVES, got, plain, exact, absum):
        if e is None:
            ok = ok and g is None
            continue
        tol = KXZ_VJP_TOL * float(e.abs().max())
        err = float((g.double() - e).abs().max())
        err_p = float((g - p).abs().max())
        err_32 = float((p.double() - e).abs().max())
        worst = max(worst, err)
        # Where the gradient cancels far below its terms (the lengthscale's
        # over [25, 1] x [300, 1], K(Z, Z)'s Z-bar near 0), the f32 closed
        # form itself lies further than tol from f64: the kernel is then
        # held within 2x the closed form's distance, as the Cholesky rows
        # hold it to the plain version's.  A hyperparameter's gradient is
        # one f32 sum over every entry of K_bar: where it cancels (the
        # inducing-sharded step's Kmn lengthscale, 1.5e5 below its terms),
        # the kernel is held within eps32 x sum|terms|, the rounding of one
        # f32 sum, far below what a tile dropped or counted twice moves.
        rounding = (torch.finfo(torch.float32).eps * float(s.abs().max())
                    if leaf in ("lengthscales", "variance") else 0.0)
        good = finite(g) and ((err <= tol and err_p <= tol)
                              or (err_32 > tol and err <= 2 * err_32)
                              or err <= rounding)
        if not good or err > tol:
            log(f"    kxz_vjp {tuple(a[0].shape)}x{tuple(a[1].shape)} "
                f"{kind} needs {needs} {leaf}: vs f64 {err:.3e}, vs plain "
                f"f32 {err_p:.3e}, plain f32 vs f64 {err_32:.3e}, tol "
                f"{tol:.3e}, eps32 x sum|terms| {rounding:.3e}: "
                f"{'ok' if good else 'FAIL'}")
        ok = ok and good
    return ok, worst


def _replay_cholesky(a, kw):
    from modulatedgps_tpu_torch.ops import chol_kernel
    (K,) = a
    L, Inv = chol_kernel.cholesky_factor(K)
    Lp, Invp = chol_kernel.cholesky_factor_plain(K)
    L64 = torch.linalg.cholesky(K.double())
    scale, col_scale = float(L64.abs().max()), L64.abs().amax(0)

    def dist(X, Y=L64):
        d = (X.double() - Y.double()).abs()
        return float(d.max()) / scale, float((d / col_scale).max())

    (e_k, _), (e_p, c_p) = dist(L), dist(Lp)
    e_lib, _ = dist(torch.linalg.cholesky(K))
    e_kp, c_kp = dist(L, Lp)
    ok = (finite(L) and finite(Inv) and upper_nonzero(L) == 0
          and e_k <= 2 * e_lib + 2.4e-7 and e_kp <= 2 * e_p + 2.4e-7
          and c_kp <= 2 * c_p + 2.4e-7
          and inv_residual(L, Inv) <= 3 * inv_residual(Lp, Invp) + 1e-6)
    return ok, e_kp * scale


def _replay_trsm(transpose):
    def replay(a, kw):
        from modulatedgps_tpu_torch.ops import trsm_kernel
        L, B = a[0], (a[1] if len(a) > 1 else kw.get("B"))
        fn, plain = ((trsm_kernel.trsm_lower_t, trsm_kernel.trsm_lower_t_plain)
                     if transpose else
                     (trsm_kernel.trsm_lower, trsm_kernel.trsm_lower_plain))
        got, want = fn(*a, **kw), plain(L, B)
        op = torch.tril(L).T if transpose else torch.tril(L)
        rhs = torch.eye(L.shape[0], device=L.device) if B is None else B
        res_k = float((op @ got - rhs).abs().max())
        res_p = float((op @ want - rhs).abs().max())
        # Phase 2's rule for #2 and #4: within 3x the plain version's
        # residual + a few ulps of max|rhs| (trsm_wave_rows, trsm_wide_rows).
        floor = 1e-6 * float(rhs.abs().max())
        return (finite(got) and res_k <= 3 * res_p + floor,
                float((got - want).abs().max()))
    return replay


def _replay_tril(name, rel, lower_zero=False):
    def replay(a, kw):
        from modulatedgps_tpu_torch.ops import tril_kernel
        got = getattr(tril_kernel, name)(*a, **kw)
        want = getattr(tril_kernel, name + "_plain")(*a, **kw)
        ok, err = _close(got.float(), want.float(), rel)
        if name == "tril_sq_fwd":     # and its row square sums, as phase 2
            ok = ok and _close(got.float().square().sum(-1),
                               want.float().square().sum(-1), rel)[0]
        if lower_zero:
            ok = ok and upper_nonzero(got) == 0
        return ok, err
    return replay


def _replay_split(a, kw):
    from modulatedgps_tpu_torch.ops import tril_kernel
    A2, L2 = a
    B, extra = tril_kernel.tril_sq_fwd_split(A2, L2)
    want, want_extra = tril_kernel.tril_sq_fwd_split_plain(A2, L2)
    ok, err = _close(B, want, 1e-4)
    ok = ok and _close(extra, want_extra, 1e-4)[0]
    # Against the f64 product of the f32 operands (hi + lo): under 1/20 of
    # one bf16 pass's error.
    K = L2.shape[0] // 2
    A = A2[0].double() + A2[1].double()
    L = L2[:K].double() + L2[K:].double()
    exact = A.T @ torch.tril(L)
    split64 = float((B.double() - exact).abs().max())
    one64 = float((tril_kernel.tril_fwd_f32_plain(
        A.float().bfloat16(), L.float().bfloat16()).double()
        - exact).abs().max())
    return ok and split64 < one64 / 20, err


def _replay_trimm(name):
    def replay(a, kw):
        from modulatedgps_tpu_torch.ops import trimm_kernel
        got = getattr(trimm_kernel, name)(*a, **kw)
        ok, err = _close(got, getattr(trimm_kernel, name + "_plain")(*a, **kw),
                         2e-3)
        if kw.get("tril_out"):
            ok = ok and upper_nonzero(got) == 0
        return ok, err
    return replay


def _replay_kl_fwd(a, kw):
    from modulatedgps_tpu_torch.ops import kl_kernel
    (Lq,) = a
    sq, ld = kl_kernel.kl_sq_logdiag(Lq)
    low = torch.tril(Lq).double()
    logd = torch.log(torch.diagonal(low, dim1=-2, dim2=-1).abs())
    sq64, ld64 = float(low.square().sum()), float(logd.sum())
    e_sq = abs(float(sq) - sq64) / sq64
    e_ld = abs(float(ld) - ld64) / max(float(logd.abs().sum()), 1e-30)
    return e_sq <= 1e-5 and e_ld <= 1e-5, abs(float(sq) - sq64)


def _replay_kl_bwd(a, kw):
    from modulatedgps_tpu_torch.ops import kl_kernel
    dL = kl_kernel.kl_bwd_scale(*a)
    ok, err = _close(torch.tril(dL), kl_kernel.kl_bwd_scale_plain(*a), 1e-6)
    return ok and upper_nonzero(dL) == 0, err


def _replay_adam(a, kw):
    from modulatedgps_tpu_torch.training import fused_adam
    p, g, m, v = a[:4]
    got, want = [t.clone() for t in (p, m, v)], [t.clone() for t in (p, m, v)]
    fused_adam.adam_tril_(got[0], g, got[1], got[2], *a[4:], **kw)
    fused_adam.adam_tril_plain_(want[0], g, want[1], want[2], *a[4:], **kw)
    ok, worst = True, 0.0
    for x, y, old in zip(got, want, (p, m, v)):
        good, err = _close(torch.tril(x), torch.tril(y), 1e-6)
        bits = torch.int32 if x.element_size() == 4 else torch.int64
        kept = same_bits(torch.triu(x.view(bits), 1),
                         torch.triu(old.view(bits), 1))
        ok, worst = ok and good and kept, max(worst, err)
    return ok, worst


def _replay_quad(a, kw):
    from modulatedgps_tpu_torch.ops import quad_kernel
    S, A = a
    got = quad_kernel.qsqrt_sq_colsum(S, A)
    want = quad_kernel.qsqrt_sq_colsum_plain(S.to(torch.bfloat16), A)
    return _close(got, want.to(got.dtype), 1e-4)


# Each wrapper's replay: (ok, max |kernel - plain|) on the recorded inputs,
# at phase 2's tolerance for that kernel.
REPLAYS = {
    "kxz": _replay_kxz, "kxz_vjp": _replay_kxz_vjp,
    "cholesky_factor": _replay_cholesky,
    "trsm_lower": _replay_trsm(False), "trsm_lower_t": _replay_trsm(True),
    "tril_sq_fwd": _replay_tril("tril_sq_fwd", 2e-2),
    "tril_fwd_f32": _replay_tril("tril_fwd_f32", 1e-4),
    "tril_sq_fwd_split": _replay_split,
    "tril_dl": _replay_tril("tril_dl", 1e-3, lower_zero=True),
    "tril_da": _replay_tril("tril_da", 1e-3),
    "tril_sq_dl": _replay_tril("tril_sq_dl", 1e-3, lower_zero=True),
    "tril_sq_da": _replay_tril("tril_sq_da", 1e-3),
    "tri_tt_matmul": _replay_trimm("tri_tt_matmul"),
    "tri_nt_matmul": _replay_trimm("tri_nt_matmul"),
    "kl_sq_logdiag": _replay_kl_fwd, "kl_bwd_scale": _replay_kl_bwd,
    "adam_tril_": _replay_adam, "qsqrt_sq_colsum": _replay_quad,
}


def replay_demo_calls(calls, expected, where="the demos' shapes"):
    """Every recorded call replayed, kernel against plain; one check a
    wrapper over all its shapes, and one that every wrapper in
    ``expected`` was recorded.  ``where`` names the calls' source."""
    by_name = {}
    for (name, sig, _), (args, kwargs) in calls.items():
        by_name.setdefault(name, []).append((sig, args, kwargs))
    for name in sorted(by_name):
        bad, worst = [], 0.0
        for sig, args, kwargs in by_name[name]:
            try:
                ok, err = REPLAYS[name](args, kwargs)
            except Exception as exc:   # recorded as a failure
                ok, err = False, float("nan")
                log(f"    {name} {sig} raised {exc!r}")
            worst = max(worst, err) if math.isfinite(err) else worst
            if not ok:
                bad.append(sig)
        shapes = sorted({tuple(s[0] for s in sig
                               if isinstance(s, tuple) and s
                               and isinstance(s[0], tuple))
                         for sig, _, _ in by_name[name]})
        check(not bad, f"{name} at {where}: {len(by_name[name])} "
              f"recorded calls against the plain version, largest "
              f"max_abs_err {worst:.3e}; shapes {shapes[:6]}"
              + (" ..." if len(shapes) > 6 else "")
              + (f"; failed at {bad}" if bad else ""))
    missing = sorted(set(expected) - set(by_name))
    check(not missing, f"every wrapper expected at {where} was recorded "
          f"and replayed (none of {missing})")


# Phase 19: the demo CLIs at the reference demos' own configurations (M=25,
# N=100-1500, batch 500, K=2-4, D=1-2).  The kernels each must launch:
# every SMGP / SMGPModified demo trains (Adam) and serves through
# precompute_smgp (the fused q_sqrt quadratic #17), except the flagship,
# which predicts from the trained model (the 3-pass split, as the reference
# flagship predicts from its model); an SMGP takes the split on both
# layers, an SMGPModified on its assignment layer and the one pass (#3,
# #8/#9) on its prediction layer.
DEMO_COMMON = ("kxz", "kxz_vjp", "cholesky_factor", "trsm_lower",
               "tri_tt_matmul", "tri_nt_matmul")
DEMO_TRIL = ("kl_sq_logdiag", "kl_bwd_scale", "adam_tril_")
DEMO_SPLIT = ("tril_sq_fwd_split", "tril_dl", "tril_da")
DEMO_ONE_PASS = ("tril_sq_fwd", "tril_sq_dl", "tril_sq_da")
SMGP_DEMO = DEMO_COMMON + DEMO_TRIL + DEMO_SPLIT + ("qsqrt_sq_colsum",)
MODIFIED_DEMO = SMGP_DEMO + DEMO_ONE_PASS
DEMO_KERNELS = {
    "demo_multimodal_1d": DEMO_COMMON + DEMO_TRIL + DEMO_SPLIT,
    "demo_multimodal_1d_modified": MODIFIED_DEMO,
    "demo_multiclass_1d": MODIFIED_DEMO,
    "demo_2d": SMGP_DEMO,
    "demo_multiclass_2d": MODIFIED_DEMO,
    "demo_john_doe": SMGP_DEMO,
    "demo_john_doe_multiclass": MODIFIED_DEMO,
    "demo_svgp": DEMO_COMMON + DEMO_TRIL + DEMO_ONE_PASS,
    "demo_multiclass_svgp": DEMO_COMMON,      # q_diag: no tril leaf; L-BFGS
}
DEMO_ITERS, DEMO_PREDICT_SAMPLES = 50, 10
FLAGSHIP = "demo_multimodal_1d"
# The figure builders each demo writes with --out.
DEMO_FIGURES = {"demo_multimodal_1d": ("demo_multimodal_1d.png",),
                "demo_2d": ("demo_2d_1.png", "demo_2d_2.png")}
STEP_REGIME_STEPS, STEP_REGIME_PROFILED = 20, 5


def quietly(fn, *args, **kwargs):
    """(fn's result, the last line fn printed): a demo's summaries and ELBO
    table stay off this script's output."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kwargs)
    lines = buf.getvalue().strip().splitlines()
    return result, lines[-1] if lines else ""


def demo_elbos(out):
    """The ELBOs a demo's main returns: the history, or the final one."""
    if isinstance(out, tuple):
        return out[2]
    return out["elbos"] if "elbos" in out else [out["elbo"]]


def phase_demos(pt, dev="cuda", iters=DEMO_ITERS, flagship_iters=None):
    """Phase 19: (a) every demo CLI through its main(argv) for ``iters``
    steps, (b) the flagship at full length held to the golden robustness
    tier, (c) the flagship model's step regime at M=25."""
    import importlib
    import importlib.util

    from modulatedgps_tpu_torch.demos import golden
    on_card = torch.device(dev).type == "cuda"
    platform = "gpu" if on_card else "cpu"
    t_phase = time.perf_counter()
    log(f"== phase 19: the demo CLIs on {dev} ({iters} iterations, "
        f"--predict-samples {DEMO_PREDICT_SAMPLES}), the flagship's golden "
        f"run and its step regime")
    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures:
        log("  matplotlib is not installed here: the figure branches run "
            "with --no-plot (tests/test_torch_demos.py writes their PNGs)")
    with (tempfile.TemporaryDirectory() as out,
          recording_wrapper_calls() as calls):
        for name, kernels in DEMO_KERNELS.items():
            demo = importlib.import_module(f"modulatedgps_tpu_torch.demos.{name}")
            argv = ["--platform", platform, "--iters", str(iters),
                    "--predict-samples", str(DEMO_PREDICT_SAMPLES)]
            plot = figures and name in DEMO_FIGURES
            argv += ["--out", out] if plot else ["--no-plot"]
            pt.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                out_, last = quietly(demo.main, argv)
            except Exception as exc:   # recorded as a failure; next demo
                traceback.print_exc()
                check(False, f"{name} raised {exc!r}")
                continue
            elbos = demo_elbos(out_)
            seconds = time.perf_counter() - t0
            counts = {k: n for k, n in pt.launch_counts().items() if n}
            log(f"{name}: {seconds:.2f} s ({last!r}), launches {counts}")
            check(len(elbos) > 0 and all(math.isfinite(e) for e in elbos),
                  f"{name}: {len(elbos)} ELBOs, all finite (last "
                  f"{elbos[-1] if elbos else None})")
            if on_card:
                missing = [k for k in kernels if not counts.get(k)]
                check(not missing, f"{name}: every kernel it should launch "
                      f"was launched (none of {missing})")
            for fig in DEMO_FIGURES.get(name, ()) if plot else ():
                check(os.path.exists(os.path.join(out, fig)),
                      f"{name}: figure {fig} written")
    if on_card:
        replay_demo_calls(calls, set().union(*DEMO_KERNELS.values()))
    flagship_step_reference(pt, dev)

    # (b) the flagship at its reference length, S=25, batch 500, lr 5e-3,
    # seed 0, held to the robustness tier (its noise is Philox in float32,
    # not the draw the reference figure pins); the figure tier beside it.
    target = golden.FAMILIES[FLAGSHIP]
    frac = 1.0 if flagship_iters is None else flagship_iters / 2000
    with tempfile.TemporaryDirectory() as out:
        metrics = os.path.join(out, "metrics.jsonl")
        pt.reset_launch_counts()
        t0 = time.perf_counter()
        row, _ = quietly(golden.run_family, FLAGSHIP, seed=0,
                         iters_frac=frac, platform=platform,
                         argv=["--metrics", metrics])
        seconds = time.perf_counter() - t0
        with open(metrics) as f:
            fit_s = [json.loads(line) for line in f][-1]["t"]
    fam = golden.aggregate([row], target)
    robust_ok = row["elbo"] >= target - fam["elbo_tol_robust"]
    figure_checks = golden.evaluate_checks(FLAGSHIP, row, "figure")
    figure_elbo = row["elbo"] >= target - fam["elbo_tol_figure"]
    log(f"{FLAGSHIP} {row['iters']} iterations on {dev}: fit {fit_s:.2f} s "
        f"(MetricsLogger clock), {seconds:.2f} s with data, k-means and "
        f"predictions; row {json.dumps(row)}")
    log(f"  figure tier (printed, not checked): {figure_checks}, ELBO "
        f"{row['elbo']} >= {target} - {fam['elbo_tol_figure']}: {figure_elbo}")
    check(row["pass"] and robust_ok,
          f"{FLAGSHIP}: the robustness tier: {row['checks']} (purity >= "
          f"0.45, max branch RMSE <= 0.2), smoothed final ELBO "
          f"{row['elbo']} >= {target} - {fam['elbo_tol_robust']}")
    regime = step_regime(pt, dev)
    regime["fit_s"] = fit_s
    log(f"phase 19 wall time: {time.perf_counter() - t_phase:.1f} s")
    return regime


FLAGSHIP_REF_STEPS, FLAGSHIP_GRAD_FACTOR = 100, 4


def flagship_step_reference(pt, dev, steps=FLAGSHIP_REF_STEPS):
    """(a) ends with one evaluation of the flagship's model (M=25, K=3,
    S=25, batch 500, tau 1e-2) on ``dev`` in f32 against the CPU in f64,
    the f32 CPU path beside: the state after ``steps`` of the flagship's
    own f64 Adam run on the CPU, one batch and one noise draw, both layers
    at the f32 jitter.  The loss (the negative ELBO) and every raw leaf's
    gradient within FLAGSHIP_GRAD_FACTOR x the f32 CPU path's max|err| /
    max|f64| (+ 1e-6): at this size and temperature the f32 path's own
    distance runs from 1e-4 (the likelihood) to 3e-2 (the assignment
    lengthscale), so a fixed bound would say nothing of the card."""
    from modulatedgps_tpu_torch.config import default_jitter
    from modulatedgps_tpu_torch.data import minibatch_iterator
    from modulatedgps_tpu_torch.demos import demo_multimodal_1d as flagship
    from modulatedgps_tpu_torch.demos._common import demo_argparser
    from modulatedgps_tpu_torch.demos._runner import build, train
    args = demo_argparser(dict(iters=steps, K=3)).parse_args([])
    ref, (_, Xtr, Ytr, _) = build(flagship.CONFIG, args, "cpu", torch.float64)
    quietly(train, ref, args, Xtr, Ytr, "cpu", torch.float64)
    state = ref.state_dict()
    X, Y = next(iter(minibatch_iterator(Xtr, Ytr, args.batch, seed=1)))
    rng = np.random.default_rng(0)
    z = rng.normal(size=(args.num_samples, args.batch, args.K))
    g = rng.gumbel(size=(args.num_samples, args.batch, args.K))
    runs = {}
    for key, (d, t) in {dev: (dev, torch.float32),
                        "cpu f32": ("cpu", torch.float32),
                        "f64": ("cpu", torch.float64)}.items():
        model, _ = build(flagship.CONFIG, args, d, t)
        model.load_state_dict(state)
        for layer in (model.pred_layer, model.assign_layer):
            layer.jitter = default_jitter(torch.float32)
        to = lambda a: torch.as_tensor(a, dtype=t, device=d)
        runs[key] = path_c_grads(pt, model, to(X), to(Y), to(z), to(g))
    log(f"  {FLAGSHIP}'s model after {steps} f64 Adam steps: one "
        f"evaluation, {dev} f32 vs CPU f64 (f32 CPU beside)")
    want = runs["f64"]
    for name in want:
        rel, cpu_rel = (float((runs[k][name] - want[name]).abs().max()
                              / want[name].abs().max()) for k in (dev, "cpu f32"))
        tol = FLAGSHIP_GRAD_FACTOR * cpu_rel + 1e-6
        check(rel <= tol and finite(runs[dev][name]),
              f"{FLAGSHIP} {name}: max|err| / max|f64| {rel:.3e} (f32 CPU "
              f"{cpu_rel:.3e}; <= {FLAGSHIP_GRAD_FACTOR}x + 1e-6)")


def step_regime(pt, dev, steps=STEP_REGIME_STEPS,
                profiled=STEP_REGIME_PROFILED):
    """(c) The flagship's model (M=25, K=3, S=25, batch 500): ms an Adam
    step (median of ``steps`` after warm-up), kernel ms a step (kernel-level
    events of ``profiled`` steps), the busy share, launches a step by
    family and by wrapper, and one served predict_y batch of 500 points."""
    on_card = torch.device(dev).type == "cuda"
    dtype = torch.float32 if on_card else torch.float64
    model, args, run, Xtr = flagship_trainer(pt, dev)
    run(5)
    sync(dev)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        run()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    pt.reset_launch_counts()
    run(profiled)
    sync(dev)
    per_step = {k: n / profiled for k, n in pt.launch_counts().items() if n}
    out = {"step_ms": step_ms, "step_ms_range": [min(times), max(times)],
           "wrapper_launches_per_step": per_step}
    Xq = torch.tensor(Xtr[:500], dtype=dtype, device=dev)
    with torch.no_grad():
        serving = pt.precompute_smgp(model)
        for _ in range(3):
            serving.predict_y(Xq)
        sync(dev)
        served = []
        for _ in range(steps):
            t0 = time.perf_counter()
            serving.predict_y(Xq)
            sync(dev)
            served.append((time.perf_counter() - t0) * 1e3)
    out["predict_y_ms"] = statistics.median(served)
    log(f"step regime M={model.pred_layer.num_inducing} K=3 S="
        f"{args.num_samples} batch {args.batch}: {step_ms:.3f} ms an Adam "
        f"step (median of {steps}; {min(times):.3f}-{max(times):.3f}, host "
        f"clock to synchronize); served predict_y on 500 points "
        f"{out['predict_y_ms']:.3f} ms (median of {steps}); wrapper launches "
        f"a step {per_step}")
    if on_card:
        _, rows = profile_kernels(lambda: run(profiled),
                                  f"{profiled} Adam steps at M=25")
        kernel_ms = sum(r[0] for r in rows) / profiled
        launches = sum(r[1] for r in rows) / profiled
        fams = {f: [round(ms / profiled, 4), c / profiled]
                for f, (ms, c) in by_family(rows).items()}
        out.update(kernel_ms=kernel_ms, busy_share=kernel_ms / step_ms,
                   launches_per_step=launches, families_per_step=fams)
        log(f"  kernel time {kernel_ms:.3f} ms a step (kernel-level events "
            f"of {profiled} steps), busy share {kernel_ms / step_ms:.1%} of "
            f"the {step_ms:.3f} ms step; {launches:.1f} kernel launches a "
            f"step; by family (ms, launches a step): {fams}")
        check(kernel_ms > 0 and 0 < kernel_ms / step_ms <= 1.0,
              f"the step regime's busy share is a share "
              f"({kernel_ms / step_ms:.3f})")
    return out


PROFILE_TRIALS = 40


def flagship_trainer(pt, dev):
    """(model, args, run, Xtrain): the flagship's model (M=25, K=3, S=25,
    batch 500), ``run(n)``, n Adam steps over three of its batches in turn,
    and its training inputs."""
    import itertools

    from modulatedgps_tpu_torch.data import minibatch_iterator
    from modulatedgps_tpu_torch.demos import demo_multimodal_1d as flagship
    from modulatedgps_tpu_torch.demos._common import demo_argparser
    from modulatedgps_tpu_torch.demos._runner import build
    dtype = torch.float32 if torch.device(dev).type == "cuda" else torch.float64
    args = demo_argparser(dict(iters=2000, K=3)).parse_args([])
    model, (_, Xtr, Ytr, _) = build(flagship.CONFIG, args, dev, dtype)
    step = pt.make_train_step(pt.Adam(model, args.lr))
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [(torch.tensor(x, dtype=dtype, device=dev),
                torch.tensor(y, dtype=dtype, device=dev))
               for x, y in itertools.islice(
                   minibatch_iterator(Xtr, Ytr, args.batch), 3)]
    turn = itertools.count()

    def run(n=1):
        for _ in range(n):
            step(model, gen, *batches[next(turn) % 3])
    return model, args, run, Xtr


def phase_profile_misses(pt, trials=PROFILE_TRIALS):
    """--profile-misses: how often torch.profiler loses kernels of two
    regions, a flagship Adam step (M=25, about 500 launches) and one VGP
    evaluation's loss and gradient (N=4096, phase 17's), under five
    set-ups, ``trials`` profiles each in turns: a bare profile() around the
    region; a schedule with an empty warm-up step; the bare profile with
    the region 50 ms after it starts; a bare profile right after another
    profiler session has run and the card has synchronized; and
    utils.profiling.kernel_times (stand-ins, then 50 ms; its recorded
    stand-ins are counted too).  A trial's kernels are counted by name
    (kernel-level events only); the reference is the most of each name any
    trial of the region saw.  Prints each set-up's lost trials and the
    kernels lost; checks nothing into the exit code."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import profile, schedule

    from modulatedgps_tpu_torch.utils.profiling import (STAND_IN_KERNEL,
                                                        kernel_times)
    _, _, step, _ = flagship_trainer(pt, "cuda")
    X, Y, _ = vgp_data(VGP_N)
    vgp = build_vgp(pt, X, Y, "cuda", torch.float32)
    params = [p for p in vgp.parameters() if p.requires_grad]
    regions = {"flagship step": step,
               "VGP evaluation": lambda: torch.autograd.grad(
                   vgp.training_loss(), params)}
    for region in regions.values():
        for _ in range(3):
            region()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def counted(events, key=None):
        return collections.Counter({
            ev.key: ev.count for ev in events
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0
            and (STAND_IN_KERNEL in ev.key if key else
                 STAND_IN_KERNEL not in ev.key)
            and not ev.key.startswith("ProfilerStep")})

    def bare(run, pause=0.0, after_session=False):
        if after_session:
            with profile(activities=acts):
                torch.ones(8, device="cuda").sum()
                torch.cuda.synchronize()
            torch.cuda.synchronize()
        with profile(activities=acts) as p:
            if pause:
                time.sleep(pause)
            run()
            torch.cuda.synchronize()
        return counted(p.key_averages()), None

    def warmed(run):
        kept = {}
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1,
                                                        active=1),
                     on_trace_ready=lambda p: kept.update(
                         ev=p.key_averages())) as p:
            p.step()
            run()
            torch.cuda.synchronize()
            p.step()
        return counted(kept["ev"]), None

    def helper(run):
        rows, by_shape = kernel_times(run)
        stand_ins = sum(counted(by_shape, STAND_IN_KERNEL).values())
        return collections.Counter({k: c for _, c, k in rows}), stand_ins

    setups = {"bare": bare,
              "schedule warm-up": warmed,
              "bare, 50 ms in": lambda run: bare(run, pause=0.05),
              "bare, after another session":
                  lambda run: bare(run, after_session=True),
              "kernel_times": helper}
    result = {}
    for region, run in regions.items():
        seen = {name: [] for name in setups}
        for _ in range(trials):
            for name, trial in setups.items():
                seen[name].append(trial(run))
        ref = collections.Counter()
        for trials_seen in seen.values():
            for c, _ in trials_seen:
                ref |= c
        total = sum(ref.values())
        log(f"--profile-misses, {region}: {trials} profiles under each "
            f"set-up; the reference holds {total} kernel launches of "
            f"{len(ref)} kernels")
        result[region] = {"reference_launches": total}
        for name, trials_seen in seen.items():
            lost = [ref - c for c, _ in trials_seen]
            n_lost = [sum(l.values()) for l in lost]
            names = collections.Counter()
            for l in lost:
                names.update(l)
            row = {"trials": trials,
                   "trials_with_loss": sum(n > 0 for n in n_lost),
                   "launches_lost": n_lost,
                   "kernels_lost": {k[:60]: v for k, v in names.items()}}
            if name == "kernel_times":
                row["stand_ins_recorded"] = [s for _, s in trials_seen]
            result[region][name] = row
            log(f"  {name}: {row['trials_with_loss']} of {trials} profiles "
                f"lost launches ({n_lost}); lost, by kernel: "
                f"{row['kernels_lost']}"
                + (f"; stand-ins recorded {row['stand_ins_recorded']}"
                   if name == "kernel_times" else ""))
    print(json.dumps({"harness": "chip_smoke.py --profile-misses",
                      "regions": result}), flush=True)
    return result


def phase_golden(pt, dev="cuda", families=None, seeds=(0,)):
    """--golden: every reference family at its full iteration count on
    ``dev`` at each of ``seeds``, each row with both tiers' checks, and the
    family's ELBO aggregate over the seeds with the figure and robustness
    tiers' ELBO checks, in GOLDEN_r04.json's layout; checks nothing."""
    from modulatedgps_tpu_torch.demos import golden
    platform = "gpu" if torch.device(dev).type == "cuda" else "cpu"
    results = {}
    for name in families or golden.FAMILIES:
        target = golden.FAMILIES[name]
        rows = []
        for seed in seeds:
            t0 = time.perf_counter()
            row, _ = quietly(golden.run_family, name, seed=seed,
                             platform=platform)
            row["seconds"] = round(time.perf_counter() - t0, 2)
            row["checks_figure"] = golden.evaluate_checks(name, row, "figure")
            rows.append(row)
            log(f"--golden {name} seed {seed}: {json.dumps(row)}")
        fam = golden.aggregate(rows, target)
        fam["elbo_robust_tier"] = [bool(r["elbo"] >= target
                                        - fam["elbo_tol_robust"])
                                   for r in rows]
        fam["elbo_figure_tier"] = [bool(r["elbo"] >= target
                                        - fam["elbo_tol_figure"])
                                   for r in rows]
        fam["seeds"] = {str(r["seed"]): r for r in rows}
        fam["iters"] = rows[0]["iters"]
        results[name] = fam
        log(f"--golden {name}: {json.dumps(fam)}")
    kind = (torch.cuda.get_device_name(0) if platform == "gpu" else "cpu")
    print(json.dumps({"harness": "chip_smoke.py --golden",
                      "regime": f"{kind}, full reference iteration counts, "
                                f"seeds {list(seeds)}",
                      "families": results}), flush=True)
    return results


# ---------------------------------------------------------------- phase 20

PARALLEL_STEPS = 3
INDUCING_TRAIN_KERNELS = ("kxz", "kxz_vjp", "trsm_lower", "trsm_lower_t",
                          "tri_tt_matmul", "tri_nt_matmul", "cholesky_factor",
                          "adam_tril_")
# (b)'s sharded ELBO against the single-device f32 ELBO of the same state
# and noise at M=4096: the two differ in the q_sqrt term (the fp32 ring
# against the 3-pass bf16 split) and in the Cholesky's blocking.  (c) holds
# the sharded f32 loss within GRAD_TOL["loss"] of f64 at M_REF, phase 6 the
# single-device one, so the two lie within twice that of each other.
INDUCING_ELBO_TOL = 2 * GRAD_TOL["loss"]
# (c)'s assignment leaves at tau = 1e-2: Z, q_mu and q_sqrt at phase 6's
# GRAD_TOL_COLD.  The kernel variance and lengthscale sum over every
# near-tie that f32 flips, and which ties flip follows the arithmetic: the
# sharded program (panels of 128, the full-M solve, the fp32 ring) flips
# others than the single-device one, on the CPU as on the card.  So these
# two are held to INDUCING_COLD_FACTOR x the distance of the same sharded
# program run in f32 on the CPU on the same seed (+ 1e-6), as phase 19
# holds the flagship to its f32 CPU path.  `chip_smoke.py --cold-grads`
# prints both over five seeds with their ratio: on an NVIDIA H100 80GB HBM3
# (700 W) the card's reads 0.55x to 3.88x the CPU's on the variance and
# 0.63x to 3.98x on the lengthscale (seed 0 the largest on both).
INDUCING_COLD_FACTOR = 5
INDUCING_COLD_SCALARS = ("assign_layer.kernel.variance.raw",
                         "assign_layer.kernel.lengthscales.raw")
# Kernel names of library solvers that the inducing path must not run.
LIBRARY_SOLVERS = ("potrf", "getrf", "trsm", "cusolver")
PARALLEL_FAMILIES = (("nccl", "NCCL collectives"),) + FAMILIES


def upper_nonzero_global(block, index):
    """Entries of a [K, M, M / P] column block (rank ``index``'s columns)
    above the global diagonal that are not exactly 0."""
    _, M, width = block.shape
    cols = index * width + torch.arange(width, device=block.device)
    upper = torch.arange(M, device=block.device)[:, None] < cols[None, :]
    return int((block[:, upper] != 0).sum())


def timed(dev, fn):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def median_after_first(times):
    return statistics.median(times[1:]) if len(times) > 1 else times[0]


def phase_parallel(pt, dev="cuda", M=M_FULL, batch=BATCH,
                   steps=PARALLEL_STEPS, cpu_runs=None, M_ref=M_REF,
                   batch_ref=BATCH_REF):
    """Phase 20: modulatedgps_tpu_torch.parallel on a process group of one
    rank (NCCL on the card, gloo on the CPU), over a file:// store in a
    temporary directory, destroyed at the end.  (a) the replicated
    data-parallel step against the single-device step; (b) the
    inducing-sharded ELBO, its gradient and its steps; (c) the
    inducing-sharded loss, gradients and predict_f at M_ref against the
    f64 CPU path; (d) the step times, peak memory and a kernel breakdown,
    printed with (a) and (b)."""
    from modulatedgps_tpu_torch import parallel as par
    t_phase = time.perf_counter()
    log(f"== phase 20: the parallel paths on one rank ({dev}), M={M} "
        f"K={K_EXPERTS} D={D_IN} S={NUM_SAMPLES} batch={batch} f32")
    inputs = grad_inputs(M_ref, batch_ref)
    with one_rank_group(par, "cpu") as mesh:
        cpu_sharded = {tau: sharded_loss_and_grads(pt, par, mesh, *inputs,
                                                   "cpu", tau)
                       for tau in GRAD_TEMPERATURES}
    with one_rank_group(par, dev) as mesh:
        out = {"replicated": parallel_replicated(pt, par, mesh, dev, M, batch,
                                                 steps)}
        out["inducing"] = parallel_inducing(pt, par, mesh, dev, M, batch,
                                            steps, out["replicated"])
        parallel_inducing_reference(pt, par, mesh, dev, inputs, cpu_runs,
                                    cpu_sharded)
        log("  the expert-sharded step is checked on the CPU only "
            "(tests/test_torch_parallel.py, gloo ranks on a 2 x 2 mesh): one "
            "card gives an expert axis of 1, which replicates")
    log(f"phase 20 wall time: {time.perf_counter() - t_phase:.1f} s")
    return out


@contextlib.contextmanager
def one_rank_group(par, dev):
    """A process group of this one process (NCCL on the card, gloo on the
    CPU) over a file:// store in a temporary directory, and its ("data",
    "expert") mesh; the group is destroyed on the way out."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        par.initialize_multihost(f"file://{tmp}/store", num_processes=1,
                                 process_id=0, device=dev)
        try:
            mesh = par.make_mesh(device=dev)
            log(f"process group: backend {dist.get_backend()}, world size "
                f"{dist.get_world_size()}, mesh {mesh}")
            yield mesh
        finally:
            dist.destroy_process_group()
    check(not dist.is_initialized(), "the one-rank process group destroyed")


def parallel_batch(pt, dev, M, batch):
    arrays, rng = smgp_arrays(M)
    X = torch.as_tensor(rng.uniform(-3, 3, size=(batch, D_IN)),
                        dtype=torch.float32, device=dev)
    Y = torch.as_tensor(rng.normal(size=(batch, 1)), dtype=torch.float32,
                        device=dev)
    return arrays, X, Y


def parallel_replicated(pt, par, mesh, dev, M, batch, steps):
    """(a) make_parallel_train_step (replicated) against make_train_step:
    the same state and generator seed, in turns; the loss and every leaf
    bit-equal, or within GRAD_TOL of each other's scale."""
    on_card = torch.device(dev).type == "cuda"
    arrays, X, Y = parallel_batch(pt, dev, M, batch)
    single = build_model(pt, arrays, dev, torch.float32)
    model = par.replicate_state(mesh, build_model(pt, arrays, dev,
                                                  torch.float32))
    step_single = pt.make_train_step(pt.Adam(single, LR))
    step = par.make_parallel_train_step(pt.Adam(model, LR), mesh, K=K_EXPERTS)
    Xl, Yl = par.shard_batch(mesh, X, Y)
    gens = [torch.Generator(device=dev).manual_seed(0) for _ in range(2)]
    counts = dict.fromkeys(TRAIN_KERNELS, 0)
    losses, times = ([], []), ([], [])
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        loss, ms = timed(dev, lambda: step_single(single, gens[0], X, Y))
        losses[0].append(float(loss))
        times[0].append(ms)
        pt.reset_launch_counts()
        loss, ms = timed(dev, lambda: step(model, gens[1], Xl, Yl))
        for name, n in pt.launch_counts().items():
            if name in counts:
                counts[name] += n
        losses[1].append(float(loss))
        times[1].append(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    log(f"(a) replicated make_parallel_train_step, {steps} steps: losses "
        f"{losses[1]} (single device {losses[0]}); launches {counts}")
    if on_card:
        missing = [k for k, n in counts.items() if not n]
        check(not missing, f"(a) every train-path kernel launched on the "
              f"parallel step (none of {missing})")
    leaves = dict(single.named_parameters())
    with torch.no_grad():
        same = losses[0] == losses[1] and all(
            torch.equal(p, leaves[n]) for n, p in model.named_parameters())
        rel = {n: float((p - leaves[n]).abs().max() / leaves[n].abs().max())
               for n, p in model.named_parameters()}
    rel["loss"] = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    log(f"(a) bit-equal to the single-device steps (loss and every leaf): "
        f"{same}; largest max|diff| / max|leaf| {max(rel.values()):.3e}")
    check(all(rel[n] <= GRAD_TOL[n] for n in GRAD_TOL),
          f"(a) loss and every leaf within GRAD_TOL of the single-device "
          f"steps' ({ {n: f'{v:.2e}' for n, v in rel.items() if v} })")
    out = {"bit_equal": same, "step_ms": median_after_first(times[1]),
           "single_step_ms": median_after_first(times[0]),
           "step_ms_all": times[1], "single_step_ms_all": times[0],
           "peak_gib": peak}
    log(f"(d) step ms (host clock to synchronize, in turns, median of steps "
        f"2-{steps}): single device {out['single_step_ms']:.3f} "
        f"{[round(t, 3) for t in times[0]]}, replicated parallel "
        f"{out['step_ms']:.3f} {[round(t, 3) for t in times[1]]}; peak "
        f"device memory of both models {peak:.2f} GiB")
    return out


def parallel_inducing(pt, par, mesh, dev, M, batch, steps, replicated):
    """(b) inducing_sharded_elbo against the single-device ELBO, its
    gradient, then make_inducing_sharded_train_step's steps with every
    kernel of the path launched, q_sqrt and its moments exactly 0 above
    the global diagonal, a profile with no library solver."""
    from modulatedgps_tpu_torch.parallel.collectives import share
    from modulatedgps_tpu_torch.parallel.mesh import axis_group
    on_card = torch.device(dev).type == "cuda"
    arrays, X, Y = parallel_batch(pt, dev, M, batch)
    group, index, _ = axis_group(mesh, "data")
    model = build_model(pt, arrays, dev, torch.float32)
    Xl, Yl = par.shard_batch(mesh, X, Y)
    with torch.no_grad():
        single = float(model.elbo(torch.Generator(device=dev).manual_seed(1),
                                  X, Y))
    sharded = par.inducing_shard_state(mesh, model)
    del model
    elbo, ms = timed(dev, lambda: par.inducing_sharded_elbo(
        sharded, torch.Generator(device=dev).manual_seed(1), Xl, Yl, mesh))
    value = float(elbo.detach())
    rel = abs(value - single) / abs(single)
    check(rel <= INDUCING_ELBO_TOL,
          f"(b) inducing-sharded ELBO {value:.8f} against the "
          f"single-device f32 ELBO {single:.8f}: relative {rel:.3e} "
          f"(<= {INDUCING_ELBO_TOL:g}; forward {ms:.1f} ms)")
    _, ms = timed(dev, lambda: share(-elbo, group).backward())
    grads = {n: p.grad for n, p in sharded.named_parameters()}
    check(all(finite(g) for g in grads.values())
          and all(upper_nonzero_global(grads[f"{layer}.q_sqrt.raw"], index)
                  == 0 for layer in ("pred_layer", "assign_layer")),
          f"(b) every gradient finite, q_sqrt's exactly 0 above the global "
          f"diagonal (backward {ms:.1f} ms)")

    opt = pt.Adam(sharded, LR)
    step = par.make_parallel_train_step(opt, mesh, K=K_EXPERTS,
                                        shard_inducing=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    # One step with every wrapper call recorded, each replayed against its
    # plain version at the shapes this path gives it; then the counted
    # steps, with the recorded copies freed.
    with recording_wrapper_calls() as calls:
        first, _ = timed(dev, lambda: step(sharded, gen, Xl, Yl))
    check(math.isfinite(float(first)), f"(b) the recorded inducing-sharded "
          f"step's loss finite: {float(first)}")
    if on_card:
        replay_demo_calls(calls, set(INDUCING_TRAIN_KERNELS),
                          "(b) the inducing-sharded step's shapes")
    del calls
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    pt.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        loss, ms = timed(dev, lambda: step(sharded, gen, Xl, Yl))
        losses.append(float(loss))
        times.append(ms)
    counts = {k: n for k, n in pt.launch_counts().items() if n}
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    check(all(math.isfinite(x) for x in losses),
          f"(b) {steps} inducing-sharded steps after the recorded one, losses "
          f"finite: {losses}")
    log(f"(b) launches in the inducing-sharded steps: {counts}")
    if on_card:
        missing = [k for k in INDUCING_TRAIN_KERNELS if not counts.get(k)]
        check(not missing, f"(b) #1, its pullback, #2, #4, #10/#11, #15 "
              f"and #14 launched on the inducing-sharded path (none of "
              f"{missing})")
    nz = {f"{n} {w}": upper_nonzero_global(t, index)
          for n, p, m, v in zip(opt.names, opt.params, opt.m, opt.v)
          if n.endswith("q_sqrt.raw") for w, t in (("p", p), ("m", m),
                                                   ("v", v))}
    check(set(nz.values()) == {0}, f"(b) q_sqrt and its Adam moments "
          f"exactly 0 above the global diagonal: {nz}")
    step_ms = median_after_first(times)
    log(f"(d) inducing-sharded step ms (median of steps 2-{steps}) "
        f"{step_ms:.3f} {[round(t, 3) for t in times]} against the "
        f"single-device step's {replicated['single_step_ms']:.3f} in (a) "
        f"({step_ms / replicated['single_step_ms']:.2f}x); peak device "
        f"memory {peak:.2f} GiB")
    out = {"step_ms": step_ms, "step_ms_all": times, "peak_gib": peak,
           "launches": counts}
    if on_card:
        _, rows = profile_kernels(lambda: step(sharded, gen, Xl, Yl),
                                  "inducing-sharded step", PARALLEL_FAMILIES)
        solvers = [k for _, _, k in rows
                   if any(s in k.lower() for s in LIBRARY_SOLVERS)]
        check(not solvers, f"(b) no cuSOLVER or library triangular solve "
              f"in the profiled inducing-sharded step ({solvers[:3]})")
        out["kernel_ms"] = sum(r[0] for r in rows)
    return out


def sharded_loss_and_grads(pt, par, mesh, arrays, X, Y, z, g, dev, tau):
    """The inducing-sharded loss and every raw leaf's gradient (summed over
    the axis), the model's layers replicated and sliced by the path."""
    import torch.distributed as dist

    from modulatedgps_tpu_torch.parallel.collectives import share
    from modulatedgps_tpu_torch.parallel.mesh import axis_group
    group = axis_group(mesh, "data")[0]
    model = build_model(pt, arrays, dev, torch.float32, jitter=JITTER,
                        temperature=tau)
    to = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    Xl, Yl = par.shard_batch(mesh, to(X), to(Y))
    loss = -par.inducing_sharded_elbo_from_noise(model, Xl, Yl, to(z), to(g),
                                                 mesh)
    share(loss, group).backward()
    out = {}
    for name, p in model.named_parameters():
        dist.all_reduce(p.grad, group=group)
        out[name] = p.grad.double().cpu()
    out["loss"] = loss.detach().double().cpu()
    return out


def parallel_inducing_reference(pt, par, mesh, dev, inputs, cpu_runs,
                                cpu_sharded):
    """(c) the card's f32 inducing-sharded loss, gradients (temperatures
    1e-2 and 1) and predict_f on ``inputs`` (grad_inputs at M_REF) against
    the port's f64 single-device CPU path (phase 6's runs when given: the
    same state, batch and noise), with the f32 CPU path and the same
    sharded program in f32 on the CPU (``cpu_sharded``) beside; the
    assignment kernel's two scalars at tau 1e-2 within INDUCING_COLD_FACTOR
    x the latter's distance."""
    arrays, X, Y, z, g = inputs
    M, batch = arrays["pred_layer.Z.raw"].shape[0], X.shape[0]
    log(f"(c) inducing-sharded {dev} f32 vs CPU f64 (the f32 CPU path and "
        f"the f32 CPU sharded path beside), M={M} batch={batch}")
    beside = (("cpu f32", "f32 CPU"), ("cpu f32 sharded", "f32 CPU sharded"))
    for tau in GRAD_TEMPERATURES:
        runs = dict(cpu_runs[tau]) if cpu_runs else {
            label: loss_and_grads(pt, arrays, X, Y, z, g, "cpu", t, tau)
            for label, t in (("cpu f32", torch.float32),
                             ("f64", torch.float64))}
        runs["cpu f32 sharded"] = cpu_sharded[tau]
        runs[dev] = sharded_loss_and_grads(pt, par, mesh, arrays, X, Y, z, g,
                                           dev, tau)
        log(f"  temperature {tau:g}: loss {float(runs[dev]['loss']):.8f} "
            f"(f64 {float(runs['f64']['loss']):.8f})")
        cold = dict(GRAD_TOL_COLD, **{
            name: INDUCING_COLD_FACTOR * rel_dist(runs, "cpu f32 sharded",
                                                  name) + 1e-6
            for name in INDUCING_COLD_SCALARS})
        compare_grads("(c) ", runs, dev, GRAD_TOL, cold, tau, beside)
    outs = {}
    for label, (d, t) in {dev: (dev, torch.float32),
                          "cpu f32": ("cpu", torch.float32),
                          "f64": ("cpu", torch.float64)}.items():
        m = build_model(pt, arrays, d, t, jitter=JITTER)
        Xt = torch.as_tensor(X, dtype=t, device=d)
        with torch.no_grad():
            if label == dev:
                Xl = par.shard_batch(mesh, Xt)
                outs[label] = [par.inducing_sharded_predict_f(layer, Xl, mesh)
                               for layer in (m.pred_layer, m.assign_layer)]
            else:
                outs[label] = [layer.predict_f(Xt)
                               for layer in (m.pred_layer, m.assign_layer)]
    for i, layer in enumerate(("pred_layer", "assign_layer")):
        for j, (what, key) in enumerate((("mean", "predict_y.mean"),
                                         ("var", "predict_y.var"))):
            rtol, atol_frac = REF_TOL[key]
            want = outs["f64"][i][j].double()
            atol = atol_frac * float(want.abs().max())
            err, bad = allclose_report(outs[dev][i][j].double().cpu(), want,
                                       rtol, atol)
            cpu_err, _ = allclose_report(outs["cpu f32"][i][j].double(), want,
                                         rtol, atol)
            check(bad == 0, f"(c) inducing_sharded_predict_f {layer} {what}: "
                  f"max_abs_err {err:.3e} (f32 CPU {cpu_err:.3e}; rtol "
                  f"{rtol:g}, atol {atol:.2e})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import modulatedgps_tpu_torch as pt
    from modulatedgps_tpu_torch import _native

    phase_device_and_build(_native)
    if sys.argv[1:2] == ["--cold-grads"]:
        phase_cold_grads(pt)
        return 1 if failures else 0
    if sys.argv[1:2] == ["--golden"]:
        phase_golden(pt)
        return 0
    if sys.argv[1:2] == ["--profile-misses"]:
        phase_profile_misses(pt)
        return 0
    if sys.argv[1:2] == ["--against"]:
        phase_against(sys.argv[2])
        for f in failures:
            print(f"chip_smoke: failed: {f}", file=sys.stderr)
        return 1 if failures else 0
    rows = phase_kernels()
    served = phase_slice(pt)
    ref_counts = phase_reference(pt)
    counts = phase_train(pt)
    counts.update(phase_svgp_regression(pt))
    counts["qsqrt_sq_colsum"] = served["qsqrt_sq_colsum"]
    cpu_runs = phase_grad_reference(pt)
    counts["tril_fwd_f32"] = phase_sampling(pt)["tril_fwd_f32"]
    phase_sampling_reference(pt)
    phase_resume(pt)
    phase_multistart(pt)
    counts["trsm_lower_t"] = phase_unwhitened(pt)["trsm_lower_t"]
    phase_unwhitened_reference(pt)
    phase_joint_grad(pt)
    phase_joint_grad_reference(pt)
    phase_path_c(pt)
    phase_path_c_reference(pt)
    phase_vgp(pt)
    phase_vgp_reference(pt)
    phase_demos(pt)
    phase_parallel(pt, cpu_runs=cpu_runs)
    log(f"cholesky_factor launches: {counts['cholesky_factor']} in "
        f"{TRAIN_STEPS} steps at M={M_FULL} (#16's shape), "
        f"{ref_counts['cholesky_factor']} in phase 4 at M={M_REF} (#15's)")

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts[name], **rows[name]}
               for name, (src, replaces) in KERNEL_SOURCES.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
