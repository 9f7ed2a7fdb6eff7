#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SMGP serving path, train step, joint
posterior sampling, the unwhitened SMGP and the joint posterior's gradient
once on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; one card

Phases, each printing its own lines:
  1. the card (nvidia-smi name and power limit) and the nvcc build of the
     kernels in modulatedgps_tpu_torch/csrc;
  2. each CUDA kernel against its plain PyTorch version on the card, at
     small ragged shapes and at its main-path shape, with CUDA-event
     medians of the kernel, the plain version and, where one exists, one
     PyTorch call computing the same function, beside the kernel's bound;
     the blocked Cholesky (#15/#16) also against f64 and cuSOLVER on both
     north-star Kmm at M = 1, 70, 1000, 1024 and 4096, with its device time
     by kernel at M=4096;
  3. the north-star SMGP (M=4096, K=8, D=4, f32) at a seeded, perturbed
     state: 8 request batches of 8192 through precompute_smgp ->
     predict_y / predict_assign / predict_density and 2 through the
     training-path predict_y, with each serving kernel's launch count > 0
     (the Cholesky and the fused q_sqrt quadratic #17 among them);
  4. the same model at M=1024, batch 2048 on the card against the port's
     plain path in float64 on the CPU, the Cholesky and #17 launched;
  5. the train step at the north-star width (S=16, batch 8192, lr 5e-3,
     Adam): 6 steps with every train-path kernel's launch count > 0 (the
     tril KL #12/#13, the tril Adam #14 and the Cholesky included), finite
     losses, q_sqrt and its Adam moments exactly 0 above the diagonal, ms
     per step, peak memory and a torch.profiler breakdown of one more step,
     with no cuSOLVER factorization in it;
  6. the loss and the gradient of every raw leaf at M=1024, batch 2048 on
     the card against the port's f64 CPU path, with the same noise, at the
     north-star temperature 1e-2 and at 1;
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
 14. path B at M=1024, N=512 against the f64 CPU path.
The line before the last is a JSON object with every kernel's launches
(on the path that runs it: the train step, sampling for #5, path A for #4,
path B for #6/#7, the served batches for #17), errors, times and bounds;
the last is {"ok": true, "device": {...}}.  Any failure exits non-zero
without that last line.
Without CUDA it exits non-zero before doing anything.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

KERNEL_SOURCES = {
    "kxz": ("modulatedgps_tpu_torch/csrc/kxz.cu",
            "modulatedgps_tpu/ops/pallas_kernels.py:94"),
    "trsm_lower": ("modulatedgps_tpu_torch/csrc/trsm.cu",
                   "modulatedgps_tpu/ops/pallas_linalg.py:313"),
    "tril_sq_fwd": ("modulatedgps_tpu_torch/csrc/tril_fwd.cu",
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
# trsm_lower_t from path A's train steps, tril_dl / tril_da from path B,
# qsqrt_sq_colsum from the served batches of phase 3).
SERVING_KERNELS = ("kxz", "trsm_lower", "tril_sq_fwd", "cholesky_factor",
                   "qsqrt_sq_colsum")
TRAIN_KERNELS = ("kxz", "trsm_lower", "tril_sq_fwd", "tril_sq_dl",
                 "tril_sq_da", "tri_tt_matmul", "tri_nt_matmul",
                 "kl_sq_logdiag", "kl_bwd_scale", "adam_tril_",
                 "cholesky_factor")
SAMPLING_KERNELS = ("kxz", "trsm_lower", "tril_sq_fwd", "tril_fwd_f32",
                    "cholesky_factor")
UNWHITENED_SERVING_KERNELS = ("kxz", "trsm_lower", "trsm_lower_t",
                              "tril_sq_fwd", "cholesky_factor",
                              "qsqrt_sq_colsum")
UNWHITENED_TRAIN_KERNELS = ("kxz", "trsm_lower", "trsm_lower_t",
                            "tril_sq_fwd", "tril_sq_dl", "tril_sq_da",
                            "tri_tt_matmul", "tri_nt_matmul", "adam_tril_",
                            "cholesky_factor")
JOINT_GRAD_KERNELS = ("kxz", "trsm_lower", "tril_fwd_f32", "tril_dl",
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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels():
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
            ms, plain_ms = cuda_ms(
                [lambda: kxz_kernel.kxz(Z, X, ls_t, var_t, kind=kind),
                 lambda: kxz_kernel.kxz_plain(Z, X, ls_t, var_t, kind=kind)], 20)
            log(f"  kxz [{M},{D}]x[{N},{D}]: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms")
            # One fp32 pass per output: the D-term cross product, two norm
            # adds, the clamp, the scale, the exp and the variance.
            return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    **bound(4 * (N * D + M * D + D + 1 + N * M),
                            N * M * (2 * D + 5), "fp32"),
                    "library_ms": None}
        return None

    kxz_case("ragged", 301, 37, 3, [0.5, 0.9, 1.4], 0.7, "rbf", False)
    kxz_case("ragged", 301, 37, 3, [0.5, 0.9, 1.4], 0.7, "matern32", False)
    kxz_case("main", M_FULL, M_FULL, D_IN, PRED_SE[1], PRED_SE[0], "rbf", True)
    rows["kxz"] = kxz_case("main", BATCH, M_FULL, D_IN, PRED_SE[1], PRED_SE[0],
                           "rbf", True)

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
    def tril_case(label, M, N, K, record):
        A = rand(M, N, scale=1 / math.sqrt(M))
        L = (torch.eye(M, device=dev) + 0.05 * rand(K, M, M))  # upper garbage
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
              f"({e_bad} outside)")
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

    tril_case("ragged", 200, 77, 3, False)
    tril_case("ragged", 136, 264, 2, False)
    rows["tril_sq_fwd"] = tril_case("main", M_FULL, BATCH, K_EXPERTS, True)

    # --- tril_sq_dl / tril_sq_da: 1e-3 of the largest magnitude (rtol and
    # atol) and dL exactly 0 above the diagonal.  The JAX suite's 3e-2
    # (tests/test_pallas_tril.py) holds a bf16 kernel against an f32
    # product; the plain versions here round W = bf16(B16 G) the same way
    # and accumulate in fp32 too (both sat within 4e-5 of the maximum on an
    # H100), so 3e-2 would pass a dropped tile of the m'-run.
    def tril_bwd_case(label, M, N, K, record):
        A = rand(M, N, scale=1 / math.sqrt(M))
        L = (torch.eye(M, device=dev) + 0.05 * rand(K, M, M))  # upper garbage
        A16, L16 = A.to(torch.bfloat16), L.to(torch.bfloat16)
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
            want = plain(x16, B16, G)
            scale = float(want.abs().max())
            err, bad = allclose_report(got, want, 1e-3, 1e-3 * scale)
            upper = upper_nonzero(got) if name == "tril_sq_dl" else 0
            check(bad == 0 and upper == 0,
                  f"{name} {label} M={M} N={N} K={K}: max_abs_err {err:.3e} "
                  f"of max {scale:.3e} ({bad} outside rtol 1e-3, atol 1e-3 "
                  f"max)" + (f", {upper} non-zero above the diagonal"
                             if name == "tril_sq_dl" else ""))
            out[name] = err
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

    tril_bwd_case("ragged", 200, 77, 3, False)
    tril_bwd_case("ragged", 197, 333, 2, False)
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
        tri = 4 * M * (M + 1) // 2
        return {"tri_tt_matmul": {
                    "max_abs_err": errs["tri_tt_matmul"], "ms": ms_tt,
                    "plain_ms": plain_tt,
                    **bound(2 * tri + 4 * M * M, 6 * macs_tt, "bf16"),
                    "library_ms": lib_tt},
                "tri_nt_matmul": {
                    "max_abs_err": errs["tri_nt_matmul"], "ms": ms_nt,
                    "plain_ms": plain_nt,
                    **bound(tri + 8 * M * M, 6 * macs_nt, "bf16"),
                    "library_ms": lib_nt}}

    trimm_case("ragged", 200, False)
    trimm_case("ragged", 197, False)
    rows.update(trimm_case("main", M_FULL, True))

    # --- tril_fwd_f32: rtol and atol 1e-4 of the largest magnitude.  The
    # kernel and its plain version multiply the same bf16 operands exactly
    # and sum in fp32, in other orders (~1e-6 apart); a dropped tile of the
    # m-run would move entries by a sizeable fraction.
    def tril_f32_case(label, M, N, K, record):
        A = rand(M, N, scale=1 / math.sqrt(M))
        L = (torch.eye(M, device=dev) + 0.05 * rand(K, M, M))  # upper garbage
        A16, L16 = A.to(torch.bfloat16), L.to(torch.bfloat16)
        got = tril_kernel.tril_fwd_f32(A16, L16)
        torch.cuda.synchronize()
        want = tril_kernel.tril_fwd_f32_plain(A16, L16)
        scale = float(want.abs().max())
        err, bad = allclose_report(got, want, 1e-4, 1e-4 * scale)
        check(bad == 0 and got.dtype == torch.float32,
              f"tril_fwd_f32 {label} M={M} N={N} K={K}: max_abs_err {err:.3e} "
              f"of max {scale:.3e} ({bad} outside rtol 1e-4, atol 1e-4 max)")
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
    rows.update(chol_quad_rows(rand))
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
    # as #8/#9's rows; dL exactly 0 above the diagonal.
    def tril_w_case(label, M, N, K, record):
        A16 = rand(M, N, scale=1 / math.sqrt(M)).to(torch.bfloat16)
        L = torch.eye(M, device=dev) + 0.05 * rand(K, M, M)
        L16 = (L + nan_above(K, M, dev)).to(torch.bfloat16)
        W16 = rand(K, N, M).to(torch.bfloat16)
        errs = {}
        for name, fn, plain, x16 in (
                ("tril_dl", tril_kernel.tril_dl, tril_kernel.tril_dl_plain, A16),
                ("tril_da", tril_kernel.tril_da, tril_kernel.tril_da_plain, L16)):
            got = fn(x16, W16)
            torch.cuda.synchronize()
            want = plain(x16, W16)
            scale = float(want.abs().max())
            err, bad = allclose_report(got, want, 1e-3, 1e-3 * scale)
            upper = upper_nonzero(got) if name == "tril_dl" else 0
            check(bad == 0 and upper == 0,
                  f"{name} {label} M={M} N={N} K={K}: max_abs_err {err:.3e} "
                  f"of max {scale:.3e} ({bad} outside rtol 1e-3, atol 1e-3 "
                  f"max)" + (f", {upper} non-zero above the diagonal"
                             if name == "tril_dl" else ""))
            errs[name] = err
        if not record:
            return None
        Lcat16 = torch.tril(L.to(torch.bfloat16)).permute(1, 0, 2).reshape(
            M, K * M)
        Wcat16 = W16.transpose(1, 2).reshape(K * M, N)
        macs = K * N * (M * (M + 1) / 2)
        res = {}
        for name, fn, plain, lib, x16, nbytes in (
                ("tril_dl", tril_kernel.tril_dl, tril_kernel.tril_dl_plain,
                 lambda: A16 @ W16, A16,
                 2 * (M * N + K * N * M) + 4 * K * M * M),
                ("tril_da", tril_kernel.tril_da, tril_kernel.tril_da_plain,
                 lambda: Lcat16 @ Wcat16, L16,
                 2 * (K * M * (M + 1) // 2 + K * N * M) + 4 * M * N)):
            ms, plain_ms, lib_ms = cuda_ms(
                [lambda: fn(x16, W16), lambda: plain(x16, W16), lib], 5)
            log(f"  {name} M={M} N={N} K={K}: kernel {ms:.4f} ms "
                f"({2 * macs / ms / 1e9:.1f} TFLOP/s useful), plain "
                f"{plain_ms:.4f} ms, bf16 matmul {lib_ms:.4f} ms")
            res[name] = {"max_abs_err": errs[name], "ms": ms,
                         "plain_ms": plain_ms,
                         **bound(nbytes, 2 * macs, "bf16"),
                         "library_ms": lib_ms}
        return res

    tril_w_case("ragged", 200, 77, 3, False)
    tril_w_case("ragged", 197, 333, 2, False)
    tril_w_case("ragged", 1, 5, 2, False)
    rows.update(tril_w_case("main", M_FULL, N_GRID, K_EXPERTS, True))
    return rows


def chol_quad_rows(rand, dev="cuda"):
    """Phase 2's rows for the blocked Cholesky (#15/#16) and the fused q_sqrt
    quadratic (#17)."""
    from modulatedgps_tpu_torch.ops import (chol_kernel, kxz_kernel,
                                            quad_kernel, trsm_kernel)
    dev = torch.device(dev)
    rows = {}

    def north_star_kmm(M, layer):
        """K(Z, Z) + JITTER I of a north-star layer (SE (variance,
        lengthscale)), Z ~ N(0, 1) as smgp_arrays draws it, in f32."""
        var, ls = layer
        Z = torch.as_tensor(np.random.default_rng(M).normal(size=(M, D_IN)),
                            dtype=torch.float32, device=dev)
        return (kxz_kernel.kxz_plain(Z, Z, torch.tensor(ls, device=dev),
                                     torch.tensor(var, device=dev))
                + JITTER * torch.eye(M, device=dev))

    def inv_residual(L, Inv):
        """max_j |Inv_j L_jj - I| over the diagonal blocks, L padded with
        the identity as the kernel pads a ragged tail."""
        nblk, B, _ = Inv.shape
        M = L.shape[0]
        Lp = torch.eye(nblk * B, device=dev)
        Lp[:M, :M] = L
        blocks = torch.stack([Lp[j * B:(j + 1) * B, j * B:(j + 1) * B]
                              for j in range(nblk)])
        return float((Inv @ blocks - torch.eye(B, device=dev)).abs().max())

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
        K = north_star_kmm(M, layer)
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
    chol_phase_times(north_star_kmm(M_FULL, PRED_SE))

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


def chol_phase_times(K):
    """Device ms of one cholesky_factor call by kernel: the copy, the
    diagonal tiles, the panels, the trailing updates and the block
    inverses (trsm.cu's diag_inv_kernel)."""
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
        + ", ".join(f"{k} {ms:.4f} ({n})" for k, (ms, n) in phases.items()))


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
        log(f"  kl_sq_logdiag K={K} M={M}: kernel {ms_f:.4f} ms, plain "
            f"{plain_f:.4f} ms, dense sum + diagonal log {lib_f:.4f} ms")
        log(f"  kl_bwd_scale K={K} M={M}: kernel {ms_b:.4f} ms, plain "
            f"{plain_b:.4f} ms, dense backward {lib_b:.4f} ms")
        tri = K * M * (M + 1) // 2
        return {"kl_sq_logdiag": {
                    "max_abs_err": abs(float(sq) - sq64), "ms": ms_f,
                    "plain_ms": plain_f,
                    **bound(4 * tri + 8, 2 * tri + K * M, "fp32"),
                    "library_ms": lib_f},
                "kl_bwd_scale": {
                    "max_abs_err": err, "ms": ms_b, "plain_ms": plain_b,
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
        log(f"  adam_tril_ K={K} M={M}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.optim.Adam(fused=True) {lib_ms:.4f} ms")
        tri = K * M * (M + 1) // 2
        return {"adam_tril_": {"max_abs_err": max(errs), "ms": ms,
                               "plain_ms": plain_ms,
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
            ("tril_fwd_kernel", "tril forward (#3)"),
            ("tril_dl_kernel<true>", "tril dL (#8)"),
            ("tril_da_kernel<true>", "tril dA (#9)"),
            ("tril_dl_kernel<false>", "tril dL (#6)"),
            ("tril_da_kernel<false>", "tril dA (#7)"),
            ("tri_tt_kernel", "pullback tt (#10)"),
            ("tri_nt_kernel", "pullback nt (#11)"),
            ("kxz_kernel", "kxz (#1)"),
            ("solve_kernel<true>", "trsm transposed (#4)"),
            ("solve_kernel", "trsm (#2)"),
            # the main paths' solves all take the Cholesky's block inverses,
            # so diag_inv_kernel runs only as the factor's last launch
            ("diag_inv_kernel", "cholesky (#15/#16)"),
            ("chol_", "cholesky (#15/#16)"),
            ("quad_kernel", "q_sqrt quadratic (#17)"),
            ("gemm", "fp32 matmul (cuBLAS)"),
            ("getrf", "cholesky (cuSOLVER)"), ("potrf", "cholesky (cuSOLVER)"),
            ("triu_tril", "tril / triu masks"), ("reduce", "reductions"))


def profile_step(step, model, gen, X, Y, top=12):
    """torch.profiler over one train step: device ms by op family and by
    kernel (kernel-level events only, so nothing is counted twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(model, gen, X, Y)
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows)
    families: dict[str, float] = {}
    for ms, _, key in rows:
        fam = next((f for sub, f in FAMILIES if sub in key),
                   "elementwise and other")
        families[fam] = families.get(fam, 0.0) + ms
    log(f"profiled step: {total:.3f} ms of kernel time; by family (ms, share):")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:9.3f} {ms / total:6.1%}  {fam}")
    log("largest kernels (self device ms, calls, name):")
    for ms, count, key in rows[:top]:
        log(f"  {ms:9.3f} {count:5d}  {key[:100]}")
    solver = [key for _, _, key in rows if "potrf" in key or "getrf" in key]
    check(not solver, f"no cuSOLVER factorization in the profiled step "
          f"({len(solver)} kernels: {[k[:60] for k in solver[:3]]})")


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


def train_steps(pt, model, X, Y, dev, steps, kernels):
    """``steps`` Adam steps of ``model`` on (X, Y): every kernel of
    ``kernels`` launched, finite losses, q_sqrt and its Adam moments exactly
    0 above the diagonal, ms per step, peak memory and a profiler breakdown
    of one more step.  Returns the launch counts of the steps."""
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
        profile_step(step, model, gen, X, Y)
    return counts


# Loss and raw-leaf gradients of the f32 card against the port's f64 CPU
# path, M=1024, batch 2048, jitter 1e-4 and the same (z, g), at two
# temperatures.  Each entry: leaf -> tolerance on max|got - want| /
# max|want|, about 4-6x the port's own f32 CPU path's distance from f64.
# At the north-star tau = 1e-2 the assignment weights are one-hot to f32
# rounding and f32 swamps the assignment layer's gradients: the f32 CPU
# path is 0.29 off f64 on its kernel variance and 0.26 on its q_sqrt.
# Those leaves are printed there, not checked, and checked at tau = 1,
# where the f32 CPU path is 6.4e-4 (kernel variance), 2.8e-3
# (lengthscales), 3.1e-3 (Z), 2.5e-3 (q_mu) and 3.5e-3 (q_sqrt) off f64.
# There, scaling the output of any one of kernels #8-#11 by 1.03 moves a
# gradient past its tolerance (tests/test_torch_grad_tolerance.py).
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
    log(f"== phase 6: loss and gradients, card f32 vs CPU f64, M={M_REF} "
        f"batch={BATCH_REF} S={NUM_SAMPLES}")
    arrays, rng = smgp_arrays(M_REF)
    X = rng.uniform(-3, 3, size=(BATCH_REF, D_IN))
    Y = rng.normal(size=(BATCH_REF, 1))
    z = rng.normal(size=(NUM_SAMPLES, BATCH_REF, K_EXPERTS))
    g = rng.gumbel(size=(NUM_SAMPLES, BATCH_REF, K_EXPERTS))
    for tau in GRAD_TEMPERATURES:
        log(f"  temperature {tau:g}")
        got = loss_and_grads(pt, arrays, X, Y, z, g, dev, torch.float32, tau)
        want = loss_and_grads(pt, arrays, X, Y, z, g, "cpu", torch.float64,
                              tau)
        for name, tol in GRAD_TOL.items():
            rel = float((got[name] - want[name]).abs().max()
                        / want[name].abs().max())
            what = f"{name}: max|err| / max|f64| {rel:.3e}"
            if tau < 1.0 and name.startswith("assign_layer."):
                log(f"  [--] {what}, not checked at this temperature")
            else:
                check(rel <= tol and bool(torch.isfinite(got[name]).all()),
                      f"{what} (tolerance {tol:g})")


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
        _, var = model.pred_layer.predict_f(X)
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
# assignment leaves are printed, not checked, as in phase 6.
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
        want = grads["f64"]
        for name, tol in UNWHITE_GRAD_TOL.items():
            rel, cpu_rel = (float((grads[k][name] - want[name]).abs().max()
                                  / want[name].abs().max())
                            for k in (dev, "cpu f32"))
            what = (f"{name}: max|err| / max|f64| {rel:.3e} (f32 CPU "
                    f"{cpu_rel:.3e})")
            if tau < 1.0 and name.startswith("assign_layer."):
                log(f"  [--] {what}, not checked at this temperature")
            else:
                check(rel <= tol and finite(grads[dev][name]),
                      f"{what} (tolerance {tol:g})")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import modulatedgps_tpu_torch as pt
    from modulatedgps_tpu_torch import _native

    phase_device_and_build(_native)
    rows = phase_kernels()
    served = phase_slice(pt)
    ref_counts = phase_reference(pt)
    counts = phase_train(pt)
    counts["qsqrt_sq_colsum"] = served["qsqrt_sq_colsum"]
    phase_grad_reference(pt)
    counts["tril_fwd_f32"] = phase_sampling(pt)["tril_fwd_f32"]
    phase_sampling_reference(pt)
    phase_resume(pt)
    phase_multistart(pt)
    counts["trsm_lower_t"] = phase_unwhitened(pt)["trsm_lower_t"]
    phase_unwhitened_reference(pt)
    joint = phase_joint_grad(pt)
    counts.update(tril_dl=joint["tril_dl"], tril_da=joint["tril_da"])
    phase_joint_grad_reference(pt)
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
