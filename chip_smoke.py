#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SMGP serving path once on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; one card

Phases, each printing its own lines:
  1. the card (nvidia-smi name and power limit) and the nvcc build of the
     kernels in modulatedgps_tpu_torch/csrc;
  2. each CUDA kernel against its plain PyTorch version on the card, at a
     small ragged shape and at its main-path shape, with CUDA-event medians;
  3. the north-star SMGP (M=4096, K=8, D=4, f32) at a seeded, perturbed
     state: 4 request batches of 8192 through precompute_smgp ->
     predict_y / predict_assign / predict_density and 2 through the
     training-path predict_y, with every kernel's launch count > 0;
  4. the same model at M=1024, batch 2048 on the card against the port's
     plain path in float64 on the CPU.
The line before the last is a JSON object with the kernels' launches,
errors and times; the last is {"ok": true, "device": {...}}.  Any failure
exits non-zero without that last line.  Without CUDA it exits non-zero
before doing anything.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
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
}
M_FULL, K_EXPERTS, D_IN, BATCH = 4096, 8, 4, 8192
M_REF, BATCH_REF = 1024, 2048
# (variance, lengthscale) of the north-star layers (bench.py:94-99).
PRED_SE, ASSIGN_SE = (0.5, 0.5), (0.1, 1.0)
LIK_VARIANCE = 0.5

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


def build_model(pt, arrays, device, dtype, jitter=None):
    return pt.smgp_from_numpy(arrays, K=K_EXPERTS, num_samples=16,
                              num_data=1_000_000, temperature=1e-2,
                              device=device, dtype=dtype, jitter=jitter)


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


def phase_kernels(pt):
    from modulatedgps_tpu_torch.ops import kxz_kernel, tril_kernel, trsm_kernel
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
            return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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
            ms, plain_ms = cuda_ms(
                [lambda: trsm_kernel.trsm_lower(L_noisy, B),
                 lambda: trsm_kernel.trsm_lower_plain(L_noisy, B)], 10)
            log(f"  trsm_lower inverse M={M}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms")
            return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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
            ms, plain_ms = cuda_ms(
                [lambda: tril_kernel.tril_sq_fwd(A16, L16),
                 lambda: tril_kernel.tril_sq_fwd_plain(A16, L16)], 5)
            macs = K * N * (M * (M + 1) / 2)
            log(f"  tril_sq_fwd M={M} N={N} K={K}: kernel {ms:.4f} ms "
                f"({2 * macs / ms / 1e9:.1f} TFLOP/s useful), plain "
                f"{plain_ms:.4f} ms")
            return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        return None

    tril_case("ragged", 200, 77, 3, False)
    tril_case("ragged", 136, 264, 2, False)
    rows["tril_sq_fwd"] = tril_case("main", M_FULL, BATCH, K_EXPERTS, True)
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


def phase_slice(pt, dev="cuda", M=M_FULL, batch=BATCH):
    log(f"== phase 3: serving slice M={M} K={K_EXPERTS} D={D_IN} "
        f"batch={batch} f32")
    arrays, rng = smgp_arrays(M)
    model = build_model(pt, arrays, dev, torch.float32)
    batches = [(torch.as_tensor(rng.uniform(-3, 3, size=(batch, D_IN)),
                                dtype=torch.float32, device=dev),
                torch.as_tensor(rng.normal(size=(batch, 1)),
                                dtype=torch.float32, device=dev))
               for _ in range(4)]
    sync(dev)
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        pt.reset_launch_counts()
        t0 = time.perf_counter()
        served = pt.precompute_smgp(model)
        sync(dev)
        t_pre = (time.perf_counter() - t0) * 1e3
        served_out, lat_served, lat_served_y = [], [], []
        for i, (X, Y) in enumerate(batches):
            t0 = time.perf_counter()
            mean, var = served.predict_y(X)
            sync(dev)
            lat_served_y.append((time.perf_counter() - t0) * 1e3)
            out = (mean[0], var[0], served.predict_assign(X),
                   served.predict_density(X, Y))
            sync(dev)
            lat_served.append((time.perf_counter() - t0) * 1e3)
            batch_checks(f"served batch {i}", *out)
            served_out.append(out)
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
        counts = pt.launch_counts()
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


def reference_outputs(pt, arrays, X, Y, device, dtype):
    model = build_model(pt, arrays, device, dtype, jitter=1e-4)
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


def phase_reference(pt):
    log(f"== phase 4: card f32 vs CPU f64 reference, M={M_REF} "
        f"batch={BATCH_REF}")
    arrays, rng = smgp_arrays(M_REF)
    X = rng.uniform(-3, 3, size=(BATCH_REF, D_IN))
    Y = rng.normal(size=(BATCH_REF, 1))
    ref = reference_outputs(pt, arrays, X, Y, "cpu", torch.float64)
    got = reference_outputs(pt, arrays, X, Y, "cuda", torch.float32)
    compare_to_reference("card f32 vs cpu f64", got, ref)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import modulatedgps_tpu_torch as pt
    from modulatedgps_tpu_torch import _native

    phase_device_and_build(_native)
    rows = phase_kernels(pt)
    counts = phase_slice(pt)
    phase_reference(pt)

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
