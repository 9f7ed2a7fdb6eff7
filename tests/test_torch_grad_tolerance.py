"""chip_smoke.py's gradient tolerances (GRAD_TOL) tell f32 rounding from a
kernel fault.

Phase 6 of chip_smoke.py holds the card's f32 raw-leaf gradients against
the port's f64 CPU path at M=1024, batch 2048, S=16.  Here the card is
stood in for by the port's f32 CPU path, which runs each kernel's plain
version with the same bf16 / 3-pass arithmetic.  At temperature 1 that
path lies within GRAD_TOL of f64 on every leaf, and scaling the output of
any one of kernels #6, #7, #10 or #11 (the backward kernels of the step:
SMGP's layers take the q_sqrt variance term's gradient by the 3-pass
split, on #6/#7) by 1.03 moves at least one leaf past its tolerance.  At
temperature 1e-2 phase 6 holds the assignment layer's leaves to
GRAD_TOL_COLD instead.

    python tests/test_torch_grad_tolerance.py   # prints every error
"""
import sys
from functools import lru_cache
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
import modulatedgps_tpu_torch as pt  # noqa: E402
from modulatedgps_tpu_torch.ops import tril_kernel, trimm_kernel  # noqa: E402

FAULTS = {"tril_da (#7)": (tril_kernel, "tril_da_plain"),
          "tril_dl (#6)": (tril_kernel, "tril_dl_plain"),
          "tri_tt_matmul (#10)": (trimm_kernel, "tri_tt_matmul_plain"),
          "tri_nt_matmul (#11)": (trimm_kernel, "tri_nt_matmul_plain")}
SCALE = 1.03


@lru_cache(maxsize=None)
def _inputs():
    arrays, rng = chip_smoke.smgp_arrays(chip_smoke.M_REF)
    S, B, K = chip_smoke.NUM_SAMPLES, chip_smoke.BATCH_REF, chip_smoke.K_EXPERTS
    X = rng.uniform(-3, 3, size=(B, chip_smoke.D_IN))
    Y = rng.normal(size=(B, 1))
    z = rng.normal(size=(S, B, K))
    g = rng.gumbel(size=(S, B, K))
    return arrays, X, Y, z, g


@lru_cache(maxsize=None)
def _grads(dtype, temperature):
    return chip_smoke.loss_and_grads(pt, *_inputs(), "cpu", dtype,
                                     temperature)


def _rel_errors(got, temperature):
    want = _grads(torch.float64, temperature)
    return {name: float((got[name] - want[name]).abs().max()
                        / want[name].abs().max())
            for name in chip_smoke.GRAD_TOL}


def _faulty_grads(fault):
    module, name = FAULTS[fault]
    plain = getattr(module, name)
    scaled = lambda *a, **kw: SCALE * plain(*a, **kw)  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, name, scaled)
        return chip_smoke.loss_and_grads(pt, *_inputs(), "cpu", torch.float32,
                                         1.0)


def _tolerance(name, tau):
    if tau < 1.0 and name.startswith("assign_layer."):
        return chip_smoke.GRAD_TOL_COLD[name]
    return chip_smoke.GRAD_TOL[name]


def test_f32_cpu_path_is_within_grad_tol_of_f64():
    """Every leaf at temperature 1; at 1e-2 the assignment layer's within
    GRAD_TOL_COLD, the others within GRAD_TOL, as phase 6 checks them."""
    for tau in chip_smoke.GRAD_TEMPERATURES:
        errs = _rel_errors(_grads(torch.float32, tau), tau)
        over = {name: (err, _tolerance(name, tau))
                for name, err in errs.items() if err > _tolerance(name, tau)}
        assert not over, f"temperature {tau}: {over}"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_scaled_kernel_output_breaks_a_tolerance(fault):
    errs = _rel_errors(_faulty_grads(fault), 1.0)
    over = {name for name, err in errs.items()
            if err > chip_smoke.GRAD_TOL[name]}
    assert over, f"{fault} x{SCALE}: every leaf within GRAD_TOL: {errs}"


if __name__ == "__main__":
    torch.set_num_threads(4)
    cases = {f"f32, temperature {tau:g}": (_grads(torch.float32, tau), tau)
             for tau in chip_smoke.GRAD_TEMPERATURES}
    cases.update({f"{fault} x{SCALE}, temperature 1": (_faulty_grads(fault),
                                                       1.0)
                  for fault in sorted(FAULTS)})
    for label, (got, tau) in cases.items():
        print(label)
        for name, err in _rel_errors(got, tau).items():
            tol = _tolerance(name, tau)
            print(f"  {name:38s} {err:.3e}  (tolerance {tol:g})"
                  + ("  over" if err > tol else ""))
