"""The numbers that decide ``correct``, from the program's readings and its
reference's.

Training (each step's loss; every leaf's gradient norm at step 1 as Adam
got it; every leaf's change after the checked steps):

    loss_gap   = max_t |L_t - L_t*| / |L_t*|
    grad_gap   = max_leaf | |g| - |g*| | / max(|g*|, median_leaf |g*|)
    change_gap = the same of the change norms, over the leaves whose
                 reference gradient is at least 1e-3 of the median leaf's
                 (a smaller one moves under Adam by round-off alone)

Serving (the sampled requests' outputs, all points together):

    mean_gap    = max |mu - mu*| / max |mu*|
    var_gap     = max |v - v*| / v*
    assign_gap  = max |pi - pi*|
    density_gap = max |log p - log p*|

A number that is not finite reads 1e308 (JSON has no infinity), and
fails any limit.
"""
from __future__ import annotations

import math
import statistics

import torch

GRAD_FLOOR = 1e-3


NOT_FINITE = 1e308


def _finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_FINITE


def train_numbers(prog: dict, ref: dict) -> dict:
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(prog["grad_norms"][k] - g) / max(g, g_med)
                   for k, g in g_ref.items())
    counted = [k for k, g in g_ref.items() if g >= GRAD_FLOOR * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[k] for k in counted)
    change_gap = max(abs(prog["change_norms"][k] - c_ref[k])
                     / max(c_ref[k], c_med) for k in counted)
    return {"loss_gap": _finite(loss_gap), "grad_gap": _finite(grad_gap),
            "change_gap": _finite(change_gap)}


def serve_numbers(prog: list, ref: list) -> dict:
    def cat(outs, key):
        return torch.cat([o[key].reshape(-1).double() for o in outs])

    got = {k: cat(prog, k) for k in ("mean", "var", "assign", "density")}
    want = {k: cat(ref, k) for k in got}
    nums = {
        "mean_gap": (got["mean"] - want["mean"]).abs().max()
                    / want["mean"].abs().max(),
        "var_gap": ((got["var"] - want["var"]).abs() / want["var"]).max(),
        "assign_gap": (got["assign"] - want["assign"]).abs().max(),
        "density_gap": (got["density"] - want["density"]).abs().max(),
    }
    return {k: _finite(float(v)) for k, v in nums.items()}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}); every limit must be met."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(row["value"] <= row["limit"] for row in table.values()), table
