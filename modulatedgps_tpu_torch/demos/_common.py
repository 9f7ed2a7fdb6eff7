"""Shared demo scaffolding: the device, argument parsing, figure output.

Mirrors demos/_common.py with the same flags, except ``--platform``:
``gpu`` (the default) runs on the card and exits non-zero without one;
``cpu`` runs the plain versions of the kernels in float64, as the JAX
demos run the CPU in float64.  There is no ``auto`` that falls back to the
CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bootstrap(platform: str = "gpu", debug_nans: bool = False):
    """(device, dtype) for ``platform``: ("cuda", float32) or ("cpu",
    float64).  Exits non-zero for ``gpu`` when torch sees no card."""
    import torch
    if platform == "gpu":
        if not torch.cuda.is_available():
            sys.exit("--platform gpu: torch.cuda.is_available() is False")
        device, dtype = torch.device("cuda"), torch.float32
    else:
        device, dtype = torch.device("cpu"), torch.float64
    if debug_nans:
        from modulatedgps_tpu_torch.config import enable_debug_checks
        enable_debug_checks(nans=True)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}, dtype {str(dtype).removeprefix('torch.')}")
    return device, dtype


def demo_argparser(defaults: dict) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=defaults.get("iters", 2000))
    p.add_argument("--lr", type=float, default=defaults.get("lr", 0.005))
    p.add_argument("--batch", type=int, default=defaults.get("batch", 500))
    p.add_argument("--num-samples", type=int, default=defaults.get("num_samples", 25))
    p.add_argument("--predict-samples", type=int,
                   default=defaults.get("predict_samples", 100))
    p.add_argument("--num-inducing", type=int, default=defaults.get("num_inducing", 25))
    p.add_argument("--K", type=int, default=defaults.get("K", 3))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--out", default=os.path.join(_REPO, "figs"))
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--checkpoint", default=None, help="save final model here")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also save the FULL train state every N steps to "
                        "--checkpoint (atomic; rerunning resumes from it)")
    p.add_argument("--resume", default=None, help="restore model before training")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise on the first NaN-producing op (slow; dev only)")
    return p


def save_figure(fig, out_dir: str, name: str):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=110)
    print(f"figure -> {path}")


def predict_in_batches(fn, X, batch: int = 500):
    """fn over host-side chunks of X (about ``batch`` rows each), its
    outputs (a tensor or a tuple of them) moved to numpy and concatenated
    along axis -2, as demos/_common.py:84-98 does (the reference's
    demos/demo_tf2.py:62-68)."""
    import numpy as np
    n_batches = max(int(X.shape[0] / batch), 1)
    outs = None
    for xb in np.array_split(X, n_batches):
        res = fn(xb)
        if not isinstance(res, tuple):
            res = (res,)
        if outs is None:
            outs = [[] for _ in res]
        for acc, r in zip(outs, res):
            acc.append(r.detach().cpu().numpy() if hasattr(r, "detach")
                       else np.asarray(r))
    cat = [np.concatenate(a, axis=-2) for a in outs]
    return cat[0] if len(cat) == 1 else tuple(cat)
