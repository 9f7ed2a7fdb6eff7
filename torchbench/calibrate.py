"""The readings behind a cell's limits: the program's, its control's and
its faults', over many seeds in one process.

    python3 torchbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--seconds S] [--control] [--faults N]

For each seed it runs the cell's set-up (and, for a serve cell, a short
window at the cell's own load) and prints one JSON line of numbers:

- ``program``: the program against the reference, as a run compares them;
- ``control`` (--control): the reference itself in the program's place,
  one precision below what the configuration states (float32 with TF32 on;
  fp8 operands for its bf16 terms);
- ``fault.<name>`` (--faults N, on the first N seeds): the program with
  a fault planted: a train
  cell's step that leaves the state unchanged and its loss over half of
  the batch; a serve cell's answer altered where it is produced.

A limit is set between the largest program reading and the smallest of the
control's and the faults' (see PERF.md).  Needs a card, as a run does;
``calibrate(...)`` takes a device for the tests.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """The program with one fault, for the length of the block."""
    import torch

    import modulatedgps_tpu_torch as pt
    from modulatedgps_tpu_torch.models.smgp import SMGP
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if kind == "train" and fault == "unchanged":
        patch(pt.Adam, "step", lambda self: None)
    elif kind == "train" and fault == "half_batch":
        loss = SMGP.training_loss

        def half(self, generator, X, Y):
            n = X.shape[0] // 2
            return loss(self, generator, X[:n], Y[:n])

        patch(SMGP, "training_loss", half)
    elif kind == "serve" and fault == "altered":
        assign = SMGP.predict_assign

        def altered(self, Xnew):        # one point's answer reversed
            pi = assign(self, Xnew)
            return torch.cat([pi[:1].flip(-1), pi[1:]])

        patch(SMGP, "predict_assign", altered)
    else:
        raise ValueError(f"no fault {fault!r} for a {kind} cell")
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


FAULTS = {"train": ("unchanged", "half_batch"), "serve": ("altered",)}


def leaf_gaps(prog: dict, ref: dict, key: str, top: int = 3) -> list:
    """A train cell's largest per-leaf gaps of ``key`` (grad_norms or
    change_norms), as harness/train.numbers measures them: [[leaf, gap]]."""
    want = ref[key]
    med = statistics.median(want.values())
    gaps = {k: abs(prog[key][k] - v) / max(v, med) for k, v in want.items()}
    return sorted(([k, g] for k, g in gaps.items()), key=lambda kg: -kg[1])[:top]


def calibrate(cell, seeds, device, seconds=0.0, control=False, faults=0,
              out=print):
    """One dict of readings per seed (also handed to ``out``); the faults
    are planted on the first ``faults`` seeds."""
    import torch
    kind = cell.traffic["kind"]
    module = cell.kind()
    rows = []
    for seed in seeds:
        args = types.SimpleNamespace(workload=cell.name, seed=seed,
                                     seconds=seconds, trace=0)
        row = {"seed": seed}
        ctx = module.run(cell, args, device, time.perf_counter())
        ref = module.reference(cell, args, device, ctx)
        row["program"] = module.numbers(ctx["check"]["program"], ref)
        if kind == "train":
            row["leaves"] = {key: leaf_gaps(ctx["check"]["program"], ref, key)
                             for key in ("grad_norms", "change_norms")}
        if control:
            low = module.reference(cell, args, device, ctx, "control")
            row["control"] = module.numbers(low, ref)
        for fault in (FAULTS[kind] if len(rows) < faults else ()):
            with planted(kind, fault):
                bad = module.run(cell, args, device, time.perf_counter())
            row[f"fault.{fault}"] = module.numbers(bad["check"]["program"],
                                                   ref)
        del ctx, ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rows.append(row)
        out(json.dumps(row))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", type=int, default=0,
                   help="plant each fault on this many of the first seeds")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from torchbench.harness import spec
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    calibrate(cell, args.seeds, torch.device("cuda"), args.seconds,
              args.control, args.faults, out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
