"""The readings behind the limits of a cell on several cards: calibrate.py's,
with one rank a card.

    python3 torchbench/calibrate_ranks.py --workload <cell> --seeds 1 2 ... \
        [--control] [--faults N]

run.py's launcher (harness/ranks.py) starts the ranks; each runs, for each
seed, the cell's set-up with no warm-up and no window, the reference, and
(--control) the reference one precision below what the configuration
states, then on the first N seeds the program with each fault of FAULTS
planted.  Rank 0's numbers are printed, one JSON line a seed, as
calibrate.py prints them.  Needs the cards the cell asks for.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import types
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 3000.0      # the launcher kills every rank after this


@contextlib.contextmanager
def planted(fault: str):
    """The inducing-sharded program with one fault, for the block: its
    step leaves the state unchanged, or its loss covers half of each
    rank's batch."""
    import modulatedgps_tpu_torch as pt
    from modulatedgps_tpu_torch.parallel import inducing
    if fault == "unchanged":
        owner, name, value = pt.Adam, "step", lambda self: None
    elif fault == "half_batch":
        owner, name = inducing, "inducing_sharded_elbo"
        elbo = inducing.inducing_sharded_elbo

        def value(model, generator, X_local, Y_local, mesh, **kw):
            n = X_local.shape[0] // 2
            return elbo(model, generator, X_local[:n], Y_local[:n], mesh,
                        **kw)
    else:
        raise ValueError(f"no fault {fault!r}")
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


FAULTS = ("unchanged", "half_batch")


def rank_rows(cell, args, device) -> list:
    """This rank's part of every seed's readings; rank 0's hold them."""
    import torch
    cell.traffic = dict(cell.traffic, warmup_steps=0)
    kind = cell.kind()
    rows = []
    for i, seed in enumerate(args.seeds):
        run_args = types.SimpleNamespace(workload=cell.name, seed=seed,
                                         seconds=0.0, trace=0)
        row = {"seed": seed}
        ctx = kind.run(cell, run_args, device, time.perf_counter())
        ref = kind.reference(cell, run_args, device, ctx)
        row["program"] = kind.numbers(ctx["check"]["program"], ref)
        if args.control:
            low = kind.reference(cell, run_args, device, ctx, "control")
            row["control"] = kind.numbers(low, ref)
        del ctx
        for fault in (FAULTS if i < args.faults else ()):
            with planted(fault):
                bad = kind.run(cell, run_args, device, time.perf_counter())
            row[f"fault.{fault}"] = kind.numbers(bad["check"]["program"], ref)
            del bad
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rows.append(row)
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", type=int, default=0,
                   help="plant each fault on this many of the first seeds")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu: gloo ranks, to rehearse at a small size")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from torchbench.harness import ranks, spec
    cell = spec.load_cell(args.workload)
    if ranks.in_rank():
        local = int(os.environ["LOCAL_RANK"])
        if os.environ[ranks.ENV_DEVICE] == "cuda":
            torch.cuda.set_device(local)
            device = torch.device("cuda", local)
        else:
            device = torch.device("cpu")
        rows = rank_rows(cell, args, device)
        path = os.path.join(os.environ[ranks.ENV_DIR],
                            f"rank{os.environ['RANK']}.json")
        with open(path, "w") as f:
            json.dump({"result": rows, "lines": []}, f)
        return 0
    if args.device == "cuda" and torch.cuda.device_count() < cell.chips:
        print(f"calibrate_ranks: {cell.name} needs {cell.chips} CUDA "
              f"device(s)", file=sys.stderr)
        return 2
    out = ranks.launch([sys.executable, str(Path(__file__).resolve()), *argv],
                       cell.chips, DEADLINE_S, T_START, args.device)
    if out is None:
        return 1
    for row in out[0]["result"]:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
