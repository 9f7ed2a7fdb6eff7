"""A traffic kind of the launcher's tests, added to a copy of the benchmark
as a new file (``torchbench/tests/probe/``).  Each rank starts the
program's process group from torchrun's variables with the program's own
``initialize_multihost()`` and all-reduces its [M, K] share ``rounds``
times; the check compares each rank's sum with the plain one.  The mix can
make one rank slow in set-up or in its window, hold more memory, read a
wrong sum, raise, or hang."""
from __future__ import annotations

import os
import time

import torch

from .clock import mark

LIMITS = frozenset({"sum_gap"})


def run(cell, args, device, t_start: float) -> dict:
    import torch.distributed as dist

    from modulatedgps_tpu_torch.parallel.multihost import initialize_multihost
    mix, cfg = cell.traffic, cell.config
    rank = int(os.environ["RANK"])
    if mix["raise_rank"] == rank:
        raise RuntimeError(f"rank {rank} raises, as the mix asks")
    initialize_multihost(device=device)
    dist.barrier()              # the ranks' imports no longer differ
    mark("process group")
    if mix["hang_rank"] == rank:
        time.sleep(mix["hang_s"])
    if mix["slow_setup_rank"] == rank:
        time.sleep(mix["sleep_s"])
    size = cfg["M"] * cfg["K"]
    held = torch.full((size * (mix["big_factor"] if mix["big_rank"] == rank
                               else 1),), float(rank + 1), device=device)
    setup_s = time.perf_counter() - t_start
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(mix["rounds"]):
        total = held[:size].clone()
        dist.all_reduce(total)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if mix["slow_window_rank"] == rank:
        time.sleep(mix["sleep_s"])
    window_s = time.perf_counter() - t0
    if mix["wrong_rank"] == rank:
        total += 1
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else held.nbytes)
    return {"setup_s": setup_s, "window_s": window_s, "rounds": mix["rounds"],
            "peak_bytes": peak, "failed": 0,
            "attempted": mix["rounds"] if rank == 0 else 0,
            "check": {"program": total.cpu(),
                      "world": dist.get_world_size()}}


def reference(cell, args, device, ctx: dict):
    return cell.reference().total(ctx["check"]["world"])


def numbers(program, ref) -> dict:
    return {"sum_gap": float((program.double() - ref).abs().max())}


def summary(ctx: dict) -> list:
    return [f"rounds {ctx['rounds']}, window {ctx['window_s']!r} s, world "
            f"{ctx['check']['world']}"]
