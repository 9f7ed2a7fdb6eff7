"""A cell on more than one card: one rank a card, joined into one line.

Given a cell whose ``chips`` is more than 1, run.py becomes a launcher.  It
starts ``chips`` processes of itself with torchrun's variables (RANK =
LOCAL_RANK = i, WORLD_SIZE = LOCAL_WORLD_SIZE = chips, MASTER_ADDR and a
free MASTER_PORT on 127.0.0.1), so that the program's own
``parallel/multihost.initialize_multihost()`` starts its process group as
it would under torchrun; the harness starts none.  Each rank runs the
cell's kind on its own device (``cuda:LOCAL_RANK``), measures its set-up
from the launcher's start, and writes its result to a file in the
launcher's temporary directory.  The launcher waits until a deadline and
joins the ranks' results into the one line:

- each metric is the value of the rank for which it is worst by its
  ``better``: the slowest rank's set-up, the slowest rate, the fullest
  card's peak (also ``device.memory_peak_bytes``);
- ``correct`` holds where every rank that reports checks is correct;
  ``checks`` holds every rank's rows, as ``r<i>.<number>`` where more than
  one rank reports;
- ``attempted`` and ``failed`` are the ranks' sums: a kind whose ranks
  take the same global steps counts them on rank 0 alone;
- ``breakdown`` is rank 0's; ``busy_s`` and ``window_s`` are the ranks'
  means.

A rank that exits non-zero or misses the deadline ends the run: every rank
is killed with whatever it started, the end of each one's output is
printed on standard error, and no line is printed.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

ENV_DIR = "TORCHBENCH_RANK_DIR"         # a rank's result goes here
ENV_T0 = "TORCHBENCH_T0"                # the launcher's time.monotonic() start
ENV_DEVICE = "TORCHBENCH_RANK_DEVICE"   # "cuda"; "cpu" in the harness's tests
ENV_LAUNCHER = "TORCHBENCH_LAUNCHER"    # the launcher's process id
# A rank's time beyond the window: set-up (a checkout's first run also
# builds the port's kernels), the reference and the result file.  It keeps
# the whole run under the 1200 s a checkout's first run is given, so that
# the launcher, and not a cut from outside, ends a stuck rank and its
# siblings.
ALLOWANCE_S = 1000.0
TAIL_CHARS = 4000
POLL_S = 0.05
WATCH_S = 1.0


def in_rank() -> bool:
    """Whether this process is a rank that a launcher started."""
    return ENV_DIR in os.environ


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _follow_launcher(launcher: int) -> None:
    """End this rank and whatever it started once its launcher is gone (a
    launcher killed from outside cannot kill its ranks)."""
    while os.getppid() == launcher:
        time.sleep(WATCH_S)
    os.killpg(os.getpgrp(), signal.SIGKILL)


def run_rank(cell, args) -> int:
    """This rank's run of the cell: its result and report lines into
    ``<ENV_DIR>/rank<RANK>.json``; non-zero, writing nothing, where JAX was
    loaded."""
    import torch
    import torch.distributed as dist

    from .guard import forbidden_modules
    from .runner import run_cell
    launcher = int(os.environ[ENV_LAUNCHER])
    threading.Thread(target=_follow_launcher, args=(launcher,),
                     daemon=True).start()
    rank = int(os.environ["RANK"])
    local = int(os.environ["LOCAL_RANK"])
    if os.environ[ENV_DEVICE] == "cuda":
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    else:
        device = torch.device("cpu")
    t_start = time.perf_counter() - (time.monotonic()
                                     - float(os.environ[ENV_T0]))
    result, lines = run_cell(cell, args, device, t_start)
    if dist.is_initialized():
        dist.destroy_process_group()
    found = forbidden_modules()
    if found:
        print(f"torchbench: rank {rank}: JAX was loaded: {found}",
              file=sys.stderr)
        return 3
    path = os.path.join(os.environ[ENV_DIR], f"rank{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"result": result, "lines": lines}, f)
    os.replace(path + ".tmp", path)
    return 0


def _kill(procs) -> None:
    """Every rank and whatever it started (each leads its own session)."""
    for p in procs:
        if p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
    for p in procs:
        p.wait()
        with contextlib.suppress(ProcessLookupError):
            os.killpg(p.pid, signal.SIGKILL)    # its own children, if any


def _wait(procs, deadline: float) -> str | None:
    """None once every rank has exited 0; else why the run failed."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            return ", ".join(f"rank {i} exited {c}" for i, c in bad)
        if all(c == 0 for c in codes):
            return None
        if time.monotonic() >= deadline:
            late = [i for i, c in enumerate(codes) if c is None]
            return f"rank(s) {late} missed the deadline"
        time.sleep(POLL_S)


def _tail(path: str) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-TAIL_CHARS:]


def _exit_on_signal(signum, frame):
    sys.exit(128 + signum)


def launch(command: list, chips: int, deadline_s: float, t_start: float,
           device: str = "cuda") -> list | None:
    """Start ``chips`` ranks of ``command`` and wait for them until
    ``deadline_s`` after ``t_start`` (time.perf_counter()): each rank's
    {"result", "lines"} in rank order, or None once one has failed or
    missed the deadline, with every rank killed."""
    t0 = time.monotonic() - (time.perf_counter() - t_start)
    handlers = {s: signal.signal(s, _exit_on_signal)
                for s in (signal.SIGTERM, signal.SIGHUP)}
    procs, logs = [], []
    try:
        with tempfile.TemporaryDirectory(prefix="torchbench-ranks-") as tmp:
            port = str(free_port())
            try:
                for i in range(chips):
                    env = dict(os.environ, RANK=str(i), LOCAL_RANK=str(i),
                               WORLD_SIZE=str(chips),
                               LOCAL_WORLD_SIZE=str(chips),
                               MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                               **{ENV_DIR: tmp, ENV_T0: repr(t0),
                                  ENV_DEVICE: device,
                                  ENV_LAUNCHER: str(os.getpid())})
                    logs.append(os.path.join(tmp, f"rank{i}.log"))
                    with open(logs[-1], "wb") as log:
                        procs.append(subprocess.Popen(
                            command, env=env, stdin=subprocess.DEVNULL,
                            stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True))
                failed = _wait(procs, t0 + deadline_s)
            finally:
                _kill(procs)
            if failed is not None:
                print(f"torchbench: {failed}; every rank was killed "
                      f"(pids {[p.pid for p in procs]})", file=sys.stderr)
                for i, path in enumerate(logs):
                    print(f"--- rank {i}, the end of its output:\n"
                          f"{_tail(path)}", file=sys.stderr)
                return None
            rows = []
            for i in range(chips):
                with open(os.path.join(tmp, f"rank{i}.json")) as f:
                    rows.append(json.load(f))
            return rows
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def join(cell, rows: list) -> tuple[dict, list]:
    """(the one result line, the ranks' report lines) from each rank's
    {"result", "lines"}."""
    results = [row["result"] for row in rows]
    better = {m["name"]: m["better"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    for res in results:
        for name in res["metrics"]:
            if name in metrics:
                continue
            got = [r["metrics"][name] for r in results if name in r["metrics"]]
            worst = max if better[name] == "lower" else min
            metrics[name] = worst(got, key=lambda m: m["value"])
    checked = [(i, r) for i, r in enumerate(results) if r["checks"]]
    if len(checked) > 1:
        checks = {f"r{i}.{k}": v for i, r in checked
                  for k, v in r["checks"].items()}
    else:
        checks = checked[0][1]["checks"] if checked else {}
    device = dict(results[0]["device"], count=cell.chips,
                  memory_peak_bytes=max(r["device"]["memory_peak_bytes"]
                                        for r in results))
    for key in ("busy_s", "window_s"):
        got = [r["device"][key] for r in results if key in r["device"]]
        if got:
            device[key] = sum(got) / len(got)
    line = {"correct": bool(checked) and all(r["correct"] for _, r in checked),
            "attempted": sum(r["attempted"] for r in results),
            "failed": sum(r["failed"] for r in results),
            "metrics": metrics, "device": device}
    if "breakdown" in results[0]:
        line["breakdown"] = results[0]["breakdown"]
    line["checks"] = checks
    lines = [f"r{i}: {text}" for i, row in enumerate(rows)
             for text in row["lines"]]
    return line, lines
