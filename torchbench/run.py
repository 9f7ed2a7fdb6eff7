"""Run one benchmark cell once and print its result as the last line.

    python3 torchbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  With --trace 0 the line holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (and the device's busy and window seconds
and a breakdown of the trace).  The numbers that decide ``correct`` are
printed beside their limits as the last lines on standard error and under
the line's last key, ``checks``.  A cell on one card runs in this process;
a cell on more starts one rank of this script a card and joins them
(harness/ranks.py).  Exits non-zero, printing no result, without enough
cards, without the program, when a rank fails, or when a module of JAX or
of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Python's bytecode cache at a fixed path inside the checkout.  Where the
# environment turns bytecode writing off (PYTHONDONTWRITEBYTECODE) and the
# installed packages ship none, every run would compile torch's sources
# anew: seconds of set-up that swing with the host's load.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(BENCH / "_cache" / "pyc")

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
# Every kernel and build cache at a fixed path inside the checkout.  The
# port builds its own library into modulatedgps_tpu_torch/_build/.
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "extensions",
          "CUDA_CACHE_PATH": "nv"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(BENCH / "_cache" / sub)
    sys.path.insert(0, str(ROOT))
    from torchbench.harness import clock, guard, ranks, spec
    cell = spec.load_cell(args.workload)

    import torch
    clock.mark("import torch")
    if ranks.in_rank():
        return ranks.run_rank(cell, args)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"torchbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if cell.chips > 1:
        rows = ranks.launch([sys.executable, str(Path(__file__).resolve()),
                             *argv], cell.chips,
                            args.seconds + ranks.ALLOWANCE_S, T_START)
        if rows is None:
            return 1
        result, lines = ranks.join(cell, rows)
    else:
        from torchbench.harness.runner import run_cell
        result, lines = run_cell(cell, args, torch.device("cuda"), T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"torchbench: JAX was loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
