"""One run of one cell: the cell's own window, then the check, then the
metrics by their readers, as the result line's dictionary."""
from __future__ import annotations

import torch

from . import check, serve, train

GIB = 2 ** 30
KINDS = {"train": (train, check.train_numbers),
         "serve": (serve, check.serve_numbers)}


def run_cell(cell, args, device, t_start: float) -> tuple[dict, dict]:
    """(result, check table).  The reference runs after the window has
    closed, the peak memory has been read and the program's state freed."""
    module, numbers_of = KINDS[cell.traffic["kind"]]
    ctx = module.run(cell, args, device, t_start)
    ref = module.reference(cell, args, device, ctx)
    program = ctx["check"]["program"]
    numbers = numbers_of(program, ref)
    correct, table = check.judge(numbers, cell.limits)
    if cell.traffic["kind"] == "serve":
        ctx["failed"] = sum(1 for out in program
                            if not all(bool(torch.isfinite(t).all())
                                       for t in out.values()))
    metrics = {}
    for metric in (cell.per_layer if args.trace else cell.end_to_end):
        value = cell.reader(metric)(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    on_card = device.type == "cuda"
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": cell.chips, "memory_peak_bytes": ctx["peak_bytes"]}
    result = {"correct": correct,
              "attempted": ctx["attempted"], "failed": ctx["failed"],
              "metrics": metrics, "device": info}
    trace = ctx.get("trace")
    if trace is not None:
        info.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops,
                               "idle_gaps": trace.idle_gaps}
    result["checks"] = table
    return result, ctx
