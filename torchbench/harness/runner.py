"""One run of one cell: the cell's own window, then the check, then the
metrics by their readers, as the result line's dictionary."""
from __future__ import annotations

import torch

from . import check, clock

GIB = 2 ** 30


def run_cell(cell, args, device, t_start: float) -> tuple[dict, list]:
    """(result, report lines) of the cell's kind on ``device``.  The
    reference runs after the window has closed, the peak memory has been
    read and the program's state freed.  A kind whose ``numbers`` gives
    nothing in this process (a rank that checks nothing) leaves ``checks``
    empty.  The lines, for standard error: the kind's summary, set-up and
    peak, and set-up by part since ``t_start``."""
    kind = cell.kind()
    ctx = kind.run(cell, args, device, t_start)
    ref = kind.reference(cell, args, device, ctx)
    numbers = kind.numbers(ctx["check"]["program"], ref)
    correct, table = (check.judge(numbers, cell.limits) if numbers
                      else (False, {}))
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
    lines = [*kind.summary(ctx),
             f"setup_s {ctx['setup_s']!r}, "
             f"peak {ctx['peak_bytes'] / GIB!r} GiB",
             "setup parts: " + ", ".join(f"{label} {s!r}" for label, s
                                         in clock.parts(t_start))]
    return result, lines
