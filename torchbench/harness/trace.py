"""The device trace of a steady sub-window, from torch.profiler.

A profile can lose the launches of its first milliseconds, so the recording
opens with stand-in sleep kernels and a pause before the window (the method
of modulatedgps_tpu_torch/utils/profiling.kernel_times, copied here).  The
window is a user annotation, ``WINDOW``; everything is read from the
exported Chrome trace inside it:

- busy_s: the union of the device's kernel, memset and copy intervals;
- ops: how many of those the device ran;
- op_seconds: device seconds by operation name;
- device_ops: the largest of those, largest first;
- idle_gaps: the device's idle intervals, labelled by the innermost host
  event running at the middle of each gap, seconds by label, largest first.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import time

import torch

WINDOW = "torchbench.window"
STAND_IN_KERNEL = "spin_kernel"
STAND_INS = 8
PAUSE_S = 0.05
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: int
    op_seconds: dict
    device_ops: list
    idle_gaps: list


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)


class Recorder:
    """start() before the first profiled unit of work, stop() after the
    last; ``result`` is then a Trace.  Built in set-up: the first profile
    of a process initializes CUPTI, which takes seconds, so the constructor
    records one stand-in kernel and throws it away."""

    def __init__(self):
        with _profiler():
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self._prof = _profiler()
        self._window = None
        self.result: Trace | None = None

    @property
    def started(self) -> bool:
        return self._window is not None

    def start(self):
        self._prof.start()
        for _ in range(STAND_INS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self):
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.result = read_events(events)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(events):
    """One thread's nested host events flattened into segments (start, end,
    name, length of the innermost event open there), sorted by start."""
    segs, stack, cursor = [], [], None
    for s, e, name in sorted(events, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top, length = stack.pop()
            if cursor < end:
                segs.append((cursor, end, top, length))
                cursor = end
        if stack and cursor < s:
            segs.append((cursor, s, stack[-1][1], stack[-1][2]))
        cursor = s
        stack.append((e, name, e - s))
    while stack:
        end, top, length = stack.pop()
        if cursor < end:
            segs.append((cursor, end, top, length))
            cursor = end
    return [x[0] for x in segs], segs


def _host_label(lanes, t: float) -> str:
    """The innermost host event at time t over every thread."""
    best = None
    for starts, segs in lanes:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and segs[i][1] > t and (best is None or segs[i][3] < best[3]):
            best = segs[i]
    return best[2][:NAME_CHARS] if best else "host: no event"


def read_events(events: list) -> Trace:
    """A Trace from Chrome trace events (times in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in spans if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError(f"no {WINDOW} annotation in the trace")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device, by_name = [], {}
    for e in spans:
        if e.get("cat") not in DEVICE_CATS or STAND_IN_KERNEL in e["name"]:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        device.append((a, b))
        key = e["name"][:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
    busy = _union(device)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    lanes = {}
    for e in spans:
        if e.get("cat") in HOST_CATS and e.get("name") != WINDOW:
            lanes.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    lanes = [_innermost(v) for v in lanes.values()]
    gaps, edge = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            label = _host_label(lanes, 0.5 * (a + edge))
            gaps[label] = gaps.get(label, 0.0) + (a - edge) * 1e-6
        edge = max(edge, b)
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:TOP]
    return Trace((w1 - w0) * 1e-6, busy_s, len(device), by_name,
                 top(by_name), top(gaps))


def idle_share(ctx: dict):
    """1 - (union of the device's operation intervals) / (the traced
    sub-window), in %; None where nothing was traced."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def program_spans(ctx: dict):
    """(the program's ``span_table()``, the number of traced steps or
    requests), or None where nothing was traced or the program has no
    spans.  The spans record only while the Recorder's profiler runs."""
    work = ctx.get("profiled_work")
    if not work:
        return None
    try:
        from modulatedgps_tpu_torch.utils.profiling import span_table
    except ImportError:
        return None
    return span_table(), len(work)


def span_ms(ctx: dict, names, column: str = "device_ms"):
    """The sum of ``column`` of the program's spans ``names`` per traced
    step or request; None where nothing was traced or a span is missing or
    never ran on the card."""
    spans = program_spans(ctx)
    if spans is None:
        return None
    table, n = spans
    ms = [table[name][column] for name in names if name in table]
    if len(ms) < len(names) or None in ms:
        return None
    return sum(ms) / n


def prefix_ms(ctx: dict, prefix: str, column: str):
    """The sum of ``column`` of the program's spans whose names start with
    ``prefix``, per traced step or request; None where nothing was traced,
    no such span ran, or one never ran on the card."""
    spans = program_spans(ctx)
    if spans is None:
        return None
    table, n = spans
    ms = [row[column] for name, row in table.items()
          if name.startswith(prefix)]
    if not ms or None in ms:
        return None
    return sum(ms) / n
