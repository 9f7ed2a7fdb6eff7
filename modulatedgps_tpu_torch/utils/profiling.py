"""Tracing, spans, timing and operation counts.

The counterpart of modulatedgps_tpu/utils/profiling.py on torch.profiler:

    with trace("/tmp/mgp_trace"):        # a Chrome / Perfetto trace file
        step(model, gen, X, Y)
    table = span_table()                  # {span: calls, host ms, device ms}

    flops = flops_estimate(step, model, gen, X, Y)

``span(name)`` marks a part of the program: the train step and its loss,
backward and Adam update, the batch gather, each custom autograd
Function's forward and backward, the served predictions and the cached
posterior's marginals.  While no torch profiler records it costs one call
and one global read.  While one records, each span is a
``record_function`` range on the trace's clock (named ``mgp.*``, so a
trace reader tells it from aten ops), timed by the host clock and, on the
card, by CUDA events on the current stream; ``span_table()`` sums them by
name, ``reset_spans()`` clears them.  ``region(name, fn, *tensors)`` spans
a composite of ordinary ops, ``name.fwd`` around ``fn`` and ``name.bwd``
from the first of its pullbacks to the last.  ``count(name, n)`` adds to a
counter (the collectives' bytes sent) under the same rule: only while a
profiler records; ``counter_table()`` reads them, ``reset_spans()`` clears
them too.

``kernel_times`` profiles one call and returns the device time of each
kernel, from kernel-level events only: an autograd Function's range in
``key_averages()`` holds the device time of the kernels inside it, so a sum
over every event counts them twice.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "span", "region", "span_table", "count", "counter_table",
           "reset_spans", "flops_estimate", "intercepting", "kernel_times",
           "SPAN_PREFIX", "STAND_IN_KERNEL"]

# kernel_times' stand-ins: the kernel torch.cuda._sleep launches, how many
# open each of its steps, and the host seconds from them to what follows.
STAND_IN_KERNEL = "spin_kernel"
STAND_INS = 8
PAUSE_S = 0.05

_PACKAGE = __name__.split(".")[0]


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block; writes ``log_dir/trace.json`` (open it
    in Perfetto or chrome://tracing).  Yields the profiler."""
    from torch.profiler import profile
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# Every span's name starts with this.
SPAN_PREFIX = "mgp."
# What span() returns while no profiler records: one object, shared.
_OFF = contextlib.nullcontext()
# {name: [(host seconds, outermost of its kind, start event, end event)]};
# the events are None off the card.
_SPANS: dict[str, list] = {}
# Per thread: {kind: how many spans of that kind are open}.
_DEPTH = threading.local()
# {name: [amount]}: count()'s additions, kept while a profiler records.
_COUNTS: dict[str, list] = {}


def span(name: str, tensor: torch.Tensor | None = None,
         kind: str | None = None):
    """A context manager over a part of the program named ``name``
    (``mgp.*``).

    While no torch profiler records it is one shared ``nullcontext``.
    While one records, the block is a ``record_function(name)`` range,
    timed by ``time.perf_counter`` and, where ``tensor`` is on the card,
    by two CUDA events on that device's current stream (in a backward,
    the autograd engine's).  A span opened inside another open span of the
    same ``kind`` (default: its name) on the same thread is not outermost:
    ``span_table``'s ``outer_*`` sums leave it out."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, kind or name, tensor)


def _event(stream):
    if stream is None:
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


class _Span:
    __slots__ = ("name", "kind", "stream", "range", "outer", "t0", "e0")

    def __init__(self, name, kind, tensor):
        self.name, self.kind = name, kind
        self.stream = (torch.cuda.current_stream(tensor.device)
                       if tensor is not None and tensor.is_cuda else None)

    def __enter__(self):
        depth = _DEPTH.__dict__
        open_ = depth.get(self.kind, 0)
        depth[self.kind] = open_ + 1
        self.outer = open_ == 0
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.e0 = _event(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        e1 = _event(self.stream)
        self.range.__exit__(*exc)
        _DEPTH.__dict__[self.kind] -= 1
        _SPANS.setdefault(self.name, []).append(
            (host_s, self.outer, self.e0, e1))
        return False


def span_table() -> dict:
    """{name: {"calls", "host_ms", "device_ms", "outer_calls",
    "outer_host_ms", "outer_device_ms"}} of every span recorded since the
    last ``reset_spans``; synchronizes the card first.  The device ms are
    CUDA-event times, None for a span that never ran on the card."""
    rows = {name: list(calls) for name, calls in list(_SPANS.items())}
    if any(e0 is not None for calls in rows.values() for _, _, e0, _ in calls):
        torch.cuda.synchronize()
    table = {}
    for name, calls in rows.items():
        device = [(outer, e0.elapsed_time(e1))
                  for _, outer, e0, e1 in calls if e0 is not None]
        on_card = bool(device)
        table[name] = {
            "calls": len(calls),
            "host_ms": 1e3 * sum(h for h, _, _, _ in calls),
            "device_ms": sum(ms for _, ms in device) if on_card else None,
            "outer_calls": sum(1 for _, outer, _, _ in calls if outer),
            "outer_host_ms": 1e3 * sum(h for h, outer, _, _ in calls if outer),
            "outer_device_ms": (sum(ms for outer, ms in device if outer)
                                if on_card else None),
        }
    return table


def reset_spans() -> None:
    """Forget every span and count recorded so far."""
    _SPANS.clear()
    _COUNTS.clear()


def count(name: str, amount: int) -> None:
    """Add ``amount`` to the counter ``name`` (``mgp.*``) while a torch
    profiler records; nothing otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTS.setdefault(name, []).append(amount)


def counter_table() -> dict:
    """{name: {"calls", "total"}} of every counter added to since the last
    ``reset_spans``."""
    return {name: {"calls": len(adds), "total": sum(adds)}
            for name, adds in list(_COUNTS.items())}


class _Region:
    """The backward of one ``region`` call: its span is opened by the
    pullback of the region's output, which autograd runs first, and closed
    by the last of the pullbacks of its inputs."""
    __slots__ = ("name", "kind", "inputs", "left", "open")

    def __init__(self, name, kind, inputs):
        self.name, self.kind, self.inputs = name, kind, inputs
        self.left, self.open = inputs, None

    def start(self, g):
        if self.open is None:
            self.open = span(self.name, g, self.kind)
            self.open.__enter__()

    def end(self, g):
        self.left -= 1
        if self.left == 0:
            if self.open is not None:
                self.open.__exit__(None, None, None)
            self.open, self.left = None, self.inputs


class _Mark(torch.autograd.Function):
    """The identity, whose pullback calls ``action(gradient)``."""

    @staticmethod
    def forward(ctx, x, action):
        ctx.action = action
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.action(g)
        return g, None


def region(name: str, fn, *tensors, **kwargs):
    """``fn(*tensors, **kwargs)`` (one tensor out) as a spanned part of the
    program made of ordinary ops: its forward under ``span(name + ".fwd")``
    and, where autograd records it, its backward under ``span(name +
    ".bwd")``, from the pullback of the output to the last pullback of an
    input that requires grad (autograd runs a graph's later nodes first, so
    the nodes between are the region's).  Both spans are of the kind
    ``name``.  While no torch profiler records it is ``fn`` itself: no
    span, and no node added to the graph."""
    if not _autograd_profiler._is_profiler_enabled:
        return fn(*tensors, **kwargs)
    needs = (sum(t.requires_grad for t in tensors)
             if torch.is_grad_enabled() else 0)
    marks = _Region(f"{name}.bwd", name, needs) if needs else None
    if marks is not None:
        tensors = tuple(_Mark.apply(t, marks.end) if t.requires_grad else t
                        for t in tensors)
    with span(f"{name}.fwd", tensors[0], name):
        out = fn(*tensors, **kwargs)
    if marks is not None and out.requires_grad:
        out = _Mark.apply(out, marks.start)
    return out


class _StandIn:
    """A kernel wrapper as the package's modules see it inside
    ``intercepting``: calls go to ``call(wrapper, *args, **kwargs)``; its
    launch count is the wrapper's own."""

    def __init__(self, fn, call):
        self.fn, self.call, self.__name__ = fn, call, fn.__name__

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))

    def __call__(self, *args, **kwargs):
        return self.call(self.fn, *args, **kwargs)


@contextlib.contextmanager
def intercepting(call):
    """Inside, every module of the package calls each kernel wrapper ``fn``
    (``ops.launch_counts()``'s) as ``call(fn, *args, **kwargs)``; the
    modules get the wrappers back on the way out.  Code outside the package
    that bound a wrapper to a name of its own is not reached."""
    from ..ops import _WRAPPERS
    stand_ins = {id(w): _StandIn(w, call) for w in _WRAPPERS}
    patched = []
    try:
        for name, module in list(sys.modules.items()):
            if module is None or not name.startswith(_PACKAGE):
                continue
            for attr, value in list(vars(module).items()):
                stand_in = stand_ins.get(id(value))
                if stand_in is not None and stand_in.fn is value:
                    patched.append((module, attr, value))
                    setattr(module, attr, stand_in)
        yield
    finally:
        for module, attr, value in patched:
            setattr(module, attr, value)


def flops_estimate(fn, *args) -> int:
    """The operations of one ``fn(*args)``: the aten ops
    ``torch.utils.flop_counter.FlopCounterMode`` counts, with each kernel
    wrapper that ``fn`` reaches through the package's modules counted once,
    at the CostEstimate of its Pallas counterpart (``ops.cost``), in place
    of the aten ops its plain version runs on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops.cost import FLOPS
    mode = FlopCounterMode(display=False)
    tally = {"depth": 0, "flops": 0}

    def count(wrapper, *a, **kw):
        if tally["depth"]:           # inside another wrapper: its count
            return wrapper(*a, **kw)
        before = mode.get_total_flops()
        tally["depth"] += 1
        try:
            out = wrapper(*a, **kw)
        finally:
            tally["depth"] -= 1
        tally["flops"] += (FLOPS[wrapper.__name__](*a, **kw)
                           - (mode.get_total_flops() - before))
        return out

    with intercepting(count), mode:
        fn(*args)
    return mode.get_total_flops() + tally["flops"]


def kernel_times(fn):
    """torch.profiler over one ``fn()`` on the card: ([(self device ms,
    calls, kernel name)] largest first, the events grouped by input shape).

    Only kernel-level events are kept (not the device-side ranges of
    ProfilerStep or of the spans).  A profile can lose the launches of
    its first milliseconds (a train step's noise draw, K(X, Z) forwards and
    Cholesky; a VGP evaluation's K(X, X) and Cholesky), and a pause alone
    does not keep them: so STAND_INS sleep kernels run in the schedule's
    warm-up step and again at the start of the recorded step, ``fn`` starts
    PAUSE_S after them, and the stand-ins are left out of the rows (the
    events by shape keep them).  ``chip_smoke.py --profile-misses``
    measures how often each set-up loses launches.  ``fn`` runs once."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, schedule
    events = {}

    def keep(p):
        events["all"] = p.key_averages()
        events["by_shape"] = p.key_averages(group_by_input_shape=True)

    def stand_in():
        for _ in range(STAND_INS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)

    with profile(activities=_activities(), record_shapes=True,
                 on_trace_ready=keep,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        stand_in()
        prof.step()
        stand_in()
        fn()
        torch.cuda.synchronize()
        prof.step()
    rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                   for ev in events["all"]
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0
                   and STAND_IN_KERNEL not in ev.key
                   and not ev.key.startswith(("ProfilerStep", SPAN_PREFIX))),
                  reverse=True)
    return rows, events["by_shape"]
