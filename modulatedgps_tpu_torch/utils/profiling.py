"""Tracing, timing and operation counts.

The counterpart of modulatedgps_tpu/utils/profiling.py on torch.profiler:

    with trace("/tmp/mgp_trace"):        # a Chrome / Perfetto trace file
        step(model, gen, X, Y)

    t = time_fn(step, model, gen, X, Y)   # best wall seconds per call
    flops = flops_estimate(step, model, gen, X, Y)

``kernel_times`` profiles one call and returns the device time of each
kernel, from kernel-level events only: an autograd Function's range in
``key_averages()`` holds the device time of the kernels inside it, so a sum
over every event counts them twice.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

__all__ = ["trace", "time_fn", "flops_estimate", "intercepting",
           "kernel_times", "STAND_IN_KERNEL"]

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


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Best wall seconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup``; on the card each call ends in ``torch.cuda.synchronize()``."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


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

    Only kernel-level events are kept.  A profile can lose the launches of
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
                   and not ev.key.startswith("ProfilerStep")), reverse=True)
    return rows, events["by_shape"]
