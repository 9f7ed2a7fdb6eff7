"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit), against which every share is charged.  Every FLOP is
charged at the bf16 peak: the program mixes fp32 with bf16 kernels, so no
implementation that keeps the configuration's precision classes can beat
it."""
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
PEAK_BYTES = 3.35e12         # HBM3 bytes/s


def least_seconds(work: dict) -> float:
    """The least time the card could take for ``{"flops", "bytes"}``."""
    return max(work["flops"] / PEAK_FLOPS, work["bytes"] / PEAK_BYTES)


def mfu(ctx: dict):
    """The required FLOPs of the traced sub-window's steps or requests
    (``work/<config>.py``) over that sub-window, against PEAK_FLOPS, in %;
    None where nothing was traced."""
    trace, work = ctx.get("trace"), ctx.get("profiled_work")
    if trace is None or not work:
        return None
    return 100.0 * sum(w["flops"] for w in work) / trace.window_s / PEAK_FLOPS


def roofline_share(ctx: dict):
    """The traced steps' or requests' least time, each max(FLOPs / peak,
    bytes / peak bandwidth), over the device's busy time in the traced
    sub-window, in %; None where nothing was traced."""
    trace, work = ctx.get("trace"), ctx.get("profiled_work")
    if trace is None or not work:
        return None
    return 100.0 * sum(least_seconds(w) for w in work) / trace.busy_s
