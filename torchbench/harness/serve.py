"""A serve cell: a closed loop of one client over the program's serving
path.  Set-up folds the model into its cached posteriors with
precompute_smgp and serves one request twice (the first call is cold; every
request has the mix's one size); each request
is predict_y, predict_assign and predict_density of that served model under
torch.inference_mode(), timed from its start to its outputs on the device
(a synchronize).  The outputs of the requests the check samples are kept
and compared with the reference once the window has closed; the window
does not close before every sampled request has been served.

The numbers that decide ``correct`` (the sampled requests' outputs, all
points together):

    mean_gap    = max |mu - mu*| / max |mu*|
    var_gap     = max |v - v*| / v*
    assign_gap  = max |pi - pi*|
    density_gap = max |log p - log p*|
"""
from __future__ import annotations

import time

import torch

from . import state as st
from .check import finite
from .clock import mark
from .trace import Recorder
from .traffic import request_pool


def run(cell, args, device, t_start: float) -> dict:
    from modulatedgps_tpu_torch import precompute_smgp

    mark("import program")
    cfg, mix = cell.config, cell.traffic
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    model = st.build_model(cfg, st.make_state(cfg, args.seed, device), device)
    with torch.no_grad():
        served = precompute_smgp(model)
    del model
    mark("model and posterior cache")
    pool = request_pool(mix, cfg, args.seed, device)
    mark("requests")

    def serve(X, Y):
        with torch.inference_mode():
            return (served.predict_y(X), served.predict_assign(X),
                    served.predict_density(X, Y))

    serve(*pool.request(0))
    serve(*pool.request(0))
    sync()
    mark("warm-up")

    trace = args.trace
    recorder = Recorder() if trace else None
    if trace:
        mark("profiler")
    span = mix["trace"]
    latencies, sizes, kept = [], [], {}
    last_checked = max(pool.checked)
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    per_second = [0] * (int(args.seconds) + 2)
    i = 0
    while time.perf_counter() < deadline or i <= last_checked:
        if trace and i == span["skip"]:
            recorder.start()
        if trace and i == span["skip"] + span["profiled"]:
            recorder.stop()
        X, Y = pool.request(i)
        a = time.perf_counter()
        (mean, var), assign, density = serve(X, Y)
        sync()
        done = time.perf_counter()
        latencies.append(done - a)
        per_second[min(int(done - t0), len(per_second) - 1)] += 1
        sizes.append(X.shape[0])
        if i in pool.checked:
            kept[i] = {"mean": mean[0], "var": var[0], "assign": assign,
                       "density": density}
        i += 1
    window_s = time.perf_counter() - t0
    if trace and recorder.started and recorder.result is None:
        recorder.stop()         # the window ended inside the profiled requests
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    ctx = {
        "setup_s": setup_s, "window_s": window_s,
        "requests": i, "points": sum(sizes), "latencies": latencies,
        "per_second": per_second,
        "peak_bytes": peak, "attempted": i,
    }
    if trace:
        profiled = sizes[span["skip"]:span["skip"] + span["profiled"]]
        work = cell.work()
        ctx.update(trace=recorder.result,
                   profiled_work=[work.request(cfg, n) for n in profiled])
    requests = [pool.request(j) for j in sorted(kept)]
    program = [kept[j] for j in sorted(kept)]
    ctx["failed"] = sum(1 for out in program
                        if not all(bool(torch.isfinite(t).all())
                                   for t in out.values()))
    ctx["check"] = {"program": program,
                    "requests": [(X.clone(), Y.clone()) for X, Y in requests],
                    "indices": sorted(kept)}
    del served, pool
    if on_card:
        torch.cuda.empty_cache()
    return ctx


def reference(cell, args, device, ctx: dict, precision: str = "reference"):
    """The reference's outputs for the checked requests, from the state
    drawn anew from the seed."""
    from torchbench.reference import _plain
    state = st.make_state(cell.config, args.seed, device)
    return _plain.serve_outputs(cell.reference().predict, cell.config, state,
                                ctx["check"]["requests"],
                                _plain.Precision(precision))


LIMITS = frozenset({"mean_gap", "var_gap", "assign_gap", "density_gap"})


def numbers(prog: list, ref: list) -> dict:
    def cat(outs, key):
        return torch.cat([o[key].reshape(-1).double() for o in outs])

    got = {k: cat(prog, k) for k in ("mean", "var", "assign", "density")}
    want = {k: cat(ref, k) for k in got}
    nums = {
        "mean_gap": (got["mean"] - want["mean"]).abs().max()
                    / want["mean"].abs().max(),
        "var_gap": ((got["var"] - want["var"]).abs() / want["var"]).max(),
        "assign_gap": (got["assign"] - want["assign"]).abs().max(),
        "density_gap": (got["density"] - want["density"]).abs().max(),
    }
    return {k: finite(float(v)) for k, v in nums.items()}


def summary(ctx: dict) -> list:
    lat = sorted(ctx["latencies"])
    return [f"requests {len(lat)}, latency median "
            f"{1e3 * lat[len(lat) // 2]!r} ms, window {ctx['window_s']!r} s",
            f"requests in each second of the window: {ctx['per_second']}"]
