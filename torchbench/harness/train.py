"""A train cell: the program's own loop, run_adam, over minibatch_iterator's
stream, each batch copied to the card as demos/_runner.train copies it.

Set-up builds one model and one Adam from the seed and drives them through
the checked steps and a warm-up, by the same call and feed as the window;
the window then continues that same object until its time is up.  The
stream ends the window: its next batch after the deadline raises
WindowClosed, which leaves run_adam, and the window's last step is the one
before.  The program is not edited: the harness's hooks are the stream,
the loss function and the optimizer instance it hands run_adam.

The numbers that decide ``correct`` (each checked step's loss; every
leaf's gradient norm at step 1 as Adam got it; every leaf's change after
the checked steps):

    loss_gap   = max_t |L_t - L_t*| / |L_t*|
    grad_gap   = max_leaf | |g| - |g*| | / max(|g*|, median_leaf |g*|)
    change_gap = the same of the change norms, over the leaves whose
                 reference gradient is at least 1e-3 of the median leaf's
                 (a smaller one moves under Adam by round-off alone)
"""
from __future__ import annotations

import statistics
import time

import torch

from . import state as st
from .check import finite
from .clock import mark
from .trace import Recorder
from .traffic import train_data


class WindowClosed(Exception):
    """The window's time is up."""


class Feed:
    """minibatch_iterator's stream moved to the card; the harness's hooks on
    it: the deadline, the host time of each batch's gather (the stream's
    next(), before the copy to the card), the batches kept for the check,
    and actions at given batch counts."""

    def __init__(self, stream, device):
        self.stream, self.device = stream, device
        self.deadline = None
        self.count = 0
        self.kept = None          # a list to keep batches in, or None
        self.gathers = None       # a list for each gather's seconds, or None
        self.at = {}              # {count: action before that batch}

    def __iter__(self):
        return self

    def __next__(self):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise WindowClosed
        action = self.at.pop(self.count, None)
        if action is not None:
            action()
        t0 = time.perf_counter()
        x, y = next(self.stream)
        if self.gathers is not None:
            self.gathers.append(time.perf_counter() - t0)
        batch = (torch.tensor(x, dtype=torch.float32, device=self.device),
                 torch.tensor(y, dtype=torch.float32, device=self.device))
        if self.kept is not None:
            self.kept.append(batch)
        self.count += 1
        return batch


def _norms(tensors: dict) -> dict:
    return {k: float(t.detach().double().norm()) for k, t in tensors.items()}


def run(cell, args, device, t_start: float) -> dict:
    import modulatedgps_tpu_torch as pt
    from modulatedgps_tpu_torch.data import minibatch_iterator

    mark("import program")
    cfg, mix = cell.config, cell.traffic
    model = st.build_model(cfg, st.make_state(cfg, args.seed, device), device)
    optimizer = pt.Adam(model, cfg["lr"])
    noise_seed = st.stream_seed(args.seed, st.NOISE)
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    mark("model")
    X, Y = train_data(mix, cfg, args.seed, device)
    feed = Feed(minibatch_iterator(X, Y, mix["batch"], seed=args.seed), device)
    mark("data")
    elbos = []

    def train(steps):
        pt.run_adam(model, steps, feed, cfg["lr"], generator=gen,
                    log_every=mix["log_every"], verbose=False,
                    optimizer=optimizer,
                    callback=lambda i, elbo, s: elbos.append(elbo))

    # The checked steps: their losses, the gradients Adam got at step 1
    # (its first moment is (1 - b1) g), and every leaf's change.
    losses, loss_fn = [], model.training_loss

    def keep_loss(*a, **kw):
        out = loss_fn(*a, **kw)
        losses.append(out.detach())
        return out

    model.training_loss = keep_loss
    feed.kept = []
    train(1)
    grads = {n: m / (1.0 - optimizer.b1)
             for n, m in zip(optimizer.names, optimizer.m)}
    grad_norms = _norms(grads)
    del grads
    train(mix["check_steps"] - 1)
    del model.training_loss
    start = st.make_state(cfg, args.seed, device)
    params = dict(model.named_parameters())
    program = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
               "change_norms": _norms({k: params[k] - start[k]
                                       for k in start})}
    del start, params
    checked, feed.kept = feed.kept, None
    mark("checked steps")
    train(mix["warmup_steps"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    mark("warm-up")

    recorder = None
    if args.trace:
        recorder = Recorder()
        feed.gathers = []
        span = mix["trace"]
        feed.at = {span["skip"]: recorder.start,
                   span["skip"] + span["profiled"]: recorder.stop}
        mark("profiler")
    setup_s = time.perf_counter() - t_start
    feed.count = 0
    t0 = time.perf_counter()
    feed.deadline = t0 + args.seconds
    try:
        train(10 ** 9)
    except WindowClosed:
        pass
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    steps = feed.count
    if recorder is not None and recorder.started and recorder.result is None:
        recorder.stop()         # the window ended inside the profiled steps
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    ctx = {
        "setup_s": setup_s, "window_s": window_s,
        "steps": steps, "points": steps * mix["batch"], "peak_bytes": peak,
        "attempted": steps, "failed": sum(1 for e in elbos
                                          if e != e or abs(e) == float("inf")),
    }
    if args.trace:
        span = mix["trace"]
        profiled = max(0, min(span["profiled"], steps - span["skip"]))
        ctx.update(trace=recorder.result,
                   profiled_work=[cell.work().train_step(cfg, mix["batch"])]
                   * profiled,
                   gathers=feed.gathers)
    del model, optimizer, feed, X, Y
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx["check"] = {"program": program, "batches": checked,
                    "noise_seed": noise_seed}
    return ctx


def reference(cell, args, device, ctx: dict, precision: str = "reference"):
    """The reference's readings over the checked steps, from the state
    drawn anew from the seed and the same batches and noise seed."""
    from torchbench.reference import _plain
    chk = ctx["check"]
    state = st.make_state(cell.config, args.seed, device)
    return _plain.train_readings(cell.reference().loss, cell.config, state,
                                 chk["batches"], chk["noise_seed"],
                                 len(chk["batches"]),
                                 _plain.Precision(precision))


LIMITS = frozenset({"loss_gap", "grad_gap", "change_gap"})
GRAD_FLOOR = 1e-3


def numbers(prog: dict, ref: dict) -> dict:
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(prog["grad_norms"][k] - g) / max(g, g_med)
                   for k, g in g_ref.items())
    counted = [k for k, g in g_ref.items() if g >= GRAD_FLOOR * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[k] for k in counted)
    change_gap = max(abs(prog["change_norms"][k] - c_ref[k])
                     / max(c_ref[k], c_med) for k in counted)
    return {"loss_gap": finite(loss_gap), "grad_gap": finite(grad_gap),
            "change_gap": finite(change_gap)}


def summary(ctx: dict) -> list:
    return [f"steps {ctx['steps']}, window {ctx['window_s']!r} s"]
