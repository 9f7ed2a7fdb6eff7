"""A train cell over several cards: the inducing-sharded SMGP on the
program's multi-card training path (parallel/inducing.py), one rank a card.

Each rank starts the program's process group from torchrun's variables
(``initialize_multihost()``), builds the mesh (``make_mesh``), draws the
whole state from the seed, keeps its quarter of the inducing state
(``inducing_shard_state``), builds the port's Adam on it and trains with
``make_inducing_sharded_train_step(optimizer, mesh, block=cfg["block"])``
over minibatch_iterator's global stream, each batch copied to the card as
harness/train.py copies it and cut to the rank's rows by ``shard_batch``.
The harness times, feeds and checks; the step is the program's.  Every
rank takes the same steps: at each step the ranks agree on a gloo group of
the harness's own whether the window's time is up on any of them (a host
all-reduce, so the cards are not synchronized).  Rank 0 counts the steps
attempted and failed; every rank reports the global rate it saw, its
set-up and its card's peak (ranks.join takes the worst).

The checked steps (the first ``check_steps``), as harness/train.py's:
each step's loss (the global one), every leaf's gradient norm at step 1
as Adam got it and every leaf's change after the checked steps, a sharded
leaf's norm over the blocks of every rank.  The reference
(reference/<config>.py) runs after the window on every rank, each holding
the same columns of the q_sqrt leaves as in the program; rank 0 alone
reports the numbers, harness/train.py's ``numbers``.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from . import state as st
from .clock import mark
from .trace import Recorder
from .traffic import train_data
from .train import LIMITS, Feed, numbers as _numbers  # noqa: F401

SHARDED = ("Z.raw", "q_mu.raw", "q_sqrt.raw")


def _block(name: str, t: torch.Tensor, index: int, world: int):
    """This rank's block of a leaf: the rows of Z and q_mu, the columns of
    q_sqrt (the program's placement), or the whole leaf."""
    if name.endswith("q_sqrt.raw"):
        return t.chunk(world, dim=-1)[index]
    if name.endswith(SHARDED):
        return t.chunk(world, dim=0)[index]
    return t


def _global_norms(tensors: dict, group) -> dict:
    """Every leaf's norm, a sharded leaf's over the blocks of all ranks."""
    sq = {k: t.detach().double().square().sum() for k, t in tensors.items()}
    blocks = [k for k in sq if k.endswith(SHARDED)]
    summed = torch.stack([sq[k] for k in blocks])
    dist.all_reduce(summed, group=group)
    sq.update(zip(blocks, summed))
    return {k: float(s) ** 0.5 for k, s in sq.items()}


def run(cell, args, device, t_start: float) -> dict:
    import modulatedgps_tpu_torch as pt
    from modulatedgps_tpu_torch import parallel as par
    from modulatedgps_tpu_torch.data import minibatch_iterator
    from modulatedgps_tpu_torch.parallel.mesh import axis_group

    mark("import program")
    cfg, mix = cell.config, cell.traffic
    par.initialize_multihost(device=device.type)
    mesh = par.make_mesh(device=device.type)
    group, index, world = axis_group(mesh, "data")
    if world != cfg["ranks"]:
        raise ValueError(f"{cell.name} takes {cfg['ranks']} ranks, the "
                         f"process group has {world}")
    hosts = dist.new_group(backend="gloo")
    dist.barrier(group=hosts)       # the ranks' imports no longer differ
    mark("process group")
    state = st.make_state(cfg, args.seed, device)
    full = st.build_model(cfg, state, device)
    del state
    model = par.inducing_shard_state(mesh, full)
    del full
    optimizer = pt.Adam(model, cfg["lr"])
    step = par.make_inducing_sharded_train_step(optimizer, mesh,
                                                block=cfg["block"])
    noise_seed = st.stream_seed(args.seed, st.NOISE)
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    mark("model")
    X, Y = train_data(mix, cfg, args.seed, device)
    feed = Feed(minibatch_iterator(X, Y, mix["batch"], seed=args.seed), device)
    mark("data")
    elbos, deadline = [], None

    def closed() -> bool:
        """Whether the window's time is up on any rank."""
        late = torch.tensor([deadline is not None
                             and time.perf_counter() >= deadline],
                            dtype=torch.int32)
        dist.all_reduce(late, op=dist.ReduceOp.MAX, group=hosts)
        return bool(late)

    def train(steps):
        losses = []
        for _ in range(steps):
            if closed():
                break
            X_loc, Y_loc = par.shard_batch(mesh, *next(feed))
            losses.append(step(model, gen, X_loc, Y_loc))
            if feed.count % mix["log_every"] == 0:
                elbos.append(-float(losses[-1]))
        return losses

    # The checked steps: their losses, the gradients Adam got at step 1
    # (its first moment is (1 - b1) g), and every leaf's change.
    feed.kept = []
    losses = train(1)
    grad_norms = _global_norms({n: m / (1.0 - optimizer.b1) for n, m
                                in zip(optimizer.names, optimizer.m)}, group)
    losses += train(mix["check_steps"] - 1)
    start = st.make_state(cfg, args.seed, device)
    params = dict(model.named_parameters())
    change = _global_norms({k: params[k] - _block(k, start[k], index, world)
                            for k in start}, group)
    program = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
               "change_norms": change}
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
    dist.barrier(group=hosts)
    setup_s = time.perf_counter() - t_start
    feed.count = 0
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    train(10 ** 9)
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    steps = feed.count
    if recorder is not None and recorder.started and recorder.result is None:
        recorder.stop()         # the window ended inside the profiled steps
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    ctx = {
        "setup_s": setup_s, "window_s": window_s, "steps": steps,
        "points": steps * mix["batch"], "peak_bytes": peak,
        "attempted": steps if index == 0 else 0,
        "failed": (sum(1 for e in elbos if e != e or abs(e) == float("inf"))
                   if index == 0 else 0),
    }
    if args.trace:
        span = mix["trace"]
        profiled = max(0, min(span["profiled"], steps - span["skip"]))
        ctx.update(trace=recorder.result,
                   profiled_work=[cell.work().train_step(cfg, mix["batch"])]
                   * profiled,
                   gathers=feed.gathers)
    del model, optimizer, step, feed, X, Y
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx["check"] = {"program": program if index == 0 else None,
                    "batches": checked, "noise_seed": noise_seed,
                    "group": group, "index": index, "world": world}
    return ctx


def reference(cell, args, device, ctx: dict, precision: str = "reference"):
    """The reference's readings over the checked steps, on every rank, from
    the state drawn anew from the seed (this rank's q_sqrt columns, every
    other leaf whole) and the same global batches and noise seed."""
    from torchbench.reference import _plain
    chk = ctx["check"]
    state = st.make_state(cell.config, args.seed, device)
    blocks = {k: (_block(k, t, chk["index"], chk["world"]).clone()
                  if k.endswith("q_sqrt.raw") else t)
              for k, t in state.items()}
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return cell.reference().train_readings(
        cell.config, blocks, chk["batches"], chk["noise_seed"],
        len(chk["batches"]), _plain.Precision(precision), group=chk["group"])


def numbers(prog, ref: dict) -> dict:
    """harness/train.py's numbers on rank 0; nothing on the others."""
    return {} if prog is None else _numbers(prog, ref)


def summary(ctx: dict) -> list:
    return [f"steps {ctx['steps']}, window {ctx['window_s']!r} s, world "
            f"{ctx['check']['world']}"]
