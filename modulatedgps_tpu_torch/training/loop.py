"""The Adam training loop.

Mirrors modulatedgps_tpu/training/loop.py:34-305: ``make_train_step``
gives one step (loss, backward, Adam update); ``run_adam`` runs a number of
them over a minibatch iterator, logging the ELBO every ``log_every`` steps
(the loss of that step, read back from the device only then), with
periodic checkpoints and resume, and an optional ``callback(i, elbo,
state)`` at each log step; ``run_adam_multistart`` trains a few short
replicas and continues the best.  Randomness is an explicit
``torch.Generator`` on the model's device.
"""
from __future__ import annotations

import copy
import os
import warnings
from typing import Callable, Iterator, NamedTuple

import torch

from ..utils.profiling import span
from .adam import Adam
from .checkpoint import restore_checkpoint, save_checkpoint

__all__ = ["TrainState", "make_train_step", "run_adam",
           "run_adam_multistart"]


class TrainState(NamedTuple):
    """What ``run_adam`` hands its callback: the port's counterpart of the
    JAX package's TrainState (model, opt_state, step, key).  ``model`` and
    ``optimizer`` are the live objects the run updates in place; ``step``
    is the number of steps taken; ``generator`` is the run's
    torch.Generator."""
    model: torch.nn.Module
    optimizer: Adam
    step: int
    generator: torch.Generator


def make_train_step(optimizer: Adam, loss_fn: Callable | None = None):
    """step(model, generator, X, Y) -> loss (a 0-dim tensor, not synced).

    ``loss_fn(model, generator, X, Y)`` defaults to
    ``model.training_loss(generator, X, Y)``; the gradient of every
    trainable parameter updates it through ``optimizer``.
    """
    def default_loss(model, generator, X, Y):
        return model.training_loss(generator, X, Y)

    loss = loss_fn or default_loss

    def step(model, generator, X, Y):
        with span("mgp.step", X):
            optimizer.zero_grad()
            with span("mgp.loss", X):
                value = loss(model, generator, X, Y)
            with span("mgp.backward", X):
                value.backward()
            with span("mgp.adam", X):
                optimizer.step()
        return value.detach()

    return step


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _train(step, model, generator, train_iter, first, last, log_every, verbose,
           on_step=None, on_log=None):
    """Steps first..last; returns (iters, elbos, the last step taken).
    ``on_log(i, elbo)`` runs at each log step, ``on_step(i)`` after every
    step."""
    iters, elbos = [], []
    if verbose:
        print(f"{'iter':>5s}{'ELBO:':>24s}")
    done = first - 1
    try:
        for i in range(first, last + 1):
            X, Y = next(train_iter)
            loss = step(model, generator, X, Y)
            done = i
            if i % log_every == 0:
                elbo = -float(loss)
                if verbose:
                    print(f"{i:>5d}{elbo:>24.6f}")
                iters.append(i)
                elbos.append(elbo)
                if on_log is not None:
                    on_log(i, elbo)
            if on_step is not None:
                on_step(i)
    except KeyboardInterrupt:
        print("stopping training")
    return iters, elbos, done


def run_adam(model, num_iter: int, train_iter: Iterator, lr: float, *,
             generator: torch.Generator | None = None, log_every: int = 5,
             verbose: bool = True, checkpoint_path: str | None = None,
             checkpoint_every: int = 0, resume: bool = False,
             optimizer: Adam | None = None, callback: Callable | None = None):
    """Train with Adam; returns (model, iters, elbos).

    ``train_iter`` yields (X, Y) minibatches on the model's device; the
    generator defaults to one seeded with 0 on that device; ``optimizer``
    defaults to ``Adam(model, lr)``.  Prints an iter/ELBO table every
    ``log_every`` steps and stops on KeyboardInterrupt, returning the
    history so far.  ``callback(i, elbo, state)``, where given, runs at
    every log step right after the ELBO is recorded, with ``state`` a
    TrainState(model, optimizer, i, generator), as the JAX package's
    run_adam calls it.

    With ``checkpoint_path`` and ``checkpoint_every=N`` the model, Adam's
    state, the step and the generator are saved every N steps and once at
    the end; ``resume=True`` restores them from an existing file and
    continues from the saved step, so an interrupted run ends where an
    uninterrupted one would.  The caller owns ``train_iter``: for an
    identical run, fast-forward it to the saved step.
    """
    if generator is None:
        generator = torch.Generator(device=_device(model)).manual_seed(0)
    if checkpoint_every and not checkpoint_path:
        warnings.warn("checkpoint_every is set but checkpoint_path is None: "
                      "no checkpoints will be saved", stacklevel=2)
    optimizer = optimizer or Adam(model, lr)
    start = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        start = restore_checkpoint(checkpoint_path, model, optimizer, generator)
        if verbose:
            print(f"resumed from {checkpoint_path} at step {start}")
            if start >= num_iter:
                print(f"restored step {start} >= num_iter {num_iter}: "
                      "training already complete, no new steps will run")
    saving = bool(checkpoint_path and checkpoint_every)

    def save(i):
        if saving and i % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, model, optimizer, i, generator)

    def on_log(i, elbo):
        callback(i, elbo, TrainState(model, optimizer, i, generator))

    iters, elbos, done = _train(make_train_step(optimizer), model, generator,
                                train_iter, start + 1, num_iter, log_every,
                                verbose, save, on_log if callback else None)
    if saving and done > start and done % checkpoint_every:
        # The file always holds the state returned, whatever num_iter is.
        save_checkpoint(checkpoint_path, model, optimizer, done, generator)
    return model, iters, elbos


def run_adam_multistart(model, num_iter: int, make_train_iter: Callable,
                        lr: float, *, num_starts: int = 4,
                        probe_iters: int = 400, probe_data=None,
                        eval_keys: int = 4, seed: int = 0, log_every: int = 5,
                        verbose: bool = True):
    """Multi-start Adam: train ``num_starts`` short replicas, continue the
    best; returns (model, iters, elbos, info).

    Replica s is a deep copy of ``model`` with its own Adam and a generator
    seeded ``seed + s`` on the model's device, fed by
    ``make_train_iter(s)``, for ``min(probe_iters, num_iter)`` steps.  Each
    is scored by its ELBO on ``probe_data=(X, Y)`` (default: the first
    batch of ``make_train_iter(0)``), averaged over ``eval_keys``
    generators seeded 977 + i.  The winner continues to ``num_iter`` with
    its Adam state, generator and iterator intact, so the result is what an
    uninterrupted run of that replica gives.  ``model`` itself is not
    changed; the winner's copy is returned.  info holds the probe scores
    and the winner's index.
    """
    device = _device(model)
    probe_iters = min(probe_iters, num_iter)
    replicas = []
    for s in range(num_starts):
        m = copy.deepcopy(model)
        opt = Adam(m, lr)
        gen = torch.Generator(device=device).manual_seed(seed + s)
        it = make_train_iter(s)
        _train(make_train_step(opt), m, gen, it, 1, probe_iters, log_every,
               False)
        replicas.append((m, opt, gen, it))

    Xp, Yp = probe_data if probe_data is not None else next(make_train_iter(0))
    with torch.no_grad():
        scores = [sum(float(-m.training_loss(
                      torch.Generator(device=device).manual_seed(977 + i),
                      Xp, Yp)) for i in range(eval_keys)) / eval_keys
                  for m, *_ in replicas]
    winner = max(range(num_starts), key=lambda s: scores[s])
    if verbose:
        for s, score in enumerate(scores):
            tag = " <- winner" if s == winner else ""
            print(f"replica {s}: probe ELBO {score:.6f}{tag}")

    m, opt, gen, it = replicas[winner]
    iters, elbos, _ = _train(make_train_step(opt), m, gen, it,
                             probe_iters + 1, num_iter, log_every, verbose)
    info = {"probe_scores": scores, "winner": winner,
            "probe_iters": probe_iters, "num_starts": num_starts}
    return m, iters, elbos, info
