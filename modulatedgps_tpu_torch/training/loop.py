"""The Adam training loop.

Mirrors modulatedgps_tpu/training/loop.py:34-207: ``make_train_step``
gives one step (loss, backward, Adam update) and ``run_adam`` runs a
number of them over a minibatch iterator, logging the ELBO every
``log_every`` steps (the loss of that step, read back from the device only
then).  Randomness is an explicit ``torch.Generator`` on the model's
device.  Checkpointing waits for a later slice.
"""
from __future__ import annotations

from typing import Callable, Iterator

import torch

from .adam import Adam

__all__ = ["make_train_step", "run_adam"]


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
        optimizer.zero_grad()
        value = loss(model, generator, X, Y)
        value.backward()
        optimizer.step()
        return value.detach()

    return step


def run_adam(model, num_iter: int, train_iter: Iterator, lr: float, *,
             generator: torch.Generator | None = None, log_every: int = 5,
             verbose: bool = True):
    """Train with Adam; returns (model, iters, elbos).

    ``train_iter`` yields (X, Y) minibatches on the model's device; the
    generator defaults to one seeded with 0 on that device.  Prints an
    iter/ELBO table every ``log_every`` steps and stops on
    KeyboardInterrupt, returning the history so far.
    """
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(0)
    optimizer = Adam(model.parameters(), lr)
    step = make_train_step(optimizer)
    if verbose:
        print(f"{'iter':>5s}{'ELBO:':>24s}")
    iters, elbos = [], []
    try:
        for i in range(1, num_iter + 1):
            X, Y = next(train_iter)
            loss = step(model, generator, X, Y)
            if i % log_every == 0:
                elbo = -float(loss)
                if verbose:
                    print(f"{i:>5d}{elbo:>24.6f}")
                iters.append(i)
                elbos.append(elbo)
    except KeyboardInterrupt:
        print("stopping training")
    return model, iters, elbos
