"""Checkpoint and resume of an Adam run.

Mirrors modulatedgps_tpu/training/checkpoint.py:19-55: everything a run
needs to continue as if it had not stopped, in one .npz written
atomically (a tmp file, then os.replace, so a save cut short never
corrupts the previous one):

    model/<name>     the model's state dict (its raw tensors)
    adam/count       Adam's step count
    adam/m/<name>    Adam's moments, keyed by parameter name
    adam/v/<name>
    step             the run's step
    generator        the torch.Generator's state

``restore_checkpoint`` copies the arrays into a template model, Adam and
generator built the same way, onto the template's devices, and returns
the step.  The copies are exact: a restored run continues bit for bit.
Reading a checkpoint of the JAX package (its flattened TrainState) is not
supported.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from .adam import Adam

__all__ = ["save_checkpoint", "restore_checkpoint"]


_SCALARS = ("adam/count", "step", "generator")


def _tensors(model: nn.Module, optimizer: Adam) -> dict[str, torch.Tensor]:
    """The model's and Adam's tensors, by their keys in the checkpoint."""
    out = {f"model/{k}": t for k, t in model.state_dict(keep_vars=True).items()}
    for name, m, v in zip(optimizer.names, optimizer.m, optimizer.v):
        out[f"adam/m/{name}"] = m
        out[f"adam/v/{name}"] = v
    return out


def save_checkpoint(path: str, model: nn.Module, optimizer: Adam, step: int,
                    generator: torch.Generator) -> None:
    arrays = {k: t.detach().cpu().numpy()
              for k, t in _tensors(model, optimizer).items()}
    arrays.update({"adam/count": np.asarray(optimizer.count),
                   "step": np.asarray(step),
                   "generator": generator.get_state().numpy()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


@torch.no_grad()
def restore_checkpoint(path: str, model: nn.Module, optimizer: Adam,
                       generator: torch.Generator) -> int:
    """Load ``path`` into ``model``, ``optimizer`` and ``generator`` in
    place; returns the saved step.  Raises ValueError, and changes nothing,
    if the checkpoint's arrays are not the template's keys and shapes."""
    targets = _tensors(model, optimizer)
    want = set(targets) | set(_SCALARS)
    with np.load(path) as data:
        if set(data.files) != want:
            raise ValueError(
                f"checkpoint {path} does not fit the template: missing "
                f"{sorted(want - set(data.files))}, unexpected "
                f"{sorted(set(data.files) - want)}")
        arrays = {key: data[key] for key in data.files}
    for key, t in targets.items():
        if arrays[key].shape != tuple(t.shape):
            raise ValueError(f"checkpoint {path}: {key} has shape "
                             f"{arrays[key].shape}, the template "
                             f"{tuple(t.shape)}")
    for key, t in targets.items():
        t.copy_(torch.from_numpy(arrays[key]))
    optimizer.count = int(arrays["adam/count"])
    generator.set_state(torch.from_numpy(arrays["generator"]))
    return int(arrays["step"])
