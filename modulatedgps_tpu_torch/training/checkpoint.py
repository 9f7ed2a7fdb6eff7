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
``save_model`` writes the ``model/<name>`` arrays alone; ``restore_model``
reads the model's part of any of these files, or of the JAX package's.

``restore_jax_checkpoint`` reads what the JAX package's save_checkpoint
writes (modulatedgps_tpu/training/checkpoint.py:19-32): ``leaf_0`` ...
``leaf_{n-1}``, the leaves of ``jax.tree_util.tree_flatten`` of a model,
or of a TrainState (modulatedgps_tpu/training/loop.py:27-31): the model's
n leaves, then optax's ScaleByAdamState (count, then mu and nu, each the
model's n leaves), then the step and the threefry key.  The leaf order is
the JAX model's dataclass field order (``jax_leaf_names``).
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from .adam import Adam

__all__ = ["save_checkpoint", "restore_checkpoint", "save_model",
           "restore_model", "restore_jax_checkpoint", "jax_leaf_names"]


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


def save_model(path: str, model: nn.Module) -> None:
    """The model's ``model/<name>`` arrays alone, written atomically."""
    arrays = {f"model/{k}": t.detach().cpu().numpy()
              for k, t in model.state_dict(keep_vars=True).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


@torch.no_grad()
def restore_model(path: str, model: nn.Module) -> None:
    """Load the model's part of ``path`` into ``model`` in place: a file of
    this package (``save_model``'s or ``save_checkpoint``'s) or of the JAX
    package (a model or a TrainState), told apart by its ``leaf_0`` key.
    Raises ValueError, and changes nothing, if it does not fit."""
    with np.load(path) as data:
        files = set(data.files)
    if "leaf_0" in files:
        restore_jax_checkpoint(path, model)
        return
    targets = {f"model/{k}": t
               for k, t in model.state_dict(keep_vars=True).items()}
    saved = {k for k in files if k.startswith("model/")}
    if saved != set(targets):
        raise ValueError(f"checkpoint {path} does not fit the model: missing "
                         f"{sorted(set(targets) - saved)}, unexpected "
                         f"{sorted(saved - set(targets))}")
    with np.load(path) as data:
        arrays = {k: data[k] for k in targets}
    for key, t in targets.items():
        if arrays[key].shape != tuple(t.shape):
            raise ValueError(f"checkpoint {path}: {key} has shape "
                             f"{arrays[key].shape}, the model "
                             f"{tuple(t.shape)}")
    for key, t in targets.items():
        t.copy_(torch.from_numpy(arrays[key]))


# The JAX package's dataclass fields that hold leaves, in declaration order
# (inherited fields first), for each port class whose attributes are not
# registered in that order; any other module's children are taken in
# registration order, which is its JAX counterpart's.  Parameter's one leaf
# is its raw array.
_JAX_FIELDS = {
    "SGP": ("likelihood", "pred_layer"),
    "SMGP": ("likelihood", "pred_layer", "assign_layer"),
    "SMGPModified": ("likelihood", "pred_layer", "assign_layer",
                     "assign_likelihood"),
    "SVGP": ("kernel", "Z", "q_mu", "q_sqrt", "mean_function"),
    "VGP": ("kernel", "likelihood", "X", "Y", "q_mu", "q_sqrt",
            "mean_function"),
}


def jax_leaf_names(module: nn.Module) -> list[str]:
    """``module``'s raw leaves, named as ``named_parameters`` names them, in
    the order ``jax.tree_util.tree_flatten`` gives the JAX model built with
    the same constructors."""
    names = [n for n, _ in module.named_parameters(recurse=False)]
    children = dict(module.named_children())
    order = _JAX_FIELDS.get(type(module).__name__, tuple(children))
    for field in order:
        child = children.get(field)
        if child is not None:
            names += [f"{field}.{n}" for n in jax_leaf_names(child)]
    return names


@torch.no_grad()
def restore_jax_checkpoint(path: str, model: nn.Module,
                           optimizer: Adam | None = None,
                           generator: torch.Generator | None = None) -> int:
    """Load a JAX package checkpoint into ``model`` (and, from a TrainState,
    ``optimizer`` and ``generator``) in place; returns the saved step (0 for
    a model-only file).

    Each leaf is cast to its parameter's dtype and device.  Adam's m and v
    are copied for the optimizer's trainable leaves (JAX's moments of a
    frozen leaf stay 0) and its count set.  A threefry key cannot continue
    as torch's Philox stream: the generator is seeded with the key's two
    32-bit words as one 64-bit integer, so a resumed run draws other noise
    than JAX's would.  Raises ValueError, and changes nothing, on a file
    that is not a JAX checkpoint, a leaf count that is neither the model's
    n nor a TrainState's 3n + 3, a shape that differs, or an optimizer or
    generator given for a model-only file."""
    names = jax_leaf_names(model)
    params = dict(model.named_parameters(remove_duplicate=False))
    n = len(names)
    with np.load(path) as data:
        count = len(data.files)
        if set(data.files) != {f"leaf_{i}" for i in range(count)}:
            raise ValueError(f"{path} is not a JAX checkpoint (leaf_0 ... "
                             f"leaf_{{n-1}}): {sorted(data.files)[:4]}")
        if count not in (n, 3 * n + 3):
            raise ValueError(f"JAX checkpoint {path} has {count} leaves; the "
                             f"model has {n} (a TrainState {3 * n + 3})")
        leaves = [data[f"leaf_{i}"] for i in range(count)]
    full = count == 3 * n + 3
    if not full and (optimizer is not None or generator is not None):
        raise ValueError(f"JAX checkpoint {path} holds the model only: no "
                         f"Adam state, step or key")
    blocks = [leaves[:n]]
    if full:
        blocks += [leaves[n + 1:2 * n + 1], leaves[2 * n + 1:3 * n + 1]]
        if leaves[n].shape != () or leaves[-2].shape != () \
                or leaves[-1].shape != (2,):
            raise ValueError(f"JAX checkpoint {path}: count, step and key "
                             f"have shapes {leaves[n].shape}, "
                             f"{leaves[-2].shape}, {leaves[-1].shape}")
    for block in blocks:
        for name, leaf in zip(names, block):
            if leaf.shape != tuple(params[name].shape):
                raise ValueError(f"JAX checkpoint {path}: {name} has shape "
                                 f"{leaf.shape}, the model "
                                 f"{tuple(params[name].shape)}")
    for name, leaf in zip(names, leaves[:n]):
        params[name].copy_(torch.from_numpy(leaf))
    if not full:
        return 0
    if optimizer is not None:
        index = {name: i for i, name in enumerate(names)}
        for name, m, v in zip(optimizer.names, optimizer.m, optimizer.v):
            m.copy_(torch.from_numpy(blocks[1][index[name]]))
            v.copy_(torch.from_numpy(blocks[2][index[name]]))
        optimizer.count = int(leaves[n])
    if generator is not None:
        hi, lo = (int(w) for w in leaves[-1].astype(np.uint64))
        generator.manual_seed((hi << 32) | lo)
    return int(leaves[-2])
