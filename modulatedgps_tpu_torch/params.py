"""Constrained parameters as ``nn.Module``s.

Mirrors modulatedgps_tpu/params.py: a parameter stores an unconstrained
``raw`` tensor (an ``nn.Parameter``) and a transform name; ``value`` applies
the transform.  Transforms: ``identity``, ``positive`` (softplus, with the
stable inverse y + log(-expm1(-y))) and ``tril`` (lower triangle).
``set_trainable``, ``trainable_mask`` and ``print_summary`` are the
gpflow-style helpers of params.py:195-250.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

__all__ = ["Parameter", "positive", "positive_inverse", "TRANSFORMS",
           "set_trainable", "trainable_mask", "print_summary"]

_SOFTPLUS_CUTOFF = 20.0


def positive(raw: torch.Tensor) -> torch.Tensor:
    """softplus(raw) = log(1 + exp(raw)), as jax.nn.softplus (no cutoff)."""
    return torch.logaddexp(raw, torch.zeros_like(raw))


def positive_inverse(value: torch.Tensor) -> torch.Tensor:
    """Numerically stable softplus inverse: y + log(-expm1(-y))."""
    big = value > _SOFTPLUS_CUTOFF
    safe = torch.where(big, torch.ones_like(value), value)
    return torch.where(big, value, safe + torch.log(-torch.expm1(-safe)))


_FORWARD: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "identity": lambda x: x,
    "positive": positive,
    "tril": torch.tril,
}

_INVERSE: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "identity": lambda x: x,
    "positive": positive_inverse,
    "tril": torch.tril,
}

TRANSFORMS = tuple(_FORWARD)


class Parameter(nn.Module):
    """An unconstrained ``raw`` tensor with a transform; ``value`` is the
    constrained tensor.  ``trainable`` sets ``raw.requires_grad``."""

    def __init__(self, raw: torch.Tensor, transform: str = "identity",
                 trainable: bool = True):
        super().__init__()
        if transform not in _FORWARD:
            raise ValueError(f"unknown transform {transform!r}; have {TRANSFORMS}")
        self.transform = transform
        self.raw = nn.Parameter(torch.as_tensor(raw), requires_grad=trainable)

    @classmethod
    def from_value(cls, value, transform: str = "identity",
                   trainable: bool = True, *, dtype: torch.dtype,
                   device: torch.device | str) -> "Parameter":
        """Store the transform's inverse of ``value``."""
        value = torch.as_tensor(value, dtype=dtype, device=device)
        return cls(_INVERSE[transform](value), transform, trainable)

    @property
    def value(self) -> torch.Tensor:
        return _FORWARD[self.transform](self.raw)

    @property
    def trainable(self) -> bool:
        return self.raw.requires_grad

    @property
    def shape(self) -> torch.Size:
        return self.raw.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.raw.dtype

    def extra_repr(self) -> str:
        return (f"shape={tuple(self.raw.shape)}, transform={self.transform!r}, "
                f"trainable={self.trainable}")


def set_trainable(param: Parameter, trainable: bool) -> Parameter:
    """Freeze or unfreeze ``param``: sets ``param.raw.requires_grad``.

    Unlike the JAX package's, which returns a copy to re-attach, this
    changes the Parameter in place and returns it.  ``Adam`` picks its
    leaves when it is built: freeze before building it."""
    param.raw.requires_grad_(bool(trainable))
    return param


def trainable_mask(module: nn.Module) -> dict[str, bool]:
    """{raw leaf name: trainable} over ``module.named_parameters()``; the
    names are the JAX pytree paths of the same leaves."""
    return {name: p.requires_grad for name, p in module.named_parameters()}


def print_summary(module: nn.Module, name: str = "model") -> str:
    """A table of ``module``'s Parameters (path, transform, trainable, shape,
    dtype) in the JAX package's columns and paths (a list entry reads
    ``kernels[0]``); prints it and returns it."""
    lines = [f"{'path':<60} {'transform':<10} {'trainable':<10} "
             f"{'shape':<16} dtype"]

    def walk(mod: nn.Module, path: str) -> None:
        if isinstance(mod, Parameter):
            dtype = str(mod.dtype).removeprefix("torch.")
            lines.append(f"{path:<60} {mod.transform:<10} "
                         f"{str(mod.trainable):<10} "
                         f"{str(tuple(mod.shape)):<16} {dtype}")
            return
        for child_name, child in mod.named_children():
            if isinstance(child, nn.ModuleList):
                for i, item in enumerate(child):
                    walk(item, f"{path}.{child_name}[{i}]")
            else:
                walk(child, f"{path}.{child_name}")

    walk(module, name)
    out = "\n".join(lines)
    print(out)
    return out
