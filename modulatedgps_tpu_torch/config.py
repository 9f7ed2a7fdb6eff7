"""Numerics configuration: the dtype-aware jitter, the default float and the
debug checks.

Mirrors modulatedgps_tpu/config.py:63-109.  gpflow's 1e-6 assumes float64;
float32 gets a 1e-4 floor, without which chol(Kuu) goes NaN at M of a few
hundred.  A whitened model must be evaluated at the jitter it was trained
with, so callers that compare dtypes pass the jitter explicitly
(``SVGP.jitter``).

The state is one module-level object: ``set_default_jitter`` changes it,
``config_context`` changes it for a ``with`` block.  ``default_float()`` is
the dtype the ``create`` methods use when they are given none: float32
unless ``config_context(float_override=...)`` says otherwise (the JAX
package follows its x64 flag instead).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

__all__ = ["JITTER", "JITTER_F32", "default_float", "default_jitter",
           "set_default_jitter", "config_context", "enable_debug_checks"]

JITTER = 1e-6
JITTER_F32 = 1e-4


@dataclasses.dataclass
class _Config:
    jitter: float = JITTER
    jitter_f32: float = JITTER_F32
    float_override: torch.dtype | None = None


_CONFIG = _Config()


def default_float() -> torch.dtype:
    """The dtype of new state when a ``create`` method is given none."""
    if _CONFIG.float_override is not None:
        return _CONFIG.float_override
    return torch.float32


def default_jitter(dtype: torch.dtype | None = None) -> float:
    """The jitter for ``dtype`` (default: ``default_float()``)."""
    dtype = default_float() if dtype is None else dtype
    if dtype == torch.float64:
        return _CONFIG.jitter
    return max(_CONFIG.jitter, _CONFIG.jitter_f32)


def set_default_jitter(value: float, *, f32_floor: float | None = None) -> None:
    """Set the base jitter.  float32 callers still get max(value, the f32
    floor) unless ``f32_floor`` is also given."""
    _CONFIG.jitter = float(value)
    if f32_floor is not None:
        _CONFIG.jitter_f32 = float(f32_floor)


def enable_debug_checks(nans: bool = True, checks: bool = False) -> None:
    """torch's anomaly mode, the counterpart of jax_debug_nans /
    jax_enable_checks: with ``nans`` a backward that produces NaN raises,
    naming the forward op it came from; ``checks`` alone turns on the
    anomaly mode's forward traces without the NaN check.  Both slow every
    backward down: development only."""
    torch.autograd.set_detect_anomaly(bool(nans or checks),
                                      check_nan=bool(nans))


@contextlib.contextmanager
def config_context(jitter: float | None = None,
                   float_override: torch.dtype | None = None):
    """Set the base jitter and the default float inside a ``with`` block."""
    old = dataclasses.replace(_CONFIG)
    try:
        if jitter is not None:
            _CONFIG.jitter = jitter
        if float_override is not None:
            _CONFIG.float_override = float_override
        yield
    finally:
        _CONFIG.jitter = old.jitter
        _CONFIG.float_override = old.float_override
