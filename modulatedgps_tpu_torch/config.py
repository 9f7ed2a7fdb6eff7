"""Numerics configuration: the dtype-aware jitter.

Mirrors modulatedgps_tpu/config.py:default_jitter.  gpflow's 1e-6 assumes
float64; float32 gets a 1e-4 floor, without which chol(Kuu) goes NaN at
M of a few hundred.  A whitened model must be evaluated at the jitter it was
trained with, so callers that compare dtypes pass the jitter explicitly
(``SVGP.jitter``).
"""
from __future__ import annotations

import torch

__all__ = ["JITTER", "JITTER_F32", "default_jitter"]

JITTER = 1e-6
JITTER_F32 = 1e-4


def default_jitter(dtype: torch.dtype) -> float:
    if dtype == torch.float64:
        return JITTER
    return max(JITTER, JITTER_F32)
