"""Adam's update over the lower triangle of [K, M, M] leaves, in place: the
CUDA kernel and its plain version.

Replaces modulatedgps_tpu/training/fused_adam.py:_k_adam; the kernel is
csrc/adam_tril.cu.  The update is optax.adam's, the arithmetic
modulatedgps_tpu/training/fused_adam.py:93-97 writes:

    m' = b1 m + (1 - b1) g
    v' = b2 v + (1 - b2) g^2
    p' = p - lr (m' c1) / (sqrt(v' c2) + eps),   c = 1 / (1 - b^t).

b1, b2 and eps are arguments (the defaults B1, B2, EPS are optax's), as
JAX's FusedAdam(lr, b1, b2, eps) takes them.

The kernel reads p, g, m, v and writes p, m, v on and below the diagonal
only: one pass over half the bytes of the dense update, with no
temporaries.  The strictly-upper entries are neither read nor written and
keep their bits (the TPU kernel aliased its outputs onto its inputs for the
same reason).  The bias corrections c1, c2 come from the caller and are
rounded to f32 for the kernel and its plain version alike.

``adam_tril_`` takes its plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  Every launch adds one to
``adam_tril_.launches``.
"""
from __future__ import annotations

import torch

from .. import _native

__all__ = ["B1", "B2", "EPS", "adam_update", "adam_tril_", "adam_tril_plain_",
           "check_launch_args"]

B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_update(p, g, m, v, lr, c1, c2, b1=B1, b2=B2, eps=EPS):
    """(p', m', v') of one Adam step, in optax's order of operations."""
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    return p - lr * (m2 * c1) / (torch.sqrt(v2 * c2) + eps), m2, v2


def adam_tril_plain_(p, g, m, v, lr, c1, c2, b1=B1, b2=B2, eps=EPS):
    """adam_update written into p, m and v on and below the diagonal only."""
    lower = torch.ones(p.shape[-2:], dtype=torch.bool, device=p.device).tril_()
    for old, new in zip((p, m, v),
                        adam_update(p, g, m, v, lr, c1, c2, b1, b2, eps)):
        old.copy_(torch.where(lower, new, old))


def check_launch_args(p, g, m, v):
    if p.ndim != 3 or p.shape[1] != p.shape[2]:
        raise ValueError(f"adam_tril_: expected [K, M, M] leaves, got "
                         f"{tuple(p.shape)}")
    for what, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        _native.require(f"adam_tril_ {what}", t, torch.float32, p.device)
        if t.shape != p.shape:
            raise ValueError(f"adam_tril_: {what} has shape {tuple(t.shape)}, "
                             f"p {tuple(p.shape)}")


@torch.no_grad()
def adam_tril_(p, g, m, v, lr: float, c1: float, c2: float, b1: float = B1,
               b2: float = B2, eps: float = EPS) -> None:
    """One Adam step of p, m, v [K, M, M] in place from the gradient g, on
    and below the diagonal; c1, c2 are the bias corrections of this step."""
    if p.device.type == "cpu":
        adam_tril_plain_(p, g, m, v, lr, c1, c2, b1, b2, eps)
        return
    check_launch_args(p, g, m, v)
    K, M, _ = p.shape
    code = _native.library().mgp_adam_tril(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), M, K,
        b1, 1.0 - b1, b2, 1.0 - b2, lr, c1, c2, eps,
        _native.stream_ptr(p.device))
    _native.check(code, "adam_tril_")
    adam_tril_.launches += 1


adam_tril_.launches = 0
