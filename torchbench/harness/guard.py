"""The JAX guard: the port is measured alone.

The port's package name begins with the JAX package's, so names are
compared whole, by the part before the first dot."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "modulatedgps_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """Names in ``modules`` (default sys.modules) whose top-level part is a
    forbidden package."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
