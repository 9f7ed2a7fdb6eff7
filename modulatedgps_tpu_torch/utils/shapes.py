"""Runtime shape contracts — the check_shapes analog.

The reference relies on the ``check_shapes`` package for dev-time shape
validation (reference MixtureGPs/models.py:4,128 and gpflow's internal
annotations).  Plain Python checks on ``tensor.shape`` cost nothing next to
the device work and need no host-device synchronisation.  Same checker as
modulatedgps_tpu/utils/shapes.py.

Spec mini-language (one string per array):  dims separated by spaces;
an integer pins a size, a name binds a symbolic dim (must agree across all
arrays in one ``ShapeChecker``), ``.`` matches anything, a leading ``...``
allows extra leading batch dims.

    chk = ShapeChecker()
    chk.check(X, "N D", "X")
    chk.check(Y, "N 1", "Y")      # raises if Y's first dim != X's
"""
from __future__ import annotations

__all__ = ["ShapeChecker", "check_shape"]


class ShapeError(ValueError):
    pass


class ShapeChecker:
    """Binds symbolic dimension names across a group of arrays."""

    def __init__(self):
        self.bound: dict[str, int] = {}

    def check(self, array, spec: str, name: str = "array"):
        dims = spec.split()
        variadic = dims and dims[0] == "..."
        if variadic:
            dims = dims[1:]
        shape = tuple(array.shape)
        if variadic:
            if len(shape) < len(dims):
                raise ShapeError(
                    f"{name}: expected rank >= {len(dims)} ('{spec}'), got "
                    f"shape {shape}")
            shape = shape[len(shape) - len(dims):]
        elif len(shape) != len(dims):
            raise ShapeError(
                f"{name}: expected rank {len(dims)} ('{spec}'), got shape "
                f"{tuple(array.shape)}")
        for d, s in zip(dims, shape):
            if d == ".":
                continue
            if d.isdigit():
                if s != int(d):
                    raise ShapeError(
                        f"{name}: dim pinned to {d} in '{spec}', got shape "
                        f"{tuple(array.shape)}")
                continue
            if d in self.bound and self.bound[d] != s:
                raise ShapeError(
                    f"{name}: dim '{d}' = {s} conflicts with previously "
                    f"bound {d} = {self.bound[d]} (spec '{spec}', shape "
                    f"{tuple(array.shape)})")
            self.bound[d] = s
        return array


def check_shape(array, spec: str, name: str = "array"):
    """One-off contract (no cross-array dim binding)."""
    return ShapeChecker().check(array, spec, name)
