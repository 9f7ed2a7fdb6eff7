"""ctypes bindings for the native host-side data pipeline (native/).

Falls back cleanly when the shared library hasn't been built; call
``available()`` to check.  Build with ``make -C native``.  A copy of
modulatedgps_tpu/data/native.py, reading the same native/libmgploader.so;
this is a host CSV reader and row gather, not a device kernel.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

__all__ = ["available", "NativeCsv", "shuffle_epoch", "gather_rows"]

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "libmgploader.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.mgp_csv_open.restype = ctypes.c_void_p
    lib.mgp_csv_open.argtypes = [ctypes.c_char_p]
    lib.mgp_csv_dims.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_int64)]
    lib.mgp_csv_col_index.restype = ctypes.c_int64
    lib.mgp_csv_col_index.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mgp_csv_read_columns.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    lib.mgp_csv_match_column.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.mgp_csv_close.argtypes = [ctypes.c_void_p]
    lib.mgp_shuffle_epoch.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                                      ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int32)]
    lib.mgp_gather_rows.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeCsv:
    """mmap'd CSV with numeric column extraction and string matching."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("libmgploader.so not built (make -C native)")
        self._lib = lib
        self._h = lib.mgp_csv_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        r, c = ctypes.c_int64(), ctypes.c_int64()
        lib.mgp_csv_dims(self._h, ctypes.byref(r), ctypes.byref(c))
        self.n_rows, self.n_cols = r.value, c.value

    def col_index(self, name: str) -> int:
        i = self._lib.mgp_csv_col_index(self._h, name.encode())
        if i < 0:
            raise KeyError(name)
        return int(i)

    def read_columns(self, names: list[str]) -> np.ndarray:
        idx = sorted(self.col_index(n) for n in names)
        order = np.argsort(np.argsort([self.col_index(n) for n in names]))
        cols = (ctypes.c_int64 * len(idx))(*idx)
        out = np.empty((self.n_rows, len(idx)), dtype=np.float64)
        self._lib.mgp_csv_read_columns(
            self._h, cols, len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out[:, order]

    def match_column(self, name: str, values: list[str]) -> np.ndarray:
        col = self.col_index(name)
        joined = b"\0".join(v.encode() for v in values) + b"\0"
        mask = np.zeros(self.n_rows, dtype=np.uint8)
        self._lib.mgp_csv_match_column(
            self._h, col, joined, len(values),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return mask.astype(bool)

    def close(self):
        if self._h:
            self._lib.mgp_csv_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def shuffle_epoch(seed: int, epoch: int, n: int) -> np.ndarray:
    lib = _load()
    out = np.empty(n, dtype=np.int32)
    lib.mgp_shuffle_epoch(seed, epoch, n,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.float64)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    dst = np.empty((len(idx), src.shape[1]), dtype=np.float64)
    lib.mgp_gather_rows(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        src.shape[0], src.shape[1],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(idx),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return dst
