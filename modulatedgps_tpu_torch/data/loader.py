"""Host-side minibatch pipeline (tf.data parity, numpy + native C++).

The reference builds Dataset.shuffle(N, seed).batch(B).repeat()
(demos/demo_tf2.py:53-56); with buffer_size == N that is a full reshuffle
every epoch.  This iterator reproduces that: per-epoch permutation from a
seeded Generator, fixed-size batches (the trailing remainder batch is
dropped so every step has a static shape — XLA recompiles on shape change,
so ragged tail batches are a TPU anti-pattern).

Native path (default when built — make -C native): the row gathers run in
the C++ engine while the permutation stays numpy-seeded, so the batch
stream is BIT-IDENTICAL to the pure-numpy path and goldens/demos are
unaffected.  ``use_native=True`` additionally moves the per-epoch shuffle
to the C++ PRNG (a different but deterministic stream).

A copy of modulatedgps_tpu/data/loader.py, with the span
``mgp.data.gather`` around each batch's row gathers; the batches are numpy
arrays on the host, moved to the card by the caller.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from ..utils.profiling import span

__all__ = ["minibatch_iterator"]


def minibatch_iterator(X: np.ndarray, Y: np.ndarray, batch_size: int,
                       seed: int = 0, drop_remainder: bool = True,
                       use_native: bool | None = None
                       ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Infinite (X_batch, Y_batch) stream with per-epoch seeded reshuffle.

    use_native=None (default): numpy-seeded permutation; row gathers run in
    C++ when the native library is built (bit-identical batches either way).
    use_native=True: the full native pipeline including the C++ PRNG shuffle
    (deterministic in (seed, epoch), but a different stream than numpy).
    use_native=False: pure numpy.
    """
    n = X.shape[0]
    batch_size = min(batch_size, n)
    native = None
    native_shuffle = bool(use_native)
    if use_native is None or use_native:
        from . import native as native_mod
        if native_mod.available():
            native = native_mod
        elif use_native:
            raise RuntimeError("native loader requested but not built "
                               "(make -C native)")

    def gathers(Xc, Yc):
        """(gather_fn, X', Y') — C++ row gather when eligible, numpy else."""
        if (native is not None and Xc.dtype == np.float64
                and Yc.dtype == np.float64):
            Xc = np.ascontiguousarray(Xc)
            Yc = np.ascontiguousarray(Yc)
            return (lambda a, idx: native.gather_rows(a, idx)), Xc, Yc
        return (lambda a, idx: a[idx]), Xc, Yc

    gather, X, Y = gathers(X, Y)
    rng = np.random.default_rng(seed)
    epoch = 0
    while True:
        if native_shuffle:
            perm = native.shuffle_epoch(seed, epoch, n)
        else:
            perm = rng.permutation(n).astype(np.int32)
        epoch += 1
        limit = n - batch_size + 1 if drop_remainder else n
        for start in range(0, limit, batch_size):
            idx = perm[start:start + batch_size]
            if drop_remainder and len(idx) < batch_size:
                break
            with span("mgp.data.gather"):
                batch = gather(X, idx), gather(Y, idx)
            yield batch
