"""k-means inducing-point initialization.

The demos initialize Z with scipy.cluster.vq.kmeans(X, M, seed=s)
(reference demos/demo_tf2.py:39).  We keep scipy for exact behavioral parity
on the host (init runs once, off the hot path).  A copy of
modulatedgps_tpu/utils/kmeans.py.
"""
from __future__ import annotations

import numpy as np
from scipy.cluster.vq import kmeans

__all__ = ["kmeans_centers"]


def kmeans_centers(X: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    centers, _ = kmeans(np.asarray(X, dtype=np.float64), k, seed=seed)
    if centers.shape[0] < k:
        # scipy can return < k centers on degenerate data; pad with samples.
        rng = np.random.default_rng(seed)
        extra = X[rng.choice(X.shape[0], k - centers.shape[0], replace=False)]
        centers = np.concatenate([centers, extra], axis=0)
    return centers
