"""Dataset loaders — behavioral parity with reference utils/dataset_utils.py.

Each loader returns (N, Xtrain, Ytrain, Xtest[, attrs]) with the same
generating processes, split ratios and filters as the reference (cited per
function).  All synthetic loaders take an explicit numpy Generator;
``load_toy_data_assoc`` additionally takes one (the reference version uses
unseeded global numpy — dataset_utils.py:117-125 — which SURVEY.md §4 flags
as non-reproducible; we fix that while keeping the same distribution).

A copy of modulatedgps_tpu/data/datasets.py: the same generators, draws
and filters, bit for bit (tests/test_torch_data_utils.py).  The John Doe
loaders read the CSV with the csv module and split it with numpy in
scikit-learn's order, so they need neither pandas nor scikit-learn.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = [
    "load_toy_multimodal_data",
    "load_toy_data_categorical",
    "load_toy_data_assoc",
    "load_toy_2d_data",
    "load_toy_2d_data_categorical",
    "load_john_doe_runs",
    "load_john_doe",
]

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "data")


def load_toy_multimodal_data(rng: np.random.Generator):
    """Three overlapping 1-D functions (sin; sin − Gaussian bump; linear+sin)
    — reference utils/dataset_utils.py:100-114."""
    N, Ns = 1500, 100
    epsilon = rng.normal(0, 0.1, (N // 3, 1))
    Xtrain = rng.uniform(low=-2 * np.pi, high=2 * np.pi, size=(N, 1))
    Y1 = np.sin(Xtrain[0:N // 3]) + epsilon
    Y2 = (np.sin(Xtrain[N // 3:2 * N // 3])
          - 2 * np.exp(-0.5 * (Xtrain[N // 3:2 * N // 3] - 2) ** 2) + epsilon)
    Y3 = (-2 - (3 / (8 * np.pi)) * Xtrain[2 * N // 3:N]
          + (3 / 10) * np.sin(2 * Xtrain[2 * N // 3:N]) + epsilon)
    Ytrain = np.concatenate((Y1, Y2, Y3))
    Xtest = np.linspace(-2 * np.pi, 2 * np.pi, Ns)[:, None]
    return N, Xtrain, Ytrain, Xtest


def load_toy_data_categorical(rng: np.random.Generator):
    """1-D step function with 10% label flips — dataset_utils.py:84-97."""
    N, Ns, lambda_ = 500, 100, 0.1
    Xtrain = rng.uniform(low=-6.0, high=6.0, size=(N, 1))
    Ytrain = np.where(Xtrain < 0.0, 1, 0)
    flips = rng.choice(N, size=int(N * lambda_), replace=False)
    Ytrain[flips] = 1 - Ytrain[flips]
    Xtest = np.linspace(-6.0, 6.0, Ns).reshape(Ns, 1)
    return N, Xtrain, Ytrain, Xtest


def load_toy_data_assoc(rng: np.random.Generator | None = None):
    """Signal + 40% uniform outliers — dataset_utils.py:117-125 (seeded here)."""
    rng = rng or np.random.default_rng()
    N, Ns, lambda_ = 500, 100, 0.4
    delta = rng.binomial(1, lambda_, size=(N, 1))
    noise = rng.standard_normal((N, 1)) * 0.15
    epsilon = rng.uniform(low=-1.0, high=3.0, size=(N, 1))
    Xtrain = rng.uniform(low=-3.0, high=3.0, size=(N, 1))
    Ytrain = ((1.0 - delta)
              * (np.cos(0.5 * np.pi * Xtrain) * np.exp(-0.25 * Xtrain ** 2) + noise)
              + delta * epsilon)
    Xtest = np.linspace(-3, 3, Ns)[:, None]
    return N, Xtrain, Ytrain, Xtest


def load_toy_2d_data(rng: np.random.Generator):
    """Two radial sheets offset by 10 — dataset_utils.py:128-146."""
    N, Ns = 500, 100
    Xtrain = rng.uniform(low=[-12.0, -12.0], high=[12.0, 12.0], size=(N, 2))
    radial = np.sqrt((Xtrain[:, 0] - 0.5) ** 2 + (Xtrain[:, 1] - 0.5) ** 2)
    radial2 = radial + 10.0
    Ytrain = np.concatenate((radial[0:N // 2], radial2[N // 2:N])).reshape((N, 1))
    Xtest = np.linspace([-12.0, -12.0], [12.0, 12.0], Ns)
    return N, Xtrain, Ytrain, Xtest


def load_toy_2d_data_categorical(rng: np.random.Generator):
    """Quadrant indicator with 10% flips — dataset_utils.py:149-165."""
    N, Ns, lambda_ = 500, 100, 0.1
    Xtrain = rng.uniform(low=[-6.0, -6.0], high=[6.0, 6.0], size=(N, 2))
    Ytrain = np.where((Xtrain[:, 0] < 0) & (Xtrain[:, 1] < 0), 1, 0)
    flips = rng.choice(N, size=int(N * lambda_), replace=False)
    Ytrain[flips] = 1 - Ytrain[flips]
    Ytrain = Ytrain.reshape((N, 1))
    Xtest = np.linspace([-6.0, -6.0], [6.0, 6.0], Ns)
    return N, Xtrain, Ytrain, Xtest


# --------------------------------------------------------------- John Doe CSV

_SEAM = ("FAST_SEAM", "MEDIUM_SEAM", "SEAM")
_FEATURES = ["stumpsX", "stumpsY"]


def _john_doe_columns(csv_path: str | None):
    """The John Doe filter (batterRuns in {0, 1, 4, 6}, seam bowling,
    right-arm) read with the csv module: (features [N, 2] float64,
    batterRuns [N] int64), the rows and values pandas.read_csv gives."""
    import csv
    path = csv_path or os.path.join(_DATA_DIR, "john_doe_dataset.csv")
    feats, runs = [], []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            r = int(row["batterRuns"])
            if (r in (0, 1, 4, 6) and row["bowlingStyle"] in _SEAM
                    and row["rightArmedBowl"] == "True"):
                feats.append([float(row[c]) for c in _FEATURES])
                runs.append(r)
    return np.array(feats, dtype=np.float64), np.array(runs, dtype=np.int64)


def load_john_doe_arrays_native(csv_path: str | None = None):
    """The John Doe filter pipeline through the native CSV engine
    (native/mgp_loader.cpp): the same rows as _john_doe_columns.
    Returns (features [N, 2], batterRuns [N, 1])."""
    from . import native
    path = csv_path or os.path.join(_DATA_DIR, "john_doe_dataset.csv")
    csv = native.NativeCsv(path)
    cols = csv.read_columns(_FEATURES + ["batterRuns"])
    runs = cols[:, 2]
    keep = np.isin(runs, (0, 1, 4, 6))
    keep &= csv.match_column("bowlingStyle", list(_SEAM))
    keep &= csv.match_column("rightArmedBowl", ["True"])
    csv.close()
    return cols[keep][:, :2], runs[keep].reshape(-1, 1)


def _split(features, targets, rng: np.random.Generator | None, test_size=0.2):
    """scikit-learn's train_test_split(test_size, random_state=seed) with
    the seed drawn from rng, as numpy: ShuffleSplit's permutation of a
    RandomState(seed), the first ceil(test_size N) rows the test set."""
    seed = None if rng is None else int(rng.integers(0, 2 ** 31 - 1))
    n = len(targets)
    n_test = int(np.ceil(test_size * n))
    perm = np.random.RandomState(seed).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return (features[train], features[test], targets[train].reshape(-1, 1),
            targets[test].reshape(-1, 1))


def load_john_doe_runs(csv_path: str | None = None,
                       rng: np.random.Generator | None = None):
    """Cricket deliveries → (stumpsX, stumpsY) → batterRuns ∈ {0,1,4,6};
    seam bowling, right-arm only; 80/20 split — dataset_utils.py:8-37."""
    feats, runs = _john_doe_columns(csv_path)
    Xtr, Xte, Ytr, _ = _split(feats, runs, rng)
    return len(Xtr), Xtr, Ytr, Xte, _FEATURES


def load_john_doe(csv_path: str | None = None,
                  rng: np.random.Generator | None = None):
    """Binary boundary target: {0,1}→0, {4,6}→1 — dataset_utils.py:40-81."""
    feats, runs = _john_doe_columns(csv_path)
    Xtr, Xte, Ytr, _ = _split(feats, (runs >= 4).astype(np.int64), rng)
    return len(Xtr), Xtr, Ytr, Xte, _FEATURES
