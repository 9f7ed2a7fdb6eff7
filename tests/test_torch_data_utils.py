"""The port's data/ and utils/ against the JAX package's, on the CPU.

The loaders, the minibatch iterator, the native CSV reader and k-means are
host code copied from the JAX package (which the port may not import): each
must give the same bits from the same seed.  MetricsLogger writes the same
JSON lines on the same clock.  The evaluation metrics of a small float64
SMGP carried across with smgp_from_numpy agree to rel 1e-10.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu import data as jdata
from modulatedgps_tpu import utils as jutils
from modulatedgps_tpu.data import native as jnative
from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
from modulatedgps_tpu.models import SMGP as JSMGP
from modulatedgps_tpu.models import SVGP as JSVGP
from modulatedgps_tpu.ops import kernels as jk
from modulatedgps_tpu.utils import evaluation as jevaluation
from modulatedgps_tpu.utils import metrics as jmetrics

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch import data as pdata
from modulatedgps_tpu_torch import utils as putils
from modulatedgps_tpu_torch.data import native as pnative
from modulatedgps_tpu_torch.utils import evaluation as pevaluation
from modulatedgps_tpu_torch.utils import metrics as pmetrics

SYNTHETIC = ["load_toy_multimodal_data", "load_toy_data_categorical",
             "load_toy_data_assoc", "load_toy_2d_data",
             "load_toy_2d_data_categorical"]


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", SYNTHETIC)
def test_synthetic_loaders_are_bit_equal(name):
    _equal(getattr(pdata, name)(np.random.default_rng(3)),
           getattr(jdata, name)(np.random.default_rng(3)))


@pytest.mark.parametrize("name", ["load_john_doe_runs", "load_john_doe"])
def test_john_doe_loaders_are_bit_equal(name):
    _equal(getattr(pdata, name)(rng=np.random.default_rng(5)),
           getattr(jdata, name)(rng=np.random.default_rng(5)))


@pytest.fixture
def no_native(monkeypatch):
    """The port's native module as on a checkout without the built
    libmgploader.so."""
    monkeypatch.setattr(pnative, "_LIB_PATH", "/nonexistent/libmgploader.so")
    monkeypatch.setattr(pnative, "_lib", None)
    assert not pnative.available()


def test_john_doe_csv_loads_the_same_through_the_numpy_path(no_native):
    """The port's csv + numpy reader keeps pandas' rows and values."""
    from modulatedgps_tpu.data.datasets import _load_john_doe_frame as jframe
    from modulatedgps_tpu_torch.data.datasets import _john_doe_columns
    feats, runs = _john_doe_columns(None)
    want = jframe(None)[["stumpsX", "stumpsY", "batterRuns"]].to_numpy()
    np.testing.assert_array_equal(np.c_[feats, runs], want)
    assert runs.dtype == np.int64 and len(runs) > 100
    if jnative.available():   # the native reader keeps the same rows
        nfeats, nruns = jdata.datasets.load_john_doe_arrays_native()
        np.testing.assert_array_equal(nfeats, feats)
        np.testing.assert_array_equal(nruns[:, 0], runs)


def _batches(module, X, Y, n, **kw):
    it = module.minibatch_iterator(X, Y, 64, seed=7, **kw)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("use_native", [None, False])
def test_minibatch_iterator_yields_the_same_batches(use_native):
    rng = np.random.default_rng(0)
    X, Y = rng.normal(size=(300, 3)), rng.normal(size=(300, 1))
    _equal(_batches(pdata, X, Y, 12, use_native=use_native),
           _batches(jdata, X, Y, 12, use_native=use_native))


def test_minibatch_iterator_without_the_native_library(no_native):
    rng = np.random.default_rng(0)
    X, Y = rng.normal(size=(300, 3)), rng.normal(size=(300, 1))
    _equal(_batches(pdata, X, Y, 12), _batches(jdata, X, Y, 12,
                                               use_native=False))
    with pytest.raises(RuntimeError, match="not built"):
        next(pdata.minibatch_iterator(X, Y, 64, use_native=True))


def test_native_module_matches_when_built():
    assert pnative.available() == jnative.available()
    if not pnative.available():
        pytest.skip("native/libmgploader.so is not built (make -C native)")
    rng = np.random.default_rng(0)
    _equal(pdata.datasets.load_john_doe_arrays_native(),
           jdata.datasets.load_john_doe_arrays_native())
    src, idx = rng.normal(size=(50, 4)), rng.permutation(50)[:20]
    np.testing.assert_array_equal(pnative.gather_rows(src, idx),
                                  jnative.gather_rows(src, idx))
    np.testing.assert_array_equal(pnative.shuffle_epoch(3, 2, 40),
                                  jnative.shuffle_epoch(3, 2, 40))


def test_kmeans_centers_are_equal():
    X = np.random.default_rng(2).normal(size=(200, 2))
    np.testing.assert_array_equal(putils.kmeans_centers(X, 7, seed=4),
                                  jutils.kmeans_centers(X, 7, seed=4))


def test_metrics_logger_writes_the_same_lines(tmp_path, monkeypatch, capsys):
    paths = [tmp_path / "port.jsonl", tmp_path / "jax.jsonl"]
    for cls, path in zip((pmetrics.MetricsLogger, jmetrics.MetricsLogger),
                         paths):
        ticks = iter(np.arange(0.0, 10.0, 0.5))
        monkeypatch.setattr(pmetrics.time, "perf_counter", lambda: next(ticks))
        monkeypatch.setattr(jmetrics.time, "perf_counter", lambda: next(ticks))
        logger = cls(str(path))
        logger.log(5, elbo=-1.25, lr=5e-3)
        logger.log(10, elbo=-1.0)
        logger.close()
    port, jax_ = (p.read_text().splitlines() for p in paths)
    assert port == jax_ and len(port) == 2
    assert json.loads(port[1])["steps_per_sec"] == pytest.approx(10.0)
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] and len(out) == 4


M, K, D, N = 12, 3, 1, 40


@pytest.fixture(scope="module")
def smgps():
    """A float64 JAX SMGP at a perturbed state and the port's copy."""
    rng = np.random.default_rng(0)
    layers = []
    for var, ls in ((0.5, 0.5), (0.1, 1.0)):
        layer = JSVGP.create(jk.SquaredExponential.create(var, ls),
                             rng.uniform(-3, 3, size=(M, D)), num_latent_gps=K)
        q_sqrt = np.eye(M)[None] + 0.1 * np.tril(rng.normal(size=(K, M, M)))
        layers.append(layer.replace(
            q_mu=layer.q_mu.replace_raw(jnp.asarray(rng.normal(size=(M, K)))),
            q_sqrt=layer.q_sqrt.replace_raw(jnp.asarray(q_sqrt))))
    jm = JSMGP(likelihood=JGaussian.create(0.3, D=K), pred_layer=layers[0],
               assign_layer=layers[1], K=K, num_samples=4, num_data=N)
    arrays = {jax.tree_util.keystr(path, simple=True, separator="."):
              np.asarray(leaf) for path, leaf in
              jax.tree_util.tree_flatten_with_path(jm)[0]}
    pm = pt.smgp_from_numpy(arrays, K=K, num_samples=4, num_data=N,
                            temperature=1e-2, device="cpu",
                            dtype=torch.float64)
    X = rng.uniform(-3, 3, size=(N, D))
    Y = np.sin(X) + 0.1 * rng.normal(size=(N, 1))
    labels = rng.integers(0, K, size=N)
    return jm, pm, X, Y, labels


@pytest.mark.parametrize("metric", ["mixture_rmse", "mixture_nlpd",
                                    "assignment_accuracy"])
def test_evaluation_metrics_match_jax(smgps, metric):
    jm, pm, X, Y, labels = smgps
    third = labels if metric == "assignment_accuracy" else Y
    want = getattr(jevaluation, metric)(jm, jnp.asarray(X), jnp.asarray(third))
    got = getattr(pevaluation, metric)(pm, X, third)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-10)
    assert getattr(putils, metric) is getattr(pevaluation, metric)
