"""The mean-only entry into a layer's posterior, on the CPU.

``PrecomputedPosterior.predict_mean`` takes the same calls on the same
operands as ``predict_f``'s mean (K(Z, X), then K(Z, X)^T alpha, then the
mean function), so the two agree bit for bit in float32 and float64,
whitened or not, with or without a mean function and a leading batch
dimension.  ``SVGP.predict_mean`` is ``predict_f``'s mean.

``SMGP.predict_assign`` (and an ``SMGPModified``'s, which inherits it)
reads only the assignment layer's mean, so a model folded by
``precompute_smgp`` serves the softmax of ``predict_mean``: bit for bit
the softmax of the full cached marginal's mean, and ``predict_density``
bit for bit its own value with ``predict_assign`` served so.  The cached
and the training-path models agree at rtol 1e-9 in float64, the
tolerance that tests/test_torch_serving.py and
tests/test_torch_smgp_modified.py hold both routes to against the JAX
package.

The models are served under ``torch.no_grad()``: the Gauss-Hermite nodes a
MultiClass likelihood caches on first use would otherwise be inference
tensors, which a later test's autograd cannot save.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.models import PrecomputedPosterior
from modulatedgps_tpu_torch.utils import profiling

M, K, D, N, B = 16, 3, 2, 20, 2
RTOL = 1e-9
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _layer(g, dtype, *, whiten=True, mean=False, variance=0.5,
           lengthscale=0.7):
    """An SVGP at a perturbed state: q_mu ~ 0.5 N(0, 1), q_sqrt = I + 0.05
    tril(N(0, 1)) with a positive diagonal."""
    kw = dict(dtype=dtype, device="cpu")
    mean_function = (pt.mean_functions.Linear.create(
        0.3 * torch.randn((D, K), generator=g), 0.1, **kw) if mean else None)
    layer = pt.SVGP.create(
        pt.SquaredExponential.create(variance, lengthscale, **kw),
        torch.randn((M, D), generator=g), K, whiten=whiten,
        mean_function=mean_function, jitter=1e-4, **kw)
    q_sqrt = torch.eye(M) + 0.05 * torch.tril(torch.randn((K, M, M),
                                                          generator=g))
    idx = torch.arange(M)
    q_sqrt[:, idx, idx] = q_sqrt[:, idx, idx].abs()
    with torch.no_grad():
        layer.q_mu.raw.copy_(0.5 * torch.randn((M, K), generator=g))
        layer.q_sqrt.raw.copy_(q_sqrt)
    return layer


def _inputs(g, dtype, batch=False):
    shape = (B, N, D) if batch else (N, D)
    return (torch.rand(shape, generator=g) * 6 - 3).to(dtype)


@pytest.mark.parametrize("batch", [False, True], ids=["NxD", "BxNxD"])
@pytest.mark.parametrize("mean", [False, True], ids=["zero", "linear"])
@pytest.mark.parametrize("whiten", [True, False], ids=["white", "unwhite"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_cached_predict_mean_is_predict_f_mean(dtype, whiten, mean, batch):
    g = torch.Generator().manual_seed(0)
    layer = _layer(g, DTYPES[dtype], whiten=whiten, mean=mean)
    X = _inputs(g, DTYPES[dtype], batch)
    with torch.no_grad():
        cached = pt.precompute_posterior(layer)
        got = cached.predict_mean(X)
        want, _ = cached.predict_f(X)
    assert got.shape == want.shape == (*X.shape[:-1], K)
    assert got.dtype == DTYPES[dtype]
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch", [False, True], ids=["NxD", "BxNxD"])
@pytest.mark.parametrize("whiten", [True, False], ids=["white", "unwhite"])
def test_svgp_predict_mean_is_predict_f_mean(whiten, batch):
    g = torch.Generator().manual_seed(1)
    layer = _layer(g, torch.float64, whiten=whiten, mean=True)
    X = _inputs(g, torch.float64, batch)
    with torch.no_grad():
        got = layer.predict_mean(X)
        want, _ = layer.predict_f(X)
        split, _ = layer.predict_f(X, split=True)
    assert got.shape == (*X.shape[:-1], K)
    assert torch.equal(got, want) and torch.equal(got, split)


def _model(kind, dtype, seed=2):
    g = torch.Generator().manual_seed(seed)
    pred = _layer(g, dtype, variance=0.5, lengthscale=0.5)
    assign = _layer(g, dtype, variance=0.1, lengthscale=1.0)
    kw = dict(dtype=dtype, device="cpu")
    if kind == "smgp":
        model = pt.SMGP(pt.Gaussian.create(0.5, D=K, **kw), pred, assign,
                        K=K, num_samples=4, num_data=100)
        Y = torch.randn((N, 1), generator=g).to(dtype)
    else:
        model = pt.SMGPModified(pt.MultiClass.create(K), pred, assign,
                                assign_likelihood=pt.Gaussian.create(
                                    0.5, D=K, **kw),
                                K=K, num_samples=4, num_data=100)
        Y = torch.randint(0, K, (N, 1), generator=g).to(dtype)
    return model, _inputs(g, dtype), Y


MODELS = [("smgp", "f32"), ("smgp", "f64"), ("smgpmod", "f32"),
          ("smgpmod", "f64")]


def _served(kind, dtype):
    model, X, Y = _model(kind, DTYPES[dtype])
    with torch.no_grad():
        served = pt.precompute_smgp(model)
    assert type(served) is type(model)
    assert isinstance(served.assign_layer, PrecomputedPosterior)
    return model, served, X, Y


@pytest.mark.parametrize("kind,dtype", MODELS)
def test_served_predict_assign_is_softmax_of_the_full_mean(kind, dtype):
    _, served, X, _ = _served(kind, dtype)
    with torch.no_grad():
        got = served.predict_assign(X)
        amu, _ = served.assign_layer.predict_f(X)
        want = torch.softmax(amu, dim=-1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind,dtype", MODELS)
def test_served_predict_density_is_the_full_marginal_composition(kind,
                                                                 dtype):
    _, served, X, Y = _served(kind, dtype)
    with torch.no_grad():
        got = served.predict_density(X, Y)
        # the composition on the full marginal: predict_assign served as the
        # softmax of the assignment layer's predict_f mean
        served.predict_assign = lambda X: torch.softmax(
            served.assign_layer.predict_f(X)[0], dim=-1)
        want = served.predict_density(X, Y)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["smgp", "smgpmod"])
def test_served_predict_assign_matches_the_training_route(kind):
    model, served, X, Y = _served(kind, "f64")
    with torch.no_grad():
        amu, _ = model._marginals(model.assign_layer, X)
        for got, want in ((served.predict_assign(X), model.predict_assign(X)),
                          (model.predict_assign(X),
                           torch.softmax(amu, dim=-1)),
                          (served.predict_density(X, Y),
                           model.predict_density(X, Y))):
            torch.testing.assert_close(got, want, rtol=RTOL,
                                       atol=RTOL * want.abs().max().item())


def test_served_predict_assign_runs_the_mean_alone():
    """Under the profiler a cached predict_assign records one
    mgp.posterior.predict_mean and no mgp.posterior.predict_f."""
    _, served, X, _ = _served("smgp", "f32")
    profiling.reset_spans()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        served.predict_assign(X)
    table = profiling.span_table()
    profiling.reset_spans()
    assert table["mgp.posterior.predict_mean"]["calls"] == 1
    assert "mgp.posterior.predict_f" not in table
