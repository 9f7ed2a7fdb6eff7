"""The port's other covariance functions and the mean functions against the
JAX package, on the CPU at float64.

Matern12, Matern52, White, Constant, Sum and Product (with
SquaredExponential and Matern32, which run kxz's plain version here, inside
them): K(X, X2), K(X), K_diag and the gradients of a weighted sum of
K(X, X2) with respect to X, X2 and every raw leaf, against jax.grad.  The
port's kernels are built with the same constructors and loaded through
load_numpy_ from jax.tree_util.tree_flatten_with_path, which also holds the
parameter names (``kernels.0.variance.raw``) to the JAX pytree paths.
Zero, Constant and Linear mean functions likewise.

Tolerance: rtol 1e-9, atol 1e-9 of each output's largest magnitude.
Gradients are taken of the cross-covariance K(X, X2) at distinct points:
at r = 0 (the diagonal of K(X)) the Matern forms' derivative in r is
singular and both packages' autodiff give rounding noise there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import kernels as jk
from modulatedgps_tpu.ops import mean_functions as jmf

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.ops import kernels as tk
from modulatedgps_tpu_torch.ops import mean_functions as tmf

RTOL = 1e-9
N, M, D = 7, 5, 3
F64 = dict(dtype=torch.float64, device="cpu")


def _leaves(tree):
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, what="", atol_frac=RTOL):
    want = np.asarray(want)
    # an input nothing depends on has no gradient in torch, zeros in JAX
    got = np.zeros_like(want) if got is None else got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = atol_frac * max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _perturb(tree, rng):
    """Every raw leaf moved by 0.3 N(0, 1), so no two leaves are equal."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(
        treedef, [leaf + 0.3 * rng.normal(size=np.shape(leaf))
                  for leaf in leaves])


# (name, JAX kernel, the port's skeleton), each built the same way
def _pairs():
    ard = np.array([0.7, 1.3, 2.0])
    return [
        ("matern12", jk.Matern12.create(1.3, 0.8),
         tk.Matern12.create(1.3, 0.8, **F64)),
        ("matern52_ard", jk.Matern52.create(0.9, ard),
         tk.Matern52.create(0.9, ard, **F64)),
        ("white", jk.White.create(0.01), tk.White.create(0.01, **F64)),
        ("constant", jk.Constant.create(0.4), tk.Constant.create(0.4, **F64)),
        ("sum_matern32_white",
         jk.Sum(kernels=(jk.Matern32.create(1.0, 1.0), jk.White.create(0.01))),
         tk.Sum([tk.Matern32.create(1.0, 1.0, **F64),
                 tk.White.create(0.01, **F64)])),
        ("product_se_matern52",
         jk.Product(kernels=(jk.SquaredExponential.create(0.5, ard),
                             jk.Matern52.create(1.2, 0.6))),
         tk.Product([tk.SquaredExponential.create(0.5, ard, **F64),
                     tk.Matern52.create(1.2, 0.6, **F64)])),
        ("nested", jk.Matern12.create(0.8, 1.1) * jk.Constant.create(2.0)
         + jk.White.create(0.05),
         tk.Matern12.create(0.8, 1.1, **F64) * tk.Constant.create(2.0, **F64)
         + tk.White.create(0.05, **F64)),
    ]


PAIRS = [name for name, _, _ in _pairs()]


def _matched(name, rng):
    jkern, tkern = next((j, t) for n, j, t in _pairs() if n == name)
    jkern = _perturb(jkern, rng)
    pt.load_numpy_(tkern, _leaves(jkern))
    return jkern, tkern


@pytest.mark.parametrize("name", PAIRS)
def test_kernel_values_match_jax(rng, name):
    jkern, tkern = _matched(name, rng)
    X, X2 = rng.normal(size=(N, D)), rng.normal(size=(M, D))
    T = lambda a: torch.tensor(a, dtype=torch.float64)
    _close(tkern.K(T(X), T(X2)), jkern.K(jnp.asarray(X), jnp.asarray(X2)),
           "K(X, X2)")
    _close(tkern.K(T(X)), jkern.K(jnp.asarray(X)), "K(X)")
    _close(tkern(T(X), full_cov=False), jkern(jnp.asarray(X), full_cov=False),
           "K_diag")
    if "se" not in name and "matern32" not in name:
        # batched inputs [B, N, D] (kxz's kernels take [N, D]; SVGP flattens).
        # On K(Xb)'s diagonal a Matern12's r is the square root of the
        # expansion's rounding (~1e-8): atol 1e-7 of the largest entry there.
        Xb = rng.normal(size=(2, N, D))
        got, want = tkern.K(T(Xb)), np.asarray(jkern.K(jnp.asarray(Xb)))
        off = ~np.eye(N, dtype=bool)
        _close(got[:, off], want[:, off], "K(Xb) off the diagonal")
        _close(torch.diagonal(got, dim1=-2, dim2=-1),
               np.diagonal(want, axis1=-2, axis2=-1), "K(Xb) diagonal", 1e-7)
        _close(tkern.K_diag(T(Xb)), jkern.K_diag(jnp.asarray(Xb)), "K_diag(Xb)")


@pytest.mark.parametrize("name", PAIRS)
def test_kernel_gradients_match_jax_grad(rng, name):
    jkern, tkern = _matched(name, rng)
    X, X2 = rng.normal(size=(N, D)), rng.normal(size=(M, D))
    W, Wd = rng.normal(size=(N, M)), rng.normal(size=(N,))

    def jloss(kern, a, b):
        return jnp.sum(kern.K(a, b) * W) + jnp.sum(kern.K_diag(a) * Wd)

    gk, gx, gx2 = jax.grad(jloss, (0, 1, 2))(jkern, jnp.asarray(X),
                                             jnp.asarray(X2))
    tx = torch.tensor(X, requires_grad=True)
    tx2 = torch.tensor(X2, requires_grad=True)
    ((tkern.K(tx, tx2) * torch.tensor(W)).sum()
     + (tkern.K_diag(tx) * torch.tensor(Wd)).sum()).backward()
    want = _leaves(gk)
    got = dict(tkern.named_parameters())
    assert sorted(got) == sorted(want)
    for key, p in got.items():
        _close(p.grad, want[key], key)
    _close(tx.grad, gx, "X")
    _close(tx2.grad, gx2, "X2")


def test_square_distance_matches_jax(rng):
    X, X2 = rng.normal(size=(2, N, D)), rng.normal(size=(2, M, D))
    T = lambda a: torch.tensor(a, dtype=torch.float64)
    _close(tk.square_distance(T(X), T(X2)),
           jk.square_distance(jnp.asarray(X), jnp.asarray(X2)), "X, X2")
    _close(tk.square_distance(T(X), None),
           jk.square_distance(jnp.asarray(X), None), "X")


def test_sum_and_product_parameter_names_are_the_jax_paths():
    kern = tk.Sum([tk.Matern32.create(**F64), tk.White.create(**F64)])
    jkern = jk.Sum(kernels=(jk.Matern32.create(), jk.White.create()))
    assert sorted(n for n, _ in kern.named_parameters()) == sorted(
        _leaves(jkern))
    assert [n for n, _ in kern.named_parameters()][0] == \
        "kernels.0.variance.raw"
    with pytest.raises(ValueError, match="missing"):
        pt.load_numpy_(kern, {"kernels.0.variance.raw": np.zeros(())})


def _means(name):
    A = np.arange(D * 3.0).reshape(D, 3) / 7
    return {
        "zero": lambda: (jmf.Zero(), tmf.Zero()),
        "constant": lambda: (
            jmf.Constant.create([0.3, -1.0, 2.0], output_dim=3),
            tmf.Constant.create([0.3, -1.0, 2.0], output_dim=3, **F64)),
        "linear": lambda: (jmf.Linear.create(A, 0.5),
                           tmf.Linear.create(A, 0.5, **F64)),
    }[name]()


@pytest.mark.parametrize("name", ["zero", "constant", "linear"])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_mean_functions_match_jax(rng, name, lead):
    jmean, tmean = _means(name)
    jmean = _perturb(jmean, rng)
    pt.load_numpy_(tmean, _leaves(jmean))
    X = rng.normal(size=(*lead, N, D))
    W = rng.normal(size=(*lead, N, 3))
    _close(tmean(torch.tensor(X)), jmean(jnp.asarray(X)), "m(X)")
    gm, gx = jax.grad(lambda m, x: jnp.sum(m(x) * W), (0, 1))(
        jmean, jnp.asarray(X))
    tx = torch.tensor(X, requires_grad=True)
    out = tmean(tx)
    if out.requires_grad:
        (out * torch.tensor(W)).sum().backward()
    want = _leaves(gm)
    for key, p in tmean.named_parameters():
        _close(p.grad, want[key], key)
    _close(tx.grad, gx, "X")
