"""The tril Adam of modulatedgps_tpu_torch (training/fused_adam.py, kernel
#14) and its routing in Adam, against the JAX package.

adam_tril_'s plain version is held against JAX's FusedAdam with its
Pallas kernel forced on and run in interpret mode (as
tests/test_training_infra.py runs it) over three f32 steps on a [2, 512,
512] leaf whose upper triangle is non-zero (the gradient is
lower-triangular), plus a small elementwise leaf.  Tolerance: rtol 1e-5,
atol 5e-7, the JAX suite's own for FusedAdam against optax.  The port
computes the bias corrections c1, c2 in Python double from the step count
and rounds them to f32 once; JAX computes them in f32 from an f32 count;
the two differ by at most an ulp.  The upper triangle of p keeps its bits
and m, v stay 0 there.  Adam sends exactly the "tril" Parameters through
adam_tril_, whatever the shapes of the other leaves.
"""
import importlib
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import torch

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.params import Parameter
from modulatedgps_tpu_torch.training import adam as tadam
from modulatedgps_tpu_torch.training import fused_adam

K, M, LR, STEPS = 2, 512, 1e-2, 3


def _jax_fused_steps(params, grads):
    fa = importlib.import_module("modulatedgps_tpu.training.fused_adam")
    opt = fa.FusedAdam(LR)
    state = opt.init(params)
    orig = fa.pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    old_min = fa._FUSED_MIN_DIM
    try:
        fa._FUSED_MIN_DIM = M
        fa.set_fused_dispatch(True)
        with mock.patch.object(fa.pl, "pallas_call", patched):
            assert fa._eligible(params["q"])
            for g in grads:
                params, state = opt.update_and_apply(g, state, params)
    finally:
        fa._FUSED_MIN_DIM = old_min
        fa.set_fused_dispatch(None)
    return params, state[0].mu, state[0].nu


def test_adam_tril_plain_matches_fused_adam_interpret():
    rng = np.random.default_rng(0)
    full = rng.normal(size=(K, M, M)).astype(np.float32)
    w = rng.normal(size=(7,)).astype(np.float32)
    grads = [{"q": np.tril(rng.normal(size=(K, M, M))).astype(np.float32),
              "w": rng.normal(size=(7,)).astype(np.float32)}
             for _ in range(STEPS)]
    jp, jm, jv = _jax_fused_steps(
        {"q": jnp.asarray(full), "w": jnp.asarray(w)},
        [{k: jnp.asarray(v) for k, v in g.items()} for g in grads])

    p, pw = torch.tensor(full), torch.tensor(w)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    mw, vw = torch.zeros_like(pw), torch.zeros_like(pw)
    for t, g in enumerate(grads, start=1):
        c1 = 1.0 / (1.0 - fused_adam.B1 ** t)
        c2 = 1.0 / (1.0 - fused_adam.B2 ** t)
        fused_adam.adam_tril_(p, torch.tensor(g["q"]), m, v, LR, c1, c2)
        pw, mw, vw = fused_adam.adam_update(pw, torch.tensor(g["w"]), mw, vw,
                                            LR, c1, c2)
    for got, want in ((p, jp["q"]), (m, jm["q"]), (v, jv["q"]),
                      (pw, jp["w"]), (mw, jm["w"]), (vw, jv["w"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=5e-7)
    assert torch.equal(torch.triu(p, 1), torch.triu(torch.tensor(full), 1))
    assert not torch.triu(m, 1).any() and not torch.triu(v, 1).any()


def test_adam_tril_plain_leaves_the_upper_triangle_bit_identical():
    """NaN above the diagonal of p, m and v survives a step unchanged and
    does not reach the lower triangle."""
    rng = np.random.default_rng(1)
    nan = torch.triu(torch.full((9, 9), float("nan")), 1)
    p, m, v = (torch.tensor(rng.normal(size=(2, 9, 9)), dtype=torch.float32)
               + nan for _ in range(3))
    v = v.abs()
    before = [t.clone() for t in (p, m, v)]
    fused_adam.adam_tril_(p, torch.tril(torch.randn(2, 9, 9)), m, v, LR,
                          10.0, 1000.0)
    for new, old in zip((p, m, v), before):
        assert torch.equal(torch.triu(new.view(torch.int32), 1),
                           torch.triu(old.view(torch.int32), 1))
        assert bool(torch.isfinite(torch.tril(new)).all())


def _small_smgp(dtype=torch.float32):
    rng = np.random.default_rng(2)
    layer = lambda: pt.SVGP.create(
        pt.SquaredExponential.create(0.5, 0.7, dtype=dtype, device="cpu"),
        rng.normal(size=(12, 2)), 2, dtype=dtype, device="cpu")
    return pt.SMGP(pt.Gaussian.create(0.5, D=2, dtype=dtype, device="cpu"),
                   layer(), layer(), K=2, num_samples=3, num_data=100)


def test_adam_routes_tril_parameters_by_transform():
    """Both q_sqrt leaves go through adam_tril_; a square rank-3 f32 leaf
    with another transform does not (tril-ness is the transform, not the
    shape, unlike the JAX package's _eligible)."""
    model = _small_smgp()
    model.extra = Parameter(torch.zeros(2, 12, 12))
    opt = pt.Adam(model, LR)
    assert [n for n, t in zip(opt.names, opt.tril) if t] == [
        "pred_layer.q_sqrt.raw", "assign_layer.q_sqrt.raw"]
    for p, tril in zip(opt.params, opt.tril):
        p.grad = torch.tril(torch.ones_like(p)) if tril else torch.ones_like(p)
    with mock.patch.object(tadam, "adam_tril_",
                           wraps=fused_adam.adam_tril_) as spy:
        opt.step()
    routed = {id(c.args[0]) for c in spy.call_args_list}
    assert routed == {id(model.pred_layer.q_sqrt.raw),
                      id(model.assign_layer.q_sqrt.raw)}
    assert float(model.extra.raw.detach().abs().min()) > 0   # elementwise
