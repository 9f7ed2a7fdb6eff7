"""The banded Cholesky-pullback products and whiten_solve of
modulatedgps_tpu_torch against the JAX package.

The port's tri_tt_matmul / tri_nt_matmul on CPU tensors run their plain
versions: the same 3-pass bf16 split with fp32 accumulation that
pallas_trimm._dot3 computes.  They are held against pallas_trimm with
interpret=True at M=768 (BM 256, 3 block rows), as tests/test_pallas_trimm.py
runs it, with non-zero garbage above the diagonal of every triangular
operand.  Tolerances are that suite's: 2e-3 (rtol, and atol as a fraction
of the largest magnitude) for the products, 5e-3 for the pullback.
whiten_solve's gradients are held at f64 against JAX autodiff of the
unfused chain (cholesky, triangular solve) at rtol 1e-9: both are exact
pullbacks of the same function and differ only in rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import pallas_trimm as ptm

from modulatedgps_tpu_torch.ops import linalg, trimm_kernel as tk

M = 768


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(0)
    A0 = rng.normal(size=(M, M))
    L = np.linalg.cholesky(A0 @ A0.T / M + 2.0 * np.eye(M))
    Linv = np.linalg.inv(L)
    Lbar = np.tril(rng.normal(size=(M, M)))
    garbage = np.triu(rng.normal(size=(M, M)), 1)
    f32 = lambda a: a.astype(np.float32)
    return {"L": f32(L + garbage), "Linv": f32(Linv + garbage),
            "Lbar": f32(Lbar + garbage), "S": f32(rng.normal(size=(M, M))),
            "L_clean": f32(L), "Linv_clean": f32(Linv), "Lbar_clean": f32(Lbar)}


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("tril_out", [False, True])
def test_tri_tt_matches_pallas_interpret(mats, tril_out):
    want = ptm.tri_tt_matmul(jnp.asarray(mats["L"]), jnp.asarray(mats["Lbar"]),
                             tril_out=tril_out, interpret=True)
    got = tk.tri_tt_matmul(torch.as_tensor(mats["L"]),
                           torch.as_tensor(mats["Lbar"]),
                           tril_out=tril_out).numpy()
    if tril_out:     # JAX leaves the strictly-upper blocks unwritten
        il = np.tril_indices(M)
        _close(got[il], np.asarray(want)[il], 2e-3)
        assert not np.triu(got, 1).any()
    else:
        _close(got, want, 2e-3)


def test_tri_nt_matches_pallas_interpret(mats):
    want = ptm.tri_nt_matmul(jnp.asarray(mats["S"]), jnp.asarray(mats["Linv"]),
                             interpret=True)
    got = tk.tri_nt_matmul(torch.as_tensor(mats["S"]),
                           torch.as_tensor(mats["Linv"])).numpy()
    _close(got, want, 2e-3)


def test_three_pass_split_keeps_the_low_part(mats):
    """The split's lo part is non-zero and carries the product to the HIGH
    class: against the f64 product, the 3-pass error is far below one bf16
    pass."""
    A, B = mats["S"], mats["Linv_clean"]
    At = torch.as_tensor(A)
    hi, lo = tk.split_bf16(At)
    assert lo.float().abs().max() > 0
    assert ((hi.float() + lo.float() - At).abs() <= 2 ** -16 * At.abs()).all()
    exact = A.astype(np.float64) @ B.astype(np.float64)
    got = tk.tri_nt_matmul(torch.as_tensor(A), torch.as_tensor(B)).double()
    one = (torch.as_tensor(A).bfloat16().double()
           @ torch.as_tensor(B).bfloat16().double())
    err3 = np.abs(got.numpy() - exact).max()
    err1 = np.abs(one.numpy() - exact).max()
    assert err3 < err1 / 50, (err3, err1)


def test_chol_pullback_matches_pallas_and_dense(mats):
    args = [mats[k] for k in ("L", "Linv", "Lbar")]
    want = ptm.chol_pullback_structured(*map(jnp.asarray, args),
                                        interpret=True)
    got = tk.chol_pullback_structured(*map(torch.as_tensor, args)).numpy()
    _close(got, want, 5e-3)
    np.testing.assert_array_equal(got, got.T)
    clean = [torch.as_tensor(mats[k]).double()
             for k in ("L_clean", "Linv_clean", "Lbar_clean")]
    _close(got, tk.chol_pullback_dense(*clean).numpy(), 5e-3)
    dense_jax = ptm.chol_pullback_dense(*(jnp.asarray(c.numpy()) for c in clean),
                                        jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(tk.chol_pullback_dense(*clean).numpy(),
                               np.asarray(dense_jax), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(dense_jax)).max())


def test_whiten_solve_gradients_match_jax_unfused_f64():
    rng = np.random.default_rng(2)
    Mw, Nw = 96, 40
    A0 = rng.normal(size=(Mw, Mw))
    Kmm = A0 @ A0.T / Mw + 0.5 * np.eye(Mw)
    Kmn = rng.normal(size=(Mw, Nw))
    w = rng.normal(size=(Mw, Nw))

    def jloss(Kmm, Kmn):
        L = jnp.linalg.cholesky(Kmm)
        A = jax.scipy.linalg.solve_triangular(L, Kmn, lower=True)
        return jnp.sum(jnp.asarray(w) * A)

    want = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(Kmm),
                                                     jnp.asarray(Kmn))
    Kt = torch.tensor(Kmm, requires_grad=True)
    Kn = torch.tensor(Kmn, requires_grad=True)
    loss = (torch.as_tensor(w) * linalg.whiten_solve(Kt, Kn)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want[0]), rtol=1e-9)
    for got, ref in ((Kt.grad, want[1][0]), (Kn.grad, want[1][1])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max())


def test_trimm_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tk.tri_tt_matmul(torch.zeros(4, 3), torch.zeros(4, 3), tril_out=True)
    with pytest.raises(ValueError):
        tk.tri_nt_matmul(torch.zeros(4, 4), torch.zeros(5, 5))
