"""The gradient of the joint posterior in modulatedgps_tpu_torch against the
JAX package: atl_matmul's backward (kernels #6/#7, their plain versions
here), and the gradients of predict_f(full_cov=True) and
predict_f_samples with fixed noise.

Tolerances:
- atl_matmul's gradients against pallas_tril.atl_matmul's custom VJP run
  in interpret mode (K=3, M=768 in three 256-row blocks, N=300 padded to
  the kernel's 1024): both cast the cotangent to bf16 once and sum exact
  bf16 products in f32, in other orders; an element of the f32 cotangent
  that lands on the other side of a bf16 rounding boundary moves its
  products by 2^-8 relative, so rtol and atol are 1e-3 of the largest
  magnitude (the JAX suite holds the kernels to 3e-2 against an f32
  product, tests/test_pallas_tril.py:64-86).
- f64 gradients against JAX autodiff: rtol 1e-7, atol 1e-7 of each
  gradient's largest magnitude.  Both differentiate the same formulas; the
  Cholesky of each [N, N] covariance plus 1e-6 I (the draws' jitter)
  magnifies summation-order differences beyond test_torch_train.py's 1e-9.
- The f32 route's gradients (bf16 operands) against JAX's conditional
  forced onto its Pallas kernels in interpret mode: 5e-3 of the largest
  magnitude.  The two round A to bf16 from differently formed f32 values
  and take the Cholesky pullback at other precisions (JAX's HIGH matmuls,
  the port's 3-pass split); the port's f32 gradients lie up to 3.1e-3 of
  the maximum from f64 at this size (Z and q_sqrt), and the two routes
  part by up to 1.5e-3 (Z).
"""
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.models import SVGP as JSVGP
from modulatedgps_tpu.models import svgp as jsvgp_module
from modulatedgps_tpu.ops import pallas_tril as ptl
from modulatedgps_tpu.ops.kernels import SquaredExponential as JSE

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.ops import tril_kernel
from modulatedgps_tpu_torch.params import Parameter

M, K, D, N, S = 48, 3, 2, 40, 4


def _interp(fn):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with mock.patch.object(ptl.pl, "pallas_call", patched):
            return fn(*a, **kw)
    return wrapper


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_atl_matmul_grads_match_pallas_interpret():
    rng = np.random.default_rng(0)
    L = rng.normal(size=(3, 768, 768)).astype(np.float32)   # upper garbage
    A = (rng.normal(size=(768, 300)) / np.sqrt(768)).astype(np.float32)

    def jloss(A_, L_):
        B = ptl.atl_matmul(A_, L_)
        return jnp.sum(jnp.square(B) * jnp.cos(0.1 * B))

    dA_j, dL_j = _interp(lambda: jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(A), jnp.asarray(L)))()
    At = torch.tensor(A, requires_grad=True)
    Lt = torch.tensor(L, requires_grad=True)
    B = tril_kernel.atl_matmul(At, Lt)
    (B.square() * torch.cos(0.1 * B)).sum().backward()
    assert At.grad.dtype == Lt.grad.dtype == torch.float32
    _close(At.grad.numpy(), dA_j, 1e-3)
    _close(Lt.grad.numpy(), dL_j, 1e-3)
    assert not torch.triu(Lt.grad, 1).any()


def test_tril_dl_da_plain_versions():
    """tril_dl / tril_da against their definitions over the lower triangle
    (exact bf16 products, f64 sums); the square-sum's scaled pair is the
    same function of W = bf16(B16 G)."""
    g = torch.Generator().manual_seed(1)
    A16 = torch.randn(9, 5, generator=g).bfloat16()
    L16 = torch.randn(2, 9, 9, generator=g).bfloat16()   # upper garbage
    W16 = torch.randn(2, 5, 9, generator=g).bfloat16()
    a, l, w = A16.double(), torch.tril(L16.double()), W16.double()
    dL = torch.einsum("mn,knp->kmp", a, w)
    mask = torch.ones(9, 9).tril().bool()
    torch.testing.assert_close(tril_kernel.tril_dl(A16, W16).double(),
                               torch.where(mask, dL, 0.0), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(tril_kernel.tril_da(L16, W16).double(),
                               torch.einsum("kmp,knp->mn", l, w), rtol=1e-6,
                               atol=1e-6)
    B16 = torch.randn(2, 5, 9, generator=g).bfloat16()
    G = torch.randn(2, 5, generator=g)
    W = (B16.float() * G[:, :, None]).bfloat16()
    assert torch.equal(tril_kernel.tril_sq_dl(A16, B16, G),
                       tril_kernel.tril_dl(A16, W))
    assert torch.equal(tril_kernel.tril_sq_da(L16, B16, G),
                       tril_kernel.tril_da(L16, W))


def _jax_layer(rng):
    layer = JSVGP.create(JSE.create(0.5, 0.5), rng.normal(size=(M, D)),
                         num_latent_gps=K)
    q_mu = 0.5 * rng.normal(size=(M, K))
    q_sqrt = np.eye(M)[None] + 0.05 * np.tril(rng.normal(size=(K, M, M)))
    idx = np.arange(M)
    q_sqrt[:, idx, idx] = np.abs(q_sqrt[:, idx, idx])
    return layer.replace(q_mu=layer.q_mu.replace_raw(jnp.asarray(q_mu)),
                         q_sqrt=layer.q_sqrt.replace_raw(jnp.asarray(q_sqrt)))


def _port_layer(jl, dtype, jitter=None):
    leaves = jax.tree_util.tree_flatten_with_path(jl)[0]
    raw = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
           for p, v in leaves}
    t = lambda k: torch.tensor(raw[k], dtype=dtype)
    kern = pt.SquaredExponential(Parameter(t("kernel.variance.raw"), "positive"),
                                 Parameter(t("kernel.lengthscales.raw"),
                                           "positive"))
    return pt.SVGP(kern, Parameter(t("Z.raw")), Parameter(t("q_mu.raw")),
                   Parameter(t("q_sqrt.raw"), "tril"), jitter=jitter)


def _raw_grads(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in leaves}


@pytest.mark.parametrize("kind", ["cov", "samples"])
def test_joint_posterior_gradients_match_jax_f64(kind):
    """A seeded weighted sum of predict_f(full_cov=True)'s covariance and
    mean, or of predict_f_samples' joint draws with the port's z fed to
    JAX, differentiated to every raw leaf of the layer."""
    rng = np.random.default_rng(2)
    jl = _jax_layer(rng)
    X = rng.uniform(-3, 3, size=(N, D))
    wc = rng.normal(size=(K, N, N))
    wm = rng.normal(size=(N, K))
    wf = rng.normal(size=(S, N, K))
    z = torch.randn((S, K, N, 1), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)

    def jloss(layer):
        if kind == "cov":
            m, v = layer.predict_f(jnp.asarray(X), full_cov=True)
            return jnp.sum(wm * m) + jnp.sum(wc * v)
        f = layer.predict_f_samples(jax.random.PRNGKey(0), jnp.asarray(X), S)
        return jnp.sum(wf * f)

    with mock.patch.object(jsvgp_module.jax.random, "normal",
                           lambda key, shape_, dtype: jnp.asarray(z.numpy())):
        want_loss, jgrads = jax.value_and_grad(jloss)(jl)
    tl = _port_layer(jl, torch.float64)
    Xt = torch.as_tensor(X)
    if kind == "cov":
        m, v = tl.predict_f(Xt, full_cov=True)
        loss = (torch.as_tensor(wm) * m).sum() + (torch.as_tensor(wc) * v).sum()
    else:
        f = tl.predict_f_samples(torch.Generator().manual_seed(3), Xt, S)
        loss = (torch.as_tensor(wf) * f).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-9)
    want = _raw_grads(jgrads)
    got = {name: p.grad.numpy() for name, p in tl.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], 1e-7)
    assert not torch.triu(tl.q_sqrt.raw.grad, 1).any()


def test_f32_joint_covariance_gradient_matches_jax_bf16_route():
    """The f32 route's gradient (atl_matmul with #6/#7's plain versions)
    against JAX's conditional forced onto its tril Pallas kernels in
    interpret mode (BM=16 so that M=48 has several tril blocks), both at
    f32's jitter 1e-4."""
    rng = np.random.default_rng(4)
    jl = _jax_layer(rng)
    jl32 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32) if hasattr(a, "dtype") else a, jl)
    X = rng.uniform(-3, 3, size=(N, D)).astype(np.float32)
    wc = rng.normal(size=(K, N, N)).astype(np.float32)
    wm = rng.normal(size=(N, K)).astype(np.float32)

    def jloss(layer):
        m, v = layer.predict_f(jnp.asarray(X), full_cov=True)
        return jnp.sum(wm * m) + jnp.sum(wc * v)

    try:
        ptl.set_tril_dispatch(True)
        with mock.patch.object(ptl, "eligible", lambda M_, min_M=2048: True), \
                mock.patch("modulatedgps_tpu.ops.pallas_tril._block_m",
                           lambda M_: 16), \
                mock.patch.object(ptl, "_dl_pallas",
                                  wraps=ptl._dl_pallas) as dl:
            jgrads = _interp(lambda: jax.grad(jloss)(jl32))()
        assert dl.call_count == 1
    finally:
        ptl.set_tril_dispatch(None)
    tl = _port_layer(jl, torch.float32, jitter=1e-4)
    m, v = tl.predict_f(torch.as_tensor(X), full_cov=True)
    ((torch.as_tensor(wm) * m).sum() + (torch.as_tensor(wc) * v).sum()
     ).backward()
    want = _raw_grads(jgrads)
    for name, p in tl.named_parameters():
        _close(p.grad.numpy(), want[name], 5e-3)


def test_chip_smoke_joint_grad_phase_runs_on_cpu():
    """chip_smoke's path B at a tiny size on CPU tensors: a finite loss and
    finite gradients of every raw leaf; only the launch checks fail, as the
    counts stay 0 off the card."""
    import chip_smoke
    chip_smoke.failures.clear()
    try:
        counts = chip_smoke.phase_joint_grad(pt, dev="cpu", M=32, N=24, S=3)
        assert set(counts) == set(chip_smoke.JOINT_GRAD_KERNELS)
        assert not any(counts.values())
        assert len(chip_smoke.failures) == len(counts)
        assert all("launched 0 times" in f for f in chip_smoke.failures)
    finally:
        chip_smoke.failures.clear()


@functools.lru_cache(maxsize=None)
def _joint_ref(dtype, draws, fault=None):
    """chip_smoke's path B reference (M=1024, N=512) on the CPU, the draws'
    noise taken as phase 14 takes it; ``fault`` scales that kernel's plain
    version by 1.03."""
    import chip_smoke
    S_, N_ = chip_smoke.SAMPLE_DRAWS, chip_smoke.N_GRID_REF
    inputs = chip_smoke.joint_inputs(chip_smoke.M_REF, N_, S_)
    z = torch.randn((S_, chip_smoke.K_EXPERTS, N_, 1), dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0)).numpy()
    with pytest.MonkeyPatch.context() as mp:
        if fault is not None:
            plain = getattr(tril_kernel, fault)
            mp.setattr(tril_kernel, fault, lambda *a: 1.03 * plain(*a))
        return chip_smoke.joint_grads(pt, inputs, S_, "cpu", dtype, draws,
                                      z=z)


def _joint_errors(got, draws):
    import chip_smoke
    want = _joint_ref(torch.float64, draws)
    return {name: float((got[name] - want[name]).abs().max()
                        / want[name].abs().max())
            for name in chip_smoke.JOINT_GRAD_TOL["cov"]}


@pytest.mark.parametrize("terms", ["cov", "cov+draws"])
def test_f32_cpu_path_is_within_joint_grad_tol_of_f64(terms):
    """chip_smoke's phase 14 holds the card's f32 gradients of path B's
    losses to JOINT_GRAD_TOL of f64 (or JOINT_CPU_FACTOR times the f32 CPU
    path's distance); the port's f32 CPU path lies within the fixed
    entries on every leaf here."""
    import chip_smoke
    draws = terms == "cov+draws"
    errs = _joint_errors(_joint_ref(torch.float32, draws), draws)
    tols = chip_smoke.JOINT_GRAD_TOL[terms]
    assert all(err <= tols[n] for n, err in errs.items()), errs


@pytest.mark.parametrize("fault", ["tril_dl_plain", "tril_da_plain"])
def test_a_scaled_joint_backward_kernel_breaks_a_tolerance(fault):
    """Scaling the output of #6 or #7 by 1.03 moves a gradient of the
    covariance loss past phase 14's limit."""
    import chip_smoke
    clean = _joint_errors(_joint_ref(torch.float32, False), False)
    errs = _joint_errors(_joint_ref(torch.float32, False, fault), False)
    tols = chip_smoke.JOINT_GRAD_TOL["cov"]
    assert any(err > max(tols[n], chip_smoke.JOINT_CPU_FACTOR * clean[n])
               for n, err in errs.items()), errs
