"""utils/profiling and utils/plotting of the port, on the CPU.

trace writes a trace file, flops_estimate counts a matmul as 2·M·N·K and
a kernel wrapper once (its plain version's aten ops hidden): at the
CostEstimate the JAX package hands pl.pallas_call for the same operands,
captured here, or where JAX takes no Pallas call at XLA's cost analysis of
the dense contraction it runs instead.  The
figure builders, given the same numpy inputs as the JAX package's, draw
the same lines and scatters; the SVGP helpers draw the same prediction
bands from the same state.
"""
import importlib
import json

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import modulatedgps_tpu_torch as pt  # noqa: E402
from modulatedgps_tpu import models as jmodels  # noqa: E402
from modulatedgps_tpu.ops.kernels import SquaredExponential as JSE  # noqa: E402
from modulatedgps_tpu.ops import pallas_kernels as pk  # noqa: E402
from modulatedgps_tpu.ops import pallas_kl as jkl  # noqa: E402
from modulatedgps_tpu.ops import pallas_linalg as jlinalg  # noqa: E402
from modulatedgps_tpu.ops import pallas_quad as jquad  # noqa: E402
from modulatedgps_tpu.ops import pallas_tril as jtril  # noqa: E402
from modulatedgps_tpu.ops import pallas_trimm as jtrimm  # noqa: E402
from modulatedgps_tpu.utils import plotting as jplotting  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

jadam = importlib.import_module("modulatedgps_tpu.training.fused_adam")
from modulatedgps_tpu_torch.ops import (chol_kernel, cost, kl_kernel,  # noqa: E402
                                        quad_kernel, tril_kernel, trimm_kernel,
                                        trsm_kernel)
from modulatedgps_tpu_torch.training import fused_adam  # noqa: E402
from modulatedgps_tpu_torch.utils import plotting, profiling  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU runs are many small ops: one intra-op thread keeps them
    from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.randn(32, 32) @ torch.randn(32, 32)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert data["traceEvents"]


def test_flops_of_a_matmul():
    a, b = torch.randn(8, 16), torch.randn(16, 5)
    assert profiling.flops_estimate(torch.matmul, a, b) == 2 * 8 * 16 * 5


def _spd(M, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(M, M, generator=g, dtype=torch.float64)
    return A @ A.T + M * torch.eye(M, dtype=torch.float64)


bf = torch.bfloat16
f32 = jnp.float32


def _pallas_flops(monkeypatch, call):
    """The flops of each CostEstimate the JAX package hands pl.pallas_call
    during ``call()``, in order; the Pallas kernels themselves do not run
    (each returns zeros of its out_shape)."""
    seen = []

    def fake(kernel, *, out_shape, cost_estimate=None, **_):
        seen.append(cost_estimate.flops)
        return lambda *a: jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), out_shape)

    monkeypatch.setattr(pl, "pallas_call", fake)
    call()
    return seen


def _xla_flops(f, *args):
    """XLA's cost analysis of jit(f) on the CPU."""
    c = jax.jit(f).lower(*args).compile().cost_analysis()
    return (c[0] if isinstance(c, list) else c)["flops"]


def _spd(M, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(M, M, generator=g, dtype=torch.float64)
    return A @ A.T + M * torch.eye(M, dtype=torch.float64)


def _tril_vjp(f, M, N, K):
    """f's forward and pullback at [M, N], [K, M, M]."""
    def call():
        out, vjp = jax.vjp(f, jnp.ones((M, N), f32), jnp.ones((K, M, M), f32))
        vjp(jnp.ones_like(out))
    return call


# The wrapper's call on CPU tensors, the JAX call whose pl.pallas_call
# CostEstimates it is counted at, and optionally which of those calls (the
# pullback's, after the forward's) and how many times their sum: each at a
# shape the Pallas kernel takes, the tril / KL / Adam kernels at M=2048.
M_T, N_T = 2048, 64
PALLAS = {
    "kxz at the demos' N=500 M=25 D=2 (padded to 512 / 256 / 128)": (
        lambda: pt.ops.kxz(torch.ones(500, 2), torch.ones(25, 2),
                           torch.tensor(1.0), torch.tensor(1.0)),
        lambda: pk._kxz_impl(jnp.ones((500, 2)), jnp.ones((25, 2)),
                             jnp.float32(1), jnp.float32(1),
                             epilogue=pk._rbf_epilogue, interpret=False)),
    "cholesky_factor at M=25 (padded to 128)": (
        lambda K=_spd(25): chol_kernel.cholesky_factor(K),
        lambda: jlinalg.cholesky_blocked(jnp.eye(25))),
    "cholesky_factor at M=300 (padded to 384)": (
        lambda K=_spd(300): chol_kernel.cholesky_factor(K),
        lambda: jlinalg.cholesky_blocked(jnp.eye(300))),
    "trsm_lower's inverse at M=25": (
        lambda L=torch.linalg.cholesky(_spd(25)): trsm_kernel.trsm_lower(L),
        lambda: jlinalg.solve_triangular_blocked(jnp.eye(25), jnp.eye(25))),
    "trsm_lower_t on [300, 600]": (
        lambda L=torch.linalg.cholesky(_spd(300)): trsm_kernel.trsm_lower_t(
            L, torch.ones(300, 600, dtype=torch.float64)),
        lambda: jlinalg.solve_triangular_blocked(
            jnp.eye(300), jnp.ones((300, 600)), trans=True)),
    "qsqrt_sq_colsum at K=2 M=25 N=100": (
        lambda: quad_kernel.qsqrt_sq_colsum(torch.ones(2, 25, 25),
                                            torch.ones(25, 100)),
        lambda: jquad.qsqrt_sq_colsum(jnp.ones((2, 25, 25)),
                                      jnp.ones((25, 100)))),
    "tril_sq_fwd at M=2048 N=64 (BM 512, N padded to 1024)": (
        lambda: tril_kernel.tril_sq_fwd(torch.ones(M_T, N_T, dtype=bf),
                                        torch.ones(1, M_T, M_T, dtype=bf)),
        lambda: jtril.atl_sq_colsum(jnp.ones((M_T, N_T)),
                                    jnp.ones((1, M_T, M_T)))),
    "tril_fwd_f32 at M=2304 (BM 256)": (
        lambda: tril_kernel.tril_fwd_f32(torch.ones(2304, 8, dtype=bf),
                                         torch.ones(1, 2304, 2304, dtype=bf)),
        lambda: jtril.atl_matmul(jnp.ones((2304, 8)),
                                 jnp.ones((1, 2304, 2304)))),
    "tril_dl + tril_da at M=2048, K=2": (
        lambda: (tril_kernel.tril_dl(torch.ones(M_T, N_T, dtype=bf),
                                     torch.ones(2, N_T, M_T, dtype=bf)),
                 tril_kernel.tril_da(torch.ones(2, M_T, M_T, dtype=bf),
                                     torch.ones(2, N_T, M_T, dtype=bf))),
        _tril_vjp(jtril.atl_matmul, M_T, N_T, 2), slice(1, 3)),
    "tril_sq_dl + tril_sq_da at M=2048": (
        lambda: (tril_kernel.tril_sq_dl(torch.ones(M_T, N_T, dtype=bf),
                                        torch.ones(1, N_T, M_T, dtype=bf),
                                        torch.ones(1, N_T)),
                 tril_kernel.tril_sq_da(torch.ones(1, M_T, M_T, dtype=bf),
                                        torch.ones(1, N_T, M_T, dtype=bf),
                                        torch.ones(1, N_T))),
        _tril_vjp(jtril.atl_sq_colsum, M_T, N_T, 1), slice(1, 3)),
    "tril_sq_fwd_split at M=2048: three of #3's passes": (
        lambda: tril_kernel.tril_sq_fwd_split(
            torch.ones(2, M_T, 8, dtype=bf), torch.ones(2, M_T, M_T, dtype=bf)),
        lambda: jtril.atl_sq_colsum(jnp.ones((M_T, 8)),
                                    jnp.ones((1, M_T, M_T))), slice(0, 1), 3),
    "tri_tt_matmul tril_out at M=1024 (BM 512, 4 products)": (
        lambda: trimm_kernel.tri_tt_matmul(torch.eye(1024), torch.eye(1024),
                                           tril_out=True),
        lambda: jtrimm.tri_tt_matmul(jnp.eye(1024), jnp.eye(1024),
                                     tril_out=True)),
    "tri_tt_matmul at M=768 (BM 256)": (
        lambda: trimm_kernel.tri_tt_matmul(torch.eye(768), torch.eye(768),
                                           tril_out=False),
        lambda: jtrimm.tri_tt_matmul(jnp.eye(768), jnp.eye(768),
                                     tril_out=False)),
    "tri_nt_matmul at M=512": (
        lambda: trimm_kernel.tri_nt_matmul(torch.eye(512), torch.eye(512)),
        lambda: jtrimm.tri_nt_matmul(jnp.eye(512), jnp.eye(512))),
    "kl_sq_logdiag at K=2 M=2048": (
        lambda: kl_kernel.kl_sq_logdiag(torch.ones(2, M_T, M_T)),
        lambda: jkl.kl_sq_logdiag(jnp.ones((2, M_T, M_T)))),
    "kl_bwd_scale at K=2 M=2048": (
        lambda: kl_kernel.kl_bwd_scale(torch.ones(2, M_T, M_T),
                                       torch.tensor(1.0)),
        lambda: jkl.kl_bwd_scale(jnp.ones((2, M_T, M_T)), jnp.float32(1))),
    "adam_tril_ at K=1 M=2048": (
        lambda: fused_adam.adam_tril_(*(torch.zeros(1, M_T, M_T)
                                        for _ in range(4)), 1e-3, 1.0, 1.0),
        lambda: jadam._pallas_adam(*(jnp.zeros((1, M_T, M_T))
                                     for _ in range(4)), jnp.ones(2),
                                   b1=0.9, b2=0.999, eps=1e-8, lr=1e-3)),
}


@pytest.mark.parametrize("case", list(PALLAS))
def test_flops_count_a_wrapper_once_at_its_pallas_cost_estimate(case,
                                                                monkeypatch):
    port, jax_call, keep, times = (PALLAS[case] + (slice(0, 1), 1)[
        len(PALLAS[case]) - 2:])
    declared = _pallas_flops(monkeypatch, jax_call)
    assert len(declared) == keep.stop
    assert profiling.flops_estimate(port) == times * sum(declared[keep])
    # Outside an estimate the wrapper is itself again.
    port()


# At the demos' M=25 no block of 512 or 256 divides M (and M < 2048): the
# JAX package takes no Pallas call there and runs XLA's dense op.  The
# wrapper is counted at that op's contraction, as XLA's cost analysis gives
# it, and the element-wise KL and Adam updates at 0.
K_D, M_D, N_D = 3, 25, 500
_A, _L = jnp.ones((M_D, N_D), f32), jnp.ones((K_D, M_D, M_D), f32)
_W = jnp.ones((K_D, N_D, M_D), f32)
DENSE = {
    "tril_sq_fwd": (
        lambda: tril_kernel.tril_sq_fwd(torch.ones(M_D, N_D, dtype=bf),
                                        torch.ones(K_D, M_D, M_D, dtype=bf)),
        lambda A, L: jnp.matmul(A.T[None], L), (_A, _L)),
    "tril_sq_fwd_split": (
        lambda: tril_kernel.tril_sq_fwd_split(
            torch.ones(2, M_D, N_D, dtype=bf),
            torch.ones(2 * K_D, M_D, M_D, dtype=bf)),
        lambda A, L: jnp.matmul(A.T[None], L), (_A, _L)),
    "tril_dl": (
        lambda: tril_kernel.tril_dl(torch.ones(M_D, N_D, dtype=bf),
                                    torch.ones(K_D, N_D, M_D, dtype=bf)),
        lambda A, W: jnp.matmul(A[None], W), (_A, _W)),
    "tril_sq_da": (
        lambda: tril_kernel.tril_sq_da(torch.ones(K_D, M_D, M_D, dtype=bf),
                                       torch.ones(K_D, N_D, M_D, dtype=bf),
                                       torch.ones(K_D, N_D)),
        lambda L, W: jnp.einsum("kab,knb->an", L, W), (_L, _W)),
    "tri_tt_matmul": (
        lambda: trimm_kernel.tri_tt_matmul(torch.eye(M_D), torch.eye(M_D),
                                           tril_out=True),
        lambda A, B: A.T @ B, (_L[0], _L[0])),
    "tri_nt_matmul": (
        lambda: trimm_kernel.tri_nt_matmul(torch.eye(M_D), torch.eye(M_D)),
        lambda A, B: A @ B.T, (_L[0], _L[0])),
    "kl_sq_logdiag": (
        lambda: kl_kernel.kl_sq_logdiag(torch.eye(M_D).repeat(K_D, 1, 1)),
        None, None),
    "adam_tril_": (
        lambda: fused_adam.adam_tril_(*(torch.zeros(K_D, M_D, M_D)
                                        for _ in range(4)), 1e-3, 1.0, 1.0),
        None, None),
}


@pytest.mark.parametrize("case", list(DENSE))
def test_flops_count_a_wrapper_at_xla_where_jax_takes_no_pallas_call(case):
    port, dense, args = DENSE[case]
    assert not (jtril.eligible(M_D) or jkl.eligible(M_D)
                or jtrimm.eligible(M_D))
    want = 0 if dense is None else _xla_flops(dense, *args)
    assert profiling.flops_estimate(port) == want


def test_flops_of_a_wrapper_inside_other_work():
    A = torch.randn(25, 40)
    L = torch.randn(2, 25, 25)
    W = torch.randn(25, 7)
    f = lambda: tril_kernel.tril_sq_fwd(A.to(bf), L.to(bf)).float() @ W
    assert profiling.flops_estimate(f) == (2 * 2 * 25 * 25 * 40
                                           + 2 * 2 * 40 * 25 * 7)


def test_flops_of_kxz_pullback_are_its_xla_contractions():
    """On the CPU K(X, Z)'s pullback is aten's: its matmuls are the
    contractions the wrapper's count stands for on the card."""
    X = torch.randn(50, 2, requires_grad=True)
    Z = torch.randn(7, 2, requires_grad=True)
    ls, var = torch.tensor(0.5), torch.tensor(1.3)

    def step():
        pt.ops.kxz(X, Z, ls, var).sum().backward()

    fwd = profiling.flops_estimate(lambda: pt.ops.kxz(X, Z, ls, var))
    assert profiling.flops_estimate(step) - fwd == cost.kxz_vjp(
        X, Z, ls, var, None, needs=(True, True, False, False)) - 2 * 50 * 7 * 2


def test_wrappers_are_restored_after_an_estimate():
    from modulatedgps_tpu_torch.ops import kernels
    before = kernels.kxz
    with pytest.raises(RuntimeError):
        profiling.flops_estimate(lambda: (_ for _ in ()).throw(
            RuntimeError("boom")))
    assert kernels.kxz is before is pt.ops.kxz


def _artists(fig):
    """Each axis's line data and scatter offsets, in drawing order."""
    out = []
    for ax in fig.axes:
        lines = [np.asarray(line.get_xydata()) for line in ax.get_lines()]
        scatters = []
        for c in ax.collections:
            pts = getattr(c, "_offsets3d", None)
            scatters.append(np.asarray(pts if pts is not None
                                       else c.get_offsets(), dtype=float))
        out.append((ax.get_title(), lines, scatters))
    return out


def _same_figures(a, b):
    for (ta, la, sa), (tb, lb, sb) in zip(_artists(a), _artists(b),
                                          strict=True):
        assert ta == tb
        for x, y in zip(la, lb, strict=True):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(sa, sb, strict=True):
            np.testing.assert_array_equal(x, y)


def _figure_inputs(rng, D):
    N, Np, S, K = 60, 20, 3, 3
    return dict(Xtrain=rng.normal(size=(N, D)), Ytrain=rng.normal(size=(N, 1)),
                Xplot=rng.normal(size=(Np, D)),
                samples_y=rng.normal(size=(S, Np, 1)),
                samples_f=rng.normal(size=(S, Np, 1)),
                iters=[5, 10, 15], elbos=[-3.0, -2.0, -1.5], K=K)


def test_four_panel_figure_matches_jax():
    rng = np.random.default_rng(0)
    kw = _figure_inputs(rng, 1)
    extra = dict(assign_X=kw["Xtrain"],
                 assign_probs=rng.dirichlet(np.ones(3), 60),
                 pred_X=kw["Xplot"], fmean=rng.normal(size=(20, 3)),
                 fvar=rng.uniform(0.1, 1, (20, 3)))
    _same_figures(plotting.four_panel_figure(**kw, **extra),
                  jplotting.four_panel_figure(**kw, **extra))


def test_two_figure_2d_matches_jax():
    rng = np.random.default_rng(1)
    kw = _figure_inputs(rng, 2)
    line = np.linspace(-1, 1, 30)
    slices = [(np.c_[line, np.full(30, 0.75)], 0, 0.75,
               rng.dirichlet(np.ones(3), 30), rng.normal(size=(30, 3)),
               rng.uniform(0.1, 1, (30, 3))),
              (np.c_[np.full(30, -0.25), line], 1, -0.25,
               rng.dirichlet(np.ones(3), 30), rng.normal(size=(30, 3)),
               rng.uniform(0.1, 1, (30, 3)))]
    extra = dict(assign_probs_plot=rng.dirichlet(np.ones(3), 20),
                 fmean_plot=rng.normal(size=(20, 3)), slices=slices,
                 axis_labels=("StumpsX", "StumpsY"))
    got = plotting.two_figure_2d(**kw, **extra)
    want = jplotting.two_figure_2d(**kw, **extra)
    for a, b in zip(got, want, strict=True):
        _same_figures(a, b)


def test_svgp_helpers_match_jax():
    rng = np.random.default_rng(2)
    Z = rng.uniform(-4, 4, (8, 1))
    q_mu = rng.normal(size=(8, 2))
    jl = jmodels.SVGP.create(JSE.create(0.7, 1.3), Z, num_latent_gps=2)
    jl = jl.replace(q_mu=jl.q_mu.replace_raw(jnp.asarray(q_mu)))
    pl = pt.SVGP.create(pt.SquaredExponential.create(0.7, 1.3,
                                                     dtype=torch.float64,
                                                     device="cpu"),
                        Z, num_latent_gps=2, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        pl.q_mu.raw.copy_(torch.as_tensor(q_mu))
    plt = plotting.pyplot()
    figs = []
    for helper, layer in ((plotting.plot_kernel_prediction, pl),
                          (jplotting.plot_kernel_prediction, jl)):
        fig, ax = plt.subplots()
        helper(ax, layer)
        figs.append(fig)
    for (_, la, sa), (_, lb, sb) in zip(_artists(figs[0]), _artists(figs[1])):
        for x, y in zip(la, lb, strict=True):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)
    fig, ax = plt.subplots()
    plotting.plot_kernel_samples(ax, pl, torch.Generator().manual_seed(0))
    lines = ax.get_lines()
    assert len(lines) == 3 and all(np.isfinite(line.get_ydata()).all()
                                   for line in lines)
    plotting.plot_kernel(pl, torch.Generator().manual_seed(1))
