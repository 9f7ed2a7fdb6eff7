"""Guards of modulatedgps_tpu_torch that need no card.

The port never imports jax, importing it builds nothing, CPU tensors never
launch a kernel (not in a forward, not in a backward), the entry points
create their state on the card unless asked for the CPU, and each CUDA
wrapper's own argument checks refuse what its kernel does not take (a
tensor that requires grad while autograd records: a raw launcher records
no gradient; a wrong dtype).  Also the constrained-parameter transforms,
the jitter policy and the shape checker against the JAX package.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu import config as jconfig
from modulatedgps_tpu import params as jparams
from modulatedgps_tpu.utils import shapes as jshapes

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch import _native, config, params
from modulatedgps_tpu_torch.ops import (chol_kernel, kl_kernel, kxz_kernel,
                                        quad_kernel, tril_kernel, trimm_kernel,
                                        trsm_kernel)
from modulatedgps_tpu_torch.training import fused_adam
from modulatedgps_tpu_torch.utils.shapes import ShapeChecker, ShapeError

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
import modulatedgps_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
               for m, v in sys.modules.items() if v is not None)
assert pkg._native._lib is None    # importing builds and loads nothing
print(len(names))
"""


def test_port_imports_without_jax_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


def test_cpu_tensors_launch_nothing():
    pt.reset_launch_counts()
    X = torch.randn(20, 3)
    Z = torch.randn(10, 3)
    K = kxz_kernel.kxz(X, Z, torch.tensor(0.5), torch.tensor(1.0))
    trsm_kernel.trsm_lower(torch.linalg.cholesky(K[:10] @ K[:10].T
                                                 + torch.eye(10)))
    tril_kernel.atl_sq_colsum(torch.randn(10, 7), torch.randn(2, 10, 10))
    assert pt.launch_counts() == dict.fromkeys(KERNELS, 0)
    assert _native._lib is None


KERNELS = ("kxz", "trsm_lower", "tril_sq_fwd", "trsm_lower_t", "tril_fwd_f32",
           "tril_dl", "tril_da", "tril_sq_dl", "tril_sq_da", "tri_tt_matmul",
           "tri_nt_matmul", "kl_sq_logdiag", "kl_bwd_scale", "adam_tril_",
           "cholesky_factor", "qsqrt_sq_colsum")


def test_cpu_train_step_launches_nothing():
    """A whole loss, backward and Adam step of a float32 SMGP on CPU
    tensors runs the plain versions only."""
    rng = np.random.default_rng(0)
    M, K, D, N = 16, 2, 2, 24
    layer = lambda: pt.SVGP.create(
        pt.SquaredExponential.create(0.5, 0.7, device="cpu"),
        rng.normal(size=(M, D)), K, device="cpu")
    model = pt.SMGP(pt.Gaussian.create(0.5, D=K, device="cpu"), layer(),
                    layer(), K=K, num_samples=3, num_data=100)
    with torch.no_grad():
        model.pred_layer.q_sqrt.raw.add_(
            0.05 * torch.tril(torch.randn(K, M, M)))
    pt.reset_launch_counts()
    step = pt.make_train_step(pt.Adam(model, 1e-2))
    loss = step(model, torch.Generator().manual_seed(0),
                torch.as_tensor(rng.uniform(-2, 2, size=(N, D)),
                                dtype=torch.float32),
                torch.as_tensor(rng.normal(size=(N, 1)), dtype=torch.float32))
    assert bool(torch.isfinite(loss))
    assert all(p.grad is not None for p in model.parameters())
    assert pt.launch_counts() == dict.fromkeys(KERNELS, 0)
    assert _native._lib is None


def test_entry_points_default_to_the_card():
    """SVGP.create, the kernels' create and Gaussian.create put their state
    on the card unless given a device; without a card they raise instead
    of falling back to the CPU."""
    creates = [lambda: pt.SquaredExponential.create(0.5, 0.7),
               lambda: pt.Matern32.create(0.5, 0.7),
               lambda: pt.Gaussian.create(0.5, D=2),
               lambda: pt.SVGP.create(
                   pt.SquaredExponential.create(device="cpu"),
                   np.zeros((4, 2)), 2)]
    for create in creates:
        if torch.cuda.is_available():
            assert all(p.device.type == "cuda"
                       for p in create().parameters())
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                create()


def _grad(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, requires_grad=True)


@pytest.mark.parametrize("case", ["kxz", "trsm_lower", "tril_sq_fwd",
                                  "tril_sq_dl", "tril_sq_da", "tri_tt_matmul",
                                  "tri_nt_matmul", "kl_sq_logdiag",
                                  "kl_bwd_scale", "adam_tril_",
                                  "tril_fwd_f32", "trsm_lower_t", "tril_dl",
                                  "tril_da", "cholesky_factor",
                                  "qsqrt_sq_colsum"])
def test_cuda_argument_checks_refuse_grad(case):
    bf16 = torch.bfloat16
    with pytest.raises(NotImplementedError, match="autograd Function"):
        if case == "cholesky_factor":
            chol_kernel.check_launch_args(torch.eye(4, requires_grad=True))
        elif case == "qsqrt_sq_colsum":
            quad_kernel.check_launch_args(
                torch.zeros(1, 4, 4, dtype=bf16, requires_grad=True),
                torch.zeros(4, 3, dtype=bf16))
        elif case == "kl_sq_logdiag":
            kl_kernel.check_launch_args(case, _grad(2, 4, 4))
        elif case == "kl_bwd_scale":
            kl_kernel.check_launch_args(case, torch.zeros(2, 4, 4), _grad(1))
        elif case == "adam_tril_":
            z = torch.zeros(2, 4, 4)
            fused_adam.check_launch_args(_grad(2, 4, 4), z, z, z)
        elif case == "tril_fwd_f32":
            tril_kernel.check_launch_args(
                torch.zeros(4, 3, dtype=bf16, requires_grad=True),
                torch.zeros(1, 4, 4, dtype=bf16), case)
        elif case == "kxz":
            kxz_kernel.check_launch_args(
                torch.zeros(4, 2, requires_grad=True), torch.zeros(3, 2),
                torch.tensor(1.0), torch.tensor(1.0))
        elif case == "trsm_lower":
            trsm_kernel.check_launch_args(torch.eye(4, requires_grad=True))
        elif case == "trsm_lower_t":
            trsm_kernel.check_launch_args(torch.eye(4), _grad(4, 3), case)
        elif case in ("tril_dl", "tril_da"):
            tril_kernel.check_bwd_launch_args(
                case, torch.zeros(4, 3, dtype=bf16),
                torch.zeros(1, 3, 4, dtype=bf16, requires_grad=True))
        elif case == "tril_sq_fwd":
            tril_kernel.check_launch_args(
                torch.zeros(4, 3, dtype=torch.bfloat16, requires_grad=True),
                torch.zeros(1, 4, 4, dtype=torch.bfloat16))
        elif case in ("tril_sq_dl", "tril_sq_da"):
            tril_kernel.check_bwd_launch_args(
                case, torch.zeros(4, 3, dtype=bf16),
                torch.zeros(1, 3, 4, dtype=bf16), _grad(1, 3))
        else:
            trimm_kernel.check_launch_args(case, torch.eye(4), _grad(4, 4))


def test_cuda_argument_checks_accept_grad_tensors_when_not_recording():
    """Serving runs under inference_mode: parameters that require grad feed
    the kernels there, because no backward will be asked for."""
    X = torch.zeros(4, 2, requires_grad=True)
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            kxz_kernel.check_launch_args(X, X, torch.tensor(1.0),
                                         torch.tensor(1.0))
            trsm_kernel.check_launch_args(torch.eye(4, requires_grad=True))


@pytest.mark.parametrize("case", ["kxz", "kxz_variance", "trsm_lower",
                                  "trsm_rhs", "tril_sq_fwd", "tril_sq_bwd_G",
                                  "tril_sq_bwd_B16", "trimm", "kl_sq_logdiag",
                                  "kl_bwd_scale_g", "adam_tril_",
                                  "tril_fwd_f32", "trsm_lower_t", "tril_dl",
                                  "tril_da", "cholesky_factor", "trsm_inv",
                                  "qsqrt_sq_colsum"])
def test_cuda_argument_checks_refuse_dtype(case):
    f64 = torch.float64
    with pytest.raises(TypeError):
        if case == "cholesky_factor":   # the f64 factor stays on the CPU
            chol_kernel.check_launch_args(torch.eye(4, dtype=f64))
        elif case == "trsm_inv":
            trsm_kernel.check_launch_args(torch.eye(4), None, "trsm_lower",
                                          torch.zeros(1, 64, 64, dtype=f64))
        elif case == "qsqrt_sq_colsum":   # bf16, cast by the Function
            quad_kernel.check_launch_args(torch.zeros(1, 4, 4),
                                          torch.zeros(4, 3))
        elif case == "trsm_lower_t":
            trsm_kernel.check_launch_args(torch.eye(4, dtype=f64),
                                          torch.zeros(4, 3, dtype=f64), case)
        elif case == "tril_dl":   # W16 = bf16(dB), cast by atl_matmul
            tril_kernel.check_bwd_launch_args(
                case, torch.zeros(4, 3, dtype=torch.bfloat16),
                torch.zeros(1, 3, 4))
        elif case == "tril_da":
            tril_kernel.check_bwd_launch_args(
                case, torch.zeros(1, 4, 4), torch.zeros(1, 3, 4,
                                                        dtype=torch.bfloat16))
        elif case == "kl_sq_logdiag":   # the f64 KL keeps the dense form
            kl_kernel.check_launch_args(case, torch.zeros(2, 4, 4, dtype=f64))
        elif case == "kl_bwd_scale_g":
            kl_kernel.check_launch_args("kl_bwd_scale", torch.zeros(2, 4, 4),
                                        torch.tensor(1.0, dtype=f64))
        elif case == "adam_tril_":
            z = torch.zeros(2, 4, 4)
            fused_adam.check_launch_args(z, z.double(), z, z)
        elif case == "tril_fwd_f32":   # bf16 operands, cast by atl_matmul
            tril_kernel.check_launch_args(torch.zeros(4, 3),
                                          torch.zeros(1, 4, 4), case)
        elif case == "kxz":
            kxz_kernel.check_launch_args(torch.zeros(4, 2, dtype=f64),
                                         torch.zeros(3, 2, dtype=f64),
                                         torch.tensor(1.0), torch.tensor(1.0))
        elif case == "kxz_variance":
            kxz_kernel.check_launch_args(torch.zeros(4, 2), torch.zeros(3, 2),
                                         torch.tensor(1.0),
                                         torch.tensor(1.0, dtype=f64))
        elif case == "trsm_lower":
            trsm_kernel.check_launch_args(torch.eye(4, dtype=f64))
        elif case == "trsm_rhs":
            trsm_kernel.check_launch_args(torch.eye(4), torch.eye(4, dtype=f64))
        elif case == "tril_sq_fwd":   # bf16, cast by atl_sq_colsum
            tril_kernel.check_launch_args(torch.zeros(4, 3),
                                          torch.zeros(1, 4, 4))
        elif case == "tril_sq_bwd_G":
            tril_kernel.check_bwd_launch_args(
                "tril_sq_dl", torch.zeros(4, 3, dtype=torch.bfloat16),
                torch.zeros(1, 3, 4, dtype=torch.bfloat16),
                torch.zeros(1, 3, dtype=f64))
        elif case == "tril_sq_bwd_B16":
            tril_kernel.check_bwd_launch_args(
                "tril_sq_da", torch.zeros(1, 4, 4, dtype=torch.bfloat16),
                torch.zeros(1, 3, 4), torch.zeros(1, 3))
        else:   # the pullback products take fp32; f64 stays on the CPU
            trimm_kernel.check_launch_args("tri_tt_matmul",
                                           torch.eye(4, dtype=f64),
                                           torch.eye(4, dtype=f64))


def test_cuda_argument_checks_refuse_layout_and_shape():
    with pytest.raises(ValueError, match="contiguous"):
        trsm_kernel.check_launch_args(torch.eye(4).T.contiguous()[:, ::2].T)
    with pytest.raises(ValueError, match="lengthscales"):
        kxz_kernel.check_launch_args(torch.zeros(4, 2), torch.zeros(3, 2),
                                     torch.ones(3), torch.tensor(1.0))
    ls, var = kxz_kernel.check_launch_args(torch.zeros(4, 2), torch.zeros(3, 2),
                                           torch.tensor(0.5), torch.tensor(2.0))
    assert ls.tolist() == [0.5, 0.5] and var.tolist() == [2.0]


def test_new_wrappers_refuse_layout_and_shape():
    with pytest.raises(ValueError, match="contiguous"):
        kl_kernel.check_launch_args("kl_sq_logdiag",
                                    torch.zeros(2, 4, 4).transpose(1, 2))
    with pytest.raises(ValueError, match="one value"):
        kl_kernel.check_launch_args("kl_bwd_scale", torch.zeros(2, 4, 4),
                                    torch.zeros(2))
    for fn in (kl_kernel.kl_sq_logdiag,
               lambda L: kl_kernel.kl_bwd_scale(L, torch.tensor(1.0))):
        with pytest.raises(ValueError, match=r"\[K, M, M\]"):
            fn(torch.zeros(2, 4, 5))
    z = torch.zeros(2, 4, 4)
    with pytest.raises(ValueError, match="shape"):
        fused_adam.check_launch_args(z, torch.zeros(2, 4, 3), z, z)
    with pytest.raises(ValueError, match=r"\[K, M, M\]"):
        fused_adam.check_launch_args(torch.zeros(4, 4), z, z, z)
    with pytest.raises(ValueError, match="contiguous"):
        fused_adam.check_launch_args(z, z, z.transpose(1, 2), z)
    with pytest.raises(ValueError):
        tril_kernel.tril_fwd_f32(torch.zeros(4, 3, dtype=torch.bfloat16),
                                 torch.zeros(1, 5, 5, dtype=torch.bfloat16))


def test_atl_matmul_refuses_autograd():
    """The f32 tril forward no longer refuses autograd: while it records,
    atl_matmul's backward (kernels #6/#7, their plain versions here)
    gives fp32 gradients of A and L, dL exactly 0 above the diagonal, and
    launches nothing on CPU tensors; without autograd it still runs."""
    A = torch.randn(5, 3, requires_grad=True)
    L = torch.randn(2, 5, 5, requires_grad=True)
    pt.reset_launch_counts()
    tril_kernel.atl_matmul(A, L).square().sum().backward()
    assert A.grad.dtype == L.grad.dtype == torch.float32
    assert A.grad.shape == (5, 3) and L.grad.shape == (2, 5, 5)
    assert not torch.triu(L.grad, 1).any() and L.grad.abs().sum() > 0
    assert pt.launch_counts() == dict.fromkeys(KERNELS, 0)
    with torch.no_grad():
        assert tril_kernel.atl_matmul(A, torch.randn(2, 5, 5)).shape == (2, 3, 5)


def test_cpu_steps_keep_tril_leaves_lower_triangular():
    """Three f32 CPU steps through the new routes (the KL's kl_sq_logdiag /
    kl_bwd_scale, Adam's adam_tril_, each on its plain version): q_sqrt and
    its Adam moments stay exactly 0 above the diagonal."""
    import unittest.mock as mock
    from modulatedgps_tpu_torch.ops import kl as kl_module
    from modulatedgps_tpu_torch.training import adam as adam_module
    rng = np.random.default_rng(1)
    M, K, D, N = 16, 2, 2, 24
    layer = lambda: pt.SVGP.create(
        pt.SquaredExponential.create(0.5, 0.7, device="cpu"),
        rng.normal(size=(M, D)), K, device="cpu")
    model = pt.SMGP(pt.Gaussian.create(0.5, D=K, device="cpu"), layer(),
                    layer(), K=K, num_samples=3, num_data=100)
    with torch.no_grad():
        model.pred_layer.q_sqrt.raw.add_(
            0.05 * torch.tril(torch.randn(K, M, M)))
    opt = pt.Adam(model, 1e-2)
    step = pt.make_train_step(opt)
    X = torch.as_tensor(rng.uniform(-2, 2, size=(N, D)), dtype=torch.float32)
    Y = torch.as_tensor(rng.normal(size=(N, 1)), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    with mock.patch.object(kl_module, "kl_sq_logdiag",
                           wraps=kl_module.kl_sq_logdiag) as fwd, \
            mock.patch.object(kl_module, "kl_bwd_scale",
                              wraps=kl_module.kl_bwd_scale) as bwd, \
            mock.patch.object(adam_module, "adam_tril_",
                              wraps=adam_module.adam_tril_) as upd:
        for _ in range(3):
            assert bool(torch.isfinite(step(model, gen, X, Y)))
    assert fwd.call_count == bwd.call_count == upd.call_count == 6
    for p, m, v, tril in zip(opt.params, opt.m, opt.v, opt.tril):
        if tril:
            for t in (p, m, v):
                assert not torch.triu(t, 1).any()
            assert m.abs().sum() > 0


def test_serving_refuses_grad_path_only_on_cuda():
    """On CPU the plain versions are differentiable; the CUDA refusal is
    the wrappers' own check (above), so CPU autograd still works."""
    X = torch.randn(5, 2, requires_grad=True)
    K = kxz_kernel.kxz(X, X, torch.tensor(0.5), torch.tensor(1.0))
    K.sum().backward()
    assert X.grad is not None


@pytest.mark.parametrize("values", [[1e-6, 0.3, 2.0, 19.9, 20.1, 50.0]])
def test_positive_transform_matches_jax(values):
    v = np.asarray(values)
    want = np.asarray(jparams.positive_inverse(jnp.asarray(v)))
    got = params.positive_inverse(torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(params.positive(torch.tensor(want)).numpy(),
                               np.asarray(jparams.positive(jnp.asarray(want))),
                               rtol=1e-12)


def test_parameter_round_trip_and_tril():
    p = params.Parameter.from_value([[0.5, 2.0]], "positive",
                                    dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(p.value.detach().numpy(), [[0.5, 2.0]],
                               rtol=1e-12)
    t = params.Parameter(torch.ones(2, 3, 3), "tril", trainable=False)
    assert not t.trainable
    assert torch.equal(t.value, torch.tril(torch.ones(2, 3, 3)))
    with pytest.raises(ValueError):
        params.Parameter(torch.ones(2), "exp")


@pytest.mark.parametrize("dtype,jdtype", [(torch.float64, jnp.float64),
                                          (torch.float32, jnp.float32)])
def test_default_jitter_matches_jax(dtype, jdtype):
    assert config.default_jitter(dtype) == jconfig.default_jitter(jdtype)


def test_shape_checker_matches_jax():
    for chk_cls, err in ((ShapeChecker, ShapeError),
                         (jshapes.ShapeChecker, jshapes.ShapeError)):
        chk = chk_cls()
        chk.check(np.zeros((5, 2)), "N D", "X")
        with pytest.raises(err, match="conflicts"):
            chk.check(np.zeros((4, 1)), "N 1", "Y")
        with pytest.raises(err, match="rank"):
            chk.check(np.zeros(3), "N D", "Z")


def test_svgp_predict_f_checks_shapes():
    kern = pt.SquaredExponential.create(dtype=torch.float64, device="cpu")
    layer = pt.SVGP.create(kern, np.zeros((4, 2)), 2, dtype=torch.float64,
                           device="cpu")
    with pytest.raises(ShapeError):
        layer.predict_f(torch.zeros(5, 3, dtype=torch.float64))
