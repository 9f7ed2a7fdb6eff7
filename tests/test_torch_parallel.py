"""modulatedgps_tpu_torch.parallel's mesh, data-parallel and expert-sharded
training and distributed blocked Cholesky / solve against the JAX
package's, float64.

The JAX references run once per module on the conftest's 8-device CPU mesh
(the JAX imports stay inside the fixture: the spawned ranks import this
module again).  The port runs in 4 gloo ranks (test_torch_parallel_
collectives.run_ranks), spawned once for the module, on a 4 x 1 mesh (P4)
and on a 2 x 2 one whose "data" axis has 2 ranks (P2; its two expert ranks
repeat the same data-parallel work, and its expert axis shards K = 4
experts).  The port's model is the JAX model's leaves through
smgp_from_numpy, and it takes JAX's noise where JAX draws it: the elbo's
key, and each step's subkey of the TrainState key.

Tolerances: the sharded ELBO against JAX's at rtol 1e-12 (one sum over N
in another order); its gradients and the leaves after a step at rtol 1e-8,
atol 1e-10, as tests/test_parallel.py holds GSPMD's step; the distributed
factor and solve at rtol 1e-10 (a different block layout than JAX's).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_parallel_collectives import (as_tensor as _t, fixed_noise,
                                             jax_leaves, load_ranks,
                                             record_collectives, run_ranks,
                                             save_rank)

M, K, D, N, S = 16, 4, 2, 64, 5
K_FALLBACK = 3
LR = 1e-2
STEP_KEY, EXPERT_STEPS = 3, 2
M_CHOL, N_RHS = 128, 24
RTOL_LEAF, ATOL_LEAF = 1e-8, 1e-10


# ------------------------------------------------------------- the ranks

def _port_model(arrays, k):
    """The port's SMGP from the JAX model's leaves stored as "k{K}:name"."""
    import modulatedgps_tpu_torch as pt
    leaves = {key.split(":", 1)[1]: arrays[key] for key in arrays
              if key.startswith(f"k{k}:")}
    return pt.smgp_from_numpy(leaves, K=k, num_samples=S, num_data=N,
                              temperature=1e-2, device="cpu",
                              dtype=torch.float64)




def _leaves(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def parallel_program(rank, world, inputs, out_dir):
    from modulatedgps_tpu_torch import Adam
    from modulatedgps_tpu_torch import parallel as par
    from modulatedgps_tpu_torch.parallel.collectives import share
    from modulatedgps_tpu_torch.parallel.mesh import axis_group
    arr = dict(np.load(inputs))
    X, Y = _t(arr["X"]), _t(arr["Y"])
    res = {}
    meshes = {"P4": par.make_mesh(num_data=4, device="cpu"),
              "P2": par.make_mesh(num_data=2, num_expert=2, device="cpu")}
    res["mesh_shapes"] = {k: tuple(m.shape) for k, m in meshes.items()}
    try:
        par.make_mesh(num_data=3, num_expert=2, device="cpu")
    except ValueError as e:
        res["mesh_error"] = str(e)
    try:
        par.shard_batch(meshes["P4"], X[:10])
    except ValueError as e:
        res["shard_error"] = str(e)

    for label, mesh in meshes.items():
        data, _, _ = axis_group(mesh, "data")
        Xl, Yl = par.shard_batch(mesh, X, Y)
        res[(label, "rows")] = Xl.clone()

        # The ELBO and its gradient (the backward of its share, then the
        # replicated leaves' all-reduce).
        model = _port_model(arr, K)
        elbo = par.data_parallel_elbo_from_noise(model, Xl, Yl, _t(arr["z"]),
                                                 _t(arr["g"]), mesh)
        share(elbo, data).backward()
        grads = {}
        for name, p in model.named_parameters():
            dist.all_reduce(p.grad, group=data)
            grads[name] = p.grad.clone()
        res[(label, "elbo")] = (float(elbo.detach()), grads)

        # One replicated step, its collectives recorded.
        model = par.replicate_state(mesh, _port_model(arr, K))
        model.draw_noise = fixed_noise([(_t(arr["zs0"]), _t(arr["gs0"]))])
        step = par.make_parallel_train_step(Adam(model, LR), mesh, K=K)
        with record_collectives() as calls:
            loss = step(model, None, Xl, Yl)
        res[(label, "step")] = (float(loss), _leaves(model), list(calls))

    # replicate_state: every rank perturbed, then the first rank's values.
    mesh = meshes["P2"]
    model = _port_model(arr, K)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(rank)
    res["replicated"] = _leaves(par.replicate_state(mesh, model))

    # Expert placement on 2 x 2 (K = 4: two experts a rank) and the
    # fallback (K = 3), then two expert-sharded steps.
    res["expert_index"] = mesh.get_local_rank("expert")
    res["expert_leaves"] = _leaves(par.expert_shard_state(
        mesh, _port_model(arr, K), K))
    res["fallback_leaves"] = _leaves(par.expert_shard_state(
        mesh, _port_model(arr, K_FALLBACK), K_FALLBACK))
    model = par.expert_shard_state(mesh, _port_model(arr, K), K)
    model.draw_noise = fixed_noise(
        [(_t(arr[f"zs{i}"]), _t(arr[f"gs{i}"])) for i in range(EXPERT_STEPS)])
    step = par.make_parallel_train_step(Adam(model, LR), mesh, K=K,
                                        shard_experts=True)
    Xl, Yl = par.shard_batch(mesh, X, Y)
    res["expert_losses"] = [float(step(model, None, Xl, Yl))
                            for _ in range(EXPERT_STEPS)]
    res["expert_steps"] = _leaves(model)
    try:
        par.make_parallel_train_step(Adam(model, LR), mesh, K=K,
                                     shard_experts=True, shard_inducing=True)
    except ValueError as e:
        res["pick_one"] = str(e)

    # The distributed factor and solve, their errors and the factor's
    # gradient.
    A, B = _t(arr["A"]), _t(arr["B"])
    for label, mesh, block in (("P4", meshes["P4"], 16),
                               ("P4", meshes["P4"], 32),
                               ("P2", meshes["P2"], 32)):
        _, index, size = axis_group(mesh, "data")
        rows = slice(index * M_CHOL // size, (index + 1) * M_CHOL // size)
        A_loc = A[rows].clone().requires_grad_(True)
        L_loc = par.distributed_cholesky(A_loc, mesh, block=block)
        (_t(arr["W"])[rows] * L_loc).sum().backward()
        X_loc = par.distributed_solve_lower(_t(arr["L_jax"])[rows], B[rows],
                                            mesh, block=block)
        res[(label, block, "chol")] = (index, L_loc.detach(), A_loc.grad,
                                       X_loc)
    errors = []
    for A_bad, block in ((torch.eye(96)[:24], 64),
                         (torch.eye(130)[:24], 16)):
        try:
            par.distributed_cholesky(A_bad, meshes["P4"], block=block)
        except ValueError as e:
            errors.append(str(e))
        try:
            par.distributed_solve_lower(A_bad, A_bad, meshes["P4"],
                                        block=block)
        except ValueError as e:
            errors.append(str(e))
    res["chol_errors"] = errors
    save_rank(out_dir, rank, res)


# ---------------------------------------------------- the JAX references


def _jax_model(rng, k):
    from modulatedgps_tpu.likelihoods import Gaussian
    from modulatedgps_tpu.models import SMGP, SVGP
    from modulatedgps_tpu.ops.kernels import SquaredExponential

    def layer(var, ls):
        lay = SVGP.create(SquaredExponential.create(var, ls),
                          rng.normal(size=(M, D)), num_latent_gps=k)
        q_sqrt = np.eye(M)[None] + 0.05 * np.tril(rng.normal(size=(k, M, M)))
        return lay.replace(
            q_mu=lay.q_mu.replace_raw(0.3 * rng.normal(size=(M, k))),
            q_sqrt=lay.q_sqrt.replace_raw(q_sqrt))
    return SMGP(likelihood=Gaussian.create(0.5, D=k),
                pred_layer=layer(0.5, 0.5), assign_layer=layer(0.1, 1.0),
                K=k, num_samples=S, num_data=N)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax
    from modulatedgps_tpu.parallel import (data_parallel_elbo, make_mesh,
                                           make_parallel_train_step,
                                           replicate_state, shard_batch)
    from modulatedgps_tpu.parallel.blocked import (distributed_cholesky,
                                                   distributed_solve_lower)
    rng = np.random.default_rng(0)
    jm = _jax_model(rng, K)
    jm3 = _jax_model(rng, K_FALLBACK)
    X = rng.uniform(-3, 3, size=(N, D))
    Y = rng.normal(size=(N, 1))
    mesh = make_mesh(num_data=8)
    Xs, Ys = shard_batch(mesh, jnp.asarray(X), jnp.asarray(Y))
    key = jax.random.PRNGKey(0)
    z, g = jm.draw_noise(key, N, S, jnp.float64)
    elbo_fn = lambda m: data_parallel_elbo(m, key, Xs, Ys, mesh)
    elbo, grads = jax.jit(jax.value_and_grad(elbo_fn))(
        replicate_state(mesh, jm))

    init_fn, step_fn = make_parallel_train_step(optax.adam(LR), mesh, K=K,
                                                donate=False)
    state, loss = step_fn(init_fn(jm, jax.random.PRNGKey(STEP_KEY)), Xs, Ys)
    step_keys, k = [], jax.random.PRNGKey(STEP_KEY)
    for _ in range(EXPERT_STEPS):
        k, sub = jax.random.split(k)
        step_keys.append(jm.draw_noise(sub, N, S, jnp.float64))

    A = rng.normal(size=(M_CHOL, M_CHOL))
    A = A @ A.T / M_CHOL + 2.0 * np.eye(M_CHOL)
    B = rng.normal(size=(M_CHOL, N_RHS))
    L = np.asarray(distributed_cholesky(jnp.asarray(A), mesh, block=16))
    Xsol = np.asarray(distributed_solve_lower(jnp.asarray(L), jnp.asarray(B),
                                              mesh, block=16))
    arrays = {"X": X, "Y": Y, "z": np.asarray(z), "g": np.asarray(g),
              "A": A, "B": B, "L_jax": L,
              "W": rng.normal(size=(M_CHOL, M_CHOL))}
    for i, (zs, gs) in enumerate(step_keys):
        arrays[f"zs{i}"], arrays[f"gs{i}"] = np.asarray(zs), np.asarray(gs)
    for k_, model in ((K, jm), (K_FALLBACK, jm3)):
        arrays.update({f"k{k_}:{n}": v for n, v in jax_leaves(model).items()})
    tmp = tmp_path_factory.mktemp("parallel")
    np.savez(tmp / "inputs.npz", **arrays)
    return {"arrays": arrays, "inputs": tmp / "inputs.npz", "tmp": tmp,
            "elbo": float(elbo), "grads": jax_leaves(grads),
            "loss": float(loss), "leaves": jax_leaves(state.model),
            "L": L, "X": Xsol}


@pytest.fixture(scope="module")
def ranks(ref):
    out = ref["tmp"] / "out"
    out.mkdir()
    run_ranks(parallel_program, ref["tmp"], str(ref["inputs"]), str(out))
    return load_ranks(out)


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]), want[name],
                                   rtol=RTOL_LEAF, atol=ATOL_LEAF,
                                   err_msg=f"{what} {name}")


# ------------------------------------------------------------------ tests

def test_make_mesh_and_shard_batch(ranks, ref):
    for res in ranks:
        assert res["mesh_shapes"] == {"P4": (4, 1), "P2": (2, 2)}
        assert "3x2 != 4" in res["mesh_error"]
        assert "multiple" in res["shard_error"]
    X = ref["arrays"]["X"]
    for rank, res in enumerate(ranks):
        np.testing.assert_array_equal(res[("P4", "rows")],
                                      X[rank * 16:(rank + 1) * 16])
        d = rank // 2                            # the 2 x 2 mesh's data index
        np.testing.assert_array_equal(res[("P2", "rows")],
                                      X[d * 32:(d + 1) * 32])


@pytest.mark.parametrize("label", ["P4", "P2"])
def test_data_parallel_elbo_and_gradient_match_jax(ranks, ref, label):
    for res in ranks:
        elbo, grads = res[(label, "elbo")]
        np.testing.assert_allclose(elbo, ref["elbo"], rtol=1e-12)
        _close(grads, ref["grads"], f"{label} gradient")


@pytest.mark.parametrize("label", ["P4", "P2"])
def test_replicated_step_matches_jax_gspmd_step(ranks, ref, label):
    for res in ranks:
        loss, leaves, _ = res[(label, "step")]
        np.testing.assert_allclose(loss, ref["loss"], rtol=1e-10)
        _close(leaves, ref["leaves"], f"{label} step")


@pytest.mark.parametrize("label", ["P4", "P2"])
def test_replicated_step_runs_exactly_one_all_reduce(ranks, label):
    """The port's counterpart of tests/test_parallel.py's HLO audit: one
    all-reduce a step (gradients and loss in one flat buffer), no
    all-gather or any other collective."""
    n_params = sum(v.numel() for v in ranks[0][(label, "step")][1].values())
    for res in ranks:
        calls = res[(label, "step")][2]
        assert [c[0] for c in calls] == ["all_reduce"], calls
        assert calls[0][1] == (n_params + 1,)


def test_replicate_state_copies_the_first_rank(ranks, ref):
    want = {n.split(":", 1)[1]: v for n, v in ref["arrays"].items()
            if n.startswith(f"k{K}:")}
    for res in ranks:
        for name, value in res["replicated"].items():
            np.testing.assert_array_equal(value, want[name], err_msg=name)


def test_expert_shard_state_placement_and_fallback(ranks, ref):
    full = {n.split(":", 1)[1]: v for n, v in ref["arrays"].items()
            if n.startswith(f"k{K}:")}
    full3 = {n.split(":", 1)[1]: v for n, v in ref["arrays"].items()
             if n.startswith(f"k{K_FALLBACK}:")}
    sharded_dims = {"likelihood.variance.raw": 1,
                    "pred_layer.q_mu.raw": 1, "pred_layer.q_sqrt.raw": 0,
                    "assign_layer.q_mu.raw": 1, "assign_layer.q_sqrt.raw": 0}
    for res in ranks:
        e = res["expert_index"]
        for name, value in res["expert_leaves"].items():
            want = full[name]
            if name in sharded_dims:
                want = np.take(want, range(2 * e, 2 * e + 2),
                               axis=sharded_dims[name])
            np.testing.assert_array_equal(value, want, err_msg=name)
        for name, value in res["fallback_leaves"].items():
            np.testing.assert_array_equal(value, full3[name], err_msg=name)
        assert "pick one" in res["pick_one"]


def test_expert_sharded_steps_match_the_single_device_step(ranks, ref):
    """Two steps on the 2 x 2 mesh, each rank holding 2 of the 4 experts,
    against the port's single-device make_train_step from the same state
    with the same noise."""
    import modulatedgps_tpu_torch as pt
    arr = ref["arrays"]
    model = _port_model(arr, K)
    model.draw_noise = fixed_noise(
        [(_t(arr[f"zs{i}"]), _t(arr[f"gs{i}"])) for i in range(EXPERT_STEPS)])
    step = pt.make_train_step(pt.Adam(model, LR))
    losses = [float(step(model, None, _t(arr["X"]), _t(arr["Y"])))
              for _ in range(EXPERT_STEPS)]
    full = {n: p.detach().numpy() for n, p in model.named_parameters()}
    dims = {"likelihood.variance.raw": 1, "pred_layer.q_mu.raw": 1,
            "pred_layer.q_sqrt.raw": 0, "assign_layer.q_mu.raw": 1,
            "assign_layer.q_sqrt.raw": 0}
    for res in ranks:
        np.testing.assert_allclose(res["expert_losses"], losses, rtol=1e-10)
        e = res["expert_index"]
        want = {n: (np.take(v, range(2 * e, 2 * e + 2), axis=dims[n])
                    if n in dims else v) for n, v in full.items()}
        _close(res["expert_steps"], want, "expert step")


@pytest.mark.parametrize("case", [("P4", 16), ("P4", 32), ("P2", 32)])
def test_distributed_cholesky_and_solve_match_jax(ranks, ref, case):
    L = np.zeros((M_CHOL, M_CHOL))
    X = np.zeros((M_CHOL, N_RHS))
    seen = set()
    for res in ranks:
        index, L_loc, _, X_loc = res[(*case, "chol")]
        n = L_loc.shape[0]
        L[index * n:(index + 1) * n] = L_loc.numpy()
        X[index * n:(index + 1) * n] = X_loc.numpy()
        seen.add(index)
    assert seen == set(range(M_CHOL // n))
    np.testing.assert_allclose(L, ref["L"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(X, ref["X"], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", [("P4", 16), ("P4", 32), ("P2", 32)])
def test_distributed_cholesky_gradient_matches_the_dense_pullback(ranks, ref,
                                                                  case):
    """Each rank's backward of sum(W * L) over its rows, through the panel
    collectives: the symmetric part of the gathered gradient equals the
    port's dense Cholesky pullback (ops.linalg.cholesky)."""
    from modulatedgps_tpu_torch.ops.linalg import cholesky
    A = _t(ref["arrays"]["A"]).requires_grad_(True)
    (cholesky(A) * _t(ref["arrays"]["W"])).sum().backward()
    G = np.zeros((M_CHOL, M_CHOL))
    for res in ranks:
        index, L_loc, grad, _ = res[(*case, "chol")]
        n = L_loc.shape[0]
        G[index * n:(index + 1) * n] = grad.numpy()
    np.testing.assert_allclose(0.5 * (G + G.T), A.grad.numpy(), rtol=1e-9,
                               atol=1e-11)


def test_distributed_cholesky_refuses_bad_layouts(ranks):
    for res in ranks:
        errors = res["chol_errors"]
        assert len(errors) == 4
        assert all("rows-per-device 24" in e for e in errors[:2])
        assert all("multiple of the 'data' axis" in e for e in errors[2:])
