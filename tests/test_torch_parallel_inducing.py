"""modulatedgps_tpu_torch.parallel's inducing-sharded path against the JAX
package's, float64.

The JAX references (inducing_sharded_elbo with its gradient,
inducing_sharded_predict_f and three steps of
make_inducing_sharded_train_step over optax.adam) run once per module on
the conftest's 8-device CPU mesh at M = 64 and 128 (K = 3, D = 2, N = 32,
S = 5), with test_inducing_sharded.py's randomized state.  The port runs in
4 gloo ranks spawned once for the module, with the inducing state sharded
over "data" on three meshes: 4 x 1 (P4), 2 x 2 (P2: the expert ranks
repeat the work) and 1 x 4 (P1: each rank holds the whole matrix, so Adam
takes kernel #14's tril update).  It takes JAX's noise: the ELBO's key and
each step's subkey of the TrainState key.

Tolerances as tests/test_inducing_sharded.py holds JAX's sharded path
against the replicated one: the ELBO at rtol 1e-10 (another block layout
of the Cholesky: 16-64 rows a rank here, 8-16 in JAX), gradients and
leaves at rtol 1e-8, atol 1e-10 (the leaves after 3 Adam steps at atol
1e-8: ATOL_ADAM); predict_f at rtol 1e-10 and an atol of
1e-10 of its largest magnitude (the means' near-zero entries move by a few
1e-12 between the two layouts).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_parallel_collectives import (as_tensor as _t, fixed_noise,
                                             jax_leaves, load_ranks,
                                             record_collectives, run_ranks,
                                             save_rank)

K, D, N, S = 3, 2, 32, 5
SIZES = (64, 128)
LR, STEPS = 1e-2, 3
MESHES = {"P4": (4, 1), "P2": (2, 2), "P1": (1, 4)}
AUDIT_M, AUDIT_N = 64, (128, 1024)
# Adam's update g / (|g| + eps) turns a rounding-level difference in a
# near-zero gradient entry into up to LR times its relative size: after 3
# steps at M=128 two q_sqrt entries land 1.1e-9 off JAX's.
ATOL_ADAM = 1e-8


# ------------------------------------------------------------- the ranks


def _port_model(arrays, M, whiten=True):
    import modulatedgps_tpu_torch as pt
    leaves = {key.split(":", 1)[1]: arrays[key] for key in arrays
              if key.startswith(f"m{M}:")}
    return pt.smgp_from_numpy(leaves, K=K, num_samples=S, num_data=N,
                              temperature=1e-2, device="cpu",
                              dtype=torch.float64, whiten=whiten)


def _resized_model(arrays, M):
    """The M=64 state's kernels and likelihood with M inducing points (Z,
    q_mu drawn anew, q_sqrt the identity)."""
    import modulatedgps_tpu_torch as pt
    rng = np.random.default_rng(M)
    leaves = {key.split(":", 1)[1]: arrays[key] for key in arrays
              if key.startswith("m64:")}
    for key, value in leaves.items():
        if key.endswith(("Z.raw", "q_mu.raw")):
            leaves[key] = rng.normal(size=(M, value.shape[1]))
        elif key.endswith("q_sqrt.raw"):
            leaves[key] = np.tile(np.eye(M), (value.shape[0], 1, 1))
    return pt.smgp_from_numpy(leaves, K=K, num_samples=S, num_data=N,
                              temperature=1e-2, device="cpu",
                              dtype=torch.float64)


def _upper_nonzero(block, index):
    """Entries of a [K, M, M / P] column block above the global diagonal
    that are not exactly 0."""
    K_, M, rpd = block.shape
    cols = index * rpd + torch.arange(rpd)
    upper = torch.arange(M)[:, None] < cols[None, :]
    return int((block[:, upper] != 0).sum())


def _case(arr, M, mesh):
    from modulatedgps_tpu_torch import Adam
    from modulatedgps_tpu_torch import parallel as par
    from modulatedgps_tpu_torch.parallel.collectives import all_gather, share
    from modulatedgps_tpu_torch.parallel.mesh import axis_group
    group, index, size = axis_group(mesh, "data")
    X, Y = par.shard_batch(mesh, _t(arr["X"]), _t(arr["Y"]))
    out = {}

    # The ELBO of the replicated model and its gradient (each rank's
    # backward of its share; one all-reduce completes every leaf).
    model = _port_model(arr, M)
    elbo = par.inducing_sharded_elbo_from_noise(
        model, X, Y, _t(arr[f"m{M}/z"]), _t(arr[f"m{M}/g"]), mesh)
    share(elbo, group).backward()
    grads = {}
    for name, p in model.named_parameters():
        dist.all_reduce(p.grad, group=group)
        grads[name] = p.grad.clone()
    out["elbo"] = (float(elbo.detach()), grads)

    with torch.no_grad():
        mu, var = par.inducing_sharded_predict_f(model.pred_layer, X, mesh)
        out["predict_f"] = (all_gather(mu, group), all_gather(var, group))

    # Three steps of the sharded state (routed by make_parallel_train_step).
    sharded = par.inducing_shard_state(mesh, _port_model(arr, M))
    sharded.draw_noise = fixed_noise(
        [(_t(arr[f"m{M}/zs{i}"]), _t(arr[f"m{M}/gs{i}"]))
         for i in range(STEPS)])
    opt = Adam(sharded, LR)
    step = par.make_parallel_train_step(opt, mesh, K=K, shard_inducing=True)
    out["losses"] = [float(step(sharded, None, X, Y)) for _ in range(STEPS)]
    full = par.inducing_gather_state(mesh, sharded)
    out["leaves"] = {n: p.detach().clone() for n, p in full.named_parameters()}
    tril = dict(zip(opt.names, opt.tril))
    out["adam_tril"] = {n: tril[n] for n in tril if n.endswith("q_sqrt.raw")}
    out["upper_nonzero"] = {
        f"{name} {what}": _upper_nonzero(t, index)
        for name, p, m, v in zip(opt.names, opt.params, opt.m, opt.v)
        if name.endswith("q_sqrt.raw")
        for what, t in (("p", p), ("m", m), ("v", v))}
    out["local_shapes"] = {n: tuple(p.shape)
                           for n, p in sharded.named_parameters()}
    refused = []
    for call in (lambda: sharded.pred_layer.predict_f(X),
                 lambda: sharded.assign_layer.prior_kl()):
        try:
            call()
        except NotImplementedError as e:
            refused.append(str(e))
    out["refused"] = refused
    out["index"] = index
    return out


def _audit(arr, mesh):
    """One sharded step's collectives at N = 128 and 1024 (M = 64)."""
    from modulatedgps_tpu_torch import Adam
    from modulatedgps_tpu_torch import parallel as par
    calls = {}
    for n in AUDIT_N:
        X, Y = par.shard_batch(mesh, _t(arr[f"audit{n}/X"]),
                               _t(arr[f"audit{n}/Y"]))
        model = _port_model(arr, AUDIT_M)
        model.num_data = n
        sharded = par.inducing_shard_state(mesh, model)
        step = par.make_inducing_sharded_train_step(Adam(sharded, LR), mesh)
        gen = torch.Generator().manual_seed(0)
        with record_collectives() as got:
            step(sharded, gen, X, Y)
        calls[n] = sorted(got)
    return calls


def inducing_program(rank, world, inputs, out_dir):
    from modulatedgps_tpu_torch import parallel as par
    arr = dict(np.load(inputs))
    res = {}
    meshes = {label: par.make_mesh(*shape, device="cpu")
              for label, shape in MESHES.items()}
    for M in SIZES:
        for label, mesh in meshes.items():
            res[(M, label)] = _case(arr, M, mesh)
    res["audit"] = _audit(arr, meshes["P4"])
    errors = []
    X, Y = par.shard_batch(meshes["P4"], _t(arr["X"]), _t(arr["Y"]))
    z, g = _t(arr["m64/z"]), _t(arr["m64/g"])
    unwhitened = _port_model(arr, 64, whiten=False)
    diagonal = _port_model(arr, 64)
    diagonal.pred_layer.q_sqrt.raw = torch.nn.Parameter(torch.ones(64, K))
    for model in (unwhitened, diagonal):
        try:
            par.inducing_sharded_elbo_from_noise(model, X, Y, z, g,
                                                 meshes["P4"])
        except NotImplementedError as e:
            errors.append(str(e))
    res["errors"] = errors
    # Block layouts that leave a panel to no rank: 16 rows a rank in blocks
    # of 24, and 300 rows on one rank in the default blocks of 128.
    layout_errors = []
    for model, mesh, block in ((_port_model(arr, 64), meshes["P4"], 24),
                               (_resized_model(arr, 300), meshes["P1"], None)):
        Xm, Ym = par.shard_batch(mesh, _t(arr["X"]), _t(arr["Y"]))
        for call in (
                lambda: par.inducing_sharded_elbo_from_noise(
                    model, Xm, Ym, z, g, mesh, block=block),
                lambda: par.inducing_sharded_predict_f(
                    model.assign_layer, Xm, mesh, block=block)):
            try:
                call()
            except ValueError as e:
                layout_errors.append(str(e))
    res["layout_errors"] = layout_errors
    save_rank(out_dir, rank, res)


# ---------------------------------------------------- the JAX references


def _jax_model(rng, M, randomize=True):
    """tests/test_inducing_sharded.py's _model (N = 32 there too)."""
    import jax
    import jax.numpy as jnp
    from modulatedgps_tpu.likelihoods import Gaussian
    from modulatedgps_tpu.models import SMGP, SVGP
    from modulatedgps_tpu.ops.kernels import SquaredExponential
    pred = SVGP.create(SquaredExponential.create(0.5, 0.5),
                       rng.normal(size=(M, D)), num_latent_gps=K)
    assign = SVGP.create(SquaredExponential.create(0.1, 1.0),
                         rng.normal(size=(M, D)), num_latent_gps=K)
    if randomize:
        def rnd(layer, seed):
            k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
            q_mu = 0.3 * jax.random.normal(k1, (M, K))
            q_sqrt = (jnp.tril(0.1 * jax.random.normal(k2, (K, M, M)))
                      + jnp.eye(M) * 0.8)
            return layer.replace(q_mu=layer.q_mu.replace_raw(q_mu),
                                 q_sqrt=layer.q_sqrt.replace_raw(q_sqrt))
        pred, assign = rnd(pred, 1), rnd(assign, 2)
    return SMGP(likelihood=Gaussian.create(0.5, D=K), pred_layer=pred,
                assign_layer=assign, K=K, num_samples=S, num_data=N)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax
    from modulatedgps_tpu.parallel import (inducing_sharded_elbo,
                                           inducing_sharded_predict_f,
                                           make_mesh, shard_batch)
    from modulatedgps_tpu.parallel.inducing import (
        make_inducing_sharded_train_step)
    rng = np.random.default_rng(0)
    mesh = make_mesh(num_data=8, num_expert=1)
    X = rng.uniform(-3, 3, size=(N, D))
    Y = rng.normal(size=(N, 1))
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    arrays, out = {"X": X, "Y": Y}, {}
    key = jax.random.PRNGKey(0)
    for M in SIZES:
        jm = _jax_model(rng, M)
        arrays.update({f"m{M}:{n}": v for n, v in jax_leaves(jm).items()})
        z, g = jm.draw_noise(key, N, S, jnp.float64)
        arrays[f"m{M}/z"], arrays[f"m{M}/g"] = np.asarray(z), np.asarray(g)
        elbo, grads = jax.jit(jax.value_and_grad(
            lambda m: inducing_sharded_elbo(m, key, Xj, Yj, mesh)))(jm)
        mu, var = jax.jit(lambda layer: inducing_sharded_predict_f(
            layer, Xj, mesh))(jm.pred_layer)
        init_fn, step_fn = make_inducing_sharded_train_step(
            optax.adam(LR), mesh, donate=False)
        state = init_fn(jm, jax.random.PRNGKey(0))
        Xs, Ys = shard_batch(mesh, Xj, Yj)
        losses, k = [], jax.random.PRNGKey(0)
        for i in range(STEPS):
            k, sub = jax.random.split(k)
            zs, gs = jm.draw_noise(sub, N, S, jnp.float64)
            arrays[f"m{M}/zs{i}"], arrays[f"m{M}/gs{i}"] = (np.asarray(zs),
                                                            np.asarray(gs))
            state, loss = step_fn(state, Xs, Ys)
            losses.append(float(loss))
        out[M] = {"elbo": float(elbo), "grads": jax_leaves(grads),
                  "mu": np.asarray(mu), "var": np.asarray(var),
                  "losses": losses, "leaves": jax_leaves(state.model)}
    for n in AUDIT_N:
        arrays[f"audit{n}/X"] = rng.uniform(-3, 3, size=(n, D))
        arrays[f"audit{n}/Y"] = rng.normal(size=(n, 1))
    tmp = tmp_path_factory.mktemp("inducing")
    np.savez(tmp / "inputs.npz", **arrays)
    out["tmp"], out["inputs"] = tmp, tmp / "inputs.npz"
    return out


@pytest.fixture(scope="module")
def ranks(ref):
    out = ref["tmp"] / "out"
    out.mkdir()
    run_ranks(inducing_program, ref["tmp"], str(ref["inputs"]), str(out))
    return load_ranks(out)


def _close(got, want, what, rtol=1e-8, atol=1e-10):
    assert sorted(got) == sorted(want), what
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]), want[name],
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


CASES = [(M, label) for M in SIZES for label in MESHES]


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("M, label", CASES)
def test_elbo_and_gradient_match_jax(ranks, ref, M, label):
    for res in ranks:
        elbo, grads = res[(M, label)]["elbo"]
        np.testing.assert_allclose(elbo, ref[M]["elbo"], rtol=1e-10)
        _close(grads, ref[M]["grads"], f"M={M} {label} gradient")


@pytest.mark.parametrize("M, label", CASES)
def test_predict_f_matches_jax(ranks, ref, M, label):
    for res in ranks:
        for got, want in zip(res[(M, label)]["predict_f"],
                             (ref[M]["mu"], ref[M]["var"])):
            np.testing.assert_allclose(got, want, rtol=1e-10,
                                       atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("M, label", CASES)
def test_three_adam_steps_match_jax(ranks, ref, M, label):
    for res in ranks:
        case = res[(M, label)]
        np.testing.assert_allclose(case["losses"], ref[M]["losses"],
                                   rtol=1e-9)
        _close(case["leaves"], ref[M]["leaves"], f"M={M} {label} leaves",
               atol=ATOL_ADAM)


@pytest.mark.parametrize("M, label", CASES)
def test_sharded_state_layout_and_adam_route(ranks, M, label):
    """Z and q_mu rows, q_sqrt columns; the global-upper entries of q_sqrt
    and of its Adam moments exactly 0 after the steps; Adam's tril kernel
    only where a rank holds the whole matrix; the replicated methods
    refused on a shard."""
    P = MESHES[label][0]
    for res in ranks:
        case = res[(M, label)]
        shapes = case["local_shapes"]
        for layer in ("pred_layer", "assign_layer"):
            assert shapes[f"{layer}.Z.raw"] == (M // P, D)
            assert shapes[f"{layer}.q_mu.raw"] == (M // P, K)
            assert shapes[f"{layer}.q_sqrt.raw"] == (K, M, M // P)
            assert shapes[f"{layer}.kernel.variance.raw"] == ()
            assert case["adam_tril"][f"{layer}.q_sqrt.raw"] == (P == 1)
        assert set(case["upper_nonzero"].values()) == {0}, case["upper_nonzero"]
        assert len(case["refused"]) == 2
        assert all("ShardedSVGP" in e for e in case["refused"])


def test_collective_payload_does_not_grow_with_n(ranks):
    """The port's counterpart of TestCollectiveAudit: one step's
    collectives (op, shape, bytes) are the same at N = 128 and N = 1024,
    and the ring moves [K, M, M / P] blocks, P - 1 a layer each way."""
    P, M = 4, AUDIT_M
    for res in ranks:
        small, large = (res["audit"][n] for n in AUDIT_N)
        assert small == large
        sends = [c for c in small if c[0] == "send"]
        assert sends == [("send", (K, M, M // P), K * M * M // P * 8)] * (
            2 * 2 * (P - 1))
        assert all(128 not in shape and 1024 not in shape
                   and N not in shape for _, shape, _ in small)


def test_unwhitened_and_diagonal_layers_raise(ranks):
    for res in ranks:
        assert len(res["errors"]) == 2
        assert "whiten" in res["errors"][0]
        assert "tril q_sqrt" in res["errors"][1]


def test_block_layout_without_an_owner_raises(ranks):
    """Where a rank's rows are not whole panels, some panel has no owner
    and would factor as zeros (a NaN ELBO): the ELBO and predict_f refuse
    the layout with distributed_cholesky's ValueError instead."""
    for res in ranks:
        assert len(res["layout_errors"]) == 4, res["layout_errors"]
        assert all("must be a multiple of block=" in e
                   for e in res["layout_errors"]), res["layout_errors"]


def test_inducing_specs_match_jax():
    import jax
    from jax.sharding import PartitionSpec

    import modulatedgps_tpu_torch as pt
    from modulatedgps_tpu.parallel.inducing import inducing_specs as jspecs
    from modulatedgps_tpu_torch.parallel.inducing import inducing_specs
    jm = _jax_model(np.random.default_rng(1), 16, randomize=False)
    model = pt.smgp_from_numpy(jax_leaves(jm), K=K, num_samples=S,
                               num_data=N, temperature=1e-2, device="cpu",
                               dtype=torch.float64)
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs(jm, "data"),
        is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    want = {jax.tree_util.keystr(path, simple=True, separator="."):
            tuple(spec) for path, spec in flat}
    assert inducing_specs(model, "data") == want
