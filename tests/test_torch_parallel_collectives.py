"""The differentiable collectives of modulatedgps_tpu_torch.parallel and its
process-group start-up, on gloo ranks on the CPU (no JAX: this module is
also the one the other parallel test files take their rank harness from).

Each Function runs in 4 spawned ranks, on the world group (P = 4) and on
two groups of 2 (P = 2), in float64.  Every rank's input x_r and the
weights w_r of its output's cotangent are seeded by (group, rank); the
ranks take the backward of sum(w_r * y_r), their shares of the global
scalar sum_r sum(w_r * y_r) (the sum-over-ranks convention that
collectives.py states).  The oracle is one process computing every rank's
output from all inputs with plain tensor ops, and the autograd gradient of
that global scalar: values and gradients must match to rounding (rtol
1e-12).  A rank's failure or a wait over the timeout fails the test with
the rank's traceback.

``run_ranks`` starts the ranks: torch.multiprocessing spawn, gloo over a
file:// store under the test's tmp_path (no TCP port), one intra-op thread
a rank, a 120 s collective timeout and a deadline on the whole job.  The
rank programs are module-level functions of modules that import no JAX at
their top level, because each spawned rank imports its module again.
"""
import contextlib
import datetime
import json
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 240


# ------------------------------------------------------------ rank harness

def _entry(rank, fn, world, store, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, tmp_path, *args, world=WORLD, deadline=DEADLINE_S):
    """fn(rank, world, *args) in ``world`` spawned gloo ranks; raises with
    a rank's traceback if one fails, TimeoutError past ``deadline`` s."""
    store = tmp_path / "store"
    ctx = mp.start_processes(_entry, args=(fn, world, str(store), args),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > end:
                raise TimeoutError(f"ranks still running after {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


# The torch.distributed calls that move data between ranks (point-to-point
# traffic goes through batch_isend_irecv: P2POp checks its op against the
# unwrapped isend / irecv, so those stay as they are).
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_single", "reduce_scatter", "reduce_scatter_tensor",
               "reduce_scatter_single", "broadcast", "all_to_all",
               "all_to_all_single", "batch_isend_irecv")


@contextlib.contextmanager
def record_collectives():
    """Wrap torch.distributed's collectives for the block: yields a list
    that gets (name, shape, bytes) for each call (for batch_isend_irecv,
    one row per send in the batch, its bytes those of the sent tensor)."""
    calls = []

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            if name == "batch_isend_irecv":
                calls.extend(("send", tuple(op.tensor.shape),
                              op.tensor.numel() * op.tensor.element_size())
                             for op in args[0] if op.op.__name__ == "isend")
            else:
                t = args[0] if args else next(iter(kwargs.values()))
                if isinstance(t, (list, tuple)):
                    t = t[0]
                calls.append((name, tuple(t.shape),
                              t.numel() * t.element_size()))
            return fn(*args, **kwargs)
        return recorded

    saved = {n: getattr(dist, n) for n in COLLECTIVES if hasattr(dist, n)}
    try:
        for name, fn in saved.items():
            setattr(dist, name, wrap(name, fn))
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def as_tensor(a):
    """A writable tensor copy of an array (np.load's are read-only)."""
    return torch.tensor(np.asarray(a))


def fixed_noise(pairs):
    """A draw_noise that hands out the given (z, g) pairs in turn: a rank
    program takes JAX's noise through it."""
    it = iter(pairs)
    return lambda generator, n, s, dtype: next(it)


def jax_leaves(tree):
    """{pytree path: numpy array} of a JAX pytree (imports jax: call it in
    the test process only)."""
    import jax
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def save_rank(out_dir, rank, results):
    torch.save(results, Path(out_dir) / f"rank{rank}.pt")


def load_ranks(out_dir, world=WORLD):
    return [torch.load(Path(out_dir) / f"rank{r}.pt") for r in range(world)]


# ------------------------------------------------------- the collectives

GROUPS = {"P4": [(0, 1, 2, 3)], "P2": [(0, 1), (2, 3)]}
OPS = ("all_gather", "all_gather_last", "all_gather_stacked", "psum",
       "psum_scatter", "psum_scatter_last", "ppermute_ring",
       "ppermute_partial", "share")


def _perm(op, P):
    if op == "ppermute_ring":
        return tuple((i, (i + 1) % P) for i in range(P))
    return ((0, P - 1), (P - 1, 0))          # two ranks swap, others get 0


def _inputs(label, op, r, P):
    """(x, w) of group rank r: seeded by the case, w shaped like y."""
    seed = zlib.crc32(f"{label} {op} {r}".encode())
    g = torch.Generator().manual_seed(seed)
    shape = {"psum_scatter": (2 * P, 3), "psum_scatter_last": (3, 2 * P)}.get(
        op, (2, 3))
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    out = {"all_gather": (2 * P, 3), "all_gather_last": (2, 3 * P),
           "all_gather_stacked": (P, 2, 3), "psum_scatter": (2, 3),
           "psum_scatter_last": (3, 2), "share": ()}.get(op, (2, 3))
    return x, torch.randn(out, generator=g, dtype=torch.float64)


def _apply(op, x, group, P):
    from modulatedgps_tpu_torch.parallel import collectives as c
    if op == "all_gather":
        return c.all_gather(x, group)
    if op == "all_gather_last":
        return c.all_gather(x, group, dim=-1)
    if op == "all_gather_stacked":
        return c.all_gather(x, group, tiled=False)
    if op == "psum":
        return c.psum(x, group)
    if op == "psum_scatter":
        return c.psum_scatter(x, group)
    if op == "psum_scatter_last":
        return c.psum_scatter(x, group, dim=-1)
    if op == "share":                        # a replicated scalar's share
        return c.share(c.psum(x.square().sum(), group), group)
    return c.ppermute(x, group, _perm(op, P))


def _oracle(op, xs):
    """Every rank's output from all ranks' inputs, in one process."""
    P = len(xs)
    if op == "all_gather":
        return [torch.cat(xs)] * P
    if op == "all_gather_last":
        return [torch.cat(xs, -1)] * P
    if op == "all_gather_stacked":
        return [torch.stack(xs)] * P
    if op == "psum":
        return [sum(xs)] * P
    if op in ("psum_scatter", "psum_scatter_last"):
        dim = 0 if op == "psum_scatter" else -1
        return list(sum(xs).chunk(P, dim))
    if op == "share":
        return [sum(x.square().sum() for x in xs) / P] * P
    out = [torch.zeros_like(xs[0]) for _ in xs]
    for src, dst in _perm(op, P):
        out[dst] = xs[src]
    return out


def collectives_program(rank, world, out_dir):
    groups = {label: [dist.new_group(list(ranks)) for ranks in sets]
              for label, sets in GROUPS.items()}
    results = {}
    for label, sets in GROUPS.items():
        for ranks, group in zip(sets, groups[label]):
            if rank not in ranks:
                continue
            r, P = ranks.index(rank), len(ranks)
            for op in OPS:
                x, w = _inputs(label, op, r, P)
                x.requires_grad_(True)
                y = _apply(op, x, group, P)
                (w * y).sum().backward()
                results[(label, op)] = (r, y.detach(), x.grad)
    save_rank(out_dir, rank, results)


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    run_ranks(collectives_program, tmp, str(tmp))
    return load_ranks(tmp)


@pytest.mark.parametrize("label", sorted(GROUPS))
@pytest.mark.parametrize("op", OPS)
def test_collective_value_and_gradient_match_the_oracle(collective_runs, op,
                                                        label):
    for ranks in GROUPS[label]:
        P = len(ranks)
        got = [collective_runs[rank][(label, op)] for rank in ranks]
        assert [r for r, _, _ in got] == list(range(P))
        xs, ws = zip(*(_inputs(label, op, r, P) for r in range(P)))
        xs = [x.clone().requires_grad_(True) for x in xs]
        ys = _oracle(op, xs)
        sum((w * y).sum() for w, y in zip(ws, ys)).backward()
        for r, (_, y, grad) in enumerate(got):
            np.testing.assert_allclose(y.numpy(), ys[r].detach().numpy(),
                                       rtol=1e-12, atol=1e-14)
            want = (xs[r].grad if xs[r].grad is not None      # unused: 0
                    else torch.zeros_like(xs[r]))
            np.testing.assert_allclose(grad.numpy(), want.numpy(),
                                       rtol=1e-12, atol=1e-14)


# ------------------------------------------------ backends and start-up

def test_backend_follows_the_device():
    from modulatedgps_tpu_torch.parallel import multihost
    assert multihost.backend_for("cpu") == "gloo"
    if torch.cuda.is_available():
        assert multihost.backend_for("cuda") == "nccl"
    else:
        with pytest.raises(RuntimeError, match="card"):
            multihost.backend_for("cuda")
    with pytest.raises(ValueError):
        multihost.backend_for("meta")


def test_single_process_initialize_is_a_no_op(monkeypatch):
    from modulatedgps_tpu_torch.parallel import multihost
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK",
                 "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(name, raising=False)
    multihost.initialize_multihost(device="cpu")
    assert not dist.is_initialized()
    assert multihost.is_coordinator()


def _torchrun_job(out_dir):
    """One process of the 2-process job below, started by torchrun."""
    from modulatedgps_tpu_torch.parallel import (global_mesh,
                                                 initialize_multihost,
                                                 is_coordinator, shard_batch)
    torch.set_num_threads(1)
    initialize_multihost(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = global_mesh(num_expert=2, device="cpu")
    x = shard_batch(mesh, torch.arange(8.0))
    total = torch.tensor(float(rank + 1))
    dist.all_reduce(total)
    res = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "coordinator": is_coordinator(),
           "mesh": [mesh.size(0), mesh.size(1)], "rows": x.tolist(),
           "total": float(total), "run_id": os.environ["TORCHELASTIC_RUN_ID"]}
    Path(out_dir, f"ok_{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def test_two_process_job_started_by_torchrun(tmp_path):
    """torchrun (--standalone: its own free localhost port) starts 2
    processes that run initialize_multihost() from torchrun's variables,
    build the global mesh (data 1 x expert 2) and all-reduce across both."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node=2", "-m", "test_torch_parallel_collectives",
           str(tmp_path)]
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=180)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    rows = [json.loads((tmp_path / f"ok_{r}.json").read_text())
            for r in range(2)]
    assert [r["rank"] for r in rows] == [0, 1]
    assert [r["coordinator"] for r in rows] == [True, False]
    for r in rows:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["mesh"] == [1, 2] and r["rows"] == list(range(8))
        assert r["total"] == 3.0 and r["run_id"] == rows[0]["run_id"]


if __name__ == "__main__":
    _torchrun_job(sys.argv[1])
