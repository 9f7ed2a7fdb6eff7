"""The inducing-sharded training step of modulatedgps_tpu_torch.parallel
against the benchmark's plain float64 reference, and its spans and byte
counters, on 4 gloo ranks (no JAX).

The ranks are spawned once for the module (test_torch_parallel_collectives'
harness, one torch thread a rank).  For each Cholesky panel width (8 and
16 rows: 8 and 4 panels a rank) they build the benchmark's SMGP
(torchbench/harness/state.py's state, drawn from a seed) at M = 64, K = 2,
D = 2, S = 4, shard it with ``inducing_shard_state`` and train it with
``make_inducing_sharded_train_step``:

- one step in float64 on a global batch of 32 points, with the noise the
  reference draws, against torchbench/reference/smgp_sharded_k8_m16384.py
  on the same ranks: the loss, every leaf's gradient norm (Adam's first
  moment over 1 - b1) and every leaf's change after the one Adam update;
- one float32 step under torch.profiler: the spans it records (names and
  outermost counts: the step's four, each layer's factor and ring forward
  and backward, one ``mgp.dist.comm.*`` a collective call) and the bytes
  the counters hold, against the bytes counted from the shapes of every
  collective call (recorded by wrapping torch.distributed) and against the
  benchmark's work count (torchbench/work/);
- one float32 step with no profiler: nothing recorded, no marker node in
  the autograd graph, and ``region`` handing back what its function gives.
"""
import math
import sys
from pathlib import Path

import pytest
import torch

from test_torch_parallel_collectives import (load_ranks, record_collectives,
                                             run_ranks, save_rank)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

M, K, D, S, N, WORLD = 64, 2, 2, 4, 32, 4
BLOCKS = (8, 16)
SEED = 2 ** 31 + 12345
STEP_SPANS = ("mgp.step", "mgp.loss", "mgp.backward", "mgp.adam")
REGION_SPANS = ("mgp.dist.chol.fwd", "mgp.dist.chol.bwd",
                "mgp.dist.ring.fwd", "mgp.dist.ring.bwd")
MARKS = ("_MarkBackward",)
COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce", "ppermute")


def _config(block):
    import json
    cfg = json.loads((ROOT / "torchbench" / "configs"
                      / "smgp_sharded_k8_m16384.json").read_text())
    return dict(cfg, M=M, K=K, D=D, S=S, num_data=4096, ranks=WORLD,
                block=block)


def _batch(dtype):
    g = torch.Generator().manual_seed(7)
    X = torch.rand((N, D), generator=g, dtype=torch.float64) * 6 - 3
    Y = torch.randn((N, 1), generator=g, dtype=torch.float64)
    return X.to(dtype), Y.to(dtype)


def _sharded(cfg, mesh, dtype):
    """(model, Adam, step) of the benchmark's state, sharded."""
    from modulatedgps_tpu_torch import Adam
    from modulatedgps_tpu_torch import parallel as par
    from torchbench.harness import state as st
    cpu = torch.device("cpu")
    full = st.build_model(cfg, st.make_state(cfg, SEED, cpu), cpu, dtype)
    model = par.inducing_shard_state(mesh, full)
    opt = Adam(model, cfg["lr"])
    step = par.make_inducing_sharded_train_step(opt, mesh, block=cfg["block"])
    return model, opt, step


def _reference_noise(cfg, noise_seed):
    """A draw_noise handing the program the reference's noise: z and the
    Gumbel transform of u, drawn as _plain.noise draws them."""
    from torchbench.reference import _plain

    def draw(generator, n, s, dtype):
        z, u = _plain.noise(torch.Generator().manual_seed(noise_seed), cfg, n,
                            dtype)
        return z, -torch.log(-torch.log(u))
    return draw


def _against_reference(cfg, mesh):
    """One float64 step of the program and of the reference (at the f32
    jitter floor the card runs, which the reference takes)."""
    import modulatedgps_tpu_torch as pt
    from modulatedgps_tpu_torch import parallel as par
    from modulatedgps_tpu_torch.parallel.mesh import axis_group
    from torchbench.harness import state as st
    from torchbench.harness.train_sharded import _block, _global_norms
    from torchbench.reference import _plain
    from torchbench.reference import smgp_sharded_k8_m16384 as ref
    group, index, world = axis_group(mesh, "data")
    model, opt, step = _sharded(cfg, mesh, torch.float64)
    model.draw_noise = _reference_noise(cfg, 99)
    X, Y = _batch(torch.float64)
    with pt.config_context(jitter=cfg["jitter"]):
        loss = float(step(model, None, *par.shard_batch(mesh, X, Y)))
    start = st.make_state(cfg, SEED, torch.device("cpu"))
    params = dict(model.named_parameters())
    program = {
        "losses": [loss],
        "grad_norms": _global_norms({n: m / (1 - opt.b1) for n, m
                                     in zip(opt.names, opt.m)}, group),
        "change_norms": _global_norms(
            {k: params[k] - _block(k, start[k], index, world).double()
             for k in start}, group)}
    blocks = {k: _block(k, t, index, world) if k.endswith("q_sqrt.raw")
              else t for k, t in start.items()}
    want = ref.train_readings(cfg, blocks, [(X, Y)], 99, 1,
                              _plain.Precision("reference"), group=group)
    return program, want


def _profiled(cfg, mesh):
    """One float32 step under torch.profiler: (span table, counters,
    the collectives called)."""
    from torch.profiler import ProfilerActivity, profile

    from modulatedgps_tpu_torch import parallel as par
    from modulatedgps_tpu_torch.utils import profiling
    model, _, step = _sharded(cfg, mesh, torch.float32)
    X, Y = par.shard_batch(mesh, *_batch(torch.float32))
    gen = torch.Generator().manual_seed(5)
    step(model, gen, X, Y)
    profiling.reset_spans()
    with record_collectives() as calls, \
            profile(activities=[ProfilerActivity.CPU]):
        step(model, gen, X, Y)
    out = profiling.span_table(), profiling.counter_table(), list(calls)
    profiling.reset_spans()
    return out


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


def _unprofiled(cfg, mesh):
    """A float32 step and an ELBO's graph with no profiler recording."""
    from modulatedgps_tpu_torch import parallel as par
    from modulatedgps_tpu_torch.utils import profiling
    model, _, step = _sharded(cfg, mesh, torch.float32)
    X, Y = par.shard_batch(mesh, *_batch(torch.float32))
    gen = torch.Generator().manual_seed(5)
    profiling.reset_spans()
    step(model, gen, X, Y)
    elbo = par.inducing_sharded_elbo(model, gen, X, Y, mesh,
                                     block=cfg["block"])
    out = torch.ones(3)
    return {"spans": profiling.span_table(),
            "counters": profiling.counter_table(),
            "marks": sorted(_graph_names(elbo) & set(MARKS)),
            "region_is_fn": profiling.region("mgp.t", lambda t: out,
                                             torch.zeros(3)) is out}


def spans_program(rank, world, out_dir):
    from modulatedgps_tpu_torch import parallel as par
    mesh = par.make_mesh(device="cpu")
    results = {}
    for block in BLOCKS:
        cfg = _config(block)
        results[block] = {"reference": _against_reference(cfg, mesh),
                          "profiled": _profiled(cfg, mesh),
                          "off": _unprofiled(cfg, mesh)}
    save_rank(out_dir, rank, results)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_spans")
    run_ranks(spans_program, tmp, str(tmp))
    return load_ranks(tmp)


@pytest.mark.parametrize("block", BLOCKS)
def test_step_matches_the_plain_reference(ranks, block):
    """Loss, gradient norms and the change after one Adam update, float64
    both sides: only the order of the sums differs."""
    for res in ranks:
        program, want = res[block]["reference"]
        assert program["losses"][0] == pytest.approx(want["losses"][0],
                                                     rel=1e-11)
        for key in ("grad_norms", "change_norms"):
            assert set(program[key]) == set(want[key])
            for leaf, value in want[key].items():
                assert program[key][leaf] == pytest.approx(
                    value, rel=1e-8, abs=1e-12), (key, leaf)


@pytest.mark.parametrize("block", BLOCKS)
def test_step_records_its_spans_once_a_step(ranks, block):
    for res in ranks:
        table, _, calls = res[block]["profiled"]
        for name in STEP_SPANS:
            assert table[name]["calls"] == table[name]["outer_calls"] == 1
        for name in REGION_SPANS:           # one a layer
            assert table[name]["calls"] == table[name]["outer_calls"] == 2
        comm = {n: r for n, r in table.items()
                if n.startswith("mgp.dist.comm.")}
        assert sum(r["calls"] for r in comm.values()) == len(calls)
        assert all(r["outer_calls"] == r["calls"] for r in comm.values())
        assert set(comm) == {f"mgp.dist.comm.{c}" for c in COLLECTIVES}
        assert {n for n in table if n.startswith("mgp.dist.")} == (
            set(REGION_SPANS) | set(comm))


@pytest.mark.parametrize("block", BLOCKS)
def test_factor_panels_call_two_collectives_each(ranks, block):
    """Per layer and way, each of the M / block panels psums its diagonal
    block and all-gathers its column (whose pullback, a reduce-scatter, the
    last panel does not need: its update feeds nothing)."""
    table = ranks[0][block]["profiled"][0]
    panels = M // block
    assert table["mgp.dist.comm.all_gather"]["calls"] == 2 * (3 + panels)
    assert table["mgp.dist.comm.reduce_scatter"]["calls"] == (
        2 * (3 + panels - 1))
    assert table["mgp.dist.comm.ppermute"]["calls"] == 2 * 2 * (WORLD - 1)
    # per layer and way: the panels and the KL's 3 sums; the data fit's sum
    # each way; the replicated gradients' all-reduce
    assert table["mgp.dist.comm.all_reduce"]["calls"] == (
        2 * 2 * (panels + 3) + 2 + 1)


# The bytes a rank sends, from what torch.distributed was called with: the
# first argument is the output of a gather or a scatter, the input of an
# all-reduce, and each send's tensor.
FROM_SHAPES = {
    "all_gather_into_tensor": ("all_gather", lambda b: (WORLD - 1) * b
                               // WORLD),
    "all_gather_single": ("all_gather", lambda b: (WORLD - 1) * b // WORLD),
    "reduce_scatter_tensor": ("reduce_scatter", lambda b: (WORLD - 1) * b),
    "reduce_scatter_single": ("reduce_scatter", lambda b: (WORLD - 1) * b),
    "all_reduce": ("all_reduce", lambda b: 2 * (WORLD - 1) * b // WORLD),
    "send": ("ppermute", lambda b: b),
}


@pytest.mark.parametrize("block", BLOCKS)
def test_byte_counters_match_the_shapes(ranks, block):
    for res in ranks:
        _, counters, calls = res[block]["profiled"]
        want = {}
        for name, _, nbytes in calls:
            ours, sent = FROM_SHAPES[name]
            want[ours] = want.get(ours, 0) + sent(nbytes)
        got = {name.rsplit(".", 1)[1]: row["total"]
               for name, row in counters.items()}
        assert got == want


@pytest.mark.parametrize("block", BLOCKS)
def test_byte_counters_match_the_work_count(ranks, block):
    from torchbench.work import smgp_sharded_k8_m16384 as work
    for res in ranks:
        counters = res[block]["profiled"][1]
        total = sum(row["total"] for name, row in counters.items()
                    if name.startswith("mgp.dist.sent."))
        assert total == work.sent_bytes(_config(block))


@pytest.mark.parametrize("block", BLOCKS)
def test_spans_cost_nothing_without_a_profiler(ranks, block):
    for res in ranks:
        off = res[block]["off"]
        assert off["spans"] == {} and off["counters"] == {}
        assert off["marks"] == []
        assert off["region_is_fn"]


def test_work_count_at_the_cell_size():
    """The benchmark's count at M=16384, 512-row panels: the ring's turns
    (3 K M^2 / 4 float32 a turn set, 4 a step) dominate."""
    import json

    from torchbench.work import _count
    from torchbench.work import smgp_sharded_k8_m16384 as work
    cfg = json.loads((ROOT / "torchbench" / "configs"
                      / "smgp_sharded_k8_m16384.json").read_text())
    ring = 4 * 3 * 8 * 16384 * 4096 * 4
    assert ring < work.sent_bytes(cfg) < 1.3 * ring
    assert math.isclose(4 * work.train_step(cfg, 8192)["flops"],
                        _count.train_step(cfg, 8192)["flops"])
