"""The port's spans (utils/profiling.span) and the benchmark's readers of
them, on the CPU.

While no profiler records, ``span`` hands back one shared nullcontext and
nothing is kept.  Under torch.profiler one train step of a small float32
whitened SMGP through make_train_step records the step, its loss, backward
and Adam update, and each layer's whitened solve and q_sqrt term forward
and backward; the Cholesky inside the whitened solve counts as nested.  A
served request (predict_y, predict_assign, predict_density of
precompute_smgp's model) evaluates two cached marginals (predict_y's and
predict_density's prediction layer) and two cached means (the assignment
layer's, in each predict_assign) under three outermost predict spans.  The
spans stand in the Chrome trace as user annotations, the loss inside the
step.  Each of torchbench/metrics/'s span readers, loaded by path, reads
its number from a filled table and reads nothing, raising nothing, from a
program without spans.
"""
import importlib.util
import json
import pathlib
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, K, D, N, S = 16, 2, 2, 32, 4
F32 = dict(dtype=torch.float32, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread keeps them from spinning against
    the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model():
    g = torch.Generator().manual_seed(0)

    def layer(variance, lengthscale):
        svgp = pt.SVGP.create(
            pt.SquaredExponential.create(variance, lengthscale, **F32),
            torch.randn((M, D), generator=g), K, jitter=1e-4, **F32)
        with torch.no_grad():
            svgp.q_mu.raw.copy_(0.5 * torch.randn((M, K), generator=g))
        return svgp

    return pt.SMGP(pt.Gaussian.create(0.5, **F32), layer(0.5, 0.5),
                   layer(0.1, 1.0), K=K, num_samples=S, num_data=1000)


def _data():
    g = torch.Generator().manual_seed(1)
    return (torch.rand((N, D), generator=g) * 6 - 3,
            torch.randn((N, 1), generator=g))


def _train_step(model):
    step = pt.make_train_step(pt.Adam(model, 1e-3))
    gen = torch.Generator().manual_seed(2)
    X, Y = _data()
    return lambda: step(model, gen, X, Y)


def _request(model):
    with torch.no_grad():
        served = pt.precompute_smgp(model)
    X, Y = _data()

    def serve():
        with torch.inference_mode():
            return (served.predict_y(X), served.predict_assign(X),
                    served.predict_density(X, Y))
    return serve


def _profiled(fn, path=None):
    """span_table() of one fn() under torch.profiler (and the Chrome
    trace's events where ``path`` is given)."""
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    table = profiling.span_table()
    profiling.reset_spans()
    if path is None:
        return table, None
    prof.export_chrome_trace(str(path))
    return table, json.loads(path.read_text())["traceEvents"]


@pytest.fixture(scope="module")
def step_record(tmp_path_factory):
    step = _train_step(_model())
    step()                                  # a first step unprofiled
    return _profiled(step, tmp_path_factory.mktemp("spans") / "trace.json")


@pytest.fixture(scope="module")
def request_table():
    return _profiled(_request(_model()))[0]


def test_span_off_is_one_shared_nullcontext():
    first = profiling.span("mgp.a")
    assert first is profiling.span("mgp.b", torch.zeros(2), "op")
    with first as inside:
        assert inside is None


def test_nothing_recorded_without_a_profiler():
    profiling.reset_spans()
    model = _model()
    _train_step(model)()
    _request(model)()
    assert profiling.span_table() == {}


STEP_CALLS = {"mgp.step": 1, "mgp.loss": 1, "mgp.backward": 1, "mgp.adam": 1,
              "mgp.whiten_solve.fwd": 2, "mgp.whiten_solve.bwd": 2,
              "mgp.atl_sq_colsum.fwd": 2, "mgp.atl_sq_colsum.bwd": 2}


@pytest.mark.parametrize("name", sorted(STEP_CALLS))
def test_train_step_records_its_spans(step_record, name):
    row = step_record[0][name]
    assert row["calls"] == row["outer_calls"] == STEP_CALLS[name]
    assert 0 < row["outer_host_ms"] == row["host_ms"]
    assert row["device_ms"] is None and row["outer_device_ms"] is None


def test_cholesky_inside_the_whitened_solve_is_nested(step_record):
    table = step_record[0]
    row = table["mgp.cholesky.fwd"]
    assert row["calls"] == 2 and row["outer_calls"] == 0
    assert row["outer_host_ms"] == 0 < row["host_ms"]
    assert "mgp.cholesky.bwd" not in table
    assert all(name.startswith(profiling.SPAN_PREFIX) for name in table)


def test_served_request_counts_two_marginals_and_two_means(request_table):
    for name in ("mgp.posterior.predict_f", "mgp.posterior.predict_mean"):
        row = request_table[name]
        assert row["calls"] == row["outer_calls"] == 2


def test_served_request_has_three_outermost_predict_spans(request_table):
    rows = {name: row for name, row in request_table.items()
            if name.startswith("mgp.predict_")}
    assert {name: row["outer_calls"] for name, row in rows.items()} == {
        "mgp.predict_y": 1, "mgp.predict_assign": 1,
        "mgp.predict_density": 1}
    assert rows["mgp.predict_assign"]["calls"] == 2   # one in predict_density
    assert (rows["mgp.predict_assign"]["outer_host_ms"]
            < rows["mgp.predict_assign"]["host_ms"])


def test_chrome_trace_holds_the_spans_loss_inside_step(step_record):
    events = [e for e in step_record[1]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    names = {e["name"] for e in events}
    assert set(STEP_CALLS) | {"mgp.cholesky.fwd"} <= names
    (step,) = [e for e in events if e["name"] == "mgp.step"]
    (loss,) = [e for e in events if e["name"] == "mgp.loss"]
    assert loss["tid"] == step["tid"]
    assert step["ts"] <= loss["ts"]
    assert loss["ts"] + loss["dur"] <= step["ts"] + step["dur"]


def test_depth_is_per_thread():
    def inner():
        with profiling.span("mgp.t.fwd", kind="op"):
            pass

    def record():
        with profiling.span("mgp.t.bwd", kind="op"):
            worker = threading.Thread(target=inner)
            worker.start()
            worker.join(timeout=60)
            assert not worker.is_alive()
            inner()

    table = _profiled(record)[0]
    assert table["mgp.t.bwd"]["outer_calls"] == 1
    assert table["mgp.t.fwd"]["calls"] == 2
    assert table["mgp.t.fwd"]["outer_calls"] == 1     # the other thread's


def test_no_span_lost_between_threads():
    """The record is shared by the main thread and the autograd engine's:
    many threads at a short switch interval lose no call."""
    threads, reps = 16, 200
    interval = sys.getswitchinterval()

    def work():
        for _ in range(reps):
            with profiling.span("mgp.s.fwd", kind="op"):
                with profiling.span("mgp.s.inner", kind="op"):
                    pass

    def record():
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)

    sys.setswitchinterval(1e-6)
    try:
        table = _profiled(record)[0]
    finally:
        sys.setswitchinterval(interval)
    assert table["mgp.s.fwd"]["calls"] == table["mgp.s.fwd"]["outer_calls"] \
        == threads * reps
    assert table["mgp.s.inner"]["calls"] == threads * reps
    assert table["mgp.s.inner"]["outer_calls"] == 0


def test_reset_spans_forgets_the_record():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("mgp.x"):
            pass
    assert profiling.span_table()["mgp.x"]["calls"] == 1
    profiling.reset_spans()
    assert profiling.span_table() == {}


def _reader(metric):
    path = ROOT / "torchbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _row(calls, host_ms, device_ms, outer_calls=None, outer_host_ms=None,
         outer_device_ms=None):
    return {"calls": calls, "host_ms": host_ms, "device_ms": device_ms,
            "outer_calls": calls if outer_calls is None else outer_calls,
            "outer_host_ms": host_ms if outer_host_ms is None
            else outer_host_ms,
            "outer_device_ms": device_ms if outer_device_ms is None
            else outer_device_ms}


# Four traced steps (or requests) of a filled table.
TABLE = {
    "mgp.step": _row(4, 40.0, 360.0),
    "mgp.loss": _row(4, 12.0, 140.0),
    "mgp.backward": _row(4, 20.0, 200.0),
    "mgp.adam": _row(4, 4.0, 8.0),
    "mgp.data.gather": _row(4, 6.0, None),
    "mgp.whiten_solve.fwd": _row(8, 2.0, 60.0),
    "mgp.whiten_solve.bwd": _row(8, 2.0, 100.0),
    "mgp.cholesky.fwd": _row(8, 1.0, 20.0, 0, 0.0, 0.0),
    "mgp.atl_sq_colsum.fwd": _row(8, 1.0, 30.0),
    "mgp.atl_sq_colsum.bwd": _row(8, 1.0, 50.0),
    "mgp.kxz.fwd": _row(16, 1.0, 4.0),
    "mgp.kxz.bwd": _row(16, 1.0, 12.0),
    "mgp.kl.fwd": _row(8, 0.5, 2.0),
    "mgp.kl.bwd": _row(8, 0.5, 2.0),
    "mgp.predict_y": _row(4, 2.0, 40.0),
    "mgp.predict_assign": _row(8, 3.0, 60.0, 4, 1.0, 30.0),
    "mgp.predict_density": _row(4, 5.0, 50.0),
    "mgp.posterior.predict_f": _row(16, 6.0, 100.0),
}
READS = {
    "solve_ms.train": (60.0 + 100.0) / 4,
    "qsqrt_ms.train": (30.0 + 50.0) / 4,
    # loss + backward less every outermost .fwd / .bwd (not the Cholesky)
    "glue_ms.train": (140.0 + 200.0 - (60 + 100 + 30 + 50 + 4 + 12 + 2 + 2))
    / 4,
    "host_issue_ms.train": 40.0 / 4,
    "host_issue_ms.serve": (2.0 + 1.0 + 5.0) / 4,
    "marginals_per_req.serve": 16 / 4,
}


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_reads_a_filled_table(monkeypatch, metric):
    monkeypatch.setattr(profiling, "span_table", lambda: TABLE)
    value = _reader(metric)({"profiled_work": [None] * 4})
    assert value == pytest.approx(READS[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_reads_nothing_from_a_program_without_spans(monkeypatch,
                                                           metric):
    monkeypatch.delattr(profiling, "span_table")
    assert _reader(metric)({"profiled_work": [None] * 4}) is None
