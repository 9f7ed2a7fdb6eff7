"""The harness without a card: its refusal, the JAX guard, the trace
reader, and whole runs at a tiny size on the CPU, sound and with each fault
a cell can have planted under the timed path."""
import json
import subprocess
import sys
import types

import pytest
import torch

from conftest import ROOT, tiny_cell
from torchbench.calibrate import planted
from torchbench.harness import guard, runner
from torchbench.harness.trace import WINDOW, read_events

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


def _run(name, seed=SEED):
    cell = tiny_cell(name)
    args = types.SimpleNamespace(workload=name, seed=seed, seconds=0.3,
                                 trace=0)
    return runner.run_cell(cell, args, CPU, 0.0)[0]


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "torchbench/run.py", "--workload",
                          "smgp.train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


@pytest.mark.parametrize("names,found", [
    (["modulatedgps_tpu_torch", "modulatedgps_tpu_torch.ops", "jaxtyping",
      "flaxen"], []),
    (["modulatedgps_tpu", "modulatedgps_tpu.models"],
     ["modulatedgps_tpu", "modulatedgps_tpu.models"]),
    (["jax.numpy", "jaxlib", "flax.linen"], ["flax.linen", "jax.numpy",
                                             "jaxlib"]),
])
def test_guard_compares_whole_top_level_names(names, found):
    assert guard.forbidden_modules(names) == found


def test_a_run_loads_no_jax():
    code = ("import sys, types, torch; sys.path.insert(0, 'torchbench/tests');"
            "from conftest import tiny_cell; from torchbench.harness import "
            "guard, runner; a = types.SimpleNamespace(workload='smgp.train', "
            "seed=3, seconds=0.2, trace=0); runner.run_cell(tiny_cell("
            "'smgp.train'), a, torch.device('cpu'), 0.0); "
            "print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", ["smgp.train", "smgpmod_mc.train",
                                  "smgp.serve_grid"])
def test_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    json.dumps(result)


@pytest.mark.parametrize("name,fault", [
    ("smgp.train", "unchanged"), ("smgp.train", "half_batch"),
    ("smgpmod_mc.train", "unchanged"), ("smgpmod_mc.train", "half_batch"),
    ("smgp.serve_grid", "altered"),
])
def test_fault_makes_run_incorrect(name, fault):
    kind = tiny_cell(name).traffic["kind"]
    with planted(kind, fault):
        result = _run(name)
    assert not result["correct"], result["checks"]


def test_every_seed_the_same_work():
    from torchbench.harness.traffic import request_pool
    cell = tiny_cell("smgp.serve_grid")
    a, b = (request_pool(cell.traffic, cell.config, s, CPU) for s in (1, 2))
    assert a.X.shape == b.X.shape and a.size == b.size == 128
    assert len(a.checked) == len(b.checked) == 4
    assert not torch.equal(a.X, b.X)
    again = request_pool(cell.traffic, cell.config, 1, CPU)
    assert torch.equal(again.X, a.X) and again.checked == a.checked


def test_trace_reader():
    ev = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0,
           "dur": 100, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 90,
           "pid": 1, "tid": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 40, "dur": 20, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 12, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": 70,
           "dur": 10},
          {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 95,
           "dur": 20}]
    t = read_events(ev)
    assert t.window_s == pytest.approx(1e-4)
    assert t.busy_s == pytest.approx(22e-6)          # 5-22 and 95-100
    assert t.ops == 3
    assert t.device_ops[0] == ["k1", pytest.approx(1e-5)]
    assert t.op_seconds["Memset"] == pytest.approx(5e-6)   # cut at the end
    # gaps: 0-5 and 22-95 (the spin kernel is a stand-in, not work)
    gaps = dict((k, v) for k, v in t.idle_gaps)
    assert gaps["outer"] == pytest.approx(5e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(73e-6)   # innermost


def test_readers_of_an_untraced_run_return_nothing():
    """A per-layer reader that finds nothing to read returns None, so the
    metric is left out of the line (never a 0 share)."""
    from torchbench.harness import spec
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = spec.load_cell("smgp.train")
    ctx = {"kind": "train", "latencies": [], "points": 0, "window_s": 1.0}
    for metric in bench["per_layer"]:
        assert cell.reader(metric)(ctx) is None, metric["name"]


@pytest.mark.parametrize("name,want", [
    ("fwd_ms.train", 140.0 / 4), ("bwd_ms.train", 200.0 / 4),
    ("adam_ms.train", 8.0 / 4),
    # the outermost predict spans: predict_density's own assign left out
    ("predict_ms.serve", (40.0 + 30.0 + 50.0) / 4),
])
def test_span_readers_read_the_program_spans(monkeypatch, name, want):
    """The device ms of the program's spans per traced step or request,
    and nothing from a program without spans."""
    from modulatedgps_tpu_torch.utils import profiling
    from torchbench.harness import spec

    def row(calls, device_ms, outer=None):
        outer = device_ms if outer is None else outer
        return {"calls": calls, "host_ms": 1.0, "device_ms": device_ms,
                "outer_calls": calls, "outer_host_ms": 1.0,
                "outer_device_ms": outer}

    table = {"mgp.step": row(4, 360.0), "mgp.loss": row(4, 140.0),
             "mgp.backward": row(4, 200.0), "mgp.adam": row(4, 8.0),
             "mgp.predict_y": row(4, 40.0),
             "mgp.predict_assign": row(8, 60.0, 30.0),
             "mgp.predict_density": row(4, 50.0),
             "mgp.posterior.predict_f": row(8, 100.0)}
    cell = spec.load_cell("smgp.train")
    read = cell.reader({"name": name})
    monkeypatch.setattr(profiling, "span_table", lambda: table)
    assert read({"profiled_work": [None] * 4}) == pytest.approx(want)
    assert read({"profiled_work": []}) is None
    monkeypatch.delattr(profiling, "span_table")
    assert read({"profiled_work": [None] * 4}) is None
