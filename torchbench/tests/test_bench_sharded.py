"""smgp_sharded.train_p4 on the CPU: its kind on 4 gloo ranks through the
launcher, at a size the CPU runs in seconds, and its plain reference
(reference/smgp_sharded_k8_m16384.py) against the one-process reference
of the same model (reference/smgp_gauss_k8_m4096.py through
_plain.train_readings); the readers of its spans and counters."""
import datetime
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import ROOT

CELL = "smgp_sharded.train_p4"
CONFIG = "smgp_sharded_k8_m16384"
TINY = {"M": 64, "K": 2, "S": 4, "num_data": 4096, "block": 8}
SEED = 2 ** 31 + 4242
# The launcher in a process of its own, in the copy (test_bench_ranks').
LAUNCH = """
import json, sys, time
t_start = time.perf_counter()
sys.path.insert(0, ".")
from torchbench.harness import ranks, spec
argv = sys.argv[1:]
cell = spec.load_cell(argv[1])
rows = ranks.launch([sys.executable, "torchbench/run.py", *argv], cell.chips,
                    300.0, t_start, device="cpu")
if rows is None:
    sys.exit(1)
line, lines = ranks.join(cell, rows)
print("\\n".join(lines), file=sys.stderr)
print(json.dumps(line))
"""


def tiny_copy(dst):
    """torchbench/ and BENCHMARK.json under ``dst`` with the cell's
    configuration and traffic cut to TINY."""
    import shutil
    shutil.copytree(ROOT / "torchbench", dst / "torchbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    cfg = dst / "torchbench" / "configs" / f"{CONFIG}.json"
    cfg.write_text(json.dumps(dict(json.loads(cfg.read_text()), **TINY)))
    mix = dst / "torchbench" / "traffic" / "train_sharded.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), batch=32,
                                   num_points=4096, warmup_steps=1)))
    return dst


def test_cell_runs_on_four_gloo_ranks(tmp_path):
    copy = tiny_copy(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", LAUNCH, "--workload", CELL, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"], cwd=copy,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-6000:]
    result = json.loads(out.stdout)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert result["device"]["count"] == 4
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {"setup_s", "train_points_per_s"} <= set(result["metrics"])
    for i in range(4):
        assert f"r{i}: steps {result['attempted']}, window" in out.stderr


def test_calibration_on_four_gloo_ranks(tmp_path):
    """calibrate_ranks.py: rank 0's readings a seed; the faults fail the
    limits, the program meets them."""
    from torchbench.harness import check
    copy = tiny_copy(tmp_path)
    out = subprocess.run(
        [sys.executable, "torchbench/calibrate_ranks.py", "--workload", CELL,
         "--seeds", str(SEED), str(SEED + 1), "--control", "--faults", "1",
         "--device", "cpu"], cwd=copy,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-6000:]
    rows = [json.loads(x) for x in out.stdout.splitlines()]
    assert [r["seed"] for r in rows] == [SEED, SEED + 1]
    limits = json.loads((ROOT / "torchbench" / "limits"
                         / f"{CELL}.json").read_text())["limits"]
    assert all(check.judge(r["program"], limits)[0] for r in rows)
    assert set(rows[0]) == {"seed", "program", "control", "fault.unchanged",
                            "fault.half_batch"}
    assert set(rows[1]) == {"seed", "program", "control"}
    for fault in ("fault.unchanged", "fault.half_batch"):
        assert not check.judge(rows[0][fault], limits)[0], fault
    assert rows[0]["fault.unchanged"]["change_gap"] == 1.0


# ------------------------------------------- the reference split over ranks

def _cfg():
    cfg = json.loads((ROOT / "torchbench" / "configs"
                      / f"{CONFIG}.json").read_text())
    return dict(cfg, **TINY, ranks=4)


def _batches(cfg, steps=2, n=24):
    g = torch.Generator().manual_seed(3)
    return [(torch.rand((n, cfg["D"]), generator=g) * 6 - 3,
             torch.randn((n, 1), generator=g)) for _ in range(steps)]


def _readings(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from torchbench.harness import state as st
        from torchbench.harness.train_sharded import _block
        from torchbench.reference import _plain
        from torchbench.reference import smgp_sharded_k8_m16384 as ref
        cfg = _cfg()
        state = st.make_state(cfg, 11, torch.device("cpu"))
        blocks = {k: _block(k, t, rank, world) if k.endswith("q_sqrt.raw")
                  else t for k, t in state.items()}
        got = ref.train_readings(cfg, blocks, _batches(cfg), 17, 2,
                                 _plain.Precision("reference"))
        torch.save(got, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [1, 4])
def test_reference_split_over_ranks_is_the_one_process_reference(tmp_path,
                                                                 world):
    """Two Adam steps from the same state, batches and noise: the losses,
    gradient norms and change norms of the column-split reference on 1 or
    4 ranks are smgp_gauss_k8_m4096's plain reference's, in float64."""
    from torchbench.harness import spec
    from torchbench.harness import state as st
    from torchbench.reference import _plain
    out = tmp_path / "readings"
    mp.start_processes(_readings, args=(world, str(tmp_path / "store"),
                                        str(out)),
                       nprocs=world, start_method="spawn")
    cfg = _cfg()
    plain = spec.load_module(ROOT / "torchbench" / "reference"
                             / "smgp_gauss_k8_m4096.py", "plain_smgp")
    want = _plain.train_readings(plain.loss, cfg,
                                 st.make_state(cfg, 11, torch.device("cpu")),
                                 _batches(cfg), 17, 2,
                                 _plain.Precision("reference"))
    for rank in range(world):
        got = torch.load(f"{out}.{rank}")
        assert got["losses"] == pytest.approx(want["losses"], rel=1e-12)
        for key in ("grad_norms", "change_norms"):
            assert set(got[key]) == set(want[key])
            for leaf, value in want[key].items():
                assert got[key][leaf] == pytest.approx(value, rel=1e-9,
                                                       abs=1e-14), (key, leaf)


# ------------------------------------------------------------- the readers

def _reader(name):
    from torchbench.harness import spec
    return spec.load_module(ROOT / "torchbench" / "metrics" / f"{name}.py",
                            f"reader_{name}").read


def _row(calls, device_ms):
    return {"calls": calls, "host_ms": 1.0, "device_ms": device_ms,
            "outer_calls": calls, "outer_host_ms": 1.0,
            "outer_device_ms": device_ms}


TABLE = {"mgp.dist.chol.fwd": _row(4, 100.0),
         "mgp.dist.chol.bwd": _row(4, 300.0),
         "mgp.dist.ring.fwd": _row(4, 800.0),
         "mgp.dist.ring.bwd": _row(4, 1600.0),
         "mgp.dist.comm.all_gather": _row(40, 120.0),
         "mgp.dist.comm.ppermute": _row(24, 400.0),
         "mgp.loss": _row(2, 2000.0)}
COUNTERS = {"mgp.dist.sent.all_gather": {"calls": 40, "total": 6e9},
            "mgp.dist.sent.ppermute": {"calls": 24, "total": 5e10}}
READS = {"dist_chol_ms.sharded": 400.0 / 2, "ring_ms.sharded": 2400.0 / 2,
         "comm_ms.sharded": 520.0 / 2, "comm_mb.sharded": 5.6e10 / 1e6 / 2}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_the_spans_and_counters(monkeypatch, name):
    from modulatedgps_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "span_table", lambda: TABLE)
    monkeypatch.setattr(profiling, "counter_table", lambda: COUNTERS)
    got = _reader(name)({"profiled_work": [None] * 2})
    assert got == pytest.approx(READS[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_nothing_without_them(monkeypatch, name):
    """A program without the spans and counters (the parent of this cell)
    reads nothing, raising nothing; so does an untraced run."""
    from modulatedgps_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "span_table", lambda: {})
    monkeypatch.delattr(profiling, "counter_table")
    assert _reader(name)({"profiled_work": [None] * 2}) is None
    assert _reader(name)({}) is None
