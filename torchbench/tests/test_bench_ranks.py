"""The launcher (harness/ranks.py) on the CPU: gloo ranks of run.py in a
copy of the benchmark to which the probe's files (tests/probe/) are added
as new files, as the PR of a multi-card configuration adds its own.  The
launcher is handed the device ("cpu"), since run.py itself refuses without
a card; each rank's program picks gloo for it."""
import hashlib
import json
import os
import subprocess
import sys
import time

import pytest

from conftest import ROOT, probe_copy

SEED = 2 ** 31 + 777
# The launcher in a process of its own, in the copy: the ranks' results on
# standard error, the joined line as the one line of standard output.
LAUNCH = """
import json, sys, time
t_start = time.perf_counter()
sys.path.insert(0, ".")
from torchbench.harness import ranks, spec
deadline, argv = float(sys.argv[1]), sys.argv[2:]
cell = spec.load_cell(argv[1])
rows = ranks.launch([sys.executable, "torchbench/run.py", *argv], cell.chips,
                    deadline, t_start, device="cpu")
if rows is None:
    sys.exit(1)
line, lines = ranks.join(cell, rows)
print("\\n".join(lines), file=sys.stderr)
print("rows: " + json.dumps([row["result"] for row in rows]), file=sys.stderr)
print(json.dumps(line))
"""


def _probe_cell(name, chips, traffic="rank_probe"):
    return {"name": name, "config": "rank_probe", "traffic": traffic,
            "chips": chips, "why": "a test of the launcher"}


def _mix(**rank_roles):
    mix = json.loads((ROOT / "torchbench" / "tests" / "probe" / "traffic"
                      / "rank_probe.json").read_text())
    return dict(mix, **rank_roles)


def _launch(copy, workload, deadline=120.0, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-c", LAUNCH, str(deadline), "--workload", workload,
         "--seed", str(SEED), "--seconds", "0.2", "--trace", "0"],
        cwd=copy, env=env, capture_output=True, text=True, timeout=timeout)


def _rows(err: str) -> list:
    line, = [x for x in err.splitlines() if x.startswith("rows: ")]
    return json.loads(line[len("rows: "):])


def _value(result, name):
    return result["metrics"][name]["value"]


@pytest.mark.parametrize("chips", [2, 4])
def test_ranks_join_into_one_line_of_the_worst(tmp_path, chips):
    """Each metric is its worst rank's: the set-up of the rank slowed in
    set-up, the rate of the rank slowed in its window, the peak of the rank
    that holds more; the program's group spans every rank (the sum)."""
    mix = _mix(slow_setup_rank=chips - 1, slow_window_rank=0, big_rank=1)
    copy = probe_copy(tmp_path, [_probe_cell("probe.roles", chips, "roles")],
                      {"roles": mix})
    out = _launch(copy, "probe.roles")
    assert out.returncode == 0, out.stderr
    line, = out.stdout.strip().splitlines()
    result, rows = json.loads(line), _rows(out.stderr)
    assert len(rows) == chips
    for name, worst, rank in [("setup_s", max, chips - 1),
                              ("probe_sums_per_s", min, 0),
                              ("peak_mem_gib", max, 1)]:
        got = [_value(r, name) for r in rows]
        assert _value(result, name) == worst(got) == got[rank], name
        assert got.index(worst(got)) == rank, name
    assert result["device"]["count"] == chips
    assert result["device"]["memory_peak_bytes"] == max(
        r["device"]["memory_peak_bytes"] for r in rows)
    assert result["correct"] and all(r["correct"] for r in rows)
    assert set(result["checks"]) == {f"r{i}.sum_gap" for i in range(chips)}
    assert result["attempted"] == mix["rounds"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert f"r{chips - 1}: rounds 50, window" in out.stderr
    assert f"world {chips}" in out.stderr


def test_one_wrong_rank_makes_the_line_incorrect(tmp_path):
    copy = probe_copy(tmp_path, [_probe_cell("probe.wrong", 2, "wrong")],
                      {"wrong": _mix(wrong_rank=1)})
    out = _launch(copy, "probe.wrong")
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout)
    assert not result["correct"]
    assert result["checks"]["r0.sum_gap"]["value"] == 0.0
    assert result["checks"]["r1.sum_gap"]["value"] == 1.0


def test_a_rank_that_raises_ends_the_run_without_a_line(tmp_path):
    copy = probe_copy(tmp_path, [_probe_cell("probe.raise", 2, "raise")],
                      {"raise": _mix(raise_rank=1)})
    out = _launch(copy, "probe.raise")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "rank 1 exited 1" in out.stderr
    assert "rank 1 raises, as the mix asks" in out.stderr


def test_a_rank_past_the_deadline_is_killed_with_every_rank(tmp_path):
    copy = probe_copy(tmp_path, [_probe_cell("probe.hang", 2, "hang")],
                      {"hang": _mix(hang_rank=1)})
    t0 = time.monotonic()
    out = _launch(copy, "probe.hang", deadline=25.0, timeout=120)
    assert time.monotonic() - t0 < 90
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "missed the deadline" in out.stderr
    said = [x for x in out.stderr.splitlines() if "(pids [" in x]
    pids = json.loads(said[0].split("(pids ")[1].rstrip(")"))
    assert len(pids) == 2
    for pid in pids:
        assert not os.path.exists(f"/proc/{pid}"), pid


def _digests(root) -> dict:
    return {str(p.relative_to(root)):
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_on_four_cards_needs_only_new_files(tmp_path):
    """The probe's kind, configuration, reference, work count, traffic,
    limits and readers, and its BENCHMARK.json entries, are all the copy
    gains: its cell runs on 4 gloo ranks and the layout tests pass on it,
    with no file of the benchmark changed."""
    before = _digests(ROOT / "torchbench")
    copy = probe_copy(tmp_path)
    out = _launch(copy, "probe.p4")
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout)
    assert result["correct"] and result["device"]["count"] == 4
    assert set(result["metrics"]) == {"setup_s", "probe_sums_per_s",
                                      "peak_mem_gib"}
    layout = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "torchbench/tests/test_bench_layout.py"], cwd=copy,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    assert layout.returncode == 0, layout.stdout + layout.stderr
    for test in ("test_cell_found_by_name[probe.p4]",
                 "test_config_found_by_name[rank_probe]",
                 "test_metric_entry[probe_sums_per_s]"):
        assert f"{test} PASSED" in layout.stdout, test
    after = _digests(copy / "torchbench")
    for rel, digest in before.items():
        if "__pycache__" in rel or rel.startswith("_cache"):
            continue
        assert after[rel] == digest, rel
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = json.loads((copy / "BENCHMARK.json").read_text())
    for key, value in old.items():
        if isinstance(value, list) and key != "paths":
            assert new[key][:len(value)] == value, key
        else:
            assert new[key] == value, key


def _ranks_alive(seed: int) -> list:
    found = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
        except OSError:
            continue
        if b"torchbench/run.py" in cmd and str(seed).encode() in cmd:
            found.append(int(pid))
    return found


def test_ranks_end_when_the_launcher_is_killed(tmp_path):
    """A launcher killed from outside cannot kill its ranks: each rank
    ends itself once its launcher is gone."""
    copy = probe_copy(tmp_path, [_probe_cell("probe.hang", 2, "hang")],
                      {"hang": _mix(hang_rank=1)})
    seed = SEED + 1
    proc = subprocess.Popen(
        [sys.executable, "-c", LAUNCH, "300", "--workload", "probe.hang",
         "--seed", str(seed), "--seconds", "0.2", "--trace", "0"],
        cwd=copy, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        t0 = time.monotonic()
        while len(_ranks_alive(seed)) < 2 and time.monotonic() - t0 < 60:
            time.sleep(0.2)
        assert len(_ranks_alive(seed)) == 2
        proc.kill()
        proc.wait(timeout=30)
        t0 = time.monotonic()
        while _ranks_alive(seed) and time.monotonic() - t0 < 30:
            time.sleep(0.2)
        assert _ranks_alive(seed) == []
    finally:
        proc.kill()
        for pid in _ranks_alive(seed):
            os.kill(pid, 9)
