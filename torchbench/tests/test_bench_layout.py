"""BENCHMARK.json and the files it names: every piece found by its name."""
import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["torchbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def unexplained(data: dict) -> list:
    """The keys of ``reduced`` that neither a key of ``assumed`` nor the
    ``deployment`` explains (model-configs guide, section 4)."""
    told = {k.strip() for keys in data.get("assumed", {})
            for k in keys.split(",")}
    return [k for k in data["reduced"]
            if k not in told and k not in data.get("deployment", "")]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert unexplained(data) == []
    for key in ("assumed", "deployment", "M", "K", "D", "S", "dtype"):
        assert key in data
    for kind in ("reference", "work"):
        assert (ROOT / "torchbench" / kind / f"{cfg['name']}.py").exists()


@pytest.mark.parametrize("data,left", [
    ({"reduced": [], "assumed": {}, "deployment": ""}, []),
    ({"reduced": ["num_data", "layers"],
      "assumed": {"M, num_data": "cut to fit"},
      "deployment": "layers: the card's share of a pipeline"}, []),
    ({"reduced": ["num_data"], "assumed": {"M": "the source's"},
      "deployment": "one card"}, ["num_data"]),
])
def test_reduced_keys_must_be_explained(data, left):
    assert unexplained(data) == left


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(cell):
    from torchbench.harness import spec
    loaded = spec.load_cell(cell["name"])
    assert loaded.chips == cell["chips"]
    assert loaded.chips in (1, 4)
    kind = loaded.traffic["kind"]
    assert (ROOT / "torchbench" / "harness" / f"{kind}.py").exists()
    module = loaded.kind()
    for name in ("run", "reference", "numbers", "summary"):
        assert callable(getattr(module, name)), name
    assert loaded.end_to_end and loaded.per_layer
    assert "setup_s" in {m["name"] for m in loaded.end_to_end}
    assert len(loaded.end_to_end) >= 2
    for m in loaded.end_to_end + loaded.per_layer:
        assert callable(loaded.reader(m))
    assert set(loaded.limits) == set(module.LIMITS)
    assert len(cell["why"]) <= 200


def test_few_cells_on_four_cards():
    """At most a quarter of the cells, rounded down, or one, take 4."""
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4), four


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "torchbench" / "metrics" / f"{metric['name']}.py").exists()
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        cells = {w["name"] for w in BENCH["workloads"]}
        assert set(metric["workloads"]) <= cells
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_names_unique_and_valid():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
