"""The benchmark's own tests (``python -m pytest torchbench/tests``).

Tests that need a card are marked ``card`` and take the ``card`` fixture,
which skips them where there is none; the decision is made inside the
fixture, never at import."""
import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips "
                            "without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the chip")
    return torch.device("cuda")


def tiny_cell(name: str, M: int = 32):
    """A cell of BENCHMARK.json cut to a size the CPU runs in a second."""
    from torchbench.harness import spec
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, M=M, num_data=4096, S=4)
    mix = copy.deepcopy(cell.traffic)
    if mix["kind"] == "train":
        mix.update(batch=64, num_points=4096)
    else:
        mix.update(pool_requests=16, size=128, check={"sample": 4})
    cell.traffic = mix
    return cell


PROBE = Path(__file__).resolve().parent / "probe"


def probe_copy(dst: Path, cells=(), traffic=None) -> Path:
    """A copy of the benchmark (torchbench/ and BENCHMARK.json) under
    ``dst`` with the probe's files (tests/probe/) added as new files and
    its entries appended, as a configuration's PR adds its own; ``cells``
    are further workload entries and ``traffic`` further mixes by name."""
    shutil.copytree(ROOT / "torchbench", dst / "torchbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    for src in PROBE.rglob("*"):
        rel = src.relative_to(PROBE)
        if src.is_file() and rel.name != "entries.json":
            target = dst / "torchbench" / rel
            if target.exists():
                raise FileExistsError(f"the probe would change {target}")
            shutil.copy(src, target)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    added = json.loads((PROBE / "entries.json").read_text())
    limits = (PROBE / "limits" / "probe.p4.json").read_text()
    for cell in cells:        # reported and judged as probe.p4 is
        for metric in added["end_to_end"] + added["per_layer"]:
            metric["workloads"].append(cell["name"])
        (dst / "torchbench" / "limits" / f"{cell['name']}.json").write_text(
            limits)
    for key, entries in added.items():
        bench[key] += entries
    bench["workloads"] += list(cells)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    for name, mix in (traffic or {}).items():
        (dst / "torchbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    return dst
