"""The benchmark's own tests (``python -m pytest torchbench/tests``).

Tests that need a card are marked ``card`` and take the ``card`` fixture,
which skips them where there is none; the decision is made inside the
fixture, never at import."""
import copy
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
