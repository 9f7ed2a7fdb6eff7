"""On the card, at each cell's own size: the program meets every limit and
the control, the reference one precision below what the configuration
states, fails at least one (torchbench/calibrate.py's readings)."""
import pytest

from torchbench.calibrate import calibrate
from torchbench.harness import check, spec

CELLS = {"smgp.train": 0.0, "smgpmod_mc.train": 0.0, "smgp.serve_grid": 2.5}


@pytest.mark.card
@pytest.mark.parametrize("seed", [4400000001, 4400000002, 4400000003])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_where_the_program_passes(card, name, seed):
    cell = spec.load_cell(name)
    row, = calibrate(cell, [seed], card, CELLS[name], control=True,
                     out=lambda s: None)
    program_ok, table = check.judge(row["program"], cell.limits)
    control_ok, _ = check.judge(row["control"], cell.limits)
    assert program_ok, table
    assert not control_ok, row["control"]
