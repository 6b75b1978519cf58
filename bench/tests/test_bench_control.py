"""The comparison's control on the card, at each cell's own size: the
plain reference computed one precision step below the configuration's
float32 (TF32 on), in the program's place, is refused by the cell's
limits."""

import pytest

from bench_helpers import cell_names

import run
from harness import check
from harness.cell import Cell


@pytest.mark.gpu
@pytest.mark.parametrize("name", cell_names())
def test_tf32_control_is_refused(name, cuda):
    cell = Cell.resolve(name)
    seed = 2**31 + 7
    arch, specs, fd = run.inputs(cell, seed, cuda)
    want = run.reference_readings(arch, cell.config, cell.traffic, specs,
                                  fd, seed, cuda)
    ctl = run.reference_readings(arch, cell.config, cell.traffic, specs,
                                 fd, seed, cuda, tf32=True)
    correct, checks = check.judge(check.gaps(ctl, want), cell.limits)
    assert cell.limits and not correct, checks
