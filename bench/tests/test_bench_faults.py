"""A run of each cell at a smoke size on the CPU, the harness's look for
a card skipped (a cell on several chips as that many gloo processes):
sound, it comes out correct; with the timed path broken underneath
(``harness/faults.py``), once for each fault the cell can have, it does
not."""

import time

import pytest

from bench_helpers import benchmark, cell_names, smoke

import run
from harness import ranks
from harness.cell import Cell
from harness.faults import FAULTS

SEED = 2**31 + 101
ONE_CHIP = ("half_batch", "token_altered", "unchanged")


def _run(name, fault=None):
    cell = smoke(Cell.resolve(name))
    if cell.chips > 1:
        return ranks.launch(run.rank_main, cell.chips, "cpu", cell, SEED,
                            0.01, False, "cpu", time.time(), fault)
    if fault is None:
        return run.run_cell(cell, SEED, 0.01, False, "cpu")
    with FAULTS[fault]():
        return run.run_cell(cell, SEED, 0.01, False, "cpu")


def _faults():
    chips = {w["name"]: w["chips"] for w in benchmark()["workloads"]}
    return [(n, f) for n in cell_names() for f in ONE_CHIP
            + (("exchange_dropped",) if chips[n] > 1 else ())]


@pytest.mark.parametrize("name", cell_names())
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"train_tokens_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name,fault", _faults())
def test_a_broken_step_is_not_correct(name, fault):
    res = _run(name, fault)
    assert not res["correct"], res["checks"]
