"""The plain reference against the program at a smoke size on the CPU:
the same parameter layout, one round of each configuration within f32
rounding, and a round run in bfloat16 refused by the comparison."""

import pytest
import torch

from bench_helpers import config_names, cell_names, smoke

import run
from harness import check, feed
from harness.cell import Cell
from reference import load


def _cell_of(config):
    name = next(n for n in cell_names() if n.startswith(config + "."))
    return smoke(Cell.resolve(name))


def test_chunked_wkv_is_the_recurrence():
    """The reference's wkv a chunk of steps at a time against the step
    loop, values and gradients, in f64 (decays from 1 − 1e-7 to e⁻²⁰,
    a length that ends mid-chunk)."""
    m = load("rwkv6")
    g = torch.Generator().manual_seed(0)
    B, S, H, hd = 2, 77, 3, 8
    r, k, v = (torch.randn(B, S, H, hd, generator=g, dtype=torch.float64)
               for _ in range(3))
    logw = -torch.exp(-6 + 3 * torch.randn(B, S, H, hd, generator=g,
                                           dtype=torch.float64))
    u = torch.randn(H, hd, generator=g, dtype=torch.float64)
    ins = [t.requires_grad_(True) for t in (r, k, v, logw, u)]
    a = m.wkv(r, k, v, logw, u, chunk=16)
    b = m.wkv_loop(r, k, v, torch.exp(logw), u)
    torch.testing.assert_close(a, b, rtol=1e-11, atol=1e-11)
    for x, y in zip(torch.autograd.grad(a.sum(), ins),
                    torch.autograd.grad(b.sum(), ins)):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("config", config_names())
def test_weights_take_the_programs_layout(config):
    from harness import port
    cell = _cell_of(config)
    prog = port.Program(cell.config, cell.traffic)
    g = torch.Generator().manual_seed(0)
    want = prog.rt.models.init_model(prog.mcfg, g)
    got = load(cell.config["reference"]).param_specs(cell.config)
    from reference.ranl import flatten
    assert {p: tuple(t.shape) for p, t in flatten(want).items()} == {
        p: tuple(s) for p, s, _ in got}


# f32 rounding after round 0 and one round, by architecture: RWKV-6
# normalises each head's wkv output by its rms (ln_x), so a head whose
# output is small magnifies rounding into the gradients it reaches; an
# f64 reference puts the program and this reference at the same distance
# from it (up to 1.4e-4 and 3.1e-5 on the curvature at these sizes)
NORM_TOL = {"dense": 1e-5, "rwkv6": 1e-3}


@pytest.mark.parametrize("config", config_names())
def test_reference_holds_the_program_for_one_round(config):
    """Round 0 and one round from the same weights, batches and masks:
    every number within f32 rounding (the program runs its kernels'
    plain versions on the CPU)."""
    cell = _cell_of(config)
    cell.traffic["check_steps"] = 1
    seed = 2**31 + 17
    _, fd, specs, arch, _, _, got, _ = run.setup(cell, seed, "cpu")
    want = run.reference_readings(arch, cell.config, cell.traffic, specs,
                                  fd, seed, "cpu")
    gaps = check.gaps(got, want)
    tol = NORM_TOL[cell.config["reference"]]
    assert gaps["loss.1"] < 1e-6
    assert gaps["curvature"] < tol
    assert gaps["grad"] < tol
    assert gaps["change"] < tol


@pytest.mark.parametrize("config", config_names())
def test_comparison_refuses_a_round_in_bfloat16(config, monkeypatch):
    """The program's weights, and so its whole round, in bfloat16: the
    cell's limits refuse it."""
    cell = _cell_of(config)
    seed = 2**31 + 29
    make = feed.make_weights
    monkeypatch.setattr(feed, "make_weights", lambda *a, **k: {
        p: t.to(torch.bfloat16) for p, t in make(*a, **k).items()})
    _, fd, specs, arch, _, _, got, _ = run.setup(cell, seed, "cpu")
    monkeypatch.undo()
    want = run.reference_readings(arch, cell.config, cell.traffic, specs,
                                  fd, seed, "cpu")
    correct, checks = check.judge(check.gaps(got, want), cell.limits)
    assert cell.limits and not correct, checks
