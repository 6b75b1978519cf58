"""The port's train CLI (``repro_torch.launch.train``) on the CPU: it
trains with RANL and AdamW, its hetero flags give the reference CLI's
masks and simulated clock step for step, and its checks exit
(``--journal``/``--trace``: tests/test_torch_obs.py; the shard flags on
gloo ranks: tests/test_torch_train_sharded.py)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_train_helpers import cfgs, one_torch_thread  # noqa: E402, F401

from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import init_model  # noqa: E402


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------

def _final(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert set(out) == {"final_loss", "first_loss"}
    assert np.isfinite(out["final_loss"]) and np.isfinite(out["first_loss"])
    return out, lines


@pytest.mark.parametrize("optimizer", ["ranl", "adamw"])
def test_train_cli_trains_on_the_cpu(optimizer, capsys, tmp_path):
    ck = str(tmp_path / "ck")
    hist = ttrain.run(["--device", "cpu", "--smoke", "--optimizer",
                       optimizer, "--steps", "6", "--batch", "8", "--seq",
                       "32", "--checkpoint-dir", ck])
    out, lines = _final(capsys)
    assert len(hist) == 6 and out["final_loss"] < out["first_loss"]
    assert any(line.startswith("saved checkpoint") for line in lines)
    _, tcfg = cfgs("phi4-mini-3.8b")
    like = init_model(tcfg, torch.Generator().manual_seed(9))
    restored = restore(like, ck)
    assert restored["layers"][0]["attn"]["wq"].shape == (256, 256)
    assert json.loads(open(os.path.join(ck, "manifest.json")).read())[
        "step"] == 6


def test_train_cli_hetero_traces_equal_the_reference(capsys):
    """--scenario/--controller/--quorum: the round keys are the
    reference's, so the masks' coverage and uplink, the simulated clock
    and the staleness equal the reference CLI's, step for step (the
    batches differ, so the losses do)."""
    from repro.launch.train import run as jrun
    argv = ["--smoke", "--steps", "4", "--batch", "8", "--seq", "16",
            "--scenario", "pareto-stragglers", "--controller",
            "resource:keep=0.7", "--quorum", "0.75"]
    got = ttrain.run(argv + ["--device", "cpu"])
    _final(capsys)
    want = jrun(argv)
    for a, b in zip(got, want):
        for k in ("coverage", "uplink_frac", "sim_round_s", "sim_s",
                  "max_stale"):
            assert a[k] == b[k], k


@pytest.mark.parametrize("argv,match", [
    (["--quorum", "0.5"], "needs the simulated"),
    (["--quorum", "1.5", "--scenario", "uniform"], "must be in"),
    (["--optimizer", "adamw", "--controller", "resource"], "RANL"),
    (["--optimizer", "adamw", "--compression", "int8"], "uplink"),
    (["--optimizer", "adamw", "--dump-hlo", "x"], "dump-hlo"),
    (["--dump-hlo", "x"], "no HLO"),
    (["--pods", "0"], "must be >= 1")], ids=str)
def test_train_cli_system_exits(argv, match):
    with pytest.raises(SystemExit, match=match):
        ttrain.run(["--device", "cpu", "--smoke"] + argv)


@pytest.mark.parametrize("argv,match", [
    (["--data-shards", "2", "--workers", "3", "--batch", "6"],
     "num_workers=3 must divide evenly across the 2-way"),
    (["--pods", "2", "--data-shards", "2", "--workers", "6", "--batch",
      "12"], "num_workers=6 must divide evenly across the 4-way"),
    (["--model-shards", "2", "--batch", "6"],
     "--batch 6 must divide evenly across --workers 4")], ids=str)
def test_train_cli_unported_flags_raise_naming_their_item(argv, match):
    """The shard flags are ported (tests/test_torch_train_sharded.py);
    workers that do not divide across the ("pod", "data") plane, or a
    batch that does not divide across the workers, exit before any
    process group is needed."""
    with pytest.raises(SystemExit, match=match):
        ttrain.run(["--device", "cpu", "--smoke"] + argv)
