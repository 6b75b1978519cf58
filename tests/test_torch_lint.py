"""The port's lint (``repro_torch.analysis.lint``): the reference's rule
matrix for RPL003–RPL005 (``tests/test_analysis.py``) on synthetic
sources in the port's idiom, the round-loop host-sync rule (the
counterpart of RPL001) on good and bad sources, and the gate that
``src/repro_torch/`` lints clean."""

import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from repro_torch.analysis.lint import DECLARED_AXES, lint_paths  # noqa: E402
from repro_torch.launch.mesh import MESH_AXES  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint(tmp_path, src, name="mod.py"):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return lint_paths([str(p)])


ROUND_LOOP_BAD = {
    "item": "x = x - g.sum().item()",
    "tolist": "seen = mask.tolist()",
    "float": "loss = float(losses[t])",
    "int": "n = int(mask.sum())",
}


@pytest.mark.parametrize("where", [os.path.join("core", "ranl.py"),
                                   os.path.join("core", "sharded.py")])
@pytest.mark.parametrize("call", list(ROUND_LOOP_BAD))
def test_lint_host_sync_in_a_round_loop(tmp_path, call, where):
    fn = "_scan_rounds" if where.endswith("ranl.py") else "_sharded_rounds"
    bad = _lint(tmp_path, f"""
        def {fn}(x, g, mask, losses, T):
            for t in range(T):
                {ROUND_LOOP_BAD[call]}
            return x
        """, name=where)
    assert [v.rule for v in bad] == ["RPL001"]
    # the same call outside the loop, or in another function, is fine
    good = _lint(tmp_path, f"""
        def {fn}(x, g, mask, losses, T):
            n = int(mask.shape[0])
            for t in range(T):
                x = x - g
            return x, float(losses[-1]), n

        def summary(x, g, mask, losses, t):
            for _ in range(2):
                {ROUND_LOOP_BAD[call]}
        """, name=where)
    assert good == []


def test_lint_eigh_confinement(tmp_path):
    bad = _lint(tmp_path, """
        import torch

        def decompose(a):
            return torch.linalg.eigh(a)
        """)
    assert [v.rule for v in bad] == ["RPL003"]
    allowed = _lint(tmp_path, """
        import torch

        def sym_eigh(a):
            return torch.linalg.eigh(a)
        """, name=os.path.join("core", "hessian.py"))
    assert allowed == []


def test_lint_undeclared_mesh_axis(tmp_path):
    bad = _lint(tmp_path, """
        from torch.distributed.device_mesh import init_device_mesh

        MESH = init_device_mesh("cpu", (2,), mesh_dim_names=("bogus",))

        def run(coll, t, axis_name="bogus", pod_axis="pods"):
            coll.all_reduce(t, "bogus")
            coll.all_gather(t, dim="rows")
            return coll.size("tensor"), MESH.get_group("bogus")
        """)
    assert sorted(v.rule for v in bad) == ["RPL004"] * 7
    good = _lint(tmp_path, """
        from torch.distributed.device_mesh import init_device_mesh

        MESH = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))

        def run(coll, t, axis_name="data", pod_axis="pod"):
            coll.all_reduce(t, ("pod", "data"))
            coll.all_gather(t, dim="model")
            return coll.size("data"), t.size(0), MESH.get_group("model")
        """, name="ok.py")
    assert good == []


def test_lint_bare_print(tmp_path):
    bad = _lint(tmp_path, """
        def report(x):
            print("loss", x)
        """)
    assert [v.rule for v in bad] == ["RPL005"]
    cli = _lint(tmp_path, """
        def main():
            print("hello")
        """, name=os.path.join("launch", "train.py"))
    assert cli == []
    rep = _lint(tmp_path, """
        def emit(msg):
            print(msg)
        """, name=os.path.join("obs", "report.py"))
    assert rep == []
    # attribute calls are not bare prints
    log = _lint(tmp_path, """
        import logging

        def note(x):
            logging.getLogger(__name__).info("x=%s", x)
            x.print()
        """, name="log.py")
    assert log == []


def test_declared_axes_are_the_mesh_modules():
    assert DECLARED_AXES == MESH_AXES


def test_the_port_lints_clean():
    assert lint_paths([os.path.join(ROOT, "src", "repro_torch")]) == []
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("0 violation(s)")
