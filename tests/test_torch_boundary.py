"""The port's package boundary: it never imports the reference package or
its framework, it runs with them made unimportable, its entry points
refuse to fall back to the CPU, options whose port is still to come
raise NotImplementedError, and dispatch raises the reference's errors."""

import ast
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.hetero import (  # noqa: E402
    dirichlet_weights,
    make_scenario,
    pareto_cost,
)
from _torch_threads import one_torch_thread  # noqa: E402, F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    out = [os.path.join(ROOT, name) for name in ("chip_smoke.py", "kernel_ab.py")]
    out += [os.path.join(ROOT, "examples", f) for f in sorted(os.listdir(
        os.path.join(ROOT, "examples"))) if f.startswith("torch_")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_the_reference_or_its_framework(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_every_module_imports_without_triton_or_a_card():
    names = [m.name for m in pkgutil.walk_packages([PKG], "repro_torch.")]
    assert "repro_torch.kernels.region_aggregate" in names
    for name in names:
        importlib.import_module(name)


def test_runs_with_the_reference_and_its_framework_poisoned():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import repro_torch
        from repro_torch import prng
        p = repro_torch.make_quadratic(prng.PRNGKey(0), num_workers=4,
                                       dim=16, num_regions=4, device="cpu")
        r = repro_torch.run(p, prng.PRNGKey(1), device="cpu", num_rounds=3,
                            num_regions=4, curvature="diag")
        assert r.xs.shape == (5, 16) and r.tau_star >= 0
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _small(device="cpu"):
    return repro_torch.make_quadratic(prng.PRNGKey(0), num_workers=4, dim=8,
                                      num_regions=2, device=device)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.make_quadratic(prng.PRNGKey(0), num_workers=2, dim=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.make_logistic(prng.PRNGKey(0), num_workers=2,
                                  per_worker=4, dim=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.run(_small(), prng.PRNGKey(1), num_rounds=1)


@pytest.mark.parametrize("entry", [
    lambda: pareto_cost(prng.PRNGKey(0), 4),
    lambda: make_scenario("pareto-stragglers", prng.PRNGKey(0), 4),
    lambda: dirichlet_weights(prng.PRNGKey(0), 4, 0.3)],
    ids=["pareto_cost", "make_scenario", "dirichlet_weights"])
def test_cost_and_scenario_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_run_refuses_a_problem_on_another_device():
    with pytest.raises(ValueError, match="problem"):
        repro_torch.run(_small(), prng.PRNGKey(1), device="cuda",
                        num_rounds=1)


def test_run_refuses_a_cost_model_on_another_device():
    cost = pareto_cost(prng.PRNGKey(0), 4, device="meta")
    with pytest.raises(ValueError, match="cost model"):
        repro_torch.run(_small(), prng.PRNGKey(1), device="cpu",
                        num_rounds=1, num_regions=2, cost=cost)


@pytest.mark.parametrize("kw", [
    dict(engine="sharded"), dict(engine="sharded2d"), dict(overlap=True),
    dict(engine="batch", overlap=True),
    dict(engine="reference", overlap=True)], ids=str)
def test_sharded_options_raise_the_references_value_errors(kw):
    """Once NotImplementedError (ROADMAP items 12 and 13, now ported):
    the sharded engines need a mesh, and ``overlap`` exists only on them
    (``src/repro/api.py:78-84``)."""
    key = prng.PRNGKey(1)
    if kw.get("engine") == "batch":
        key = prng.split(key, 2)
    with pytest.raises(ValueError, match="mesh|overlap"):
        repro_torch.run(_small(), key, device="cpu", num_rounds=1,
                        num_regions=2, **kw)


@pytest.mark.parametrize("kw", [
    dict(engine="batch"), dict(compression="int8"), dict(quorum=0.75),
    dict(hessian_rank=2), dict(controller="resource:keep=0.5"),
    dict(hierarchy="pods=2,period=1"),
    dict(engine="batch", hierarchy="pods=2,period=1")], ids=str)
def test_options_of_this_slice_run(kw):
    """What raised NotImplementedError before the batch engine, the
    compression, quorum, controller and hierarchy ports now runs."""
    key = prng.PRNGKey(1)
    if kw.get("engine") == "batch":
        key = prng.split(key, 2)
    res = repro_torch.run(_small(), key, device="cpu", num_rounds=1,
                          num_regions=2, **kw)
    assert torch.isfinite(res.xs).all()
    assert res.coverage.shape[-1] == 1


@pytest.mark.parametrize("spec", ["geo-distributed", "edge-cohort",
                                  "diurnal-WAN"])
def test_pod_topology_scenarios_raise_not_implemented(spec):
    """The pod-topology scenarios once raised NotImplementedError
    (ROADMAP item 11, now ported): they build, and equal the
    reference's (``tests/test_torch_hierarchy.py`` holds more
    parameters)."""
    jscen = pytest.importorskip("repro.hetero.scenarios")
    jax = pytest.importorskip("jax")
    got = make_scenario(spec, prng.PRNGKey(0), 4, device="cpu")
    want = jscen.make_scenario(spec, jax.random.PRNGKey(0), 4)
    assert got.name == want.name
    np.testing.assert_array_equal(got.cost.pod_bw.numpy(),
                                  np.asarray(want.cost.pod_bw))
    np.testing.assert_allclose(got.cost.compute_rate.numpy(),
                               np.asarray(want.cost.compute_rate), rtol=1e-6)
    assert got.cost.pod_latency == want.cost.pod_latency


@pytest.mark.parametrize("kw,err", [
    (dict(engine="warp"), ValueError),
    (dict(engine="reference", curvature="diag"), ValueError),
    (dict(engine="reference", projection="ns"), ValueError),
    (dict(engine="reference", hierarchy="pods=2,period=1"), ValueError),
    (dict(mesh="mesh"), ValueError),
    (dict(engine="reference", mesh="mesh"), ValueError),
    (dict(options="fast"), TypeError),
    (dict(bogus=1), TypeError)], ids=str)
def test_dispatch_checks_match_the_reference(kw, err):
    with pytest.raises(err):
        repro_torch.run(_small(), prng.PRNGKey(1), device="cpu",
                        num_rounds=1, num_regions=2, **kw)


@pytest.mark.parametrize("engine", ["batch", "sharded"])
def test_a_mesh_that_is_not_a_device_mesh_is_refused(engine):
    """The batch engine shards seeds and the sharded engine workers over
    a ``torch.distributed.device_mesh.DeviceMesh``; anything else is
    refused before a run starts (tests/test_torch_sharded.py runs
    both on real meshes)."""
    key = prng.PRNGKey(1)
    if engine == "batch":
        key = prng.split(key, 2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        repro_torch.run(_small(), key, engine=engine, mesh="mesh",
                        device="cpu", num_rounds=1, num_regions=2)


def _overlap_costs(jax):
    """(reference cost, port cost): Pareto rates on a finite-bandwidth
    cluster with an overlap credit, carried across as arrays."""
    jcost = pytest.importorskip("repro.hetero.cost")
    from repro_torch import interop
    want = jcost.with_overlap_credit(jcost.pareto_cost(
        jax.random.PRNGKey(3), 6, bandwidth=50.0), 0.4)
    statics = {f: getattr(want, f) for f in (
        "overhead", "dropout_prob", "churn_period", "churn_cohorts",
        "diurnal_period", "diurnal_amplitude", "pod_latency",
        "overlap_credit")}
    got = interop.cost_from_arrays(
        {"compute_rate": np.asarray(want.compute_rate),
         "bandwidth": np.asarray(want.bandwidth), "pod_bw": None},
        statics, device="cpu")
    return jcost, want, got


def test_cost_from_arrays_carries_the_overlap_credit():
    """``interop.cost_from_arrays`` once refused an ``overlap_credit``
    (ROADMAP item 12); it carries it across, and
    ``with_overlap_credit`` checks the range as the reference does."""
    jax = pytest.importorskip("jax")
    from repro_torch.hetero import with_overlap_credit
    _, want, got = _overlap_costs(jax)
    assert got.overlap_credit == want.overlap_credit == 0.4
    np.testing.assert_array_equal(got.compute_rate.numpy(),
                                  np.asarray(want.compute_rate))
    with pytest.raises(ValueError, match="overlap_credit"):
        with_overlap_credit(got, 1.5)


@pytest.mark.parametrize("overlap", [False, True])
def test_worker_times_with_overlap_match_the_reference(overlap):
    jax = pytest.importorskip("jax")
    from repro_torch.hetero import round_time, worker_times
    jcost, want, got = _overlap_costs(jax)
    work = np.array([0, 10, 40, 7, 25, 3], np.int32)
    ubytes = np.array([0.0, 40.0, 8.0, 28.0, 100.0, 12.0], np.float32)
    ref = np.asarray(jcost.worker_times(want, work, 3, ubytes,
                                        overlap=overlap))
    port = worker_times(got, torch.tensor(work), 3, torch.tensor(ubytes),
                        overlap=overlap)
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-6)
    assert ref[0] == 0.0
    np.testing.assert_allclose(
        round_time(got, torch.tensor(work), 3, overlap=overlap).item(),
        float(jcost.round_time(want, work, 3, overlap=overlap)), rtol=1e-6)
    if overlap:
        plain = worker_times(got, torch.tensor(work), 3,
                             torch.tensor(ubytes))
        assert bool((port[1:] < plain[1:]).all())


@pytest.mark.parametrize("engine", ["scan", "batch", "reference"])
@pytest.mark.parametrize("kw", [
    dict(axis_name="seeds"), dict(data_axis="d"), dict(model_axis="m"),
    dict(pod_axis="p"), dict(scenario="geo-distributed")], ids=str)
def test_reference_keywords_are_taken_and_ignored(engine, kw):
    """``run`` takes the reference's mesh-axis and scenario keywords;
    the one-card engines ignore them as the reference's do (no mesh, no
    journal): the result equals the same run without them."""
    key = prng.PRNGKey(1)
    if engine == "batch":
        key = prng.split(key, 2)
    opts = dict(engine=engine, device="cpu", num_rounds=2, num_regions=2)
    got = repro_torch.run(_small(), key, **opts, **kw)
    want = repro_torch.run(_small(), key, **opts)
    for f in ("xs", "coverage", "comm_floats", "round_time"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_run_takes_one_key_and_interop_validates():
    from repro_torch import interop
    with pytest.raises(ValueError):
        repro_torch.run(_small(), prng.split(prng.PRNGKey(1), 2),
                        device="cpu", num_rounds=1, num_regions=2)
    with pytest.raises(ValueError):
        interop.problem_from_arrays("svm", {}, {}, device="cpu")
    with pytest.raises(ValueError):
        interop.key_from_numpy(np.zeros((2, 2), np.uint32))


def test_engine_docs_name_the_dense_step_the_engine_takes():
    """The batched dense step is two triangular solves
    (``core.hessian.cho_solve_rows``), not ``torch.cholesky_solve``; the
    engine module's documentation says what the code does."""
    from repro_torch.core import hessian, ranl
    assert "cholesky_solve" not in ranl.__doc__
    assert "triangular solves" in ranl.__doc__
    src = inspect.getsource(hessian.cho_solve_rows)
    assert src.count("solve_triangular") == 2
    assert "cholesky_solve(" not in src


# --------------------------------------------------------------------------
# deep-net training (ROADMAP item 14b)
# --------------------------------------------------------------------------

def test_the_training_modules_are_part_of_the_package():
    names = {m.name for m in pkgutil.walk_packages([PKG], "repro_torch.")}
    for name in ("repro_torch.optim.ranl_llm", "repro_torch.optim.first_order",
                 "repro_torch.checkpoint.checkpoint", "repro_torch.launch.train",
                 "repro_torch.launch.steps", "repro_torch.models.moe",
                 "repro_torch.models.ssm", "repro_torch.tree",
                 "repro_torch.launch.mesh", "repro_torch.launch.shard",
                 "repro_torch.analysis.lint"):
        assert name in names, name


def test_train_cli_runs_with_the_reference_and_its_framework_poisoned(
        tmp_path):
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        from repro_torch.launch.train import run
        for opt in ("ranl", "adamw"):
            run(["--device", "cpu", "--smoke", "--steps", "2", "--seq", "8",
                 "--optimizer", opt, "--checkpoint-dir", {str(tmp_path)!r}])
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith('{"final_loss"')


def test_train_cli_defaults_to_the_card(monkeypatch):
    from repro_torch.launch.train import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("argv,item", [
    (["--data-shards", "2"], "14c"), (["--model-shards", "4"], "14c"),
    (["--pods", "2"], "14c")], ids=str)
def test_train_cli_flags_outside_the_slice_raise_not_implemented(argv,
                                                                  item):
    """The shard flags of item 14c are ported: in one process, with no
    process group and no torchrun environment, a mesh of more than one
    rank exits naming torchrun."""
    from repro_torch.launch.train import run
    assert item == "14c"
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node"):
        run(["--device", "cpu", "--smoke"] + argv)
