"""The sharded deep-net train step (``optim.ranl_llm`` with ``mesh=``) and
the train CLI under a mesh, on gloo rank processes on the CPU.

The reference's own sharded train step does not run on JAX 0.9.0
(ROADMAP Queue 3 (c)), so each sharded round is held, from the same
inputs (the sharded run's state gathered to full leaves), to

* the port's single-device step: params within the reference's sharded-
  step bounds (``tests/test_multidevice.py``: |err| ≤ 1e-5 and
  |err| / (|p| + 1e-3) ≤ 3e-4), loss within 1e-5, coverage, uplink and
  step equal, precond within 1e-5 of each leaf's max, memory within one
  bf16 step (``_torch_train_helpers.BF16_STEP``) and 1e-5 of its leaf's
  max; under int8 compression with int8 memory, params and decoded
  memory within two quanta (``FLIP["int8"]``) of the leaf's max;
* the reference's single-device jitted step, at ``STEP_TOL``.

One module fixture starts every rank process at once: meshes (2,)
("data"), (1, 2) and (2, 2) ("data", "model") and (2, 1, 2) ("pod",
"data", "model").  Smoke phi4-mini runs at every mesh, smoke rwkv6 at
(2,), smoke phi3.5-moe at (2, 2) (its expert dim on "model"), and phi4-
mini with int8 compression and int8 memory at (2, 2).  The (2,) and
(1, 2) ranks also run the train CLI with ``--data-shards 2`` and
``--model-shards 2``.  The (2,) ranks run phi4-mini's steps once more
under an active tracer (``obs.tracing``): bit for bit the untraced leg,
with the round's spans and ``host_syncs`` counter read back.  Each
rank's collective log is held to ``analysis.train_contract``; the (1, 2)
ranks' persistent RANL state (params, precond, memory) to at most 0.55
of the unsharded state's bytes.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_train_helpers import (  # noqa: E402, F401
    BF16_STEP, FLIP, STEP_TOL, assert_memory_close, assert_params_close,
    cfgs, loss_fns, make_batches, one_torch_thread, to_np, to_reference)
from repro.optim import ranl_llm as jr  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.analysis import check_log, train_contract  # noqa: E402
from repro_torch.core.collectives import Collective  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import ranl_llm as tr  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, STEPS, RNG = 4, 2, 7
PHI, RWKV, MOE = "phi4-mini-3.8b", "rwkv6-3b", "phi3.5-moe-42b-a6.6b"
INT8 = {"compression": "int8", "memory_int8": True}
# masks given (a layer uncovered: the memory fallback), glue trained
# only where masked, and the EMA curvature refresh (two passes a step)
GIVEN = {"masks": True, "protect_glue": False, "precond_beta": 0.5}
# the phi4-2 leg's steps again under an active tracer
TRACED = {"traced": True}
# (name, mesh shape, mesh dims, arch, RanlLLMConfig options)
LEGS = [("phi4-2", (2,), ("data",), PHI, {}),
        ("phi4-2-traced", (2,), ("data",), PHI, TRACED),
        ("rwkv6-2", (2,), ("data",), RWKV, {}),
        ("phi4-1x2", (1, 2), ("data", "model"), PHI, {}),
        ("phi4-2x2", (2, 2), ("data", "model"), PHI, {}),
        ("moe-2x2", (2, 2), ("data", "model"), MOE, {}),
        ("phi4-int8-2x2", (2, 2), ("data", "model"), PHI, INT8),
        ("phi4-2x1x2", (2, 1, 2), ("pod", "data", "model"), PHI, GIVEN)]
SHAPES = [(2,), (1, 2), (2, 2), (2, 1, 2)]
CLI_ARGV = ["--device", "cpu", "--smoke", "--steps", "2", "--batch", "8",
            "--seq", "16"]
CLI = {(2,): ["--data-shards", "2"], (1, 2): ["--model-shards", "2"]}
PARAM_ABS, PARAM_REL, LOSS_ABS, STATE_TOL = 1e-5, 3e-4, 1e-5, 1e-5


_RANKS = textwrap.dedent(r"""
    import contextlib, json, os, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import interop, prng
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.collectives import Collectives
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.launch.shard import ranl_state_pspecs
    from repro_torch.models import lm_loss
    from repro_torch.obs import tracing
    from repro_torch.optim import (RanlLLMConfig, gather_tree, init_state,
                                   shard_params, train_step)
    from repro_torch.optim.ranl_llm import mesh_sizes
    from repro_torch.tree import leaves

    rank, shape, cfg_path, out = (int(sys.argv[1]), json.loads(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    cfg = json.load(open(cfg_path))
    inputs = torch.load(cfg["inputs"], weights_only=False)
    ws = 1
    for n in shape:
        ws *= n
    dist.init_process_group("gloo", store=dist.FileStore(out + ".store", ws),
                            rank=rank, world_size=ws)

    def make_mesh():
        if len(shape) == 1:
            return init_device_mesh("cpu", tuple(shape),
                                    mesh_dim_names=("data",))
        pods, (data, model) = (shape[0], shape[1:]) if len(shape) == 3 \
            else (1, shape)
        return make_engine_mesh(data, model, pods=pods, device_type="cpu")

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree)
                   for t in (t.values() if isinstance(t, dict) else [t]))

    res = {}
    for name, leg_shape, _, arch, kw in cfg["legs"]:
        if leg_shape != shape:
            continue
        kw = dict(kw)
        given = kw.pop("masks", False)
        traced = kw.pop("traced", False)
        mesh = make_mesh()
        tcfg = smoke_variant(get_config(arch))
        params = interop.model_params_from_numpy(tcfg, inputs[arch]["params"],
                                                 device="cpu")
        batches = [{k: torch.tensor(v) for k, v in b.items()}
                   for b in inputs[arch]["batches"]]
        loss_fn = lambda p, b: lm_loss(p, b, tcfg)
        rcfg = RanlLLMConfig(num_workers=cfg["workers"], **kw)
        names = tuple(mesh.mesh_dim_names)
        M = mesh.size(names.index("model")) if "model" in names else 1
        pspecs = {"state": ranl_state_pspecs(params, M)}
        coll, look = Collectives(mesh), Collectives(mesh)
        sp = shard_params(params, mesh, pspecs)
        on = dict(mesh=mesh, pspecs=pspecs, coll=coll)

        def full(p, s):
            return {"params": gather_tree(p, mesh, pspecs, look),
                    "state": {"step": s["step"],
                              "precond": gather_tree(s["precond"], mesh,
                                                     pspecs, look),
                              "memory": gather_tree(s["memory"], mesh,
                                                    pspecs, look,
                                                    workers=True)}}
        state = init_state(sp, loss_fn, batches[0], rcfg, prng.PRNGKey(0),
                           **on)
        row = {"init": full(sp, state), "steps": [],
               "persistent_bytes": nbytes(sp) + nbytes(state["precond"])
               + nbytes(state["memory"]),
               "sizes": mesh_sizes(sp, mesh, pspecs)}
        row["spans"], row["host_syncs"] = [], []
        for t in range(cfg["steps"]):
            masks = torch.tensor(cfg["masks"][t]) if given else None
            with tracing() if traced else contextlib.nullcontext() as tr:
                sp, state, m = train_step(sp, state, batches[1 + t],
                                          prng.PRNGKey(cfg["rng"]),
                                          loss_fn=loss_fn, cfg=rcfg,
                                          masks=masks, **on)
            if traced:
                row["spans"].append([(s.name, s.start_ns, s.end_ns,
                                      dict(s.meta)) for s in tr.spans])
                row["host_syncs"].append(
                    tr.metrics.counter("host_syncs").value)
            row["steps"].append({"out": full(sp, state), "metrics": {
                k: float(v) for k, v in m.items()}})
        row["log"] = [tuple(c.__dict__.values()) for c in coll.log]
        res[name] = row
    argv = cfg["cli"].get(json.dumps(shape))
    if argv:
        ck = out + ".ck"
        jpath = out + ".journal.jsonl"
        from repro_torch.launch import train
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.run(cfg["cli_argv"] + argv + ["--checkpoint-dir", ck,
                                                "--journal", jpath])
        res["cli"] = {"stdout": buf.getvalue(), "ck": ck, "journal": jpath}
    torch.save(res, f"{out}.{rank}")
    dist.destroy_process_group()
""")


def _inputs(tmp):
    """Reference params and the same batches for each arch, as numpy."""
    from repro.models import init_model as jinit
    out = {}
    for arch in (PHI, RWKV, MOE):
        jcfg, _ = cfgs(arch)
        batches = [make_batches(jcfg, 8, 16, seed=s)[1] for s in (1, 10, 11)]
        out[arch] = {"params": to_np(jinit(jcfg, jax.random.PRNGKey(0))),
                     "batches": [{k: v.numpy() for k, v in b.items()}
                                 for b in batches]}
    torch.save(out, tmp / "inputs.pt")
    return out


def _given(t):
    """Step t's given masks (N, Q) for phi4-mini (Q = 2 layers + embed
    and final_norm): layer 0 uncovered."""
    given = np.random.default_rng(t).random((N, 4)) < 0.5
    given[:, 0] = False
    return given


def _run_all(tmp):
    inputs = _inputs(tmp)
    cfg = dict(inputs=str(tmp / "inputs.pt"), workers=N, steps=STEPS,
               rng=RNG, legs=[list(leg) for leg in LEGS],
               masks=[_given(t).tolist() for t in range(STEPS)],
               cli={json.dumps(list(s)): a for s, a in CLI.items()},
               cli_argv=CLI_ARGV)
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    (tmp / "ranks.py").write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = []
    for shape in SHAPES:
        tag = "x".join(map(str, shape))
        for rank in range(int(np.prod(shape))):
            procs.append(subprocess.Popen(
                [sys.executable, str(tmp / "ranks.py"), str(rank),
                 json.dumps(list(shape)), str(tmp / "cfg.json"),
                 str(tmp / f"port-{tag}")], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-4000:]
    port = {}
    for shape in SHAPES:
        tag = "x".join(map(str, shape))
        port[shape] = [torch.load(tmp / f"port-{tag}.{r}", weights_only=False)
                       for r in range(int(np.prod(shape)))]
    return inputs, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run_all(tmp_path_factory.mktemp("train_sharded"))


def _leg(name):
    return next(leg for leg in LEGS if leg[0] == name)


def _setup(inputs, arch, kw):
    kw = {k: v for k, v in kw.items() if k not in ("masks", "traced")}
    jcfg, tcfg = cfgs(arch)
    _, tloss = loss_fns(jcfg, tcfg)
    from repro_torch import interop
    tp = interop.model_params_from_numpy(tcfg, inputs[arch]["params"],
                                         device="cpu")
    tb = [{k: torch.tensor(v) for k, v in b.items()}
          for b in inputs[arch]["batches"]]
    return jcfg, tcfg, tp, tb, tloss, tr.RanlLLMConfig(num_workers=N, **kw)


def _decode(x):
    return x["q"].float() * x["scale"] if isinstance(x, dict) else x.float()


def _params_close(got, want, flip, what):
    for a, b in zip(leaves(got), leaves(want)):
        err = (a - b).abs()
        if flip is not None:
            assert float(err.max()) <= flip * float(b.abs().max()), what
        else:
            assert float(err.max()) <= PARAM_ABS, (what, float(err.max()))
            assert float((err / (b.abs() + 1e-3)).max()) <= PARAM_REL, what


def _state_close(got, want, flip, what):
    for a, b in zip(leaves(got["precond"]), leaves(want["precond"])):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= STATE_TOL * scale, what
    for a, b in zip(leaves(got["memory"]), leaves(want["memory"])):
        a, b = _decode(a), _decode(b)
        scale = max(float(b.abs().max()), 1e-30)
        bound = (flip * scale if flip is not None
                 else BF16_STEP * b.abs() + STATE_TOL * scale)
        assert bool(((a - b).abs() <= bound).all()), what
    assert int(got["step"]) == int(want["step"])


@pytest.mark.parametrize("name", [leg[0] for leg in LEGS])
def test_sharded_step_matches_the_single_device_step(runs, name):
    """init_state and each round, from the same inputs, against the
    port's single-device ``init_state``/``train_step``."""
    inputs, port = runs
    _, shape, _, arch, kw = _leg(name)
    _, _, tp, tb, tloss, rcfg = _setup(inputs, arch, kw)
    row = port[shape][0][name]
    flip = FLIP["int8"] if kw.get("compression") == "int8" else None
    init = tr.init_state(tp, tloss, tb[0], rcfg, prng.PRNGKey(0))
    _params_close(row["init"]["params"], tp, None, f"{name} init params")
    _state_close(row["init"]["state"], init, flip, f"{name} init")
    for t, step in enumerate(row["steps"]):
        src = row["init"] if t == 0 else row["steps"][t - 1]["out"]
        p, s, m = tr.train_step(src["params"], src["state"], tb[1 + t],
                                prng.PRNGKey(RNG), loss_fn=tloss, cfg=rcfg,
                                masks=_masks(kw, t, torch.tensor))
        _params_close(step["out"]["params"], p, flip, f"{name} step {t}")
        _state_close(step["out"]["state"], s, flip, f"{name} step {t}")
        got = step["metrics"]
        assert abs(got["loss"] - float(m["loss"])) <= LOSS_ABS
        assert got["coverage"] == float(m["coverage"])
        assert got["uplink_frac"] == float(m["uplink_frac"])
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]),
                                   rtol=1e-4)


def _masks(kw, t, to):
    return to(_given(t)) if kw.get("masks") else None


def test_the_given_masks_leave_a_layer_to_the_memory(runs):
    _, port = runs
    for step in port[(2, 1, 2)][0]["phi4-2x1x2"]["steps"]:
        assert step["metrics"]["coverage"] < 1.0


_JSTEPS = {}


@pytest.mark.parametrize("name", [leg[0] for leg in LEGS])
def test_sharded_step_matches_the_reference_step(runs, name):
    """Each round, from the sharded run's inputs carried into the
    reference, against the reference's single-device jitted step at
    STEP_TOL (two quanta under int8)."""
    inputs, port = runs
    _, shape, _, arch, kw = _leg(name)
    kw = {k: v for k, v in kw.items() if k != "traced"}
    jcfg, tcfg, _, _, _, _ = _setup(inputs, arch, kw)
    jloss, _ = loss_fns(jcfg, tcfg)
    flip = FLIP.get(kw.get("compression"))
    key = (arch, json.dumps(kw, sort_keys=True))
    if key not in _JSTEPS:
        jrc = jr.RanlLLMConfig(num_workers=N, **{
            k: v for k, v in kw.items() if k != "masks"})
        _JSTEPS[key] = jax.jit(lambda p, s, b, m: jr.train_step(
            p, s, b, jax.random.PRNGKey(RNG), loss_fn=jloss, cfg=jrc,
            masks=m))
    row = port[shape][0][name]
    tol = STEP_TOL[arch] if arch in STEP_TOL else STEP_TOL[PHI]
    for t, step in enumerate(row["steps"]):
        src = row["init"] if t == 0 else row["steps"][t - 1]["out"]
        jp, js = to_reference(tcfg, src["params"], src["state"])
        jb = {k: jax.numpy.asarray(v)
              for k, v in inputs[arch]["batches"][1 + t].items()}
        wp, ws, wm = _JSTEPS[key](jp, js, jb,
                                  _masks(kw, t, jax.numpy.asarray))
        out = step["out"]
        assert_params_close(wp, out["params"], tcfg, tol,
                            f"{name} step {t} params", flip)
        assert_params_close(ws["precond"], out["state"]["precond"], tcfg,
                            tol, f"{name} step {t} precond")
        assert_memory_close(ws["memory"], out["state"]["memory"], tcfg,
                            kw.get("memory_int8", False), flip, tol)
        for k in ("coverage", "uplink_frac"):
            assert step["metrics"][k] == float(wm[k]), k
        np.testing.assert_allclose(step["metrics"]["loss"], float(wm["loss"]),
                                   rtol=1e-5)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_a_traced_mesh_round_is_the_round_with_its_spans(runs):
    """Under a tracer the mesh path's steps are bit for bit the untraced
    leg's, on every rank; each step is one ``ranl.round`` holding each
    local worker's ``ranl.worker_pass`` (``forward``, ``backward``) and
    ``ranl.aggregate``, then one ``ranl.exchange`` (the plane
    all-reduce), then ``ranl.newton``; ``host_syncs`` is layers × local
    workers (``apply_attention``'s check) and one more (the masks'
    copy to the host)."""
    _, port = runs
    layers = cfgs(PHI)[1].num_layers
    for rank, out in enumerate(port[(2,)]):
        plain, traced = out["phi4-2"], out["phi4-2-traced"]
        assert _equal(plain["steps"], traced["steps"])
        assert plain["spans"] == [] and len(traced["spans"]) == STEPS
        n_local = N // 2
        for spans in traced["spans"]:
            names = [s[0] for s in spans]
            assert names[-1] == "ranl.round"
            _, r0, r1, _ = spans[-1]
            assert all(r0 <= s[1] <= s[2] <= r1 for s in spans)
            top = [n for n in names if n not in (
                "forward", "backward", "ranl.memory_decode",
                "ranl.memory_encode")]
            assert top == (["ranl.worker_pass", "ranl.aggregate"] * n_local
                           + ["ranl.exchange", "ranl.newton",
                              "ranl.round"])
            workers = [s[3]["worker"] for s in spans
                       if s[0] == "ranl.worker_pass"]
            assert workers == [rank * n_local + j for j in range(n_local)]
            (ex,) = [s for s in spans if s[0] == "ranl.exchange"]
            assert ex[3] == {"op": "all_reduce:data"}
            for p in (s for s in spans if s[0] == "ranl.worker_pass"):
                assert [s[0] for s in spans if s is not p
                        and p[1] <= s[1] <= s[2] <= p[2]] == [
                    "forward", "backward"]
        assert traced["host_syncs"] == [layers * n_local + 1] * STEPS


@pytest.mark.parametrize("name", [leg[0] for leg in LEGS])
def test_every_rank_reports_the_same_metrics(runs, name):
    _, port = runs
    shape = _leg(name)[1]
    first = [s["metrics"] for s in port[shape][0][name]["steps"]]
    for out in port[shape][1:]:
        assert [s["metrics"] for s in out[name]["steps"]] == first


def _contract(row, kw):
    return train_contract(STEPS, precond_beta=kw.get("precond_beta", 0.0),
                          **row["sizes"])


@pytest.mark.parametrize("name", [leg[0] for leg in LEGS])
def test_collective_log_meets_the_train_contract(runs, name):
    """One param-sized plane all-reduce a step (and one at init); over
    "model", one all-gather and one small all-reduce a step; on every
    rank."""
    _, port = runs
    _, shape, dims, _, kw = _leg(name)
    plane = "+".join(d for d in ("pod", "data") if d in dims)
    n_model = shape[-1] if "model" in dims else 1
    for out in port[shape]:
        row = out[name]
        log = [Collective(*e) for e in row["log"]]
        rep = check_log(_contract(row, kw), log)
        assert rep["ok"], rep["violations"]
        passes = [c for c in log if c.dim == plane]
        assert [c.round for c in passes] == [None] + list(
            range(1, STEPS + 1))
        assert row["sizes"]["n_model"] == n_model
        assert len(log) == (1 + STEPS) * (1 if n_model == 1 else 3) - (
            0 if n_model == 1 else 1)


@pytest.mark.parametrize("edit", ["drop_pass", "add_pass", "add_small",
                                  "drop_gather", "drop_model_sum"])
def test_train_contract_fails_a_broken_log(runs, edit):
    """The (2, 1, 2) log with the plane all-reduce of a step dropped or
    one added, a small all-reduce added, an all-gather or the model sum
    dropped, fails the contract."""
    _, port = runs
    row = port[(2, 1, 2)][0]["phi4-2x1x2"]
    log = [Collective(*e) for e in row["log"]]
    contract = _contract(row, _leg("phi4-2x1x2")[4])
    assert check_log(contract, log)["ok"]
    pick = {"drop_pass": ("pod+data", "sum"), "add_pass": ("pod+data", "sum"),
            "drop_gather": ("model", "all_gather"),
            "drop_model_sum": ("model", "sum"),
            "add_small": ("model", "sum")}[edit]
    hits = [i for i, c in enumerate(log) if (c.dim, c.op) == pick
            and c.round == 2]
    i = hits[0]
    if edit.startswith("drop"):
        log = log[:i] + log[i + 1:]
    elif edit == "add_pass":
        log = log + [log[i]]
    else:
        log = log + [Collective("pod+data", "sum", "float32", 16, 2)]
    assert not check_log(contract, log)["ok"]


def test_model_sharded_state_is_about_half_a_rank(runs):
    """At ("data", "model") = (1, 2) each rank's params, precond and
    memory take at most 0.55 of the unsharded state's bytes (every leaf
    counted; the replicated norms fit in the margin)."""
    _, port = runs
    row = port[(1, 2)][0]["phi4-1x2"]
    full = row["init"]

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree)
                   for t in (t.values() if isinstance(t, dict) else [t]))
    unsharded = (nbytes(full["params"]) + nbytes(full["state"]["precond"])
                 + nbytes(full["state"]["memory"]))
    for out in port[(1, 2)]:
        assert out["phi4-1x2"]["persistent_bytes"] <= 0.55 * unsharded
    assert port[(1, 2)][0]["phi4-1x2"]["persistent_bytes"] >= 0.45 * \
        unsharded


@pytest.fixture(scope="module")
def one_rank_cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli1")
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain.run(CLI_ARGV + ["--checkpoint-dir", str(tmp / "ck")])
    return json.loads(buf.getvalue().strip().splitlines()[-1]), str(
        tmp / "ck")


@pytest.mark.parametrize("shape", list(CLI), ids=["data2", "model2"])
def test_train_cli_on_two_ranks_matches_one_rank(runs, one_rank_cli, shape):
    """The final line of rank 0 within 1e-5 of the one-rank run's; rank 1
    prints nothing; the journal is rank 0's alone (one header, a round a
    step, one summary)."""
    _, port = runs
    want, _ = one_rank_cli
    out = port[shape][0]["cli"]
    got = json.loads(out["stdout"].strip().splitlines()[-1])
    for k in ("final_loss", "first_loss"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k
    assert port[shape][1]["cli"]["stdout"] == ""
    from repro_torch.obs import read_journal, validate_journal
    records = read_journal(out["journal"])
    assert validate_journal(records) == []
    kinds = [r["kind"] for r in records]
    assert kinds == ["header"] + ["round"] * 2 + ["summary"]
    assert records[0]["mesh"]["axes"] == (["data"] if shape == (2,) else
                                          ["data", "model"])


@pytest.mark.parametrize("shape", list(CLI), ids=["data2", "model2"])
def test_train_cli_checkpoint_restores_in_the_reference(runs, one_rank_cli,
                                                        shape):
    """The sharded run's checkpoint (gathered to full leaves by rank 0)
    restores in the reference, within 1e-5 of the one-rank run's."""
    from repro.checkpoint import restore as jrestore
    from repro.models import init_model as jinit
    _, port = runs
    _, ck1 = one_rank_cli
    jcfg, _ = cfgs(PHI)
    like = jinit(jcfg, jax.random.PRNGKey(3))
    got = jrestore(like, port[shape][0]["cli"]["ck"])
    want = jrestore(like, ck1)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)
