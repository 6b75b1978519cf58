"""The port's observability layer (``repro_torch.obs``) on the CPU, held
to the reference's (``repro.obs``).

* bit-exactness: ``repro_torch.run(..., journal=...)`` under an active
  tracer gives the journal-off run's xs and traces bit for bit on every
  engine (scan dense and diag with compression, quorum and hierarchy;
  reference; batch over 3 seeds; sharded and sharded2d on one gloo rank;
  sharded on two gloo ranks, where only rank 0 writes the path);
* the port's journals pass the reference's ``validate_journal``, and
  match the reference's journal of the same problem, key and options:
  header fields equal, ``t``, ``comm_floats``, ``comm_bytes``,
  ``pod_bytes``, ``max_stale`` and coverage exact, ``round_time`` and
  ``sim_s`` within rtol 1e-6, loss and dist_sq within the engine parity
  tests' tolerances (``tests/test_torch_engine.py``);
* the drift alarm: silent at the full-mask wire bytes of every
  combination of the reference's contract matrix
  (``repro.analysis.audit._configs``), with the reference's budgets;
  fires on an injected one;
* spans (nesting, the Chrome form, the no-op without a tracer, one
  ``execute`` span a run), ``torch_profiler`` on the CPU, the metrics
  registry against the reference's;
* the report CLI on port journals, on reference journals (rendered as
  the reference renders them) and on ``examples/sample_journal.jsonl``;
* the train CLI's ``--journal``/``--trace``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402
from repro.core import make_quadratic as jmake_quadratic  # noqa: E402
from repro.core.masks import PolicyConfig as JPolicy  # noqa: E402
from repro.obs import Journal as JJournal  # noqa: E402
from repro.obs import validate_journal as jvalidate  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs.metrics import result_metrics as jresult_metrics  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop, prng  # noqa: E402
from repro_torch.core.masks import PolicyConfig as TPolicy  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    Journal,
    MetricsRegistry,
    Tracer,
    check_byte_drift,
    current_tracer,
    device_ops,
    make_header,
    read_journal,
    result_metrics,
    span,
    torch_profiler,
    tracing,
    validate_journal,
    write_run_journal,
)
from repro_torch.obs.report import diff, render, render_diff, render_md  # noqa: E402
from repro_torch.obs.report import main as report_main  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JKEY = jax.random.PRNGKey(3)
TKEY = interop.key_from_numpy(np.asarray(JKEY))
POL = dict(keep_prob=0.5, tau_star=1, heterogeneous=False)
TRACES = ("xs", "dist_sq", "losses", "coverage", "comm_floats",
          "round_time", "max_stale", "comm_bytes", "pod_bytes", "xs_pods")


def _jproblem():
    return jmake_quadratic(jax.random.PRNGKey(0), num_workers=8, dim=48,
                           kappa=80.0, coupling=0.0, num_regions=6,
                           grad_noise=0.1, hess_noise=0.1, heterogeneity=0.3)


def _carry(p):
    return interop.problem_from_arrays(
        "quadratic", {n: np.asarray(getattr(p, n))
                      for n in ("A", "b", "x_star")},
        dict(grad_noise=p.grad_noise, hess_noise=p.hess_noise, mu=p.mu,
             L_g=p.L_g), device="cpu")


JPROB = _jproblem()
TPROB = _carry(JPROB)


def _topts(**kw):
    base = dict(num_rounds=6, num_regions=6, policy=TPolicy(**POL))
    return repro_torch.RanlOptions(**{**base, **kw})


def _jopts(**kw):
    base = dict(num_rounds=6, num_regions=6, policy=JPolicy(**POL))
    return repro.RanlOptions(**{**base, **kw})


def _assert_same_run(a, b):
    for f in TRACES:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f
    assert (a.tau_star == b.tau_star if isinstance(a.tau_star, int)
            else torch.equal(a.tau_star, b.tau_star))
    assert (a.tau_covered == b.tau_covered
            if isinstance(a.tau_covered, int)
            else torch.equal(a.tau_covered, b.tau_covered))


def _journaled(key, engine="scan", **kw):
    """The run without a journal, then under a tracer with an in-memory
    journal: bit-equal, and the journal valid to both packages."""
    off = repro_torch.run(TPROB, key, engine=engine, device="cpu", **kw)
    j = Journal()
    with tracing():
        on = repro_torch.run(TPROB, key, engine=engine, device="cpu",
                             journal=j, **kw)
    _assert_same_run(off, on)
    assert validate_journal(j) == [] and jvalidate(j.records) == []
    return on, j


# --------------------------------------------------------------------------
# bit-exactness and schema, every one-card engine
# --------------------------------------------------------------------------

SCAN_OPTS = [
    {}, {"curvature": "diag"}, {"compression": "int8"},
    {"curvature": "diag", "compression": "bf16"}, {"quorum": 0.75},
    {"hierarchy": "pods=2,period=2"},
    {"hierarchy": "pods=2,period=2,compression=int8"},
    {"record_every": 4}]


@pytest.mark.parametrize("kw", SCAN_OPTS, ids=str)
def test_bit_exact_scan(kw):
    _, j = _journaled(TKEY, options=_topts(**kw))
    assert not [r for r in j.records if r["kind"] == "drift"]
    spans = [r for r in j.records if r["kind"] == "span"]
    assert [s["name"] for s in spans] == ["execute"]
    assert spans[0]["meta"] == {"engine": "scan"}
    assert "device_s" not in spans[0]          # a CPU run times no card


def test_bit_exact_reference():
    _, j = _journaled(TKEY, engine="reference", options=_topts())
    assert j.records[0]["engine"] == "reference"


def test_bit_exact_batch_seeds_header():
    keys = prng.split(TKEY, 3)
    _, j = _journaled(keys, engine="batch", options=_topts())
    assert j.records[0]["seeds"] == 3
    stale = [r["max_stale"] for r in j.records if r["kind"] == "round"]
    assert all(isinstance(s, int) for s in stale)


def test_journal_roundtrip_and_schema(tmp_path):
    path = tmp_path / "run.jsonl"
    res = repro_torch.run(TPROB, TKEY, device="cpu", options=_topts(),
                          journal=str(path))
    records = read_journal(path)
    assert validate_journal(records) == [] and jvalidate(records) == []
    kinds = [r["kind"] for r in records]
    assert kinds[0] == "header" and kinds[-1] == "summary"
    assert kinds.count("round") == 6 and "span" not in kinds
    head = records[0]
    assert head["engine"] == "scan" and head["mesh"] is None
    assert head["options"]["num_rounds"] == 6
    assert head["contract_key"] == ("scan|comp=none|quorum=off|"
                                    "overlap=off|rank=none")
    assert head["problem"] == {"dim": 48, "num_workers": 8}
    assert set(head["byte_budget"]) == {"comm_per_round", "pod_per_round"}
    rounds = [r for r in records if r["kind"] == "round"]
    assert [r["t"] for r in rounds] == [1, 2, 3, 4, 5, 6]
    for r in rounds:
        assert {"coverage", "comm_floats", "comm_bytes", "loss",
                "dist_sq", "round_time", "sim_s"} <= set(r)
    sims = [r["sim_s"] for r in rounds]
    assert sims == sorted(sims)
    assert records[-1]["sim_total"] == pytest.approx(sims[-1])
    assert records[-1]["final_loss"] == pytest.approx(rounds[-1]["loss"])
    assert records[-1]["final_loss"] == float(res.losses[-1])


def test_journal_in_memory_and_context_manager(tmp_path):
    with Journal(tmp_path / "j.jsonl") as j:
        repro_torch.run(TPROB, TKEY, device="cpu",
                        options=_topts(num_rounds=2), journal=j)
    assert validate_journal(j) == []
    assert validate_journal(read_journal(tmp_path / "j.jsonl")) == []
    mem = Journal()
    repro_torch.run(TPROB, TKEY, device="cpu", options=_topts(num_rounds=2),
                    journal=mem)
    assert mem.path is None and validate_journal(mem) == []


def test_journal_record_every_thins_losses_not_rounds():
    mem = Journal()
    repro_torch.run(TPROB, TKEY, device="cpu",
                    options=_topts(num_rounds=7, record_every=3),
                    journal=mem)
    rounds = [r for r in mem.records if r["kind"] == "round"]
    assert [r["t"] for r in rounds] == [1, 2, 3, 4, 5, 6, 7]
    assert [r["t"] for r in rounds if "loss" in r] == [3, 6, 7]
    for r in rounds:
        assert "coverage" in r and "comm_bytes" in r


def test_scenario_labels_the_header():
    from repro_torch.hetero import make_scenario
    cost = make_scenario("pareto-stragglers", prng.PRNGKey(7), 8,
                         device="cpu").cost
    mem = Journal()
    repro_torch.run(TPROB, TKEY, device="cpu", options=_topts(), cost=cost,
                    journal=mem, scenario="pareto-stragglers")
    assert mem.records[0]["scenario"] == "pareto-stragglers"
    plain = Journal()
    repro_torch.run(TPROB, TKEY, device="cpu", options=_topts(), cost=cost,
                    journal=plain)
    assert plain.records[0]["scenario"] is None   # a CostModel has no name


def test_validate_journal_negatives():
    head = {"kind": "header", "schema": 1, "engine": "scan",
            "options": {}, "version": "0"}
    rnd = {"kind": "round", "t": 1, "loss": 1.0}
    assert validate_journal([]) != []
    assert any("header" in p for p in validate_journal([rnd]))
    assert any("schema" in p for p in
               validate_journal([{**head, "schema": 99}]))
    assert any("duplicate" in p for p in validate_journal([head, head]))
    assert any("unknown kind" in p for p in
               validate_journal([head, {"kind": "bogus"}]))
    assert any("not increasing" in p for p in
               validate_journal([head, rnd, {"kind": "round", "t": 1}]))
    assert any("must be an int" in p for p in
               validate_journal([head, {"kind": "round", "t": "one"}]))
    assert any("must be numeric" in p for p in
               validate_journal([head, {"kind": "round", "t": 1,
                                        "loss": "nan-ish"}]))
    assert any("summary must be the last" in p for p in
               validate_journal([head, {"kind": "summary"}, rnd]))
    ok = [head, rnd, {"kind": "round", "t": 2}, {"kind": "summary"}]
    assert validate_journal(ok) == []
    with pytest.raises(ValueError, match="kind"):
        Journal().write({"t": 1})


# --------------------------------------------------------------------------
# parity with the reference's journal
# --------------------------------------------------------------------------

# (engine, options, xs tolerance x max|x|: tests/test_torch_engine.py's
# and tests/test_torch_hierarchy.py's)
PARITY = [("scan", {}, 2e-5), ("scan", {"curvature": "diag"}, 2e-6),
          ("scan", {"hierarchy": "pods=2,period=3"}, 2e-5),
          ("batch", {}, 2e-5)]


@pytest.mark.parametrize("engine,kw,tol", PARITY,
                         ids=[f"{e}-{kw}" for e, kw, _ in PARITY])
def test_journal_matches_the_reference_journal(engine, kw, tol):
    opts = dict(num_rounds=12, **kw)
    jkey, tkey = JKEY, TKEY
    if engine == "batch":
        jkey, tkey = jax.random.split(JKEY, 3), prng.split(TKEY, 3)
    jj, tj = JJournal(), Journal()
    jres = repro.run(JPROB, jkey, engine=engine, options=_jopts(**opts),
                     journal=jj)
    repro_torch.run(TPROB, tkey, engine=engine, device="cpu",
                    options=_topts(**opts), journal=tj)
    jh, th = jj.records[0], tj.records[0]
    assert set(jh) == set(th)
    for k in jh:
        assert th[k] == jh[k], k
    jr = [r for r in jj.records if r["kind"] == "round"]
    tr = [r for r in tj.records if r["kind"] == "round"]
    assert len(jr) == len(tr) == 12
    scale = float(np.abs(np.asarray(jres.xs)).max())
    for a, b in zip(tr, jr):
        assert set(a) == set(b)
        for k in ("t", "comm_floats", "comm_bytes", "pod_bytes",
                  "max_stale", "coverage"):
            assert a[k] == b[k], k
        for k in ("round_time", "sim_s"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(a["dist_sq"], b["dist_sq"], rtol=1e-3,
                                   atol=10 * tol * scale)
    js, ts = jj.records[-1], tj.records[-1]
    assert set(js) == set(ts)
    for k in ("rounds", "tau_star", "tau_covered", "comm_bytes_total",
              "pod_bytes_total"):
        assert ts[k] == js[k], k
    np.testing.assert_allclose(ts["sim_total"], js["sim_total"], rtol=1e-6)
    np.testing.assert_allclose(ts["final_loss"], js["final_loss"],
                               rtol=1e-5, atol=1e-6)


def test_result_metrics_match_the_reference():
    jres = repro.run(JPROB, JKEY, options=_jopts())
    tres = repro_torch.run(TPROB, TKEY, device="cpu", options=_topts())
    want = jresult_metrics(jres).to_dict()
    got = result_metrics(tres).to_dict()
    assert set(got) == set(want)
    for name in ("rounds_total", "comm_floats_total", "comm_bytes_total",
                 "pod_bytes_total", "tau_star", "tau_covered",
                 "max_stale"):
        assert got[name] == want[name], name
    assert got["round_time"]["counts"] == want["round_time"]["counts"]
    np.testing.assert_allclose(got["sim_s_total"]["value"],
                               want["sim_s_total"]["value"], rtol=1e-6)
    np.testing.assert_allclose(got["final_loss"]["value"],
                               want["final_loss"]["value"], rtol=1e-5)


# --------------------------------------------------------------------------
# the sharded engines on gloo: one rank each, then two ranks
# --------------------------------------------------------------------------

_RANK = textwrap.dedent(r"""
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import repro_torch as rt
    from repro_torch import prng
    from repro_torch.obs import Journal, tracing, validate_journal

    rank, ws, engine, shape, dims, out = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
        json.loads(sys.argv[4]), json.loads(sys.argv[5]), sys.argv[6])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(out + ".store", ws),
                            rank=rank, world_size=ws)
    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(dims))
    prob = rt.make_quadratic(prng.PRNGKey(0), num_workers=8, dim=48,
                             kappa=80.0, coupling=0.0, num_regions=6,
                             device="cpu")
    kw = dict(engine=engine, mesh=mesh, device="cpu", num_rounds=6,
              num_regions=6, policy=rt.PolicyConfig(keep_prob=0.5,
                                                    tau_star=1))
    off = rt.run(prob, prng.PRNGKey(1), **kw)
    mem = Journal()
    on = rt.run(prob, prng.PRNGKey(1), journal=mem, **kw)
    with tracing() as tr:
        path = rt.run(prob, prng.PRNGKey(1), journal=f"{out}.{rank}.jsonl",
                      **kw)
    same = {f: bool(torch.equal(getattr(off, f), getattr(r, f)))
            for r in (on, path)
            for f in ("xs", "dist_sq", "losses", "coverage", "comm_floats",
                      "round_time", "max_stale", "comm_bytes", "pod_bytes")}
    json.dump({"same": same, "records": mem.records,
               "problems": validate_journal(mem),
               "spans": [s.name for s in tr.spans]},
              open(f"{out}.{rank}.json", "w"))
    dist.destroy_process_group()
""")

# (label, engine, mesh shape, dimension names)
DIST = (("sharded-1", "sharded", (1,), ("data",)),
        ("sharded2d-1x1", "sharded2d", (1, 1), ("data", "model")),
        ("sharded-2", "sharded", (2,), ("data",)))


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_dist")
    (tmp / "rank.py").write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = []
    for label, engine, shape, dims in DIST:
        ws = int(np.prod(shape))
        for rank in range(ws):
            procs.append(subprocess.Popen(
                [sys.executable, str(tmp / "rank.py"), str(rank), str(ws),
                 engine, json.dumps(list(shape)), json.dumps(list(dims)),
                 str(tmp / label)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    return tmp


@pytest.mark.parametrize("label", [d[0] for d in DIST])
def test_bit_exact_sharded_engines_on_gloo(dist_runs, label):
    _, engine, shape, dims = next(d for d in DIST if d[0] == label)
    ws = int(np.prod(shape))
    outs = [json.loads((dist_runs / f"{label}.{r}.json").read_text())
            for r in range(ws)]
    for r, out in enumerate(outs):
        assert all(out["same"].values()), (r, out["same"])
        assert out["problems"] == [] and jvalidate(out["records"]) == []
        assert out["spans"] == ["execute"]
        head = out["records"][0]
        assert head["engine"] == engine
        assert head["mesh"] == {"shape": list(shape), "axes": list(dims)}
        assert head["contract_key"].startswith(engine + "|")
        assert not [x for x in out["records"] if x["kind"] == "drift"]
    # every rank fills its Journal with the same records; the path is
    # written by global rank 0 alone
    assert all(out["records"] == outs[0]["records"] for out in outs)
    path0 = dist_runs / f"{label}.0.jsonl"
    recs = read_journal(path0)
    assert validate_journal(recs) == [] and jvalidate(recs) == []
    assert [r for r in recs if r["kind"] != "span"] == outs[0]["records"]
    for r in range(1, ws):
        assert not (dist_runs / f"{label}.{r}.jsonl").exists()


# --------------------------------------------------------------------------
# the contract-drift alarm
# --------------------------------------------------------------------------

def test_drift_alarm_fires_on_injected_mismatch():
    budget = {"comm_per_round": 256.0, "pod_per_round": 128.0}
    rounds = [{"kind": "round", "t": 1, "comm_bytes": 256.0,
               "pod_bytes": 128.0},
              {"kind": "round", "t": 2, "comm_bytes": 300.0,
               "pod_bytes": 130.0}]
    out = check_byte_drift(rounds, budget)
    assert [(d["t"], d["metric"]) for d in out] == [
        (2, "comm_bytes"), (2, "pod_bytes")]
    for d in out:
        assert d["kind"] == "drift" and d["observed"] > d["budget"]
        assert "exceeds the contract byte budget" in d["message"]
    assert check_byte_drift(rounds[:1], budget) == []


def test_drift_alarm_in_journal_on_injected_budget(monkeypatch):
    from repro_torch.analysis import contracts
    res = repro_torch.run(TPROB, TKEY, device="cpu", options=_topts())
    monkeypatch.setattr(contracts, "round_byte_budget",
                        lambda opts, *, dim, num_workers: {
                            "comm_per_round": 1.0, "pod_per_round": 1.0})
    j = write_run_journal(Journal(), res, engine="scan", options=_topts(),
                          problem=TPROB)
    drift = [r for r in j.records if r["kind"] == "drift"]
    assert len(drift) == 6                       # every round over budget
    assert validate_journal(j) == [] and jvalidate(j.records) == []


def _port_options(jo):
    fields = {f.name: getattr(jo, f.name)
              for f in dataclasses.fields(jo) if f.name != "policy"}
    return repro_torch.RanlOptions(
        policy=TPolicy(**dataclasses.asdict(jo.policy)), **fields)


def test_drift_alarm_silent_across_the_reference_contract_matrix():
    """The full-mask wire bytes of every combination of the reference's
    contract matrix stay within the port's budget, which equals the
    reference's; the contract keys are the reference's."""
    from repro.analysis.audit import DIM, NUM_REGIONS, NUM_WORKERS, _configs
    from repro.analysis.contracts import contract_key as jcontract_key
    from repro.analysis.contracts import round_byte_budget as jbudget

    from repro_torch.analysis.contracts import contract_key, \
        round_byte_budget
    from repro_torch.core.compression import parse_compression, \
        uplink_bytes
    from repro_torch.core.ranl import _pod_wire_bytes

    sizes_q = torch.full((NUM_REGIONS,), DIM // NUM_REGIONS,
                         dtype=torch.int32)
    full = torch.ones((NUM_WORKERS, NUM_REGIONS), dtype=torch.bool)
    n_checked = 0
    for engine, jo, _ in _configs():
        opts = _port_options(jo)
        assert contract_key(engine, opts) == jcontract_key(engine, jo)
        budget = round_byte_budget(opts, dim=DIM, num_workers=NUM_WORKERS)
        assert budget == jbudget(jo, dim=DIM, num_workers=NUM_WORKERS)
        comp = opts.compression_spec()
        hspec = opts.hierarchy_spec()
        pod_comp = parse_compression(hspec.compression) if hspec else comp
        rec = {"kind": "round", "t": 1,
               "comm_bytes": float(uplink_bytes(comp, full, sizes_q).sum()),
               "pod_bytes": float(_pod_wire_bytes(pod_comp, DIM))}
        assert check_byte_drift([rec], budget) == [], (engine, opts)
        n_checked += 1
    with open(os.path.join(ROOT, "CONTRACTS.json")) as f:
        assert n_checked == len(json.load(f))


# --------------------------------------------------------------------------
# spans and the profiler
# --------------------------------------------------------------------------

def test_span_noop_without_tracer():
    assert current_tracer() is None
    with span("anything", device="cpu") as t:
        assert t is None


def test_tracer_spans_nesting_and_chrome(tmp_path):
    with tracing() as tr:
        with span("outer", engine="scan"):
            with span("inner", device="cpu"):
                pass
    assert current_tracer() is None
    names = [s.name for s in tr.spans]
    assert names == ["inner", "outer"]           # close order
    tot = tr.totals()
    assert tot["outer"] >= tot["inner"] >= 0.0
    recs = tr.span_records()
    assert all(r["kind"] == "span" and "device_s" not in r for r in recs)
    assert recs[1]["meta"] == {"engine": "scan"}
    p = tmp_path / "trace.json"
    tr.write_chrome(str(p))
    ct = json.loads(p.read_text())
    assert [e["name"] for e in ct["traceEvents"]] == names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ct["traceEvents"])
    assert ct["traceEvents"][1]["args"] == {"engine": "scan"}


def test_tracer_resolves_device_seconds_of_recorded_events():
    """A span's CUDA events (here stand-ins with the events' interface)
    become its ``device_s`` when the records are read, once."""
    class Ev:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, end):
            return end.ms - self.ms

    tr = Tracer()
    with tr.span("execute"):
        pass
    tr._events[0] = ("cpu", Ev(1.0), Ev(3.5))
    synced = []
    real = torch.cuda.synchronize
    torch.cuda.synchronize = synced.append
    try:
        recs = tr.span_records()
        again = tr.span_records()
    finally:
        torch.cuda.synchronize = real
    assert synced == ["cpu"]                     # one synchronise, once
    assert recs[0]["device_s"] == pytest.approx(2.5e-3)
    assert again == recs
    assert tr.chrome_trace()["traceEvents"][0]["args"]["device_s"] == \
        pytest.approx(2.5e-3)


def test_run_records_one_execute_span_into_the_journal():
    with tracing() as tr:
        j = Journal()
        repro_torch.run(TPROB, TKEY, device="cpu",
                        options=_topts(num_rounds=2), journal=j)
    spans = [r for r in j.records if r["kind"] == "span"]
    assert [s["name"] for s in spans] == ["execute"]
    assert spans[0]["meta"] == {"engine": "scan"}
    assert [s.name for s in tr.spans] == ["execute"]


def test_torch_profiler_on_the_cpu(tmp_path, monkeypatch):
    with torch_profiler(str(tmp_path), cuda=False) as prof:
        repro_torch.run(TPROB, TKEY, device="cpu",
                        options=_topts(num_rounds=2))
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    ops = device_ops(prof)
    assert len(ops) > 3
    assert all(set(r) == {"name", "device_ms", "calls"} for r in ops)
    assert all(r["device_ms"] == 0.0 for r in ops)   # nothing on a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with torch_profiler(str(tmp_path / "card")):
            pass


# --------------------------------------------------------------------------
# metrics registry
# --------------------------------------------------------------------------

def test_metrics_registry_semantics():
    reg = MetricsRegistry()
    c = reg.counter("n")
    c.inc()
    c.inc(2.5)
    assert reg.counter("n").value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("n")
    g = reg.gauge("g")
    g.set(7)
    g.set(2)
    assert g.value == 2.0
    h = reg.histogram("h", bounds=(1, 10))
    for v in (0.5, 5, 50):
        h.observe(v)
    assert h.counts == [1, 1, 1] and h.n == 3
    assert h.mean() == pytest.approx((0.5 + 5 + 50) / 3)
    d = reg.to_dict()
    assert d["n"] == {"type": "counter", "value": 3.5}
    assert d["h"]["type"] == "histogram"
    with pytest.raises(ValueError, match="sorted"):
        reg.histogram("bad", bounds=(2, 1))


# --------------------------------------------------------------------------
# the report CLI
# --------------------------------------------------------------------------

def _two_journals(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    repro_torch.run(TPROB, TKEY, device="cpu", options=_topts(),
                    journal=str(a))
    repro_torch.run(TPROB, TKEY, device="cpu",
                    options=_topts(compression="int8"), journal=str(b))
    return str(a), str(b)


def test_report_render_text_md_target(tmp_path):
    a, _ = _two_journals(tmp_path)
    records = read_journal(a)
    txt = render(records, target=1e30)
    assert "run journal summary" in txt
    assert "uplink bytes/round" in txt and "round 1" in txt
    assert "staleness histogram" in txt
    md = render_md(records)
    assert md.startswith("# Run journal summary")
    assert "\\|" in md                           # contract key escaped
    assert "not reached" in render(records, target=-1.0)
    # the reference's report renders the port's journal the same way
    assert txt == jreport.render(records, target=1e30)
    assert md == jreport.render_md(records)


def test_report_renders_device_seconds():
    head = make_header(engine="scan", options={})
    spans = [{"kind": "span", "name": "execute", "t0_s": 0.0,
              "dur_s": 0.5, "device_s": 0.25}]
    txt = render([head] + spans)
    assert "span device time [s]" in txt and "0.250000" in txt
    assert "## Span device time" in render_md([head] + spans)


def test_report_diff(tmp_path):
    a, b = _two_journals(tmp_path)
    d = diff(read_journal(a), read_journal(b))
    assert d["engine"] == {"a": "scan", "b": "scan"}
    assert 0 < d["comm_bytes_total"]["ratio"] < 1
    out = render_diff(read_journal(a), read_journal(b))
    assert "journal diff" in out and "comm_bytes_total" in out
    assert out == jreport.render_diff(read_journal(a), read_journal(b))


def test_report_cli_main(tmp_path, capsys):
    a, b = _two_journals(tmp_path)
    assert report_main([a]) == 0
    assert report_main([a, "--md", "--target", "1e30"]) == 0
    assert report_main([a, "--validate"]) == 0
    assert report_main(["--diff", a, b]) == 0
    assert report_main(["--diff", a, b, "--md"]) == 0
    out = capsys.readouterr().out
    assert "run journal summary" in out and "Journal diff" in out
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "round", "t": 1}\n')
    assert report_main([str(bad), "--validate"]) == 1
    assert "header" in capsys.readouterr().err
    assert report_main(["--diff", a, str(bad)]) == 1


def test_report_renders_reference_journals_as_the_reference_does(tmp_path):
    path = tmp_path / "ref.jsonl"
    repro.run(JPROB, JKEY, options=_jopts(compression="int8"),
              journal=str(path))
    records = read_journal(path)
    assert validate_journal(records) == []
    for target in (None, 1e30):
        assert render(records, target=target) == jreport.render(
            records, target=target)
        assert render_md(records, target=target) == jreport.render_md(
            records, target=target)


def test_committed_sample_journal_renders(capsys):
    path = os.path.join(ROOT, "examples", "sample_journal.jsonl")
    records = read_journal(path)
    assert validate_journal(records) == []
    assert not [r for r in records if r["kind"] == "drift"]
    txt = render(records, target=1e-4)
    assert "pod bytes/round" in txt
    assert txt == jreport.render(records, target=1e-4)
    assert report_main([path, "--md"]) == 0
    assert report_main(["--diff", path, path]) == 0
    assert "B/A 1" in capsys.readouterr().out


def test_report_cli_module_runs_in_a_subprocess():
    path = os.path.join(ROOT, "examples", "sample_journal.jsonl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                          path, "--validate"], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "valid (schema 1" in out.stdout


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["ranl", "adamw"])
def test_train_cli_journal_and_trace(optimizer, tmp_path, capsys):
    from repro_torch.launch.train import run
    torch.set_num_threads(1)
    jpath, tpath = str(tmp_path / "t.jsonl"), str(tmp_path / "t.trace")
    hist = run(["--device", "cpu", "--smoke", "--steps", "3", "--batch",
                "4", "--seq", "16", "--optimizer", optimizer,
                "--log-every", "100", "--journal", jpath, "--trace", tpath,
                "--checkpoint-dir", str(tmp_path / "ck")])
    assert len(hist) == 3                        # a journal records all
    lines = capsys.readouterr().out.splitlines()
    assert f"wrote journal to {jpath}" in lines
    assert f"wrote chrome trace to {tpath}" in lines
    records = read_journal(jpath)
    assert validate_journal(records) == [] and jvalidate(records) == []
    head = records[0]
    assert head["engine"] == f"train:{optimizer}"
    assert (head["arch"], head["steps"], head["batch"], head["seq"]) == (
        "phi4-mini-3.8b", 3, 4, 16)
    rounds = [r for r in records if r["kind"] == "round"]
    assert [r["t"] for r in rounds] == [1, 2, 3]
    assert all("loss" in r for r in rounds)
    if optimizer == "ranl":
        assert all("step_s" in r and "coverage" in r for r in rounds)
        assert head["options"]["num_workers"] == 4
    spans = [r for r in records if r["kind"] == "span"]
    # each step's execute span closes after the round's own spans
    step = ["forward", "backward", "execute"]
    if optimizer == "ranl":
        # the bf16 memory is read and written by the combine itself: no
        # codec span (tests/test_torch_round_spans.py has the int8 one's)
        step = (["forward", "backward", "ranl.worker_pass"] * 4
                + ["ranl.aggregate", "ranl.newton", "ranl.round",
                   "execute"])
    assert [s["name"] for s in spans] == step * 3 + ["checkpoint"]
    execute = [s for s in spans if s["name"] == "execute"]
    assert [s["meta"]["step"] for s in execute] == [0, 1, 2]
    assert records[-1] == {"kind": "summary", "rounds": 3,
                           "first_loss": hist[0]["loss"],
                           "final_loss": hist[-1]["loss"]}
    ct = json.loads(open(tpath).read())
    assert [e["name"] for e in ct["traceEvents"]] == [s["name"]
                                                      for s in spans]
    assert report_main([jpath]) == 0
