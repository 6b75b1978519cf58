"""The port's 1-D sharded engine on ``torch.distributed`` (gloo, CPU)
against the reference's sharded engine at the same device count.

One module fixture runs everything once:

* the reference: one subprocess with 4 emulated host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) runs every
  leg of ``LEGS`` on a ``jax.make_mesh`` of the leg's shape;
* the port: for each mesh shape, one process per rank
  (``init_process_group("gloo")`` on a ``FileStore``,
  ``init_device_mesh("cpu", shape, mesh_dim_names=...)``) runs every leg
  of that shape, sequential and ``overlap=True``, and the shape's extra
  cases (the seed-sharded batch, the mesh checks, the int8 clip).

Both sides build the same problem (N = 8, d = 48, κ = 80, 6 regions, the
reference's tests' configuration) and cost models from the arrays the
fixture writes.  Tolerances, x max|x| of the reference's xs: 2e-5 for
uncompressed rounds (the port's lower Cholesky factor, ROADMAP Queue 3
(b)) and top-k, 5e-2 for int8 and 1e-2 for bf16 (one quantization step:
the quantizers' inputs differ in the last bit), 5e-5 with quorum's late
folds.  Masks, coverage, ``comm_floats``, ``comm_bytes``, ``max_stale``,
``pod_bytes``, ``round_time`` and τ are exact.  A compressed sharded run
compresses each rank's partial sum, so it is held to the reference's
sharded run, never to a scan run.
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

from repro.core import make_quadratic  # noqa: E402
from repro.hetero import cost as jcost  # noqa: E402
from repro.hetero import scenarios as jscen  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import RanlOptions, prng  # noqa: E402
from repro_torch.analysis import check_log, engine_contract  # noqa: E402
from repro_torch.analysis.contracts import PARAM_SLACK  # noqa: E402
from repro_torch.core.collectives import Collective  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N, T, Q = 48, 8, 12, 6
POL = dict(keep_prob=0.5, tau_star=1, heterogeneous=False)
HIER = "pods=2,period=3"
# (name, mesh shape, mesh dims, options, cost model, xs tolerance)
_FLAT = (("dense", {}, None, 2e-5), ("diag", {"curvature": "diag"}, None,
                                     2e-5),
         ("int8", {"compression": "int8"}, None, 5e-2),
         ("bf16", {"compression": "bf16"}, None, 1e-2),
         ("topk", {"compression": "topk:2"}, None, 2e-5),
         ("quorum", {"quorum": 0.75}, "pareto", 5e-5))
LEGS = ([("dense-1", (1,), ("data",), {}, None, 2e-5),
         ("diag-1", (1,), ("data",), {"curvature": "diag"}, None, 2e-5)]
        + [(f"{name}-{n}", (n,), ("data",), kw, cost, tol)
           for n in (2, 4) for name, kw, cost, tol in _FLAT]
        + [("quorum50-4", (4,), ("data",), {"quorum": 0.5}, "pareto", 5e-5),
           ("credit-2", (2,), ("data",), {"overlap": True}, "credit", 2e-5),
           ("resource-2", (2,), ("data",), {"controller": "resource"},
            "pareto", 2e-5),
           ("record3-2", (2,), ("data",), {"record_every": 3}, None, 2e-5),
           ("hier-2x2", (2, 2), ("pod", "data"), {"hierarchy": HIER}, None,
            2e-5),
           ("hier-int8-2x2", (2, 2), ("pod", "data"),
            {"hierarchy": HIER + ",compression=int8"}, None, 2e-5)])
SHAPES = {(1,): ("data",), (2,): ("data",), (4,): ("data",),
          (2, 2): ("pod", "data")}
INT_TRACES = ("coverage", "comm_floats", "comm_bytes", "max_stale",
              "pod_bytes", "round_time")
BATCH_XS_RTOL = 1e-4


def _cost_arrays(c):
    statics = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
               if f.name not in ("compute_rate", "bandwidth", "pod_bw")}
    return ({"compute_rate": np.asarray(c.compute_rate),
             "bandwidth": np.asarray(c.bandwidth)}, statics)


_REFERENCE = textwrap.dedent(r"""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    import repro
    from repro.core import make_quadratic
    from repro.core.masks import PolicyConfig
    from repro.hetero import cost as jcost
    from repro.hetero import scenarios as jscen
    assert jax.device_count() == 4, jax.devices()
    cfg = json.load(open(sys.argv[1]))
    KEY = jax.random.PRNGKey(0)
    prob = make_quadratic(KEY, **cfg["problem"])
    costs = {"pareto": jscen.make_scenario("pareto-stragglers",
                                           jax.random.PRNGKey(7), 8).cost,
             "credit": jcost.with_overlap_credit(jcost.pareto_cost(
                 jax.random.PRNGKey(7), 8, bandwidth=cfg["bandwidth"]),
                 0.5)}
    out = {}
    for name, shape, dims, kw, cost in cfg["legs"]:
        mesh = jax.make_mesh(tuple(shape), tuple(dims))
        kw = dict(kw)
        ctrl = kw.pop("controller", None)
        r = repro.run(prob, KEY, engine="sharded", mesh=mesh,
                      controller=ctrl,
                      cost=None if cost is None else costs[cost],
                      num_rounds=cfg["rounds"], num_regions=cfg["regions"],
                      policy=PolicyConfig(**cfg["policy"]), **kw)
        for f in ("xs", "coverage", "comm_floats", "comm_bytes",
                  "max_stale", "pod_bytes", "round_time"):
            out[f"{name}/{f}"] = np.asarray(getattr(r, f))
        if r.xs_pods is not None:
            out[f"{name}/xs_pods"] = np.asarray(r.xs_pods)
        out[f"{name}/tau"] = np.asarray([r.tau_star, r.tau_covered])
    np.savez(sys.argv[2], **out)
""")


_RANKS = textwrap.dedent(r"""
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import repro_torch as rt
    from repro_torch import interop, prng
    from repro_torch.core.collectives import Collectives
    from repro_torch.core.compression import CompressionSpec, \
        psum_compressed
    from repro_torch.core.regions import contiguous_regions

    rank, shape, cfg_path, out_path = (int(sys.argv[1]),
                                       json.loads(sys.argv[2]),
                                       sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    cfg = json.load(open(cfg_path))
    ws = int(np.prod(shape))
    dist.init_process_group("gloo", store=dist.FileStore(
        out_path + ".store", ws), rank=rank, world_size=ws)
    dims = tuple(cfg["shapes"][str(shape)])
    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=dims)
    arr = np.load(cfg["arrays"])
    prob = interop.problem_from_arrays(
        "quadratic", {k: arr[k] for k in ("A", "b", "x_star")},
        cfg["scalars"], device="cpu")
    costs = {name: interop.cost_from_arrays(
        {k: arr[f"{name}_{k}"] for k in ("compute_rate", "bandwidth")},
        cfg["statics"][name], device="cpu") for name in ("pareto", "credit")}
    KEY = prng.PRNGKey(0)
    pol = rt.PolicyConfig(**cfg["policy"])
    out = {}

    def keep(r):
        d = {f: getattr(r, f) for f in ("xs", "coverage", "comm_floats",
                                        "comm_bytes", "max_stale",
                                        "pod_bytes", "round_time",
                                        "xs_pods")}
        d["tau"] = (r.tau_star, r.tau_covered)
        d["log"] = [tuple(c.__dict__.values()) for c in r.collectives]
        return d

    for name, leg_shape, _, kw, cost in cfg["legs"]:
        if leg_shape != shape:
            continue
        kw = dict(kw)
        ctrl = kw.pop("controller", None)
        opts = rt.RanlOptions(num_rounds=cfg["rounds"],
                              num_regions=cfg["regions"], policy=pol, **kw)
        c = None if cost is None else costs[cost]
        run = lambda o: rt.run(prob, KEY, engine="sharded", mesh=mesh,
                               device="cpu", options=o, cost=c,
                               controller=ctrl)
        out[name + "/seq"] = keep(run(opts.merged(overlap=False)))
        out[name + "/overlap"] = keep(run(opts.merged(overlap=True)))

    def error(fn):
        try:
            fn()
        except Exception as e:              # the type is what is checked
            return type(e).__name__
        return None

    if shape == [2]:
        keys = prng.split(prng.PRNGKey(1), 4)
        kw = dict(device="cpu", num_rounds=cfg["rounds"],
                  num_regions=cfg["regions"], policy=pol)
        out["batch/mesh"] = keep(rt.run(prob, keys, engine="batch",
                                        mesh=mesh, **kw))
        out["batch/plain"] = keep(rt.run(prob, keys, engine="batch", **kw))
        model = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
        pods21 = init_device_mesh("cpu", (2, 1),
                                  mesh_dim_names=("pod", "data"))
        three = rt.make_quadratic(prng.PRNGKey(0), num_workers=3, dim=8,
                                  num_regions=2, device="cpu")
        meta = rt.Quadratic(A=torch.empty((8, 4, 4), device="meta"),
                            b=torch.empty((8, 4), device="meta"),
                            x_star=torch.empty(4, device="meta"),
                            grad_noise=0.0, hess_noise=0.0, mu=1.0, L_g=2.0)
        sh = dict(engine="sharded", num_rounds=2, num_regions=2)
        out["checks"] = {
            "missing_axis": error(lambda: rt.run(
                prob, KEY, mesh=model, device="cpu", **sh)),
            "batch_missing_axis": error(lambda: rt.run(
                prob, keys, engine="batch", mesh=model, device="cpu",
                num_rounds=2, num_regions=2)),
            "workers_not_dividing": error(lambda: rt.run(
                three, KEY, mesh=mesh, device="cpu", **sh)),
            "seeds_not_dividing": error(lambda: rt.run(
                prob, keys[:3], engine="batch", mesh=mesh, device="cpu",
                num_rounds=2, num_regions=2)),
            "pod_extent": error(lambda: rt.run(
                prob, KEY, mesh=pods21, device="cpu",
                hierarchy="pods=4,period=1", **sh)),
            "no_pod_axis": error(lambda: rt.run(
                prob, KEY, mesh=mesh, device="cpu",
                hierarchy="pods=2,period=1", **sh)),
            "mesh_on_another_device": error(lambda: rt.run(
                meta, KEY, mesh=mesh, device="meta", **sh)),
            "sharded_without_rounds": rt.run(
                prob, KEY, mesh=mesh, device="cpu",
                **{**sh, "num_rounds": 0}).xs}
    if shape == [2, 2]:
        six = rt.make_quadratic(prng.PRNGKey(0), num_workers=6, dim=8,
                                num_regions=2, device="cpu")
        out["checks"] = {"pod_workers_not_dividing": error(lambda: rt.run(
            six, KEY, engine="sharded", mesh=mesh, device="cpu",
            hierarchy="pods=2,period=1", num_rounds=2, num_regions=2))}
    if shape == [4]:
        # every rank at the largest level: 4 x 127 would wrap an int8 sum
        coll = Collectives(mesh)
        y = torch.linspace(-1.0, 1.0, 48) * (1.0 if rank % 2 else -1.0)
        y[7] = 1.0                      # one coordinate at +max everywhere
        pending, err = psum_compressed(
            CompressionSpec("int8"), y, torch.zeros(48), coll=coll,
            dim="data", n_agg=4, region_ids=contiguous_regions(48, 6, "cpu"),
            num_regions=6)
        out["int8_clip"] = {"sum": pending.wait(), "y": y, "err": err,
                            "log": [tuple(c.__dict__.values())
                                    for c in coll.log]}
    torch.save(out, f"{out_path}.{rank}")
    dist.destroy_process_group()
""")


def _run_all(tmp):
    """Write the problem and cost arrays, then run the reference
    subprocess and every rank process of the port at once."""
    prob = make_quadratic(jax.random.PRNGKey(0), num_workers=N, dim=D,
                          kappa=80.0, coupling=0.0, num_regions=Q,
                          grad_noise=0.1, hess_noise=0.1)
    costs = {"pareto": jscen.make_scenario("pareto-stragglers",
                                           jax.random.PRNGKey(7), N).cost,
             "credit": jcost.with_overlap_credit(jcost.pareto_cost(
                 jax.random.PRNGKey(7), N, bandwidth=200.0), 0.5)}
    arrays = {k: np.asarray(getattr(prob, k)) for k in ("A", "b", "x_star")}
    statics = {}
    for name, c in costs.items():
        arrs, statics[name] = _cost_arrays(c)
        arrays.update({f"{name}_{k}": v for k, v in arrs.items()})
    np.savez(tmp / "arrays.npz", **arrays)
    cfg = dict(problem=dict(num_workers=N, dim=D, kappa=80.0, coupling=0.0,
                            num_regions=Q, grad_noise=0.1, hess_noise=0.1),
               scalars=dict(grad_noise=prob.grad_noise,
                            hess_noise=prob.hess_noise, mu=prob.mu,
                            L_g=prob.L_g),
               statics=statics, bandwidth=200.0, rounds=T, regions=Q,
               policy=POL, legs=[list(leg[:5]) for leg in LEGS],
               shapes={str(list(s)): list(d) for s, d in SHAPES.items()},
               arrays=str(tmp / "arrays.npz"))
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    (tmp / "reference.py").write_text(_REFERENCE)
    (tmp / "ranks.py").write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "reference.py"), str(tmp / "cfg.json"),
         str(tmp / "reference.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
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
    ref = dict(np.load(tmp / "reference.npz"))
    port = {}
    for shape in SHAPES:
        tag = "x".join(map(str, shape))
        port[shape] = [torch.load(tmp / f"port-{tag}.{r}",
                                  weights_only=False)
                       for r in range(int(np.prod(shape)))]
    return ref, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run_all(tmp_path_factory.mktemp("sharded"))


def _leg(name):
    return next(leg for leg in LEGS if leg[0] == name)


def _log(entries):
    return [Collective(*e) for e in entries]


LEG_NAMES = [leg[0] for leg in LEGS]


@pytest.mark.parametrize("name", LEG_NAMES)
def test_sharded_matches_the_reference_sharded_engine(runs, name):
    ref, port = runs
    _, shape, _, kw, _, tol = _leg(name)
    got = port[shape][0][name + ("/overlap" if "overlap" in kw else "/seq")]
    for f in INT_TRACES:
        np.testing.assert_array_equal(got[f].numpy(), ref[f"{name}/{f}"],
                                      err_msg=f)
    assert list(got["tau"]) == list(ref[f"{name}/tau"])
    want = ref[f"{name}/xs"]
    scale = np.abs(want).max()
    assert np.abs(got["xs"].numpy() - want).max() <= tol * scale
    if f"{name}/xs_pods" in ref:
        np.testing.assert_allclose(got["xs_pods"].numpy(),
                                   ref[f"{name}/xs_pods"], rtol=0,
                                   atol=tol * scale)


@pytest.mark.parametrize("name", LEG_NAMES)
def test_overlap_is_bit_equal_to_the_sequential_loop(runs, name):
    """The pipelined loop moves work, never a value (the credit leg's
    clock aside: its overlap credit is the point of it)."""
    _, port = runs
    shape = _leg(name)[1]
    seq, ov = (port[shape][0][name + s] for s in ("/seq", "/overlap"))
    fields = ("xs", "coverage", "comm_floats", "comm_bytes", "max_stale",
              "pod_bytes") + (() if name.startswith("credit") else
                              ("round_time",))
    for f in fields:
        assert torch.equal(seq[f], ov[f]), f
    assert seq["tau"] == ov["tau"]


def test_overlap_credit_shortens_the_pipelined_clock(runs):
    """``worker_times(..., overlap=True)`` prices the pipelined rounds:
    with a credit on a finite-bandwidth cluster every round is faster
    than the sequential loop's (and equals the reference's, above)."""
    _, port = runs
    seq, ov = (port[(2,)][0]["credit-2" + s] for s in ("/seq", "/overlap"))
    assert bool((ov["round_time"] < seq["round_time"]).all())


@pytest.mark.parametrize("variant", ["/seq", "/overlap"])
@pytest.mark.parametrize("name", LEG_NAMES)
def test_every_rank_returns_the_same_result(runs, name, variant):
    _, port = runs
    shape = _leg(name)[1]
    first = port[shape][0][name + variant]
    for other in port[shape][1:]:
        for f, v in first.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, other[name + variant][f]), f
        assert first["tau"] == other[name + variant]["tau"]


@pytest.mark.parametrize("variant", ["/seq", "/overlap"])
@pytest.mark.parametrize("name", LEG_NAMES)
def test_collective_log_meets_the_contract(runs, name, variant):
    """One param-sized data all-reduce a round (int8 runs: int8, d
    bytes), one pod exchange a window under hierarchy, every other
    in-loop collective within PARAM_SLACK, on every rank."""
    _, port = runs
    _, shape, dims, kw, _, _ = _leg(name)
    opts = RanlOptions(num_rounds=T, num_regions=Q, **{
        k: v for k, v in kw.items() if k != "controller"})
    contract = engine_contract("sharded", opts, dim=D)
    for out in port[shape]:
        log = _log(out[name + variant]["log"])
        rep = check_log(contract, log)
        assert rep["ok"], rep["violations"]
        big = [c for c in log if c.round is not None and c.dim == "data"
               and c.op == "sum" and c.dtype != "int32"]
        assert len(big) == T
        want = ("int8", D) if kw.get("compression") == "int8" else \
            ("float32", 4 * D)
        assert {(c.dtype, c.nbytes) for c in big} == {want}
        if "hierarchy" in kw:
            pod = [c for c in log if c.dim == "pod"
                   and c.op == "sum" and c.nbytes >= D]
            assert [c.round for c in pod] == list(range(3, T + 1, 3))
            assert [c.dtype for c in pod] == (
                ["int8"] * 4 if "int8" in kw["hierarchy"] else
                ["float32"] * 4)


@pytest.mark.parametrize("edit", ["drop_param", "drop_exchange",
                                  "extra_param", "big_small"])
def test_contract_fails_a_broken_log(runs, edit):
    """The (2, 2) log with one param-sized all-reduce removed, one pod
    exchange removed, one param all-reduce added, or a small collective
    grown past PARAM_SLACK, fails the checker."""
    _, port = runs
    log = _log(port[(2, 2)][0]["hier-2x2/seq"]["log"])
    contract = engine_contract(
        "sharded", RanlOptions(num_rounds=T, num_regions=Q, hierarchy=HIER),
        dim=D)
    assert check_log(contract, log)["ok"]
    params = [i for i, c in enumerate(log) if c.dim == "data"
              and c.dtype == "float32" and c.round is not None]
    pods = [i for i, c in enumerate(log) if c.dim == "pod"
            and c.round is not None]
    small = [i for i, c in enumerate(log) if c.dtype == "int32"]
    if edit == "drop_param":
        log = log[:params[4]] + log[params[4] + 1:]
    elif edit == "drop_exchange":
        log = log[:pods[1]] + log[pods[1] + 1:]
    elif edit == "extra_param":
        log = log + [log[params[0]]]
    else:
        log[small[2]] = dataclasses.replace(log[small[2]],
                                            nbytes=PARAM_SLACK + 4)
    assert not check_log(contract, log)["ok"]


@pytest.mark.parametrize("engine", ["scan", "batch", "reference"])
def test_one_card_engines_run_no_collective(engine):
    p = repro_torch.make_quadratic(prng.PRNGKey(0), num_workers=4, dim=8,
                                   num_regions=2, device="cpu")
    key = prng.split(prng.PRNGKey(1), 2) if engine == "batch" \
        else prng.PRNGKey(1)
    opts = RanlOptions(num_rounds=3, num_regions=2)
    res = repro_torch.run(p, key, engine=engine, device="cpu", options=opts)
    contract = engine_contract(engine, opts, dim=8)
    assert res.collectives == () and check_log(contract, ())["ok"]
    one = Collective("data", "sum", "int32", 8, None)
    assert not check_log(contract, [one])["ok"]


def test_seed_sharded_batch_equals_the_unsharded_batch(runs):
    """B = 4 seeds over ("data",) = 2: each rank runs 2, one all-gather
    of the rows after the loop; integer traces exact, xs within
    BATCH_XS_RTOL (the oracle product over 2 seeds' columns rounds apart
    from 4)."""
    _, port = runs
    opts = RanlOptions(num_rounds=T, num_regions=Q)
    for out in port[(2,)]:
        got, want = out["batch/mesh"], out["batch/plain"]
        for f in INT_TRACES:
            assert torch.equal(got[f], want[f]), f
        assert torch.equal(got["tau"][0], want["tau"][0])
        scale = want["xs"].abs().max()
        assert (got["xs"] - want["xs"]).abs().max() <= BATCH_XS_RTOL * scale
        log = _log(got["log"])
        assert [(c.op, c.round) for c in log] == [("all_gather", None)]
        assert check_log(engine_contract("batch", opts, dim=D, mesh="m"),
                         log)["ok"]


CHECKS = ["missing_axis", "batch_missing_axis", "workers_not_dividing",
          "seeds_not_dividing", "pod_extent", "no_pod_axis",
          "pod_workers_not_dividing", "mesh_on_another_device"]


@pytest.mark.parametrize("case", CHECKS)
def test_mesh_checks_raise_the_references_errors(runs, case):
    _, port = runs
    shape = (2, 2) if case == "pod_workers_not_dividing" else (2,)
    for out in port[shape]:
        assert out["checks"][case] == "ValueError"


def test_sharded_without_rounds_validates_the_mesh_and_runs_scan(runs):
    _, port = runs
    assert tuple(port[(2,)][0]["checks"]["sharded_without_rounds"].shape) \
        == (2, D)


def test_int8_clip_keeps_the_int8_sum_in_range(runs):
    """At 4 ranks each rank's levels are clipped to ±31, so a coordinate
    at the shared scale on every rank sums to 124 levels, not the 4 × 127
    that would wrap an int8 sum; the decoded sum equals the sum of what
    the ranks sent (y − err), and the wire tensor is int8, d bytes."""
    _, port = runs
    outs = [o["int8_clip"] for o in port[(4,)]]
    sent = sum(o["y"] - o["err"] for o in outs)
    for o in outs:
        torch.testing.assert_close(o["sum"], sent, rtol=0, atol=1e-6)
        assert abs(o["sum"][7].item() - 4.0) < 1e-6
        dtypes = [(c[1], c[2], c[3]) for c in o["log"]]
        assert dtypes == [("max", "float32", 4), ("sum", "int8", D)]
