"""The port's 2-D engine (``engine="sharded2d"``) on ``torch.distributed``
(gloo, CPU) against the reference's ``sharded2d`` at the same mesh, and
its panel linear algebra and row oracles against the reference's.

One module fixture runs everything once:

* the reference: ``REF_PARTS`` subprocesses with 4 emulated host
  devices each (``XLA_FLAGS=--xla_force_host_platform_device_count=4``)
  run the legs of ``LEGS`` on ``make_engine_mesh`` of the leg's shape,
  and ``project_psd_sharded`` over 1, 2 and 4 model shards, a share
  each (compiling the reference's programs is most of the time);
* the port: for each mesh shape, one process per rank
  (``init_process_group("gloo")`` on a ``FileStore``,
  ``init_device_mesh("cpu", shape, mesh_dim_names=...)``) runs every leg
  of that shape, sequential and ``overlap=True``, and the shape's extra
  cases (the panel projection, the mesh checks, the memory leg).

Both sides build the same problem (N = 8, d = 48, κ = 80, 6 regions, the
reference's tests' configuration).  Tolerances, x max|x| of the
reference's xs at the same mesh: 2e-5 uncompressed and top-k (the port
factors the lower triangle and sums its all-reduces in another order),
5e-2 int8 and 1e-2 bf16 (one quantization step: the quantizers' inputs
differ in the last bit), 5e-5 with quorum's late folds.  Masks,
coverage, ``comm_floats``, ``comm_bytes``, ``max_stale``, ``pod_bytes``,
``round_time`` and τ are exact.  The (1, 4) diag leg is the K2 path (one
data rank holds every worker): K2's plain twin here, on each rank's
12-coordinate slice.
"""

import functools
import importlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.core import convex as jconvex  # noqa: E402
from repro.core import hessian as jhessian  # noqa: E402
from repro.core import make_quadratic  # noqa: E402
from repro.hetero import scenarios as jscen  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

# the module (the package exports a function of the same name)
jra = importlib.import_module("repro.kernels.region_aggregate")

from repro_torch import RanlOptions, interop, prng  # noqa: E402
from repro_torch.analysis import check_log, engine_contract, \
    memory_ceiling  # noqa: E402
from repro_torch.core import convex as tconvex  # noqa: E402
from repro_torch.core import hessian as thessian  # noqa: E402
from repro_torch.core.collectives import Collective  # noqa: E402
from repro_torch.kernels.region_aggregate import local_region_ids  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N, T, Q = 48, 8, 12, 6
POL = dict(keep_prob=0.5, tau_star=1, heterogeneous=False)
HIER = "pods=2,period=3"
DM = ("data", "model")
PDM = ("pod", "data", "model")
# (name, mesh shape, mesh dims, options, cost model, xs tolerance)
LEGS = ([(f"{curv}-{a}x{b}", (a, b), DM, {"curvature": curv}, None, 2e-5)
         for a, b in ((1, 1), (2, 2), (1, 4)) for curv in ("dense", "diag")]
        + [("int8-2x2", (2, 2), DM, {"compression": "int8"}, None, 5e-2),
           ("bf16-2x2", (2, 2), DM, {"compression": "bf16"}, None, 1e-2),
           ("topk-2x2", (2, 2), DM, {"compression": "topk:2"}, None, 2e-5),
           ("quorum-2x2", (2, 2), DM, {"quorum": 0.75}, "pareto", 5e-5),
           ("hier-2x1x2", (2, 1, 2), PDM, {"hierarchy": HIER}, None, 2e-5),
           ("hier-int8-2x1x2", (2, 1, 2), PDM,
            {"hierarchy": HIER + ",compression=int8"}, None, 2e-5)])
SHAPES = {(1, 1): DM, (2, 2): DM, (1, 4): DM, (2, 1, 2): PDM}
INT_TRACES = ("coverage", "comm_floats", "comm_bytes", "max_stale",
              "pod_bytes", "round_time")
NS_MODELS = {(1, 1): 1, (2, 2): 2, (1, 4): 4}   # project_psd_sharded legs
REF_PARTS = 3      # reference subprocesses, each compiling a third of LEGS
# the memory leg: d = 512 on (2, 2), ns_iters = 12 (the reference's HLO
# memory test's size)
MEM = dict(dim=512, num_workers=4, rounds=7, regions=8, ns_iters=12)


_REFERENCE = textwrap.dedent(r"""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    import repro
    from repro.core import make_quadratic
    from repro.core.hessian import project_psd_sharded
    from repro.core.masks import PolicyConfig
    from repro.hetero import scenarios as jscen
    from repro.launch.mesh import make_engine_mesh
    assert jax.device_count() == 4, jax.devices()
    cfg = json.load(open(sys.argv[1]))
    part, parts = int(sys.argv[3]), int(sys.argv[4])
    KEY = jax.random.PRNGKey(0)
    prob = make_quadratic(KEY, **cfg["problem"])
    costs = {"pareto": jscen.make_scenario("pareto-stragglers",
                                           jax.random.PRNGKey(7), 8).cost}
    out = {}
    for name, shape, dims, kw, cost in cfg["legs"][part::parts]:
        if len(shape) == 3:
            mesh = make_engine_mesh(shape[1], shape[2], pods=shape[0])
        else:
            mesh = make_engine_mesh(*shape)
        r = repro.run(prob, KEY, engine="sharded2d", mesh=mesh,
                      cost=None if cost is None else costs[cost],
                      num_rounds=cfg["rounds"], num_regions=cfg["regions"],
                      policy=PolicyConfig(**cfg["policy"]), **kw)
        for f in ("xs", "coverage", "comm_floats", "comm_bytes",
                  "max_stale", "pod_bytes", "round_time"):
            out[f"{name}/{f}"] = np.asarray(getattr(r, f))
        if r.xs_pods is not None:
            out[f"{name}/xs_pods"] = np.asarray(r.xs_pods)
        out[f"{name}/tau"] = np.asarray([r.tau_star, r.tau_covered])
    a = np.load(cfg["arrays"])["ns_a"]
    for n in (1, 2, 4)[part::parts]:
        out[f"ns/{n}"] = np.asarray(project_psd_sharded(
            jnp.asarray(a), 0.6, mesh=make_engine_mesh(1, n), num_iters=30))
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
    from repro_torch.analysis import LargestTensors
    from repro_torch.core.hessian import project_psd_sharded

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
    costs = {"pareto": interop.cost_from_arrays(
        {k: arr[f"pareto_{k}"] for k in ("compute_rate", "bandwidth")},
        cfg["statics"], device="cpu")}
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
        opts = rt.RanlOptions(num_rounds=cfg["rounds"],
                              num_regions=cfg["regions"], policy=pol, **kw)
        c = None if cost is None else costs[cost]
        run = lambda o: rt.run(prob, KEY, engine="sharded2d", mesh=mesh,
                               device="cpu", options=o, cost=c)
        out[name + "/seq"] = keep(run(opts.merged(overlap=False)))
        out[name + "/overlap"] = keep(run(opts.merged(overlap=True)))

    def error(fn):
        try:
            fn()
        except Exception as e:              # the type is what is checked
            return type(e).__name__
        return None

    def message(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)

    if str(shape) in cfg["ns_models"]:
        out["ns"] = project_psd_sharded(
            torch.tensor(arr["ns_a"]), 0.6, mesh=mesh, axis_name="model",
            num_iters=30)
    if shape == [2, 2]:
        m = cfg["mem"]
        big = rt.make_quadratic(prng.PRNGKey(0), num_workers=m["num_workers"],
                                dim=m["dim"], kappa=10.0, coupling=0.0,
                                num_regions=m["regions"], device="cpu")
        opts = rt.RanlOptions(num_rounds=m["rounds"],
                              num_regions=m["regions"], policy=pol,
                              ns_iters=m["ns_iters"])
        for ov in (False, True):
            with LargestTensors() as rec:
                r = rt.run(big, KEY, engine="sharded2d", mesh=mesh,
                           device="cpu", options=opts.merged(overlap=ov))
            out[f"mem/{ov}"] = {"max_bytes": rec.max_bytes,
                                "max_op": rec.max_op, "run": keep(r)}
        data = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        model = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        three = rt.make_quadratic(prng.PRNGKey(0), num_workers=3, dim=8,
                                  num_regions=2, device="cpu")
        odd = rt.make_quadratic(prng.PRNGKey(0), num_workers=4, dim=15,
                                num_regions=3, device="cpu")
        sh = dict(engine="sharded2d", num_rounds=2, num_regions=2,
                  device="cpu")
        out["checks"] = {
            "no_model_axis": error(lambda: rt.run(prob, KEY, mesh=data,
                                                  **sh)),
            "no_data_axis": error(lambda: rt.run(prob, KEY, mesh=model,
                                                 **sh)),
            "workers_not_dividing": error(lambda: rt.run(
                three, KEY, mesh=mesh, **sh)),
            "dim_not_dividing": error(lambda: rt.run(
                odd, KEY, mesh=mesh, **{**sh, "num_regions": 3})),
            "hessian_rank": error(lambda: rt.run(
                prob, KEY, mesh=mesh, hessian_rank=2, **sh)),
            "dense_eigh": error(lambda: rt.run(
                prob, KEY, mesh=mesh, projection="eigh", **sh)),
            "no_pod_axis": error(lambda: rt.run(
                prob, KEY, mesh=mesh, hierarchy="pods=2,period=1", **sh)),
            "projection_dim_not_dividing": error(
                lambda: project_psd_sharded(torch.zeros((5, 5)), 0.1,
                                            mesh=mesh)),
            "messages": [message(lambda m=m: rt.run(prob, KEY, mesh=m, **sh))
                         for m in (data, model)]}
        none = dict(num_rounds=0, num_regions=cfg["regions"], policy=pol)
        out["without_rounds"] = {
            "sharded2d": rt.run(prob, KEY, engine="sharded2d", mesh=mesh,
                                device="cpu", **none).xs,
            "scan_ns": rt.run(prob, KEY, device="cpu", projection="ns",
                              **none).xs}
    torch.save(out, f"{out_path}.{rank}")
    dist.destroy_process_group()
""")

def _run_all(tmp):
    """Write the arrays, then run the reference subprocess and every rank
    process of the port at once."""
    prob = make_quadratic(jax.random.PRNGKey(0), num_workers=N, dim=D,
                          kappa=80.0, coupling=0.0, num_regions=Q,
                          grad_noise=0.1, hess_noise=0.1)
    pareto = jscen.make_scenario("pareto-stragglers", jax.random.PRNGKey(7),
                                 N).cost
    arrays = {k: np.asarray(getattr(prob, k)) for k in ("A", "b", "x_star")}
    arrays["pareto_compute_rate"] = np.asarray(pareto.compute_rate)
    arrays["pareto_bandwidth"] = np.asarray(pareto.bandwidth)
    g = np.random.default_rng(5).standard_normal((16, 16)).astype(np.float32)
    arrays["ns_a"] = (g + g.T) / 2
    np.savez(tmp / "arrays.npz", **arrays)
    statics = {k: getattr(pareto, k) for k in (
        "overhead", "dropout_prob", "churn_period", "churn_cohorts",
        "diurnal_period", "diurnal_amplitude", "pod_latency",
        "overlap_credit")}
    cfg = dict(problem=dict(num_workers=N, dim=D, kappa=80.0, coupling=0.0,
                            num_regions=Q, grad_noise=0.1, hess_noise=0.1),
               scalars=dict(grad_noise=prob.grad_noise,
                            hess_noise=prob.hess_noise, mu=prob.mu,
                            L_g=prob.L_g),
               statics=statics, rounds=T, regions=Q, policy=POL,
               legs=[list(leg[:5]) for leg in LEGS],
               shapes={str(list(s)): list(d) for s, d in SHAPES.items()},
               ns_models=[str(list(s)) for s in NS_MODELS], mem=MEM,
               arrays=str(tmp / "arrays.npz"))
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    (tmp / "reference.py").write_text(_REFERENCE)
    (tmp / "ranks.py").write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "reference.py"), str(tmp / "cfg.json"),
         str(tmp / f"reference{i}.npz"), str(i), str(REF_PARTS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(REF_PARTS)]
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
    ref = {}
    for i in range(REF_PARTS):
        ref.update(np.load(tmp / f"reference{i}.npz"))
    port = {}
    for shape in SHAPES:
        tag = "x".join(map(str, shape))
        port[shape] = [torch.load(tmp / f"port-{tag}.{r}",
                                  weights_only=False)
                       for r in range(int(np.prod(shape)))]
    return ref, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run_all(tmp_path_factory.mktemp("sharded2d"))


def _leg(name):
    return next(leg for leg in LEGS if leg[0] == name)


def _log(entries):
    return [Collective(*e) for e in entries]


def _extents(shape, dims):
    return dict(zip(dims, shape))


LEG_NAMES = [leg[0] for leg in LEGS]


@pytest.mark.parametrize("name", LEG_NAMES)
def test_sharded2d_matches_the_reference_sharded2d_engine(runs, name):
    ref, port = runs
    _, shape, _, _, _, tol = _leg(name)
    got = port[shape][0][name + "/seq"]
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
    _, port = runs
    shape = _leg(name)[1]
    seq, ov = (port[shape][0][name + s] for s in ("/seq", "/overlap"))
    for f in ("xs",) + INT_TRACES:
        assert torch.equal(seq[f], ov[f]), f
    assert seq["tau"] == ov["tau"]


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
    """One data all-reduce of the shard's d/n_model floats a round (int8:
    d/n_model bytes; none on the K2 path), model-dimension collectives of
    at most d floats, one pod exchange of d floats a window, the dense
    init's collectives within two panels; on every rank."""
    _, port = runs
    _, shape, dims, kw, _, _ = _leg(name)
    ext = _extents(shape, dims)
    opts = RanlOptions(num_rounds=T, num_regions=Q, **kw)
    contract = engine_contract("sharded2d", opts, dim=D, n_data=ext["data"],
                               n_model=ext["model"])
    p = D // ext["model"]
    k2 = name == "diag-1x4" or name == "diag-1x1"
    for out in port[shape]:
        log = _log(out[name + variant]["log"])
        rep = check_log(contract, log)
        assert rep["ok"], rep["violations"]
        big = [c for c in log if c.round is not None and c.dim == "data"
               and c.op == "sum" and c.dtype != "int32"]
        assert len(big) == (0 if k2 else T)
        want = ("int8", p) if kw.get("compression") == "int8" else \
            ("float32", 4 * p)
        assert {(c.dtype, c.nbytes) for c in big} <= {want}
        model = [c for c in log if c.round is not None and c.dim == "model"]
        assert model and max(c.nbytes for c in model) == 4 * D
        if "hierarchy" in kw:
            pod = [c for c in log if c.dim == "pod" and c.op == "sum"
                   and c.round is not None]
            assert [c.round for c in pod] == list(range(3, T + 1, 3))


@pytest.mark.parametrize("edit", ["drop_shard", "extra_shard", "grow_model",
                                  "grow_init"])
def test_contract_fails_a_broken_log(runs, edit):
    """The (2, 2) dense log with one shard all-reduce removed or added, a
    model collective grown past d floats, or an init collective grown
    past two panels, fails the checker."""
    _, port = runs
    log = _log(port[(2, 2)][0]["dense-2x2/seq"]["log"])
    contract = engine_contract(
        "sharded2d", RanlOptions(num_rounds=T, num_regions=Q), dim=D,
        n_data=2, n_model=2)
    assert check_log(contract, log)["ok"]
    shards = [i for i, c in enumerate(log) if c.dim == "data"
              and c.dtype == "float32" and c.round is not None]
    model = [i for i, c in enumerate(log) if c.dim == "model"
             and c.round is not None]
    init = [i for i, c in enumerate(log) if c.round is None]
    if edit == "drop_shard":
        log = log[:shards[4]] + log[shards[4] + 1:]
    elif edit == "extra_shard":
        log = log + [log[shards[0]]]
    elif edit == "grow_model":
        log[model[3]] = Collective("model", "sum", "float32", 4 * D + 4, 3)
    else:
        log[init[-1]] = Collective("model", "sum", "float32",
                                   2 * 24 * D * 4 + 4, None)
    assert not check_log(contract, log)["ok"]


@pytest.mark.parametrize("overlap", [False, True])
def test_no_tensor_exceeds_one_panel(runs, overlap):
    """Dense at d = 512 on (2, 2), ns_iters = 12: the largest tensor any
    operator of the run made is one (256, 512) f32 panel (within
    MEMORY_SLACK), on every rank — where a replicated d×d buffer would be
    twice that — and the log meets the contract."""
    _, port = runs
    d = MEM["dim"]
    opts = RanlOptions(num_rounds=MEM["rounds"], num_regions=MEM["regions"],
                       ns_iters=MEM["ns_iters"], overlap=overlap)
    ceiling = memory_ceiling("sharded2d", opts, dim=d, n_model=2)
    panel = (d // 2) * d * 4
    for out in port[(2, 2)]:
        got = out[f"mem/{overlap}"]
        assert panel <= got["max_bytes"] <= ceiling < d * d * 4, got["max_op"]
        rep = check_log(engine_contract("sharded2d", opts, dim=d, n_data=2,
                                        n_model=2),
                        _log(got["run"]["log"]))
        assert rep["ok"], rep["violations"]


CHECKS = ["no_model_axis", "no_data_axis", "workers_not_dividing",
          "dim_not_dividing", "hessian_rank", "dense_eigh", "no_pod_axis",
          "projection_dim_not_dividing"]


@pytest.mark.parametrize("case", CHECKS)
def test_mesh_and_option_checks_raise_the_references_errors(runs, case):
    _, port = runs
    for out in port[(2, 2)]:
        assert out["checks"][case] == "ValueError"


def test_missing_axis_errors_name_the_axis(runs):
    _, port = runs
    no_model, no_data = port[(2, 2)][0]["checks"]["messages"]
    assert "'model'" in no_model and "'data'" in no_data


def test_sharded2d_without_rounds_runs_scan_with_ns(runs):
    _, port = runs
    got = port[(2, 2)][0]["without_rounds"]
    assert torch.equal(got["sharded2d"], got["scan_ns"])


@pytest.mark.parametrize("shape", list(NS_MODELS), ids=str)
def test_panel_projection_matches_the_reference(runs, shape):
    """``project_psd_sharded`` at 1, 2 and 4 model shards: each rank's
    row panel, stacked in model order, against the reference's at the
    same count (30 Newton–Schulz steps on a 16×16 symmetric matrix)."""
    ref, port = runs
    n = NS_MODELS[shape]
    want = ref[f"ns/{n}"]
    ranks = port[shape]
    model_rank = [r % shape[-1] for r in range(len(ranks))]
    got = torch.cat([next(o["ns"] for o, m in zip(ranks, model_rank)
                          if m == j) for j in range(n)]).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------------------
# in-process: the row oracles, local region ids, the blocked factor
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _problems(d):
    """A quadratic and a logistic problem of width d from numpy draws,
    the same arrays on both sides (built directly: the oracles read only
    their leaves)."""
    rng = np.random.default_rng(d)
    m = rng.standard_normal((4, d, d)).astype(np.float32)
    arrays = dict(A=(m @ m.transpose(0, 2, 1) / d).astype(np.float32),
                  b=rng.standard_normal((4, d)).astype(np.float32),
                  X=rng.standard_normal((4, 32, d)).astype(np.float32),
                  y=np.sign(rng.standard_normal((4, 32))).astype(np.float32),
                  x_star=np.zeros(d, np.float32))
    noise = dict(grad_noise=0.1, hess_noise=0.1, mu=1.0, L_g=2.0)
    jq = jconvex.Quadratic(A=jnp.asarray(arrays["A"]),
                           b=jnp.asarray(arrays["b"]),
                           x_star=jnp.asarray(arrays["x_star"]), **noise)
    jl = jconvex.Logistic(X=jnp.asarray(arrays["X"]),
                          y=jnp.asarray(arrays["y"]), lam=1e-2,
                          x_star=jnp.asarray(arrays["x_star"]), **noise)
    tq = interop.problem_from_arrays("quadratic", arrays, noise,
                                     device="cpu")
    tl = interop.problem_from_arrays("logistic", arrays,
                                     dict(noise, lam=1e-2), device="cpu")
    return (jq, tq), (jl, tl)


# (d, row_start, num_rows): d divisible by num_rows and not
PANELS = [(48, 0, 12), (48, 36, 12), (48, 5, 7), (50, 12, 12), (50, 0, 50)]


@pytest.mark.parametrize("d,start,rows", PANELS)
def test_sym_noise_rows_are_rows_of_the_full_noise(d, start, rows):
    """Bit-equal to rows of the port's ``_sym_noise``; within the
    threefry normals' ≤ 4-ulp gap of the reference's ``_sym_noise_rows``."""
    key = prng.PRNGKey(3)
    got = tconvex._sym_noise_rows(key, d, start, rows, "cpu")
    assert torch.equal(got, tconvex._sym_noise(key, d, "cpu")[start:
                                                             start + rows])
    want = np.asarray(jconvex._sym_noise_rows(
        jnp.asarray(np.asarray(key)), d, start, rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
@pytest.mark.parametrize("d,start,rows", PANELS)
def test_row_oracles_are_rows_of_the_full_oracles(kind, d, start, rows):
    """``worker_grad_rows`` and ``worker_hessian_rows``, from the whole
    problem and from its ``row_panel`` view, bit-equal to rows of
    ``worker_grad`` and ``worker_hessian``; the reference's row oracles
    (given the panel of A, as its engine gives it) within the normals'
    gap; the batched ``worker_grads_rows`` within f32 rounding of rows of
    ``worker_grads`` (exact at full width)."""
    (jq, tq), (jl, tl) = _problems(d)
    jp, tp = (jq, tq) if kind == "quadratic" else (jl, tl)
    view = tp.row_panel(start, rows)
    jview = jp
    if kind == "quadratic":
        jview = jq.__class__(A=jq.A[:, start:start + rows], b=jq.b,
                             grad_noise=jq.grad_noise,
                             hess_noise=jq.hess_noise, x_star=jq.x_star,
                             mu=jq.mu, L_g=jq.L_g)
    x = torch.tensor(np.random.default_rng(d).standard_normal(d),
                     dtype=torch.float32)
    key = prng.PRNGKey(11)
    for i in range(4):
        for prob in (tp, view):
            g = prob.worker_grad_rows(i, x, key, start, rows)
            h = prob.worker_hessian_rows(i, x, key, start, rows)
            assert torch.equal(g, tp.worker_grad(i, x, key)[start:
                                                            start + rows])
            assert torch.equal(h, tp.worker_hessian(i, x, key)[start:
                                                               start + rows])
        if i % 3:                    # the reference at workers 0 and 3
            continue
        jx, jk = jnp.asarray(x.numpy()), jnp.asarray(np.asarray(key))
        jg = np.asarray(jview.worker_grad_rows(i, jx, jk, start, rows))
        jh = np.asarray(jview.worker_hessian_rows(i, jx, jk, start, rows))
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5,
                                   atol=1e-5 * np.abs(jg).max())
        np.testing.assert_allclose(h.numpy(), jh, rtol=1e-5,
                                   atol=1e-5 * np.abs(jh).max())
    xs = torch.tensor(np.random.default_rng(1).standard_normal((4, d)),
                      dtype=torch.float32)
    keys = prng.split(key, 4)
    got = view.worker_grads_rows(xs, keys, start, rows)
    full = tp.worker_grads(xs, keys)[:, start:start + rows]
    if rows == d:
        assert torch.equal(got, full)
    torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim,q,offset,size", [(48, 6, 0, 12), (48, 6, 36, 12),
                                               (50, 7, 10, 25), (9, 9, 4, 5),
                                               (48, 1, 24, 24)])
def test_local_region_ids_match_the_reference(dim, q, offset, size):
    got = local_region_ids(dim, q, offset, size, "cpu")
    want = np.asarray(jra.local_region_ids(dim, q, offset, size))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,block", [(1, 1), (7, 3), (13, 4), (16, 16),
                                     (33, 8), (31, 40)])
def test_blocked_cholesky_matches_the_reference_and_torch(d, block):
    """Odd and ragged d, blocks of 1 to past d: the factor against
    ``torch.linalg.cholesky`` and the reference's ``blocked_cholesky``,
    the solve against ``torch.cholesky_solve`` and the reference's
    ``blocked_cho_solve``."""
    rng = np.random.default_rng(d * 100 + block)
    m = rng.standard_normal((d, d)).astype(np.float32)
    a = (m @ m.T / d + np.eye(d, dtype=np.float32)).astype(np.float32)
    g = rng.standard_normal(d).astype(np.float32)
    ta, tg = torch.tensor(a), torch.tensor(g)
    L = thessian.blocked_cholesky(ta, block)
    torch.testing.assert_close(L, torch.linalg.cholesky(ta), rtol=1e-5,
                               atol=1e-5)
    jL = np.asarray(jhessian.blocked_cholesky(jnp.asarray(a), block))
    np.testing.assert_allclose(L.numpy(), jL, rtol=1e-5, atol=1e-5)
    x = thessian.blocked_cho_solve(L, tg, block)
    torch.testing.assert_close(
        x, torch.cholesky_solve(tg[:, None], L)[:, 0], rtol=1e-4, atol=1e-5)
    jx = np.asarray(jhessian.blocked_cho_solve(jnp.asarray(jL),
                                               jnp.asarray(g), block))
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fn", ["blocked_cholesky", "blocked_cho_solve"])
def test_blocked_factor_rejects_an_empty_block(fn):
    a = torch.eye(3)
    with pytest.raises(ValueError, match="block_size"):
        if fn == "blocked_cholesky":
            thessian.blocked_cholesky(a, 0)
        else:
            thessian.blocked_cho_solve(a, torch.ones(3), 0)
