"""Hierarchical pod-of-pods rounds of ``repro_torch.run`` against
``repro.run``, on the configurations of ``tests/test_hierarchy.py``.

Problems and cost models are carried across with ``repro_torch.interop``
(the same arrays), keys as numpy.  Tolerances:

* masks, coverage, ``comm_floats``, ``comm_bytes``, ``pod_bytes``,
  ``max_stale`` and ``tau_*`` are exact; ``round_time`` within rtol 1e-6
  (the diurnal capacity's sin, an ulp apart in the reference's compiled
  scan; exact elsewhere);
* ``xs_pods`` within 2e-5·max|x|: the port's synchronous uncompressed pod
  rounds aggregate through the region_aggregate / ranl_update dispatch
  (their plain twins here, in another summation order than the
  reference's jnp aggregation) and solve the P pods' steps as one pair of
  triangular solves with P right-hand sides; 5e-2 under an int8 exchange
  or int8 uplinks and 1e-2 under bf16, one quantization step, as the
  flat compressed runs (``_torch_options_helpers``);
* ``pod_sum_compressed`` bit-exact on the same inputs; the pod scenarios'
  ``pod_bw`` exact and rates within rtol 1e-6 (as ``pareto_cost``).

The kernels at the pod rounds' shapes, and a hierarchical run on the
card against the host, are in ``test_torch_kernels`` (marked ``gpu``;
that file imports without the reference's framework).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import make_logistic, make_quadratic  # noqa: E402
from repro.core.masks import PolicyConfig as JPolicy  # noqa: E402
from repro.hetero import cost as jcost  # noqa: E402
from repro.hetero import scenarios as jscen  # noqa: E402
from repro.hetero import time_to_target as jtime_to_target  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop, prng  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core.masks import PolicyConfig as TPolicy  # noqa: E402
from repro_torch.hetero import cost as tcost  # noqa: E402
from repro_torch.hetero import scenarios as tscen  # noqa: E402
from repro_torch.hetero import time_to_target  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

KEY = jax.random.PRNGKey(0)
TKEY = interop.key_from_numpy(np.asarray(KEY))
POL = dict(keep_prob=0.5, tau_star=1, heterogeneous=False)


def carry(p):
    if hasattr(p, "A"):
        kind, names = "quadratic", ("A", "b", "x_star")
        scalars = dict(grad_noise=p.grad_noise, hess_noise=p.hess_noise,
                       mu=p.mu, L_g=p.L_g)
    else:
        kind, names = "logistic", ("X", "y", "x_star")
        scalars = dict(lam=p.lam, grad_noise=p.grad_noise,
                       hess_noise=p.hess_noise, mu=p.mu, L_g=p.L_g)
    return interop.problem_from_arrays(
        kind, {n: np.asarray(getattr(p, n)) for n in names}, scalars,
        device="cpu")


def carry_cost(c):
    statics = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
               if f.name not in ("compute_rate", "bandwidth", "pod_bw")}
    return interop.cost_from_arrays(
        {"compute_rate": np.asarray(c.compute_rate),
         "bandwidth": np.asarray(c.bandwidth),
         "pod_bw": None if c.pod_bw is None else np.asarray(c.pod_bw)},
        statics, device="cpu")


_PROBLEMS = {}


def problems(kind="quadratic", n=8, d=24):
    """(reference problem, port problem) as tests/test_hierarchy.py's
    ``_problem`` (quadratic) or a logistic of the same size."""
    if (kind, n, d) not in _PROBLEMS:
        if kind == "quadratic":
            jp = make_quadratic(KEY, num_workers=n, dim=d, kappa=50.0,
                                coupling=0.0, num_regions=6, grad_noise=0.1,
                                hess_noise=0.1)
        else:
            jp = make_logistic(KEY, num_workers=n, per_worker=48, dim=d,
                               grad_noise=0.1, hess_noise=0.1,
                               heterogeneity=0.3)
        _PROBLEMS[kind, n, d] = (jp, carry(jp))
    return _PROBLEMS[kind, n, d]


def both(kind="quadratic", scenario=None, engine="scan", rounds=6, **kw):
    """The same run through repro.run and repro_torch.run."""
    jp, tp = problems(kind)
    jc = tc = None
    if scenario is not None:
        jc = jscen.make_scenario(scenario, jax.random.PRNGKey(7), 8).cost
        tc = carry_cost(jc)
    jkey, tkey = KEY, TKEY
    if engine == "batch":
        jkey = jax.random.split(KEY, 3)
        tkey = np.asarray(jkey)
    opts = dict(num_rounds=rounds, num_regions=6, **kw)
    jr = repro.run(jp, jkey, engine=engine, cost=jc, policy=JPolicy(**POL),
                   **opts)
    tr = repro_torch.run(tp, tkey, engine=engine, cost=tc, device="cpu",
                         policy=TPolicy(**POL), **opts)
    return jr, tr


def assert_traces_equal(jr, tr, clock_rtol=0.0):
    for f in ("coverage", "comm_floats", "max_stale", "comm_bytes",
              "pod_bytes", "round_time"):
        want, got = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert got.dtype == want.dtype, f
        if f == "round_time" and clock_rtol:
            np.testing.assert_allclose(got, want, rtol=clock_rtol)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("tau_star", "tau_covered"):
        np.testing.assert_array_equal(np.asarray(getattr(tr, f)),
                                      np.asarray(getattr(jr, f)), err_msg=f)


def assert_pods_close(jr, tr, tol):
    want = np.asarray(jr.xs_pods)
    assert tr.xs_pods.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(tr.xs_pods.numpy(), want, rtol=0,
                               atol=tol * scale)
    np.testing.assert_allclose(tr.xs.numpy(), np.asarray(jr.xs), rtol=0,
                               atol=tol * scale)


# --------------------------------------------------------------------------
# pieces: the compressed exchange, the topology, the scenarios
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("seed,shape,scale", [
    (0, (2, 30), 1.0), (1, (4, 30), 1e-3), (2, (3, 5, 30), 1e2),
    (3, (1, 30), 0.0), (4, (2, 127, 7), 1.0)])
def test_pod_sum_compressed_bit_exact(kind, seed, shape, scale):
    """Identical payloads and residuals give the reference's total and
    new residual bit for bit, over a leading seed axis too."""
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=shape) * scale).astype(np.float32)
    e = (rng.normal(size=shape) * scale * 0.01).astype(np.float32)
    jc, tc = jcomp.parse_compression(kind), tcomp.parse_compression(kind)
    total, err = tcomp.pod_sum_compressed(tc, torch.tensor(y),
                                          torch.tensor(e))
    for idx in np.ndindex(shape[:-2]):
        want_t, want_e = jcomp.pod_sum_compressed(jc, jnp.asarray(y[idx]),
                                                  jnp.asarray(e[idx]))
        np.testing.assert_array_equal(total[idx].numpy(), np.asarray(want_t))
        np.testing.assert_array_equal(err[idx].numpy(), np.asarray(want_e))


def test_pod_sum_compressed_rejects_topk():
    with pytest.raises(ValueError, match="int8/bf16"):
        tcomp.pod_sum_compressed(tcomp.parse_compression("topk:1"),
                                 torch.ones(2, 4), torch.zeros(2, 4))


@pytest.mark.parametrize("spec", [
    "geo-distributed", "edge-cohort", "diurnal-WAN",
    "geo-distributed:pods=4,pod_bw=100,asym=3,latency=2",
    "edge-cohort:pods=8,p=0.3", "diurnal-WAN:pods=3,bw=64"])
def test_pod_scenarios_equal_the_reference(spec):
    want = jscen.make_scenario(spec, jax.random.PRNGKey(5), 16)
    got = tscen.make_scenario(spec, prng.PRNGKey(5), 16, device="cpu")
    assert got.name == want.name
    np.testing.assert_array_equal(got.cost.pod_bw.numpy(),
                                  np.asarray(want.cost.pod_bw))
    for f in ("compute_rate", "bandwidth"):
        np.testing.assert_allclose(getattr(got.cost, f).numpy(),
                                   np.asarray(getattr(want.cost, f)),
                                   rtol=1e-6)
    for f in dataclasses.fields(want.cost):
        if f.name not in ("compute_rate", "bandwidth", "pod_bw",
                          "overlap_credit"):
            assert getattr(got.cost, f.name) == getattr(want.cost, f.name)


@pytest.mark.parametrize("nbytes", [0.0, 96.0, 28.0, 32768.0])
def test_pod_exchange_time_matches_the_reference(nbytes):
    j = jcost.with_topology(jcost.uniform_cost(4), pod_bw=[64.0, 8.0],
                            pod_latency=0.5)
    t = carry_cost(j)
    assert float(tcost.pod_exchange_time(t, nbytes)) == float(
        jcost.pod_exchange_time(j, nbytes))
    assert float(tcost.pod_exchange_time(tcost.uniform_cost(4, "cpu"),
                                         nbytes)) == 0.0


def test_pod_uplinks_validate_and_moving_keeps_the_topology():
    with pytest.raises(ValueError, match="pods=0"):
        tscen.pod_uplinks(0, 64.0, 8.0)
    c = tscen.make_scenario("geo-distributed", prng.PRNGKey(1), 4,
                            device="cpu").cost
    moved = tcost.on_device(c, "meta")
    assert moved.pod_bw.device.type == "meta"
    assert moved.pod_latency == c.pod_latency


# --------------------------------------------------------------------------
# degenerate parity, dispatch, pod_bytes accounting
# --------------------------------------------------------------------------

def test_pods1_matches_flat_exactly():
    """``pods=1``: the exchange is the identity, so the hierarchical run
    gives the flat trajectory bit for bit; and both equal the
    reference's pods=1 traces."""
    _, tp = problems()
    kw = dict(num_rounds=6, num_regions=6, policy=TPolicy(**POL),
              device="cpu")
    flat = repro_torch.run(tp, TKEY, **kw)
    hier = repro_torch.run(tp, TKEY, hierarchy="pods=1,period=2", **kw)
    assert hier.xs_pods.shape == (8, 1, tp.dim)
    for f in ("xs", "dist_sq", "comm_floats", "coverage", "round_time"):
        assert torch.equal(getattr(hier, f), getattr(flat, f)), f
    jr, tr = both(hierarchy="pods=1,period=2")
    assert_traces_equal(jr, tr)
    assert_pods_close(jr, tr, 2e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(hierarchy="pods=3"), "divide evenly"),
    (dict(num_rounds=5, hierarchy="pods=2,period=2"), "multiple of the"),
    (dict(engine="reference", hierarchy="pods=2,period=2"),
     "no host-loop form")], ids=["pods", "period", "reference"])
def test_hierarchy_dispatch_validation(kw, match):
    """The reference's checks and messages (tests/test_hierarchy.py)."""
    jp, tp = problems()
    kw = dict(dict(num_rounds=4, num_regions=6), **kw)
    with pytest.raises(ValueError, match=match):
        repro.run(jp, KEY, **kw)
    with pytest.raises(ValueError, match=match):
        repro_torch.run(tp, TKEY, device="cpu", **kw)


def test_pod_bytes_period_accounting():
    """On a pod topology a flat run's aggregate crosses every round (4d
    modeled bytes); a hierarchical run pays on every ``period``-th round
    only, and an int8 exchange shrinks that to d + 4 bytes: the
    reference's values, and its round times."""
    d, T, period = 16, 8, 4
    jp, tp = problems(d=d)
    js = jscen.make_scenario("geo-distributed", jax.random.PRNGKey(7), 8)
    ts = carry_cost(js.cost)
    for spec, nbytes in ((None, 4.0 * d), (f"pods=2,period={period}",
                                            4.0 * d),
                         (f"pods=2,period={period},compression=int8",
                          d + 4.0)):
        kw = dict(num_rounds=T, num_regions=6, hierarchy=spec)
        jr = repro.run(jp, KEY, cost=js.cost, policy=JPolicy(**POL), **kw)
        tr = repro_torch.run(tp, TKEY, cost=ts, policy=TPolicy(**POL),
                             device="cpu", **kw)
        want = np.full(T, nbytes, np.float32)
        if spec is not None:
            want = np.zeros(T, np.float32)
            want[period - 1::period] = nbytes
        np.testing.assert_array_equal(tr.pod_bytes.numpy(), want)
        assert_traces_equal(jr, tr)


def test_flat_runs_without_a_topology_meter_no_pod_bytes():
    _, tp = problems()
    r = repro_torch.run(tp, TKEY, device="cpu", num_rounds=3,
                        num_regions=6)
    assert torch.equal(r.pod_bytes, torch.zeros(3))
    assert r.xs_pods is None


def test_hierarchical_time_to_target_matches_reference():
    """The reference's pinned geo-distributed configuration (N = 16,
    d = 32, pods=2, period=4): the same traces, pod iterates within
    2e-5·max|x|, and the same ≤ 0.8× simulated time-to-target win."""
    dim, rounds, N = 32, 28, 16
    jp = make_quadratic(KEY, num_workers=N, dim=dim, kappa=100.0,
                        coupling=0.0, num_regions=8)
    tp = carry(jp)
    js = jscen.make_scenario("geo-distributed", jax.random.PRNGKey(101), N)
    ts = carry_cost(js.cost)
    kw = dict(num_rounds=rounds, num_regions=8, lr=0.5)
    out = {}
    for spec in (None, "pods=2,period=4"):
        jr = repro.run(jp, KEY, cost=js.cost, policy=JPolicy(**POL),
                       hierarchy=spec, **kw)
        tr = repro_torch.run(tp, TKEY, cost=ts, policy=TPolicy(**POL),
                             hierarchy=spec, device="cpu", **kw)
        assert_traces_equal(jr, tr)
        if spec is None:
            np.testing.assert_allclose(
                tr.xs.numpy(), np.asarray(jr.xs), rtol=0,
                atol=2e-5 * float(np.abs(np.asarray(jr.xs)).max()))
        else:
            assert_pods_close(jr, tr, 2e-5)
        out[spec] = (jr, tr)
    (jf, tf), (jh, th) = out[None], out["pods=2,period=4"]
    target = 1e-4 * float(tf.dist_sq[0])
    t_f = time_to_target(tf.dist_sq, tf.round_time, target)
    t_h = time_to_target(th.dist_sq, th.round_time, target)
    assert np.isfinite(t_f) and np.isfinite(t_h)
    assert t_h <= 0.8 * t_f, (t_h, t_f)
    assert t_h == jtime_to_target(jh.dist_sq, jh.round_time, target)


# --------------------------------------------------------------------------
# the round variants, scan and batch engines
# --------------------------------------------------------------------------

# (problem kind, hierarchy, options, scenario, xs tolerance, clock rtol)
VARIANTS = [
    ("quadratic", "pods=2,period=2", {}, None, 2e-5, 0.0),
    ("quadratic", "pods=4,period=3,gamma=0.5", {}, "geo-distributed:pods=4",
     2e-5, 0.0),
    ("quadratic", "pods=2,period=2", dict(quorum=0.75, max_delay=2),
     "edge-cohort", 5e-5, 0.0),
    ("quadratic", "pods=2,period=3,compression=int8", {}, "geo-distributed",
     5e-2, 0.0),
    ("quadratic", "pods=2,period=2,gamma=0.5,compression=bf16", {}, None,
     1e-2, 0.0),
    ("quadratic", "pods=2,period=2", dict(compression="int8"), None, 5e-2,
     0.0),
    ("quadratic", "pods=2,period=3", dict(compression="topk:2"),
     "diurnal-WAN", 2e-5, 1e-6),
    ("logistic", "pods=2,period=2", dict(curvature="diag"), None, 2e-5,
     0.0),
    ("logistic", "pods=4,period=3,gamma=0.5,compression=int8",
     dict(curvature="diag"), "edge-cohort:pods=4", 5e-2, 0.0),
    ("logistic", "pods=2,period=3,gamma=0.5",
     dict(curvature="diag", quorum=0.5, max_delay=1), "edge-cohort", 5e-5,
     0.0),
    ("logistic", "pods=2,period=2", dict(curvature="diag",
                                         use_kernel=False), None, 2e-5, 0.0),
]


@pytest.mark.parametrize("kind,spec,kw,scenario,tol,clock", VARIANTS,
                         ids=lambda v: str(v))
def test_hierarchical_runs_match_reference(kind, spec, kw, scenario, tol,
                                           clock):
    jr, tr = both(kind, scenario, hierarchy=spec, **kw)
    assert_traces_equal(jr, tr, clock)
    assert_pods_close(jr, tr, tol)
    # losses at the pods' mean: near x* a loss is a small difference of
    # large terms, so they are held to the largest loss's scale
    want = np.asarray(jr.losses)
    np.testing.assert_allclose(tr.losses.numpy(), want, rtol=max(tol, 1e-5),
                               atol=max(tol, 1e-6) * float(np.abs(want).max()))


@pytest.mark.parametrize("kind,spec,kw", [
    ("quadratic", "pods=2,period=2", {}),
    ("logistic", "pods=4,period=3,gamma=0.5,compression=int8",
     dict(curvature="diag"))], ids=["dense", "diag_int8"])
def test_batch_hierarchical_runs_match_reference_and_scan(kind, spec, kw):
    """engine="batch" over 3 seeds: the reference's batch engine
    (vmapped), and each row against the port's scan run on its key."""
    jr, tr = both(kind, engine="batch", hierarchy=spec, **kw)
    tol = 5e-2 if "int8" in spec else 1e-4
    assert_traces_equal(jr, tr)
    assert_pods_close(jr, tr, tol)
    _, tp = problems(kind)
    keys = np.asarray(jax.random.split(KEY, 3))
    for b in range(3):
        one = repro_torch.run(tp, keys[b], device="cpu", num_rounds=6,
                              num_regions=6, policy=TPolicy(**POL),
                              hierarchy=spec, **kw)
        for f in ("coverage", "comm_floats", "pod_bytes", "round_time"):
            assert torch.equal(getattr(tr, f)[b], getattr(one, f)), f
        assert int(tr.tau_star[b]) == one.tau_star
        scale = float(one.xs_pods.abs().max())
        assert float((tr.xs_pods[b] - one.xs_pods).abs().max()) <= \
            1e-4 * scale


def test_record_every_thins_pod_iterates():
    jr, tr = both(hierarchy="pods=2,period=2", rounds=8, record_every=3)
    assert tr.xs_pods.shape == np.asarray(jr.xs_pods).shape == (5, 2, 24)
    assert_traces_equal(jr, tr)
    assert_pods_close(jr, tr, 2e-5)


def test_zero_rounds_give_the_replicated_init():
    _, tp = problems()
    r = repro_torch.run(tp, TKEY, device="cpu", num_rounds=0,
                        num_regions=6, hierarchy="pods=2,period=3")
    assert r.xs_pods.shape == (2, 2, tp.dim)
    assert torch.equal(r.xs_pods[1, 0], r.xs_pods[1, 1])
    assert torch.equal(r.xs[1], r.xs_pods[1, 0])


def test_pod_rounds_take_the_kernel_dispatch(monkeypatch):
    """Synchronous uncompressed pod rounds go through the kernel dispatch
    once a round for all pods, as (B·P, N/P, d) rows; quorum and
    compressed pod rounds take the plain aggregation."""
    from repro_torch.kernels import ops
    seen = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            seen.append((name, tuple(args[2 if name == "ranl_update"
                                          else 0].shape)))
            return fn(*args, **kw)
        return wrapped
    monkeypatch.setattr(ops, "region_aggregate",
                        spy("region_aggregate", ops.region_aggregate))
    monkeypatch.setattr(ops, "ranl_update",
                        spy("ranl_update", ops.ranl_update))
    _, tp = problems()
    keys = prng.split(TKEY, 3)
    for curv, name in (("dense", "region_aggregate"),
                       ("diag", "ranl_update")):
        seen.clear()
        repro_torch.run(tp, keys, engine="batch", device="cpu",
                        num_rounds=4, num_regions=6, curvature=curv,
                        hierarchy="pods=4,period=2")
        assert seen == [(name, (12, 2, tp.dim))] * 4
    seen.clear()
    repro_torch.run(tp, TKEY, device="cpu", num_rounds=4, num_regions=6,
                    quorum=0.75, hierarchy="pods=2,period=2")
    assert seen == []
