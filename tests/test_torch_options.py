"""The round options of ``repro_torch.run`` against ``repro.run``:
compression with error feedback, quorum rounds, the closed-loop
controllers, the cluster scenarios and the low-rank [H]_μ init.

Problems and cost models are carried across with ``repro_torch.interop``
(the same arrays), keys as numpy.  Tolerances:

* integer traces (masks through coverage and comm_floats, max_stale,
  tau_star, tau_covered), ``comm_bytes``, ``round_time``, on-time sets,
  deadlines and delays are exact;
* the compressors, ``uplink_bytes``, ``quorum_split`` and the memory
  updates are bit-exact on the same inputs; sums over workers differ in
  order: rtol 1e-6 (the quorum sums: rtol 1e-5, ROADMAP Queue 3);
* ``xs`` within 2e-5·max|x| on the uncompressed and top-k paths (the
  scan and reference engines).  A lossy quantizer is discontinuous: the
  oracle's f32 products round apart from the reference's in the last
  bit, which now and then moves an int8 value across a rounding edge by
  one step (1/127 of the row's absmax) or a bf16 value by one ulp of
  bf16 (2⁻⁸), and error feedback carries that into later rounds.  So
  int8 runs are held to 5e-2·max|x| and bf16 runs to 1e-2·max|x|, the
  size of such steps through a κ ≈ 80 solve — and their compressors to
  bit-exactness on identical inputs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import make_logistic, make_quadratic  # noqa: E402
from repro.core.masks import PolicyConfig as JPolicy  # noqa: E402
from repro.hetero import controller as jctrl  # noqa: E402
from repro.hetero import cost as jcost  # noqa: E402
from repro.hetero import scenarios as jscen  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop, prng  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core.masks import PolicyConfig as TPolicy  # noqa: E402
from repro_torch.core.masks import ensure_coverage  # noqa: E402
from repro_torch.hetero import controller as tctrl  # noqa: E402
from repro_torch.hetero import cost as tcost  # noqa: E402
from repro_torch.hetero import scenarios as tscen  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

KEY = jax.random.PRNGKey(3)
TKEY = interop.key_from_numpy(np.asarray(KEY))
XS_TOL = {None: 2e-5, "topk:2": 2e-5, "int8": 5e-2, "bf16": 1e-2}


def carry(p):
    """The reference problem's leaves and scalars -> the port's problem."""
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
    """The reference's CostModel -> the port's, through interop."""
    statics = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
               if f.name not in ("compute_rate", "bandwidth", "pod_bw")}
    return interop.cost_from_arrays(
        {"compute_rate": np.asarray(c.compute_rate),
         "bandwidth": np.asarray(c.bandwidth),
         "pod_bw": None if c.pod_bw is None else np.asarray(c.pod_bw)},
        statics, device="cpu")


def quad(**kw):
    return make_quadratic(jax.random.PRNGKey(0), num_workers=8, dim=48,
                          kappa=80.0, coupling=0.0, num_regions=6,
                          grad_noise=0.1, hess_noise=0.1, heterogeneity=0.3,
                          **kw)


_PROBLEMS = {}


def problems(kind="quadratic"):
    """(reference problem, port problem), built once per kind."""
    if kind not in _PROBLEMS:
        jp = quad() if kind == "quadratic" else make_logistic(
            jax.random.PRNGKey(0), num_workers=8, per_worker=64, dim=24,
            grad_noise=0.1, hess_noise=0.1, heterogeneity=0.3)
        _PROBLEMS[kind] = (jp, carry(jp))
    return _PROBLEMS[kind]


def assert_traces_equal(jr, tr, clock_rtol=0.0):
    """Integer traces and comm_bytes exact; round_time exact unless
    ``clock_rtol`` (the diurnal capacity's sin, which the reference's
    compiled scan evaluates an ulp apart from its eager ops)."""
    for f in ("coverage", "comm_floats", "max_stale", "round_time",
              "comm_bytes"):
        want, got = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert got.dtype == want.dtype, f
        if f == "round_time" and clock_rtol:
            np.testing.assert_allclose(got, want, rtol=clock_rtol)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tr.tau_star, tr.tau_covered) == (jr.tau_star, jr.tau_covered)


def assert_xs_close(jr, tr, tol):
    want = np.asarray(jr.xs)
    np.testing.assert_allclose(tr.xs.numpy(), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def both(engine="scan", scenario=None, kind="quadratic", controller=None,
         rounds=8, **kw):
    """The same run through repro.run and repro_torch.run; ``policy`` is
    a dict of PolicyConfig fields."""
    jp, tp = problems(kind)
    jc = tc = None
    if scenario is not None:
        jc = jscen.make_scenario(scenario, jax.random.PRNGKey(9), 8).cost
        tc = carry_cost(jc)
    pol = kw.pop("policy", {})
    opts = dict(num_rounds=rounds, num_regions=6, **kw)
    jr = repro.run(jp, KEY, engine=engine, cost=jc, controller=controller,
                   policy=JPolicy(**pol), **opts)
    tr = repro_torch.run(tp, TKEY, engine=engine, cost=tc,
                         controller=controller, device="cpu",
                         policy=TPolicy(**pol), **opts)
    return jr, tr


# --------------------------------------------------------------------------
# compression: parser, compressors, wire model, aggregations
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "int8", "bf16", "topk:1", "topk:7"])
def test_parse_compression_specs_match(spec):
    want, got = jcomp.parse_compression(spec), tcomp.parse_compression(spec)
    assert (want is None) == (got is None)
    if want is not None:
        assert (got.kind, got.k) == (want.kind, want.k)


@pytest.mark.parametrize("bad", ["gzip", "topk:0", "topk:-1", "topk:x",
                                 "int4"])
def test_parse_compression_rejects(bad):
    with pytest.raises(ValueError):
        tcomp.parse_compression(bad)
    with pytest.raises(ValueError):
        repro_torch.RanlOptions(compression=bad)


def test_options_validate_rank_and_quorum_knobs():
    for bad in (dict(hessian_rank=0), dict(quorum=0.0), dict(quorum=1.5),
                dict(quorum_tau=1), dict(gamma=1.5), dict(max_delay=0)):
        with pytest.raises(ValueError):
            repro_torch.RanlOptions(**bad)


def _rows(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("spec", ["int8", "bf16", "topk:1", "topk:3",
                                  "topk:9"])
@pytest.mark.parametrize("seed,shape,scale", [
    (0, (4, 30), 1.0), (1, (1, 30), 1e-3), (2, (3, 2, 30), 1e3),
    (3, (6, 30), 0.0)])
def test_compress_rows_bit_exact(spec, seed, shape, scale):
    """Each compressor on identical rows gives the reference's decoded
    rows bit for bit (round half to even, bf16 round to nearest even,
    top-k ties to the lower region), over a leading seed axis too."""
    Y = _rows(seed, shape, scale)
    rids = np.repeat(np.arange(6), 5)
    jc, tc = jcomp.parse_compression(spec), tcomp.parse_compression(spec)
    got = tcomp.compress_rows(tc, torch.tensor(Y), torch.tensor(rids), 6)
    for idx in np.ndindex(shape[:-2]):
        want = jcomp.compress_rows(jc, jnp.asarray(Y[idx]),
                                   jnp.asarray(rids), 6)
        np.testing.assert_array_equal(got[idx].numpy(), np.asarray(want))


def test_topk_ties_go_to_the_lower_region():
    """Equal energies: the lower-indexed regions survive, as lax.top_k's."""
    Y = np.ones((2, 12), np.float32)
    rids = np.repeat(np.arange(4), 3)
    got = tcomp.compress_rows(tcomp.parse_compression("topk:2"),
                              torch.tensor(Y), torch.tensor(rids), 4)
    want = jcomp.compress_rows(jcomp.parse_compression("topk:2"),
                               jnp.asarray(Y), jnp.asarray(rids), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, :6].eq(1).all() and got[:, 6:].eq(0).all()


@pytest.mark.parametrize("spec", [None, "int8", "bf16", "topk:1", "topk:2",
                                  "topk:5"])
def test_uplink_bytes_wire_model_matches(spec):
    rng = np.random.default_rng(4)
    M = rng.random((3, 7, 4)) < 0.5
    M[0, 2] = False                                   # a silent worker
    sizes = np.array([10, 20, 30, 5], np.int32)
    got = tcomp.uplink_bytes(tcomp.parse_compression(spec), torch.tensor(M),
                             torch.tensor(sizes))
    for b in range(3):
        want = jcomp.uplink_bytes(jcomp.parse_compression(spec),
                                  jnp.asarray(M[b]), jnp.asarray(sizes))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def _agg_inputs(seed=0, n=6, d=24, q=4, max_delay=2):
    rng = np.random.default_rng(seed)
    Mq = rng.random((n, q)) < 0.6
    rids = np.repeat(np.arange(q), d // q)
    Mx = Mq[:, rids]
    G = (rng.normal(size=(n, d)) * Mx).astype(np.float32)
    C = rng.normal(size=(n, d)).astype(np.float32)
    err = (0.1 * rng.normal(size=(n, d))).astype(np.float32)
    on = rng.random(n) < 0.6
    delays = np.where(on, 0, rng.integers(1, max_delay + 2, n)).astype(
        np.int32)
    late = rng.normal(size=(max_delay, d)).astype(np.float32)
    return G, Mx, C, err, on, delays, late, rids


@pytest.mark.parametrize("spec", ["int8", "bf16", "topk:2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compressed_server_aggregate_matches(spec, seed):
    G, Mx, C, err, _, _, _, rids = _agg_inputs(seed)
    want = jcomp.compressed_server_aggregate(
        jnp.asarray(G), jnp.asarray(Mx), jnp.asarray(C), jnp.asarray(err),
        jcomp.parse_compression(spec), region_ids=jnp.asarray(rids),
        num_regions=4)
    got = tcomp.compressed_server_aggregate(
        *map(torch.tensor, (G, Mx, C, err)), tcomp.parse_compression(spec),
        region_ids=torch.tensor(rids), num_regions=4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("spec", ["int8", "bf16", "topk:2"])
@pytest.mark.parametrize("gamma,max_delay", [(0.5, 2), (1.0, 1), (0.0, 3)])
def test_compressed_quorum_aggregate_matches(spec, gamma, max_delay):
    G, Mx, C, err, on, delays, late, rids = _agg_inputs(2, max_delay=max_delay)
    want = jcomp.compressed_quorum_aggregate(
        *map(jnp.asarray, (G, Mx, C, err, on, delays, late)),
        jcomp.parse_compression(spec), region_ids=jnp.asarray(rids),
        num_regions=4, gamma=gamma, max_delay=max_delay)
    got = tcomp.compressed_quorum_aggregate(
        *map(torch.tensor, (G, Mx, C, err, on, delays, late)),
        tcomp.parse_compression(spec), region_ids=torch.tensor(rids),
        num_regions=4, gamma=gamma, max_delay=max_delay)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# compression through the engines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["scan", "reference"])
@pytest.mark.parametrize("spec", ["int8", "bf16", "topk:2"])
@pytest.mark.parametrize("scenario", [None, "pareto-stragglers:bw=64"])
def test_error_feedback_runs_match_reference(engine, spec, scenario):
    """Every compression kind with error feedback, synchronous rounds:
    integer traces and comm_bytes exact (on a finite uplink the bytes
    price round_time), xs within the kind's tolerance."""
    jr, tr = both(engine, scenario, compression=spec,
                  policy=dict(keep_prob=0.5, tau_star=1))
    assert_traces_equal(jr, tr)
    assert_xs_close(jr, tr, XS_TOL[spec])


def _pinned():
    """The reference's pinned compression problem (tests/test_compression)."""
    jp = make_quadratic(jax.random.PRNGKey(0), num_workers=8, dim=32,
                        kappa=50.0, coupling=0.0, num_regions=4)
    return jp, carry(jp)


def test_error_feedback_convergence_and_bytes():
    """As the reference's pin: compressed runs track the uncompressed one
    (int8/bf16 within 5 %, top-k within 50 %) and meter fewer bytes for
    the same floats; and each lands where the reference's lands."""
    jp, tp = _pinned()
    kw = dict(num_rounds=60, lr=0.5, num_regions=4)
    pol = dict(keep_prob=0.5, tau_star=1, heterogeneous=False)
    res = {c: repro_torch.run(tp, TKEY, device="cpu", compression=c,
                              policy=TPolicy(**pol), **kw)
           for c in (None, "int8", "bf16", "topk:2")}
    d_none = float(res[None].dist_sq[-1])
    assert np.isfinite(d_none)
    assert float(res["int8"].dist_sq[-1]) <= 1.05 * d_none
    assert float(res["bf16"].dist_sq[-1]) <= 1.05 * d_none
    assert float(res["topk:2"].dist_sq[-1]) <= 1.5 * d_none
    b_none = float(res[None].comm_bytes.sum())
    for c, bound in (("int8", 0.5), ("bf16", 0.5 + 1e-9), ("topk:2", 1.0)):
        assert float(res[c].comm_bytes.sum()) < bound * b_none, c
        assert torch.equal(res[c].comm_floats, res[None].comm_floats)
        jr = repro.run(jp, KEY, compression=c, policy=JPolicy(**pol), **kw)
        assert_traces_equal(jr, res[c])


def test_compressed_quorum_path_converges():
    jp, tp = _pinned()
    kw = dict(num_rounds=60, lr=0.5, num_regions=4, quorum=0.75,
              quorum_tau=1, device="cpu",
              policy=TPolicy(keep_prob=0.5, tau_star=1, heterogeneous=False))
    d = {c: float(repro_torch.run(tp, TKEY, compression=c, **kw).dist_sq[-1])
         for c in (None, "int8")}
    assert np.isfinite(d[None]) and np.isfinite(d["int8"])
    assert d["int8"] <= 1.1 * d[None]


@pytest.mark.parametrize("spec", ["int8", "topk:2"])
@pytest.mark.parametrize("engine", ["scan", "reference"])
def test_compressed_quorum_runs_match_reference(spec, engine):
    jr, tr = both(engine, "pareto-stragglers", compression=spec, quorum=0.75,
                  quorum_tau=1, max_delay=2)
    assert_traces_equal(jr, tr)
    assert_xs_close(jr, tr, XS_TOL[spec])


# --------------------------------------------------------------------------
# quorum rounds
# --------------------------------------------------------------------------

def test_quorum_split_kth_order_statistic():
    times = torch.tensor([1.0, 2.0, 7.0, 3.0])
    masks = torch.tensor([[1, 0], [0, 1], [1, 1], [1, 1]], dtype=torch.bool)
    deadline, on_time, delays = tcost.quorum_split(
        times, masks, quorum=1.0, quorum_tau=1, max_delay=3)
    assert float(deadline) == 2.0
    assert on_time.tolist() == [True, True, False, False]
    assert delays.tolist() == [0, 0, 3, 1]
    assert float(tcost.quorum_deadline(times, masks, quorum=1.0,
                                       quorum_tau=1)) == 2.0


@pytest.mark.parametrize("quorum,tau,max_delay", [
    (1.0, None, 2), (0.75, 1, 2), (0.5, 1, 1), (0.75, 2, 3), (0.25, None, 2)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quorum_split_matches_reference(quorum, tau, max_delay, seed):
    """Random times with ties and silent workers, over a seed axis:
    deadlines, on-time sets and delays exactly the reference's (its
    argsort is stable; so is the port's)."""
    rng = np.random.default_rng(seed)
    times = rng.integers(1, 6, (3, 8)).astype(np.float32)  # many ties
    masks = rng.random((3, 8, 5)) < 0.5
    masks[:, 0] = False
    got = tcost.quorum_split(torch.tensor(times), torch.tensor(masks),
                             quorum=quorum, quorum_tau=tau,
                             max_delay=max_delay)
    for b in range(3):
        want = jcost.quorum_split(jnp.asarray(times[b]),
                                  jnp.asarray(masks[b]), quorum=quorum,
                                  quorum_tau=tau, max_delay=max_delay)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


def test_staleness_weights_bounded_delay():
    from repro_torch.core.masks import staleness_weights
    w = staleness_weights(torch.tensor([0, 1, 2, 3, 4]), 0.5, 3)
    np.testing.assert_allclose(w.numpy(), [0.0, 0.5, 0.25, 0.125, 0.0])


@pytest.mark.parametrize("gamma,max_delay", [(0.5, 2), (1.0, 3), (0.0, 1)])
@pytest.mark.parametrize("seed", [0, 3])
def test_quorum_aggregate_and_late_fold_match(gamma, max_delay, seed):
    G, Mx, C, _, on, delays, late, _ = _agg_inputs(seed, max_delay=max_delay)
    want = jagg.quorum_aggregate(*map(jnp.asarray,
                                      (G, Mx, C, on, delays, late)),
                                 gamma=gamma, max_delay=max_delay)
    got = tagg.quorum_aggregate(*map(torch.tensor,
                                     (G, Mx, C, on, delays, late)),
                                gamma=gamma, max_delay=max_delay)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-6)
    count = Mx.sum(axis=0).astype(np.float32)
    np.testing.assert_allclose(
        tagg.late_fold_updates(torch.tensor(G), torch.tensor(Mx),
                               torch.tensor(count), torch.tensor(delays),
                               gamma=gamma, max_delay=max_delay).numpy(),
        np.asarray(jagg.late_fold_updates(
            jnp.asarray(G), jnp.asarray(Mx), jnp.asarray(count),
            jnp.asarray(delays), gamma=gamma, max_delay=max_delay)),
        rtol=1e-6, atol=1e-7)


def test_gamma_one_reconstructs_synchronous_mean():
    """On-time partial sum + its late arrivals at gamma = 1 = the
    synchronous mean (rtol 1e-5: f32 order, ROADMAP Queue 3)."""
    G, Mx, C, _, on, _, _, _ = _agg_inputs(5)
    delays = np.where(on, 0, 1).astype(np.int32)
    late = np.zeros((1, G.shape[1]), np.float32)
    g_on, _, buf = tagg.quorum_aggregate(
        *map(torch.tensor, (G, Mx, C, on, delays, late)), gamma=1.0,
        max_delay=1)
    sync, _ = tagg.server_aggregate(torch.tensor(G), torch.tensor(Mx),
                                    torch.tensor(C))
    covered_on = (Mx & on[:, None]).any(axis=0)
    got = (g_on + buf[0]).numpy()
    np.testing.assert_allclose(got[covered_on], sync.numpy()[covered_on],
                               rtol=1e-5, atol=1e-6)


def test_gamma_zero_drops_late_work_and_dropped_keep_memory():
    G, Mx, C, _, on, delays, late, _ = _agg_inputs(6, max_delay=1)
    _, mem, buf = tagg.quorum_aggregate(
        *map(torch.tensor, (G, Mx, C, on, delays, np.zeros_like(late[:1]))),
        gamma=0.0, max_delay=1)
    assert buf.abs().max().item() == 0.0
    dropped = delays > 1
    np.testing.assert_array_equal(mem.numpy()[dropped], C[dropped])


def test_quorum_one_is_bit_exact_synchronous():
    """quorum=1.0 runs the quorum branch and equals the synchronous run
    bit for bit (the late buffer stays zero)."""
    _, tp = problems()
    kw = dict(num_rounds=8, num_regions=6, device="cpu")
    a = repro_torch.run(tp, TKEY, **kw)
    b = repro_torch.run(tp, TKEY, quorum=1.0, **kw)
    assert torch.equal(a.xs, b.xs)
    for f in ("coverage", "comm_floats", "round_time", "max_stale"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("engine", ["scan", "reference"])
@pytest.mark.parametrize("scenario", ["uniform", "pareto-stragglers",
                                      "churn-stragglers", "dropout"])
@pytest.mark.parametrize("kw", [dict(quorum=0.75, max_delay=2),
                                dict(quorum=0.5, quorum_tau=1, gamma=0.8)],
                         ids=["q0.75", "q0.5-tau1"])
def test_quorum_runs_match_reference(engine, scenario, kw):
    """The quorum trajectories themselves (not the reference's red 0.8x
    time pins): round_time is the deadline, coverage counts the on-time
    workers, xs within 5e-5·max|x|: the late buffer sums each round's
    damped late mass in another order and carries it forward, on top of
    the init's κ-amplified rounding (≈ 6e-6·max|x| at x¹ here)."""
    jr, tr = both(engine, scenario, **kw)
    assert_traces_equal(jr, tr)
    assert_xs_close(jr, tr, 5e-5)


def test_quorum_round_time_is_deadline_and_comm_is_full():
    _, sync = both(scenario="pareto-stragglers")
    _, q = both(scenario="pareto-stragglers", quorum=0.5, quorum_tau=1)
    assert torch.equal(q.comm_floats, sync.comm_floats)
    assert bool((q.round_time <= sync.round_time).all())
    assert float(q.round_time.sum()) < float(sync.round_time.sum())


@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
def test_quorum_diag_bypasses_the_fused_kernel_and_matches(kind):
    jr, tr = both(kind=kind, scenario="pareto-stragglers", quorum=0.75,
                  curvature="diag")
    assert_traces_equal(jr, tr)
    assert_xs_close(jr, tr, 2e-5)


# --------------------------------------------------------------------------
# cost models, scenarios and controllers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [1.2, 0.8, 3.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_pareto_cost_matches_and_is_heavy_tailed(alpha, seed):
    k = jax.random.PRNGKey(seed)
    want = jcost.pareto_cost(k, 64, alpha=alpha, bandwidth=8.0)
    got = tcost.pareto_cost(np.asarray(k), 64, alpha=alpha, bandwidth=8.0,
                            device="cpu")
    np.testing.assert_allclose(got.compute_rate.numpy(),
                               np.asarray(want.compute_rate), rtol=1e-6)
    np.testing.assert_array_equal(got.bandwidth.numpy(),
                                  np.asarray(want.bandwidth))
    rates = got.compute_rate.numpy()
    assert (rates > 0).all() and (rates <= 1.0).all()


def test_availability_with_stacked_keys_matches():
    c = tcost.with_availability(tcost.uniform_cost(16, "cpu"),
                                dropout_prob=0.3, churn_period=2)
    jc = jcost.with_availability(jcost.uniform_cost(16), dropout_prob=0.3,
                                 churn_period=2)
    keys = jax.random.split(jax.random.PRNGKey(4), 5)
    got = tcost.available(c, np.asarray(keys), 7)
    for b in range(5):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(jcost.available(jc, keys[b], 7)))


SCENARIO_SPECS = ["uniform", "pareto-stragglers", "dropout", "churn",
                  "churn-stragglers", "diurnal", "dirichlet",
                  "pareto-stragglers:alpha=1.0,bw=64", "dropout:p=0.4,alpha=1.5",
                  "churn:period=3,cohorts=2", "diurnal:period=7,amp=0.5"]


@pytest.mark.parametrize("spec", SCENARIO_SPECS)
def test_scenarios_match_reference(spec):
    k = jax.random.PRNGKey(11)
    want = jscen.make_scenario(spec, k, 8)
    got = tscen.make_scenario(spec, np.asarray(k), 8, device="cpu")
    assert got.name == want.name
    assert got.dirichlet_alpha == want.dirichlet_alpha
    np.testing.assert_allclose(got.cost.compute_rate.numpy(),
                               np.asarray(want.cost.compute_rate), rtol=1e-6)
    np.testing.assert_array_equal(got.cost.bandwidth.numpy(),
                                  np.asarray(want.cost.bandwidth))
    for f in ("overhead", "dropout_prob", "churn_period", "churn_cohorts",
              "diurnal_period", "diurnal_amplitude"):
        assert getattr(got.cost, f) == getattr(want.cost, f), f


def test_scenario_registry_and_bad_names():
    assert set(tscen.SCENARIOS) == set(jscen.SCENARIOS)
    with pytest.raises(ValueError):
        tscen.make_scenario("nope", prng.PRNGKey(0), 4, device="cpu")
    with pytest.raises(ValueError):
        tscen.make_scenario("dropout:p", prng.PRNGKey(0), 4, device="cpu")


@pytest.mark.parametrize("alpha", [0.3, 1.0, 2.5])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dirichlet_weights_match(alpha, seed):
    """The port's Marsaglia–Tsang loop on its threefry streams: within a
    few ulp of jax.random.gamma (its log and normals differ by ulps,
    ROADMAP Queue 3), mean 1."""
    k = jax.random.PRNGKey(seed)
    want = np.asarray(jscen.dirichlet_weights(k, 8, alpha))
    got = tscen.dirichlet_weights(np.asarray(k), 8, alpha,
                                  device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)
    assert abs(got.mean() - 1.0) < 1e-5


def test_scenario_problem_matches():
    k = jax.random.PRNGKey(2)
    js, ts = (jscen.make_scenario("dirichlet", k, 8),
              tscen.make_scenario("dirichlet", np.asarray(k), 8,
                                  device="cpu"))
    kw = dict(num_workers=8, dim=16, kappa=20.0)
    jp = jscen.scenario_problem(js, k, **kw)
    tp = tscen.scenario_problem(ts, np.asarray(k), device="cpu", **kw)
    np.testing.assert_allclose(tp.A.numpy(), np.asarray(jp.A), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tp.b.numpy(), np.asarray(jp.b), rtol=1e-4,
                               atol=1e-5)
    jl = jscen.scenario_problem(jscen.make_scenario("uniform", k, 4), k,
                                kind="logistic", num_workers=4,
                                per_worker=8, dim=5)
    tl = tscen.scenario_problem(ts, np.asarray(k), kind="logistic",
                                device="cpu", num_workers=4, per_worker=8,
                                dim=5)
    assert tl.X.shape == jl.X.shape
    with pytest.raises(ValueError):
        tscen.scenario_problem(ts, np.asarray(k), kind="svm", device="cpu")


CONTROLLER_SPECS = [
    "policy", "policy:name=fixed_k,keep=0.5,tau=0", "resource",
    "resource:keep=0.3,tau=2,ema=0.8,min_keep=0.1", "staleness-bounded",
    "staleness-bounded:s=2,keep=0.4,tau=0,het=0",
    "quorum:q=0.5,tau=none,gamma=0.9,delay=3,inner=resource;keep=0.5",
    "quorum"]


@pytest.mark.parametrize("spec", CONTROLLER_SPECS)
def test_make_controller_matches_reference(spec):
    def fields(c):
        out = {}
        for f in dataclasses.fields(c):
            v = getattr(c, f.name)
            out[f.name] = (fields(v) if dataclasses.is_dataclass(v)
                           else v)
        return type(c).__name__, out
    assert fields(tctrl.make_controller(spec)) == fields(
        jctrl.make_controller(spec))


def test_make_controller_rejects_and_passes_through():
    with pytest.raises(ValueError):
        tctrl.make_controller("bandit")
    with pytest.raises(ValueError):
        tctrl.make_controller("resource:keep")
    c = tctrl.ResourceProportionalController()
    assert tctrl.make_controller(c) is c
    assert isinstance(tctrl.make_controller(TPolicy()),
                      tctrl.PolicyController)


@pytest.mark.parametrize("spec", ["resource", "staleness-bounded:s=2",
                                  "quorum:q=0.75,inner=resource;keep=0.5"])
@pytest.mark.parametrize("scenario", ["pareto-stragglers", "churn",
                                      "diurnal"])
@pytest.mark.parametrize("curvature", ["dense", "diag"])
def test_closed_loop_runs_match_reference(spec, scenario, curvature):
    """The three closed-loop controllers through the engine, each on
    three scenarios: the same masks (integer traces exact)."""
    jr, tr = both(scenario=scenario, controller=spec, curvature=curvature)
    assert_traces_equal(jr, tr, 1e-6 if scenario == "diurnal" else 0.0)
    assert_xs_close(jr, tr, 5e-5 if spec.startswith("quorum") else 2e-5)


def test_closed_loop_reference_engine_matches():
    for spec in ("resource", "staleness-bounded:s=2"):
        jr, tr = both("reference", "dropout", controller=spec)
        assert_traces_equal(jr, tr)
        assert_xs_close(jr, tr, 2e-5)


@pytest.mark.parametrize("controller,scenario,policy", [
    ("staleness-bounded", "dropout", {}),
    (None, None, {}),
    (None, None, dict(keep_prob=0.5, tau_star=1))],
    ids=["staleness-bounded-dropout", "default", "keep0.5-tau1"])
def test_diag_loss_settles_above_the_first_step_as_in_the_reference(
        controller, scenario, policy):
    """The diag runs of the card's smoke at N = 32 and 64 regions, cut to
    d = 128: the first diagonal Newton step lands next to x*, and the
    pruned rounds then settle a little above it, in the reference as in
    the port.  So a diag run's loss falls below x⁰'s but not x¹'s."""
    jp = make_logistic(jax.random.PRNGKey(0), num_workers=32,
                       per_worker=128, dim=128)
    jc = tc = None
    if scenario is not None:
        jc = jscen.make_scenario(scenario, jax.random.PRNGKey(7), 32).cost
        tc = carry_cost(jc)
    key = jax.random.PRNGKey(1)
    opts = dict(num_rounds=30, num_regions=64, curvature="diag")
    jr = repro.run(jp, key, cost=jc, controller=controller,
                   policy=JPolicy(**policy), **opts)
    tr = repro_torch.run(carry(jp), interop.key_from_numpy(np.asarray(key)),
                         device="cpu", cost=tc, controller=controller,
                         policy=TPolicy(**policy), **opts)
    assert_traces_equal(jr, tr)
    assert_xs_close(jr, tr, 2e-5)
    for losses in (np.asarray(jr.losses), tr.losses.numpy()):
        assert losses[-1] < losses[0]
        assert losses[-1] > losses[1]


def test_quorum_controller_unwraps_and_conflicts():
    _, tp = problems()
    ctrl = tctrl.make_controller("quorum:q=0.5,tau=1")
    a = repro_torch.run(tp, TKEY, device="cpu", num_rounds=5, num_regions=6,
                        controller=ctrl)
    b = repro_torch.run(tp, TKEY, device="cpu", num_rounds=5, num_regions=6,
                        quorum=0.5, quorum_tau=1, gamma=0.5, max_delay=2,
                        controller=ctrl.inner)
    assert torch.equal(a.xs, b.xs)
    with pytest.raises(ValueError, match="twice"):
        repro_torch.run(tp, TKEY, device="cpu", num_rounds=1, quorum=0.5,
                        controller=ctrl)


def test_resource_controller_learns_throughput_order():
    """Workers with a tenth of the rate keep fewer regions than the rest
    once the estimates settle."""
    _, tp = problems()
    rates = torch.tensor([0.1, 0.1] + [1.0] * 6)
    cost = tcost.CostModel(compute_rate=rates,
                           bandwidth=torch.full((8,), float("inf")))
    ctrl = tctrl.ResourceProportionalController(keep_prob=0.5, tau_star=0)
    state = ctrl.init_state(8, 6, "cpu")
    telem = tctrl.initial_telemetry(8, 6, "cpu")
    kept = torch.zeros(8)
    for t in range(1, 21):
        m, state = ctrl.step(state, telem, prng.fold_in(TKEY, t), t, 8, 6,
                             "cpu")
        work = m.sum(dim=-1).to(torch.float32) * 8
        telem = tctrl.next_telemetry(telem, m.sum(dim=0),
                                     work, tcost.worker_times(cost, work, t))
        if t > 10:
            kept += m.sum(dim=-1)
    assert kept[:2].mean() < kept[2:].mean()


def test_staleness_bounded_controller_caps_staleness():
    _, tp = problems()
    res = repro_torch.run(tp, TKEY, device="cpu", num_rounds=20,
                          num_regions=6, controller="staleness-bounded:s=2,"
                          "keep=0.2,tau=0")
    assert int(res.max_stale.max()) <= 2


@pytest.mark.parametrize("n,q,seed", [(6, 4, 0), (5, 7, 1), (8, 3, 2)])
def test_ensure_coverage_per_region_tau_over_seeds(n, q, seed):
    """Per-region targets over a seed axis equal the reference per seed."""
    rng = np.random.default_rng(seed)
    m = rng.random((3, n, q)) < 0.3
    tau = rng.integers(0, n + 2, (3, q)).astype(np.int32)
    got = ensure_coverage(torch.tensor(m), torch.tensor(tau))
    for b in range(3):
        from repro.core.masks import ensure_coverage as jens
        want = jens(jnp.asarray(m[b]), jnp.asarray(tau[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the low-rank [H]_μ init
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,alpha", [(5, 0.7), (16, 2.0), (9, 0.0),
                                     (12, -1.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_chol_rank1_update_matches_and_is_exact_algebra(n, alpha, seed):
    rng = np.random.default_rng(seed)
    L = np.linalg.cholesky(np.cov(rng.normal(size=(n, 3 * n)))
                           + np.eye(n)).astype(np.float32)
    u = rng.normal(size=n).astype(np.float32)
    got = tref.chol_rank1_update(torch.tensor(L), torch.tensor(u),
                                 torch.tensor(np.float32(alpha))).numpy()
    want = np.asarray(jcomp.chol_rank1_update(jnp.asarray(L), jnp.asarray(u),
                                              np.float32(alpha)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    a = max(alpha, 0.0)
    np.testing.assert_allclose(got @ got.T, L @ L.T + a * np.outer(u, u),
                               rtol=1e-5, atol=1e-5)
    assert np.allclose(np.triu(got, 1), 0)


@pytest.mark.parametrize("rank", [1, 3])
def test_hessian_rank_runs_match_reference(rank):
    jr, tr = both(hessian_rank=rank, rounds=6)
    assert_traces_equal(jr, tr)
    assert_xs_close(jr, tr, 2e-5)


def test_hessian_rank_full_reproduces_dense_init():
    """rank = d with every worker Hessian ⪰ μI (no hessian noise) gives
    chol(mean H): the same run as the dense init, and the reference's."""
    jp = make_quadratic(jax.random.PRNGKey(1), num_workers=4, dim=12,
                        kappa=20.0, coupling=0.0, num_regions=4)
    tp = carry(jp)
    kw = dict(num_rounds=5, num_regions=4, device="cpu", mu=0.5 * jp.mu)
    full = repro_torch.run(tp, TKEY, hessian_rank=12, **kw)
    dense = repro_torch.run(tp, TKEY, **kw)
    np.testing.assert_allclose(full.xs.numpy(), dense.xs.numpy(), rtol=0,
                               atol=1e-4 * float(dense.xs.abs().max()))
    jr = repro.run(jp, KEY, hessian_rank=12, num_rounds=5, num_regions=4,
                   mu=0.5 * jp.mu)
    assert_xs_close(jr, full, 2e-5)


def test_hessian_rank_rejected_on_the_reference_engine():
    _, tp = problems()
    with pytest.raises(ValueError, match="hessian_rank"):
        repro_torch.run(tp, TKEY, engine="reference", device="cpu",
                        num_rounds=1, hessian_rank=2)


def test_cost_interop_refuses_pod_topology():
    """A pod topology, once refused (ROADMAP item 11), now carries
    across; so does the overlap credit, once refused too (item 12)."""
    c = jcost.with_topology(jcost.uniform_cost(4), pod_bw=[1.0, 2.0],
                            pod_latency=0.5)
    got = carry_cost(c)
    np.testing.assert_array_equal(got.pod_bw.numpy(), [1.0, 2.0])
    assert got.pod_latency == 0.5
    assert carry_cost(jcost.with_overlap_credit(c, 0.5)).overlap_credit \
        == 0.5
