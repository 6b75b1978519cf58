"""The port's core modules against the reference on identical inputs:
regions, masks (exactly equal), options validation, problem construction
from the same key, the Hessian projections and estimators, server
aggregation and the cost model."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import convex as jconvex  # noqa: E402
from repro.core import hessian as jhess  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import options as jopts  # noqa: E402
from repro.core import regions as jregions  # noqa: E402
from repro.core.aggregation import server_aggregate as j_server_aggregate  # noqa: E402
from repro.hetero import cost as jcost  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.core import convex as tconvex  # noqa: E402
from repro_torch.core import hessian as thess  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import options as topts  # noqa: E402
from repro_torch.core import regions as tregions  # noqa: E402
from repro_torch.core.aggregation import server_aggregate  # noqa: E402
from repro_torch.core.compression import parse_compression, uplink_bytes  # noqa: E402
from repro_torch.hetero import cost as tcost  # noqa: E402
from repro_torch.interop import key_from_numpy  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

KEY = jax.random.PRNGKey(0)
TKEY = key_from_numpy(np.asarray(KEY))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("d,q", [(1, 1), (7, 3), (48, 6), (64, 64),
                                 (100, 7)])
def test_regions_match(d, q):
    ids = tregions.contiguous_regions(d, q, "cpu")
    np.testing.assert_array_equal(_np(ids), np.asarray(
        jregions.contiguous_regions(d, q)))
    np.testing.assert_array_equal(
        _np(tregions.region_sizes(ids, q)),
        np.asarray(jregions.region_sizes(jregions.contiguous_regions(d, q),
                                         q)))
    m = np.random.default_rng(d).random((5, q)) < 0.5
    np.testing.assert_array_equal(
        _np(tregions.expand_mask(torch.as_tensor(m), ids)),
        np.asarray(jregions.expand_mask(jnp.asarray(m),
                                        jregions.contiguous_regions(d, q))))
    with pytest.raises(ValueError):
        tregions.contiguous_regions(d, d + 1, "cpu")


POLICIES = [
    dict(name="bernoulli"),
    dict(name="bernoulli", keep_prob=0.8, tau_star=2),
    dict(name="bernoulli", keep_prob=0.3, heterogeneous=False),
    dict(name="fixed_k", keep_k=2),
    dict(name="fixed_k", keep_k=3, tau_star=1),
    dict(name="roundrobin"),
    dict(name="full"),
    dict(name="staleness", keep_prob=0.6, stale_period=2,
         stale_regions=(0, 3)),
    dict(name="staleness", stale_period=0, tau_star=1),
]


@pytest.mark.parametrize("kw", POLICIES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_sample_masks_exactly_equal(kw):
    jp, tp = jmasks.PolicyConfig(**kw), tmasks.PolicyConfig(**kw)
    for t in (1, 2, 3, 7, 30):
        key = jax.random.fold_in(KEY, t)
        want = jmasks.sample_masks(jp, key, t, 8, 6)
        got = tmasks.sample_masks(tp, key_from_numpy(np.asarray(key)), t,
                                  8, 6, "cpu")
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_worker_keep_probs_exactly_equal():
    for base in (0.2, 0.5, 0.9, 1.0):
        for het in (True, False):
            np.testing.assert_array_equal(
                _np(tmasks.worker_keep_probs(TKEY, 16, base, het, "cpu")),
                np.asarray(jmasks.worker_keep_probs(KEY, 16, base, het)))


@pytest.mark.parametrize("tau", [0, 1, 3, 8])
def test_ensure_coverage_scalar_and_per_region(tau):
    rng = np.random.default_rng(tau)
    for p in (0.1, 0.5):
        m = rng.random((8, 10)) < p
        np.testing.assert_array_equal(
            _np(tmasks.ensure_coverage(torch.as_tensor(m), tau)),
            np.asarray(jmasks.ensure_coverage(jnp.asarray(m), tau)))
        per = rng.integers(0, 12, size=10)
        np.testing.assert_array_equal(
            _np(tmasks.ensure_coverage(torch.as_tensor(m),
                                       torch.as_tensor(per))),
            np.asarray(jmasks.ensure_coverage(jnp.asarray(m),
                                              jnp.asarray(per))))


def test_ensure_coverage_rejects_tau_above_n_and_policy_checks():
    with pytest.raises(ValueError):
        tmasks.ensure_coverage(torch.zeros((4, 3), dtype=torch.bool), 5)
    for bad in (dict(keep_prob=0.0), dict(keep_prob=1.5), dict(keep_k=0),
                dict(stale_period=-1), dict(tau_star=-1)):
        with pytest.raises(ValueError):
            jmasks.PolicyConfig(**bad)
        with pytest.raises(ValueError):
            tmasks.PolicyConfig(**bad)
    with pytest.raises(ValueError):
        tmasks.sample_masks(tmasks.PolicyConfig(name="nope"), TKEY, 1, 2, 2,
                            "cpu")
    with pytest.raises(ValueError):
        tmasks.sample_masks(tmasks.PolicyConfig(name="staleness",
                                                stale_regions=(5,)),
                            TKEY, 1, 2, 2, "cpu")


def test_staleness_weights_match():
    delays = np.array([0, 1, 2, 3, 4, 0, 1])
    for gamma, md in ((0.5, 2), (1.0, 3), (0.0, 2)):
        np.testing.assert_allclose(
            _np(tmasks.staleness_weights(torch.as_tensor(delays), gamma,
                                         md)),
            np.asarray(jmasks.staleness_weights(jnp.asarray(delays), gamma,
                                                md)), rtol=1e-7)


OPTION_CASES = [dict(), dict(num_regions=0), dict(curvature="full"),
                dict(projection="qr"), dict(ns_iters=0), dict(ns_iters="auto"),
                dict(record_every=0), dict(hutchinson_samples=0),
                dict(quorum=0.0), dict(quorum=0.5, quorum_tau=0),
                dict(quorum_tau=2), dict(gamma=1.5), dict(max_delay=0),
                dict(compression="int4"), dict(compression="topk:x"),
                dict(compression="topk:0"), dict(compression="topk:2"),
                dict(hessian_rank=0), dict(hierarchy="pods=2,period=2"),
                dict(hierarchy="pods=0"), dict(hierarchy="period=2"),
                dict(hierarchy="pods=2,gamma=0"),
                dict(hierarchy="pods=2,compression=topk:1"),
                dict(hierarchy="pods=2,bogus=1"), dict(policy="bernoulli")]


@pytest.mark.parametrize("kw", OPTION_CASES, ids=str)
def test_ranl_options_validation_matches(kw):
    """Construction-time checks raise (or pass) exactly as the reference's."""
    def outcome(mod):
        try:
            mod.RanlOptions(**kw)
        except (ValueError, TypeError) as e:
            return type(e)
        return None

    if kw == dict(policy="bernoulli"):
        assert outcome(topts) is TypeError
    else:
        assert outcome(topts) is outcome(jopts)


def test_options_merged_and_specs():
    o = topts.RanlOptions().merged(num_rounds=5, quorum=0.5)
    assert o.num_rounds == 5 and o.quorum_spec() == topts.QuorumSpec(
        quorum=0.5, quorum_tau=None, gamma=0.5, max_delay=2)
    with pytest.raises(TypeError):
        topts.RanlOptions().merged(bogus=1)
    assert topts.parse_hierarchy("pods=2,period=3,gamma=0.5") == \
        topts.HierarchySpec(pods=2, period=3, gamma=0.5)
    assert topts.parse_hierarchy(None) is None
    assert parse_compression("topk:3").k == 3
    assert topts.RanlOptions(compression="int8").compression_spec().kind \
        == "int8"


def test_uplink_bytes_uncompressed():
    m = np.random.default_rng(0).random((5, 4)) < 0.5
    sizes = np.array([3, 3, 2, 2], np.int32)
    from repro.core.compression import uplink_bytes as j_uplink
    np.testing.assert_array_equal(
        _np(uplink_bytes(None, torch.as_tensor(m), torch.as_tensor(sizes))),
        np.asarray(j_uplink(None, jnp.asarray(m), jnp.asarray(sizes))))


# ---------------------------------------------------------------- problems

@pytest.mark.parametrize("coupling", [0.0, 0.5, 1.0])
def test_make_quadratic_arrays_match(coupling):
    """Same key, same draws: b within the normals' few ulp, A and x*
    within f32 rounding of the QR, einsum and solve (rtol 1e-4), μ and
    L_g within 1e-4 relative."""
    kw = dict(num_workers=4, dim=24, kappa=50.0, heterogeneity=0.5,
              coupling=coupling, num_regions=4)
    jp = jconvex.make_quadratic(KEY, **kw)
    tp = tconvex.make_quadratic(TKEY, device="cpu", **kw)
    np.testing.assert_allclose(_np(tp.A), np.asarray(jp.A), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(tp.b), np.asarray(jp.b), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tp.x_star), np.asarray(jp.x_star),
                               rtol=1e-4, atol=1e-4)
    assert tp.mu == pytest.approx(jp.mu, rel=1e-4)
    assert tp.L_g == pytest.approx(jp.L_g, rel=1e-4)


def test_make_quadratic_worker_weights_match():
    w = np.array([0.5, 1.0, 1.5, 1.0])
    jp = jconvex.make_quadratic(KEY, num_workers=4, dim=16, heterogeneity=0.3,
                                worker_weights=w)
    tp = tconvex.make_quadratic(TKEY, num_workers=4, dim=16,
                                heterogeneity=0.3, worker_weights=w,
                                device="cpu")
    np.testing.assert_allclose(_np(tp.b), np.asarray(jp.b), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError):
        tconvex.make_quadratic(TKEY, num_workers=4, dim=16,
                               worker_weights=[1.0], device="cpu")


def test_make_logistic_arrays_match():
    """X, y equal (the same normal draws, ≤ 4 ulp); x* from 30 Newton
    steps with the analytic Hessian within 1e-4 of autodiff's."""
    kw = dict(num_workers=4, per_worker=64, dim=12, heterogeneity=0.5)
    jp = jconvex.make_logistic(KEY, **kw)
    tp = tconvex.make_logistic(TKEY, device="cpu", **kw)
    np.testing.assert_allclose(_np(tp.X), np.asarray(jp.X), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(_np(tp.y), np.asarray(jp.y))
    np.testing.assert_allclose(_np(tp.x_star), np.asarray(jp.x_star),
                               rtol=1e-4, atol=1e-5)
    assert tp.mu == pytest.approx(jp.mu, rel=1e-4)
    assert tp.L_g == pytest.approx(jp.L_g, rel=1e-4)
    np.testing.assert_allclose(_np(tp.mean_hessian()),
                               np.asarray(jp.mean_hessian()), rtol=1e-4,
                               atol=1e-6)


def _pair(kind, **noise):
    if kind == "quadratic":
        jp = jconvex.make_quadratic(KEY, num_workers=4, dim=16, kappa=20.0,
                                    heterogeneity=0.3, **noise)
        tp = tconvex.Quadratic(A=torch.tensor(np.asarray(jp.A)),
                               b=torch.tensor(np.asarray(jp.b)),
                               x_star=torch.tensor(np.asarray(jp.x_star)),
                               grad_noise=jp.grad_noise,
                               hess_noise=jp.hess_noise, mu=jp.mu, L_g=jp.L_g)
    else:
        jp = jconvex.make_logistic(KEY, num_workers=4, per_worker=32, dim=16,
                                   **noise)
        tp = tconvex.Logistic(X=torch.tensor(np.asarray(jp.X)),
                              y=torch.tensor(np.asarray(jp.y)),
                              x_star=torch.tensor(np.asarray(jp.x_star)),
                              lam=jp.lam, grad_noise=jp.grad_noise,
                              hess_noise=jp.hess_noise, mu=jp.mu, L_g=jp.L_g)
    return jp, tp


@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
def test_oracles_match_with_noise(kind):
    """Gradients, Hessians (with the per-row symmetric noise streams) and
    losses agree to f32 rounding (rtol 1e-5, atol 1e-6)."""
    jp, tp = _pair(kind, grad_noise=0.3, hess_noise=0.5)
    x = np.random.default_rng(1).normal(size=16).astype(np.float32)
    keys = jax.random.split(KEY, 4)
    tkeys = np.asarray(keys)
    for i in range(4):
        np.testing.assert_allclose(
            _np(tp.worker_grad(i, torch.as_tensor(x), tkeys[i])),
            np.asarray(jp.worker_grad(i, jnp.asarray(x), keys[i])),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            _np(tp.worker_hessian(i, torch.as_tensor(x), tkeys[i])),
            np.asarray(jp.worker_hessian(i, jnp.asarray(x), keys[i])),
            rtol=1e-5, atol=1e-6)
    xs = np.stack([x, 0 * x, 2 * x])
    np.testing.assert_allclose(
        _np(tp.worker_grads(torch.as_tensor(np.stack([x] * 4)), tkeys)),
        np.stack([np.asarray(jp.worker_grad(i, jnp.asarray(x), keys[i]))
                  for i in range(4)]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(tp.losses(torch.as_tensor(xs))),
        np.asarray(jax.vmap(jp.loss)(jnp.asarray(xs))), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- hessian

def _sym(seed, d, shift=0.0):
    a = np.random.default_rng(seed).normal(size=(d, d)).astype(np.float32)
    return (a + a.T) / 2 + shift * np.eye(d, dtype=np.float32)


@pytest.mark.parametrize("d,mu", [(8, 0.5), (24, 1.0), (48, 0.1)])
def test_project_psd_and_ns_match(d, mu):
    a = _sym(d, d)
    want = np.asarray(jhess.project_psd(jnp.asarray(a), mu))
    got = _np(thess.project_psd(torch.as_tensor(a), mu))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    for iters in (60, "auto"):
        np.testing.assert_allclose(
            _np(thess.project_psd_ns(torch.as_tensor(a), mu,
                                     num_iters=iters)),
            np.asarray(jhess.project_psd_ns(jnp.asarray(a), mu,
                                            num_iters=iters)),
            rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        _np(thess.project_psd_ns(torch.as_tensor(a), mu, tol=1e-6)),
        np.asarray(jhess.project_psd_ns(jnp.asarray(a), mu, tol=1e-6)),
        rtol=1e-4, atol=1e-4)
    assert thess.ns_auto_iters(d) == jhess.ns_auto_iters(d)
    assert thess.resolve_ns_iters("auto", d) == jhess.resolve_ns_iters(
        "auto", d)


def test_solve_projected_and_project_diag_match():
    a = _sym(3, 16, shift=20.0)
    g = np.random.default_rng(4).normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        _np(thess.solve_projected(torch.as_tensor(a), torch.as_tensor(g))),
        np.asarray(jhess.solve_projected(jnp.asarray(a), jnp.asarray(g))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        _np(thess.project_diag(torch.as_tensor(g), 0.1)),
        np.asarray(jhess.project_diag(jnp.asarray(g), 0.1)))


@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
def test_hutchinson_and_running_mean_hessian_match(kind):
    jp, tp = _pair(kind, grad_noise=0.1, hess_noise=0.2)
    keys = jax.random.split(KEY, 4)
    wid = jnp.arange(4)

    def jgrad(x):
        return jax.vmap(jp.worker_grad, in_axes=(0, None, 0))(
            wid, x, keys).mean(axis=0)

    def tgrad(x):
        return tp.worker_grads(x.expand(4, 16), np.asarray(keys)).sum(0) / 4

    x0 = np.zeros(16, np.float32)
    k2 = jax.random.fold_in(KEY, 2)
    np.testing.assert_allclose(
        _np(thess.hutchinson_diag(tgrad, torch.as_tensor(x0),
                                  np.asarray(k2), num_samples=8)),
        np.asarray(jhess.hutchinson_diag(jgrad, jnp.asarray(x0), k2,
                                         num_samples=8)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(thess.running_mean_hessian(tp, torch.as_tensor(x0),
                                       np.asarray(keys))),
        np.asarray(jhess.running_mean_hessian(jp, jnp.asarray(x0), keys)),
        rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- aggregation, cost

@pytest.mark.parametrize("n,d", [(1, 1), (3, 17), (8, 64)])
def test_server_aggregate_matches(n, d):
    rng = np.random.default_rng(n * d)
    m = rng.random((n, d)) < 0.4
    g = (rng.normal(size=(n, d)) * m).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    want = j_server_aggregate(jnp.asarray(g), jnp.asarray(m), jnp.asarray(c))
    for use_kernel in (False, True):
        got = server_aggregate(torch.as_tensor(g), torch.as_tensor(m),
                               torch.as_tensor(c), use_kernel=use_kernel)
        np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))


def test_cost_model_matches():
    """Availability (dropout draws, churn), capacity and per-worker times
    equal the reference's; time_to_target reads the same schedule."""
    N = 8
    jc = jcost.with_availability(jcost.uniform_cost(N, rate=2.0,
                                                    bandwidth=100.0),
                                 dropout_prob=0.3, churn_period=2,
                                 diurnal_period=5, diurnal_amplitude=0.5)
    tc = tcost.CostModel(compute_rate=torch.full((N,), 2.0),
                         bandwidth=torch.full((N,), 100.0), dropout_prob=0.3,
                         churn_period=2, diurnal_period=5,
                         diurnal_amplitude=0.5)
    work = np.arange(N, dtype=np.int32) * 3
    for t in range(1, 7):
        kt = jax.random.fold_in(KEY, t)
        np.testing.assert_array_equal(
            _np(tcost.available(tc, np.asarray(kt), t)),
            np.asarray(jcost.available(jc, kt, t)))
        np.testing.assert_allclose(_np(tcost.capacity(tc, t)),
                                   np.asarray(jcost.capacity(jc, t)),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            _np(tcost.worker_times(tc, torch.as_tensor(work), t)),
            np.asarray(jcost.worker_times(jc, jnp.asarray(work), t)),
            rtol=1e-6)
    u = tcost.uniform_cost(N, "cpu")
    assert float(tcost.round_time(u, torch.as_tensor(work), 1)) == \
        float(jcost.round_time(jcost.uniform_cost(N), jnp.asarray(work), 1))
    trace = np.array([5.0, 4.0, 3.0, 2.0, 1.0, 0.5])
    rt_ = np.array([1.0, 2.0, 3.0, 4.0])
    for k, target in ((1, 1.0), (2, 0.5), (1, 0.1)):
        tr = trace if k == 1 else trace[[0, 1, 3, 5]]
        assert tcost.time_to_target(tr, rt_, target, record_every=k) == \
            jcost.time_to_target(tr, rt_, target, record_every=k)
    with pytest.raises(ValueError):
        tcost.time_to_target(trace[:3], rt_, 1.0)
