"""The batch engine, the baselines and the stacked-key PRNG of the port
against the reference package.

* stacked keys: ``split``/``fold_in``/``bits``/``uniform`` on (B, 2)
  keys equal ``jax.vmap`` of the single-key calls bit for bit, and seed
  b's draws equal the single-key draws bit for bit; ``normal`` within
  4 ulp of the reference's (ROADMAP Queue 3);
* masks over stacked keys equal each key's own, for every policy;
* ``engine="batch"`` against the reference's batch engine (its K2 runs
  in interpret mode inside vmap, as the reference's own tests run it):
  integer traces exact, xs within 1e-4 relative — what the reference's
  own batch-vs-scan agreement reaches (``tests/test_core_ranl.py`` holds
  it to 2e-4), and
  2e-2 with int8 uplinks (one quantization step, see
  ``_torch_options_helpers``); and row b against the port's scan run on key
  b;
* the baselines (GD, SGD, Newton-exact, Newton-zero) within 2e-5·max|x|,
  ``rounds_to_tol`` equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import make_logistic, make_quadratic  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.hetero import scenarios as jscen  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop, prng  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

KEY = jax.random.PRNGKey(3)
KEYS = jax.random.split(KEY, 4)
TKEYS = np.asarray(KEYS)
BATCH_RTOL = 1e-4


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
         "bandwidth": np.asarray(c.bandwidth)}, statics, device="cpu")


_PROBLEMS = {}


def problems(kind="quadratic"):
    if kind not in _PROBLEMS:
        if kind == "quadratic":
            jp = make_quadratic(jax.random.PRNGKey(0), num_workers=8, dim=32,
                                kappa=50.0, coupling=0.0, num_regions=4,
                                grad_noise=0.1, hess_noise=0.1,
                                heterogeneity=0.3)
        else:
            jp = make_logistic(jax.random.PRNGKey(0), num_workers=6,
                               per_worker=48, dim=20, grad_noise=0.1,
                               heterogeneity=0.3)
        _PROBLEMS[kind] = (jp, carry(jp))
    return _PROBLEMS[kind]


# --------------------------------------------------------------------------
# stacked keys
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 3, 8])
def test_split_and_fold_in_over_stacked_keys(b):
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    tk = np.asarray(keys)
    for num in (2, 5):
        want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(keys))
        np.testing.assert_array_equal(prng.split(tk, num), want)
    for data in (0, 7, 2**31 + 5):
        want = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, data))(
            keys))
        np.testing.assert_array_equal(prng.fold_in(tk, data), want)


@pytest.mark.parametrize("shape", [(), (5,), (3, 7)])
@pytest.mark.parametrize("b", [1, 4])
def test_draws_over_stacked_keys_equal_each_keys_own(shape, b):
    """One pass over a (B, ...) counter: seed b's bits, uniforms and
    normals are exactly the single-key draws, and the reference's vmap
    (normals within 4 ulp)."""
    keys = jax.random.split(jax.random.PRNGKey(11), b)
    tk = np.asarray(keys)
    bits = prng.bits(tk, shape, "cpu")
    uni = prng.uniform(tk, shape, "cpu", minval=-0.3, maxval=2.0)
    nor = prng.normal(tk, shape, "cpu")
    assert tuple(bits.shape) == (b,) + shape
    want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, shape, minval=-0.3, maxval=2.0))(keys))
    want_n = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape))(
        keys))
    np.testing.assert_array_equal(uni.numpy(), want_u)
    np.testing.assert_allclose(nor.numpy(), want_n, rtol=4 * 2.0 ** -23,
                               atol=1e-7)
    for i in range(b):
        assert torch.equal(bits[i], prng.bits(tk[i], shape, "cpu"))
        assert torch.equal(uni[i], prng.uniform(tk[i], shape, "cpu",
                                                minval=-0.3, maxval=2.0))
        assert torch.equal(nor[i], prng.normal(tk[i], shape, "cpu"))


POLICIES = [dict(keep_prob=0.5, tau_star=1), dict(name="fixed_k", keep_k=2),
            dict(name="roundrobin"), dict(name="full"),
            dict(name="staleness", keep_prob=0.6, stale_period=2),
            dict(keep_prob=0.3, heterogeneous=False, tau_star=2)]


@pytest.mark.parametrize("pol", POLICIES, ids=str)
@pytest.mark.parametrize("t", [1, 4])
def test_masks_over_stacked_keys(pol, t):
    """sample_masks on (B, 2) keys draws every seed in one pass and equals
    the reference's masks key by key."""
    got = tmasks.sample_masks(tmasks.PolicyConfig(**pol), TKEYS, t, 8, 6,
                              "cpu")
    assert tuple(got.shape) == (4, 8, 6)
    for i in range(4):
        want = jmasks.sample_masks(jmasks.PolicyConfig(**pol), KEYS[i], t,
                                   8, 6)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the batch engine
# --------------------------------------------------------------------------

def assert_batch_equal(jr, tr, rtol=BATCH_RTOL):
    for f in ("coverage", "comm_floats", "max_stale", "comm_bytes",
              "tau_star", "tau_covered", "round_time"):
        want, got = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    want = np.asarray(jr.xs)
    np.testing.assert_allclose(tr.xs.numpy(), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


BATCH_CASES = [
    ("quadratic", dict()),
    ("quadratic", dict(curvature="diag")),
    ("quadratic", dict(projection="ns", ns_iters="auto")),
    ("logistic", dict()),
    ("logistic", dict(curvature="diag")),
    ("quadratic", dict(quorum=0.75, max_delay=2)),
    ("quadratic", dict(compression="topk:2")),
    ("quadratic", dict(hessian_rank=2)),
    ("logistic", dict(curvature="diag", compression="int8")),
]


@pytest.mark.parametrize("kind,kw", BATCH_CASES,
                         ids=[f"{k}-{kw}" for k, kw in BATCH_CASES])
def test_batch_engine_matches_reference_batch(kind, kw):
    """Dense and diag (K2 inside the reference's vmap), with options:
    integer traces exact over the seed axis, xs within 1e-4 relative."""
    jp, tp = problems(kind)
    opts = dict(num_rounds=6, num_regions=4, **kw)
    jr = repro.run(jp, KEYS, engine="batch", **opts)
    tr = repro_torch.run(tp, TKEYS, engine="batch", device="cpu", **opts)
    assert tuple(tr.xs.shape) == (4, 8, tp.dim)
    assert tuple(tr.coverage.shape) == (4, 6)
    assert tr.tau_star.dtype == torch.int32
    rtol = 2e-2 if kw.get("compression") == "int8" else BATCH_RTOL
    assert_batch_equal(jr, tr, rtol)


@pytest.mark.parametrize("kind,curvature", [("quadratic", "dense"),
                                            ("quadratic", "diag"),
                                            ("logistic", "dense")])
def test_batch_rows_equal_scan_runs(kind, curvature):
    """Row b of a batch run is the scan run on key b: the same masks and
    traces; xs within 1e-4 relative (B columns in one product)."""
    _, tp = problems(kind)
    opts = dict(num_rounds=7, num_regions=4, curvature=curvature,
                device="cpu",
                policy=tmasks.PolicyConfig(keep_prob=0.5, tau_star=1))
    bat = repro_torch.run(tp, TKEYS, engine="batch", **opts)
    for b in range(4):
        one = repro_torch.run(tp, TKEYS[b], **opts)
        for f in ("coverage", "comm_floats", "max_stale", "round_time",
                  "comm_bytes"):
            assert torch.equal(getattr(bat, f)[b], getattr(one, f)), f
        assert (int(bat.tau_star[b]), int(bat.tau_covered[b])) == (
            one.tau_star, one.tau_covered)
        np.testing.assert_allclose(
            bat.xs[b].numpy(), one.xs.numpy(), rtol=0,
            atol=BATCH_RTOL * float(one.xs.abs().max()))


@pytest.mark.parametrize("spec", ["resource", "staleness-bounded:s=2",
                                  "quorum:q=0.75,inner=resource;keep=0.5"])
@pytest.mark.parametrize("scenario", ["pareto-stragglers", "dropout",
                                      "churn-stragglers"])
def test_closed_loop_batch_engine(spec, scenario):
    """Each seed carries its own controller state and telemetry; the
    controllers step all seeds at once on the stacked keys."""
    jp, tp = problems()
    jc = jscen.make_scenario(scenario, jax.random.PRNGKey(9), 8).cost
    opts = dict(num_rounds=6, num_regions=4)
    jr = repro.run(jp, KEYS, engine="batch", controller=spec, cost=jc,
                   **opts)
    tr = repro_torch.run(tp, TKEYS, engine="batch", controller=spec,
                         cost=carry_cost(jc), device="cpu", **opts)
    assert_batch_equal(jr, tr)


def test_batch_record_every_and_zero_rounds():
    jp, tp = problems()
    for kw in (dict(num_rounds=7, record_every=3), dict(num_rounds=0)):
        jr = repro.run(jp, KEYS, engine="batch", num_regions=4, **kw)
        tr = repro_torch.run(tp, TKEYS, engine="batch", device="cpu",
                             num_regions=4, **kw)
        assert tr.xs.shape == jr.xs.shape
        assert tr.coverage.shape == jr.coverage.shape
        assert tr.dist_sq.shape == jr.dist_sq.shape
        assert_batch_equal(jr, tr)


def test_batch_takes_stacked_keys_and_scan_one():
    _, tp = problems()
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        repro_torch.run(tp, TKEYS[0], engine="batch", device="cpu",
                        num_rounds=1)
    with pytest.raises(ValueError, match=r"\(2,\)"):
        repro_torch.run(tp, TKEYS, device="cpu", num_rounds=1)


def test_batch_reads_the_problem_once_a_round():
    """The oracle takes all B seeds in one product: (B, N, d) iterates and
    (B, N, 2) keys give each seed's (N, d) gradients."""
    _, tp = problems()
    rng = np.random.default_rng(0)
    xs = torch.tensor(rng.normal(size=(3, 8, 32)).astype(np.float32))
    keys = prng.split(TKEYS[:3], 8)
    got = tp.worker_grads(xs, keys)
    assert got.is_contiguous()
    for b in range(3):
        torch.testing.assert_close(got[b], tp.worker_grads(xs[b], keys[b]),
                                   rtol=1e-5, atol=1e-6)
    _, lp = problems("logistic")
    xs = torch.tensor(rng.normal(size=(2, 6, 20)).astype(np.float32))
    keys = prng.split(TKEYS[:2], 6)
    got = lp.worker_grads(xs, keys)
    for b in range(2):
        torch.testing.assert_close(got[b], lp.worker_grads(xs[b], keys[b]),
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# baselines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["run_gd", "run_sgd", "run_newton_exact",
                                  "run_newton_zero"])
@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
def test_baselines_match_reference(name, kind):
    jp, tp = problems(kind)
    k = jax.random.PRNGKey(5)
    xj, dj = getattr(jbase, name)(jp, k, num_rounds=8)
    xt, dt = getattr(tbase, name)(tp, np.asarray(k), num_rounds=8)
    assert tuple(xt.shape) == tuple(np.shape(xj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=2e-5 * float(np.abs(np.asarray(xj)).max()))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-3,
                               atol=1e-6)
    for tol in (1e-1, 1e-3, 1e-9):
        assert tbase.rounds_to_tol(dt, tol) == jbase.rounds_to_tol(dj, tol)


def test_ranl_full_mask_matches_newton_zero():
    """The reference's pin: RANL with full masks has Newton-zero's init
    step (same seeds), and both settle at the same stochastic floor."""
    jp = make_quadratic(jax.random.PRNGKey(0), num_workers=8, dim=32,
                        kappa=50.0, hess_noise=0.1, grad_noise=0.05)
    tp, k = carry(jp), np.asarray(jax.random.PRNGKey(0))
    d = repro_torch.run(tp, k, device="cpu", num_rounds=10, num_regions=4,
                        policy=tmasks.PolicyConfig(name="full")).dist_sq
    _, dz = tbase.run_newton_zero(tp, k, num_rounds=10)
    np.testing.assert_allclose(float(d[1]), float(dz[1]), rtol=1e-5)
    assert float(d[-1]) < 1e-4 * float(d[0])
    assert float(dz[-1]) < 1e-4 * float(dz[0])


def test_rounds_to_tol_edges():
    d = torch.tensor([5.0, 1.0, 0.1, 0.01])
    assert tbase.rounds_to_tol(d, 0.5) == 2
    assert tbase.rounds_to_tol(d, 1e-9) == 3
    assert tbase.rounds_to_tol(d, 10.0) == 0
    assert jbase.rounds_to_tol(jnp.asarray(d.numpy()), 0.5) == 2
