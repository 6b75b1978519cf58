"""repro_torch.run against repro.run on problems carried across with
``repro_torch.interop``: the same arrays and the same key.

Integer traces (coverage, comm_floats, max_stale, tau_star, tau_covered)
and the uniform cost model's round_time/comm_bytes are exactly equal —
the masks come from the same random streams.  Float traces differ by
f32 rounding (batched products, LAPACK paths, the lower vs upper
Cholesky factor), amplified by the conditioning; each test states its
tolerance.  The port's scan engine matches its reference engine at
atol 1e-6, as the reference's own scan and reference engines do."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro  # noqa: E402
from repro.core import make_logistic, make_quadratic  # noqa: E402
from repro.core.masks import PolicyConfig as JPolicy  # noqa: E402
from repro.hetero import cost as jcost  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.masks import PolicyConfig as TPolicy  # noqa: E402
from repro_torch.hetero import cost as tcost  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

KEY = jax.random.PRNGKey(3)
TKEY = interop.key_from_numpy(np.asarray(KEY))


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


def quad():
    return make_quadratic(jax.random.PRNGKey(0), num_workers=8, dim=48,
                          kappa=80.0, coupling=0.0, num_regions=6,
                          grad_noise=0.1, hess_noise=0.1, heterogeneity=0.3)


def logistic():
    return make_logistic(jax.random.PRNGKey(0), num_workers=8, per_worker=64,
                         dim=24, grad_noise=0.1, hess_noise=0.1,
                         heterogeneity=0.3)


def assert_integer_traces_equal(jr, tr):
    for f in ("coverage", "comm_floats", "max_stale", "round_time",
              "comm_bytes"):
        want, got = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tr.tau_star, tr.tau_covered) == (jr.tau_star, jr.tau_covered)


# (problem, options, tolerance on xs relative to max |x|): the dense eigh
# solve amplifies rounding by κ ≈ 80 (quadratic); NS and the diagonal step
# do not re-solve against an ill-conditioned factor
CASES = [
    ("quadratic", dict(), 2e-5),
    ("quadratic", dict(projection="ns", ns_iters="auto"), 2e-6),
    ("quadratic", dict(curvature="diag"), 2e-6),
    ("logistic", dict(), 5e-6),
    ("logistic", dict(projection="ns"), 5e-6),
    ("logistic", dict(curvature="diag"), 5e-6),
]


@pytest.mark.parametrize("kind,kw,tol", CASES, ids=[
    f"{c[0]}-{c[1]}" for c in CASES])
def test_scan_engine_matches_reference_package(kind, kw, tol):
    jp = quad() if kind == "quadratic" else logistic()
    tp = carry(jp)
    opts = dict(num_rounds=12, num_regions=6, **kw)
    for pol in (dict(keep_prob=0.5, tau_star=1),
                dict(name="fixed_k", keep_k=2)):
        jr = repro.run(jp, KEY, options=repro.RanlOptions(
            policy=JPolicy(**pol), **opts))
        tr = repro_torch.run(tp, TKEY, device="cpu",
                             options=repro_torch.RanlOptions(
                                 policy=TPolicy(**pol), **opts))
        assert_integer_traces_equal(jr, tr)
        scale = float(np.abs(np.asarray(jr.xs)).max())
        np.testing.assert_allclose(tr.xs.numpy(), np.asarray(jr.xs),
                                   rtol=0, atol=tol * scale)
        np.testing.assert_allclose(tr.dist_sq.numpy(),
                                   np.asarray(jr.dist_sq), rtol=1e-3,
                                   atol=10 * tol * scale)
        np.testing.assert_allclose(tr.losses.numpy(), np.asarray(jr.losses),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tr.pod_bytes.numpy(),
                                      np.asarray(jr.pod_bytes))


@pytest.mark.parametrize("pol", [
    dict(keep_prob=0.5, tau_star=1, heterogeneous=False),
    dict(name="roundrobin"), dict(name="full"),
    dict(name="staleness", keep_prob=0.6, stale_period=2),
    dict(name="fixed_k", keep_k=2)], ids=str)
def test_port_scan_matches_port_reference_engine(pol):
    tp = carry(quad())
    kw = dict(num_rounds=12, num_regions=6, policy=TPolicy(**pol))
    res = repro_torch.run(tp, TKEY, device="cpu", **kw)
    ref = repro_torch.run(tp, TKEY, device="cpu", engine="reference", **kw)
    np.testing.assert_allclose(res.xs.numpy(), ref.xs.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(res.losses.numpy(), ref.losses.numpy(),
                               rtol=1e-5, atol=1e-6)
    for f in ("coverage", "comm_floats", "max_stale", "round_time",
              "comm_bytes"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    assert (res.tau_star, res.tau_covered) == (ref.tau_star, ref.tau_covered)


def test_reference_engines_match_across_packages():
    jp = quad()
    tp = carry(jp)
    kw = dict(num_rounds=8, num_regions=6)
    jr = repro.run(jp, KEY, engine="reference",
                   policy=JPolicy(keep_prob=0.5, tau_star=1), **kw)
    tr = repro_torch.run(tp, TKEY, device="cpu", engine="reference",
                         policy=TPolicy(keep_prob=0.5, tau_star=1), **kw)
    assert_integer_traces_equal(jr, tr)
    np.testing.assert_allclose(tr.xs.numpy(), np.asarray(jr.xs), rtol=0,
                               atol=2e-5 * float(np.abs(jr.xs).max()))


@pytest.mark.parametrize("curvature", ["dense", "diag"])
def test_use_kernel_flag_is_exact_on_the_host(curvature):
    """On CPU tensors the kernel dispatch takes the plain versions, so the
    kernel and plain paths agree bit for bit."""
    tp = carry(quad())
    kw = dict(num_rounds=10, num_regions=6, curvature=curvature)
    a = repro_torch.run(tp, TKEY, device="cpu", use_kernel=True, **kw)
    b = repro_torch.run(tp, TKEY, device="cpu", use_kernel=False, **kw)
    assert torch.equal(a.xs, b.xs)


def test_diag_converges_on_coordinate_diagonal_problem():
    """The reference's diag pin: linear convergence where the Hutchinson
    diagonal is exact (block size 1)."""
    jp = make_quadratic(jax.random.PRNGKey(0), num_workers=8, dim=32,
                        kappa=50.0, coupling=0.0, num_regions=32)
    res = repro_torch.run(carry(jp), interop.key_from_numpy(
        np.asarray(jax.random.PRNGKey(0))), device="cpu", num_rounds=30,
        num_regions=8, curvature="diag",
        policy=TPolicy(keep_prob=0.5, tau_star=1))
    assert float(res.dist_sq[-1]) < 1e-9 * float(res.dist_sq[0])


def test_record_every_and_zero_rounds_match():
    jp = quad()
    tp = carry(jp)
    for kw in (dict(num_rounds=7, record_every=3), dict(num_rounds=0)):
        jr = repro.run(jp, KEY, num_regions=6, **kw)
        tr = repro_torch.run(tp, TKEY, device="cpu", num_regions=6, **kw)
        assert tr.xs.shape == jr.xs.shape
        assert tr.coverage.shape == jr.coverage.shape
        assert_integer_traces_equal(jr, tr)
        np.testing.assert_allclose(tr.dist_sq.numpy(),
                                   np.asarray(jr.dist_sq), rtol=1e-3,
                                   atol=1e-4)


def test_cost_model_with_availability_matches():
    """Dropout and churn filter the masks with the same draws; the
    simulated round clock agrees."""
    jp = quad()
    tp = carry(jp)
    jc = jcost.with_availability(jcost.uniform_cost(8, rate=2.0,
                                                    bandwidth=1e3),
                                 dropout_prob=0.2, churn_period=3)
    tc = tcost.CostModel(compute_rate=torch.full((8,), 2.0),
                         bandwidth=torch.full((8,), 1e3), dropout_prob=0.2,
                         churn_period=3)
    kw = dict(num_rounds=9, num_regions=6)
    jr = repro.run(jp, KEY, cost=jc, **kw)
    tr = repro_torch.run(tp, TKEY, device="cpu", cost=tc, **kw)
    for f in ("coverage", "comm_floats", "max_stale", "comm_bytes"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)))
    np.testing.assert_allclose(tr.round_time.numpy(),
                               np.asarray(jr.round_time), rtol=1e-6)
    assert (tr.tau_star, tr.tau_covered) == (jr.tau_star, jr.tau_covered)


def test_controller_object_and_default_policy_shim():
    from repro_torch.hetero.controller import PolicyController
    tp = carry(quad())
    pol = TPolicy(name="roundrobin")
    a = repro_torch.run(tp, TKEY, device="cpu", num_rounds=5, num_regions=6,
                        controller=PolicyController(pol))
    b = repro_torch.run(tp, TKEY, device="cpu", num_rounds=5, num_regions=6,
                        policy=pol)
    assert torch.equal(a.xs, b.xs)
    with pytest.raises(TypeError):
        repro_torch.run(tp, TKEY, device="cpu", num_rounds=1,
                        controller=object())
