"""The round options of ``repro_torch.run`` against ``repro.run``, part
three: cost models, the cluster scenarios and the closed-loop
controllers.  Problems, comparisons and tolerances in
``_torch_options_helpers``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro  # noqa: E402
from repro.core import make_logistic  # noqa: E402
from repro.core.masks import PolicyConfig as JPolicy  # noqa: E402
from repro.hetero import controller as jctrl  # noqa: E402
from repro.hetero import cost as jcost  # noqa: E402
from repro.hetero import scenarios as jscen  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core.masks import PolicyConfig as TPolicy  # noqa: E402
from repro_torch.core.masks import ensure_coverage  # noqa: E402
from repro_torch.hetero import controller as tctrl  # noqa: E402
from repro_torch.hetero import cost as tcost  # noqa: E402
from repro_torch.hetero import scenarios as tscen  # noqa: E402
from _torch_options_helpers import (  # noqa: E402
    TKEY, carry, carry_cost, problems, assert_traces_equal, assert_xs_close,
    both)
from _torch_threads import one_torch_thread  # noqa: E402, F401


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
