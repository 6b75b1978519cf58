"""The round options of ``repro_torch.run`` against ``repro.run``, part
two: quorum rounds (the split, the late fold, the runs) and the
low-rank [H]_μ init.  Problems, comparisons and tolerances in
``_torch_options_helpers``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import make_quadratic  # noqa: E402
from repro.hetero import cost as jcost  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.hetero import cost as tcost  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from _torch_options_helpers import (  # noqa: E402
    KEY, TKEY, agg_inputs, carry, carry_cost, problems,
    assert_traces_equal, assert_xs_close, both)
from _torch_threads import one_torch_thread  # noqa: E402, F401


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
    G, Mx, C, _, on, delays, late, _ = agg_inputs(seed, max_delay=max_delay)
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
    G, Mx, C, _, on, _, _, _ = agg_inputs(5)
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
    G, Mx, C, _, on, delays, late, _ = agg_inputs(6, max_delay=1)
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
