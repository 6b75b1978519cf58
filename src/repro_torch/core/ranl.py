"""RANL engines — Algorithm 1 on one device, eager PyTorch.

Round 0 (init): workers send stochastic local gradients and Hessians at x⁰;
the server aggregates H = mean ∇²F_i(x⁰, ξ⁰), projects [H]_μ (Definition 4),
seeds the memory C_i^{0,q} = ∇F_i^q(x⁰, ξ⁰), and takes one unpruned Newton
step.  Rounds t ≥ 1: workers draw masks m_i^t ~ P, train pruned sub-models
x_i = x ⊙ m_i, send pruned gradients; the server aggregates per region with
memory fallback and updates x^{t+1} = x^t − [H]_μ^{-1} ∇F^t.

Two engines, as in the reference:

* ``_run_scan`` (engine ``"scan"``): the init phase with all N worker
  gradients in one batched product and the Cholesky factor of [H]_μ
  computed once; then a Python loop over rounds.  With ``use_kernel``
  (the default) each round's aggregation goes to the hand-written
  kernels: ``region_aggregate`` before the dense Cholesky step, and the
  fused aggregate + diagonal Newton step ``ranl_update`` for
  ``curvature="diag"``;
* ``_run_reference`` (engine ``"reference"``): the host-loop oracle —
  per-worker init gradients, plain aggregation, a fresh factorization of
  [H]_μ every round.  Dense ``eigh`` curvature only.

Keys are host-side (``repro_torch.prng``) and reproduce the reference's
streams, so masks, coverage, ``comm_floats`` and the coverage minima equal
the reference's exactly.  Per-round traces stay on the device and are
stacked after the loop; only ``tau_star``/``tau_covered`` become Python
ints, once.  This slice carries the flat, synchronous, uncompressed
round; quorum, compression and hierarchy rounds arrive with ROADMAP
Queue 1 items 9–11.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace

import numpy as np
import torch

from .. import prng
from ..kernels import ops as kernel_ops
from .aggregation import server_aggregate
from .compression import uplink_bytes
from .hessian import cho_factor, cho_solve, hutchinson_diag, project_diag, \
    project_psd, project_psd_ns, running_mean_hessian, solve_projected
from .options import RanlOptions
from .regions import contiguous_regions, expand_mask, region_sizes

_F32 = torch.float32


@dataclass
class RanlResult:
    xs: torch.Tensor           # (T+2, d) iterates (x⁰ is row 0 ... x^{T+1})
    dist_sq: torch.Tensor      # (T+2,) ‖x^t − x*‖²
    losses: torch.Tensor       # (T+2,)
    coverage: torch.Tensor     # (T,) fraction of regions covered per round
    comm_floats: torch.Tensor  # (T,) int32 uplink floats transmitted
    tau_star: int              # min worker coverage over rounds/regions
                               # (0 if any region went uncovered)
    tau_covered: int = 0       # min coverage over COVERED regions only
    round_time: torch.Tensor = None   # (T,) simulated wall-clock per round
    max_stale: torch.Tensor = None    # (T,) int32 max region staleness
    comm_bytes: torch.Tensor = None   # (T,) modeled uplink bytes
    pod_bytes: torch.Tensor = None    # (T,) inter-pod bytes (0: flat runs)
    xs_pods: torch.Tensor = None      # hierarchical runs only


def _init_phase(problem, k_init, *, mu: float, lr: float, curvature: str,
                hutch_samples: int, projection: str = "eigh",
                ns_iters=60):
    """Alg. 1 lines 1–8.  Returns (x1, C0, chol, hdiag): the post-init
    iterate, the seeded gradient memory, and the curvature state — the
    lower Cholesky factor of [H]_μ (dense) or the Hutchinson diagonal
    (diag); the unused one is None."""
    N, d = problem.num_workers, problem.dim
    x0 = torch.zeros(d, dtype=_F32, device=problem.device)
    hkeys = prng.split(prng.fold_in(k_init, 0), N)
    gkeys = prng.split(prng.fold_in(k_init, 1), N)
    g0 = problem.worker_grads(x0.expand(N, d), gkeys)       # (N, d)
    g0_mean = g0.sum(dim=0) / N

    if curvature == "dense":
        # eager left-to-right fold: the reference's summation order
        H = running_mean_hessian(problem, x0, hkeys)
        if projection == "ns":
            h_mu = project_psd_ns(H, mu, num_iters=ns_iters)
        else:
            h_mu = project_psd(H, mu)
        chol, hdiag = cho_factor(h_mu), None
        step0 = cho_solve(chol, g0_mean)
    elif curvature == "diag":
        def mean_grad(xx):
            return problem.worker_grads(xx.expand(N, d), gkeys).sum(
                dim=0) / N

        hdiag = hutchinson_diag(mean_grad, x0, prng.fold_in(k_init, 2),
                                num_samples=hutch_samples)
        chol = None
        step0 = g0_mean / project_diag(hdiag, mu)
    else:
        raise ValueError(f"unknown curvature {curvature!r}")
    return x0 - lr * step0, g0, chol, hdiag


def _round_diagnostics(covered_q, count_q, n_workers: int):
    """Per-round (coverage_mean, min_count, min_covered_count): the raw
    count minimum feeds ``tau_star``; uncovered regions map to N in the
    second, which feeds ``tau_covered``.  The mean is the sum times the
    f32 reciprocal of Q, which is how the reference's mean evaluates."""
    inv_q = float(np.float32(1.0) / np.float32(covered_q.shape[0]))
    return (covered_q.to(_F32).sum() * inv_q, count_q.min(),
            torch.where(covered_q, count_q,
                        torch.full_like(count_q, n_workers)).min())


def _tau_pair(min_counts, min_cov_counts, n_workers: int):
    """Cap the over-rounds minima at N -> (tau_star, tau_covered) ints."""
    tau = torch.stack([min_counts.min(), min_cov_counts.min()])
    return tuple(min(n_workers, v) for v in tau.tolist())


def _trace_row(Mx, count_q, telem, ubytes, n_workers: int):
    """One round's device-side trace entries: (coverage, comm_floats,
    min_count, min_covered_count, round_time, max_stale, comm_bytes)."""
    cov_mean, min_count, min_cov_count = _round_diagnostics(
        count_q > 0, count_q, n_workers)
    return (cov_mean, Mx.sum().to(torch.int32), min_count, min_cov_count,
            telem.times.max(), telem.stale_q.max(), ubytes.sum())


def _stack_rows(rows, n_workers: int, device):
    """Per-round rows -> (cov, comm, tau, tau_cov, times, stale, cbytes),
    with the two coverage minima as Python ints (the run's one sync)."""
    if not rows:
        empty_f = torch.zeros((0,), dtype=_F32, device=device)
        empty_i = torch.zeros((0,), dtype=torch.int32, device=device)
        return (empty_f, empty_i, n_workers, n_workers, empty_f, empty_i,
                empty_f)
    cov, comm, min_counts, min_cov_counts, times, stale, cbytes = (
        torch.stack(col) for col in zip(*rows))
    tau, tau_cov = _tau_pair(min_counts, min_cov_counts, n_workers)
    return cov, comm, tau, tau_cov, times, stale, cbytes


def _controller_mask(controller, cost, ctrl_state, telem, kt, t: int,
                     num_workers: int, num_regions: int, device):
    """One controller step + the cost model's availability filter (no
    draws at all when the cost model has no dropout or churn)."""
    from ..hetero.cost import available
    M, ctrl_state = controller.step(ctrl_state, telem, kt, t, num_workers,
                                    num_regions, device)
    if cost.dropout_prob > 0.0 or cost.churn_period > 0:
        M = M & available(cost, kt, t)[:, None]
    return M, ctrl_state


def _observe_round(cost, telem, M_full, count_q, sizes_q, t: int,
                   ubytes=None):
    """Fold one round's observations into the telemetry."""
    from ..hetero.controller import next_telemetry
    from ..hetero.cost import worker_times
    work = (M_full * sizes_q[None, :]).sum(dim=1).to(torch.int32)
    times = worker_times(cost, work, t, ubytes)
    return next_telemetry(telem, count_q, work, times)


def _hetero_defaults(problem, policy, controller, cost):
    """Resolve (controller, cost): wrap a PolicyConfig in the shim when no
    controller is given; default to the uniform cost model."""
    from ..hetero.controller import as_controller
    from ..hetero.cost import uniform_cost
    ctrl = as_controller(policy if controller is None else controller)
    if cost is None:
        cost = uniform_cost(problem.num_workers, problem.device)
    for name in ("compute_rate", "bandwidth"):
        t = getattr(cost, name)
        if t.device != problem.device:
            raise ValueError(f"cost.{name} is on {t.device}, the problem "
                             f"on {problem.device}")
    return ctrl, cost


def _scan_rounds(problem, k_loop, x1, C0, chol, hdiag, cost, *,
                 num_rounds: int, num_regions: int, controller, mu: float,
                 lr: float, curvature: str, use_kernel: bool):
    """Alg. 1 lines 9–23 as a Python loop over rounds; returns (xs, dist,
    losses, cov, comm, tau, tau_cov, times, stale, cbytes, pbytes)."""
    from ..hetero.controller import initial_telemetry
    N, d, dev = problem.num_workers, problem.dim, problem.device
    Q = num_regions
    region_ids = contiguous_regions(d, Q, dev)
    sizes_q = region_sizes(region_ids, Q)
    x, C = x1, C0
    ctrl_state = controller.init_state(N, Q)
    telem = initial_telemetry(N, Q, dev)
    xs = [torch.zeros(d, dtype=_F32, device=dev), x1]
    rows = []
    for t in range(1, num_rounds + 1):
        kt = prng.fold_in(k_loop, t)
        M, ctrl_state = _controller_mask(controller, cost, ctrl_state,
                                         telem, kt, t, N, Q, dev)  # (N, Q)
        Mx = expand_mask(M, region_ids)                  # (N, d) bool
        x_pruned = torch.where(Mx, x[None, :], 0.0)      # x ⊙ m_i
        gk = prng.split(prng.fold_in(kt, 7), N)
        G = problem.worker_grads(x_pruned, gk) * Mx      # ∇F_i ⊙ m_i
        ubytes = uplink_bytes(None, M, sizes_q)          # (N,) wire model
        if curvature == "diag" and use_kernel:
            x, C = kernel_ops.ranl_update(x, hdiag, G, Mx, C, mu=mu, lr=lr)
        else:
            # dense rounds aggregate through the region_aggregate kernel
            # (the reference's dense branch always takes its jnp form)
            g, C = server_aggregate(G, Mx, C, use_kernel=use_kernel)
            if curvature == "dense":
                step = cho_solve(chol, g)
            else:
                step = g / project_diag(hdiag, mu)
            x = x - lr * step
        count_q = M.sum(dim=0).to(torch.int32)
        telem = _observe_round(cost, telem, M, count_q, sizes_q, t, ubytes)
        xs.append(x)
        rows.append(_trace_row(Mx, count_q, telem, ubytes, N))
    xs = torch.stack(xs)
    cov, comm, tau, tau_cov, times, stale, cbytes = _stack_rows(rows, N, dev)
    pbytes = torch.zeros_like(cbytes)
    dist = ((xs - problem.x_star[None, :]) ** 2).sum(dim=1)
    losses = problem.losses(xs)
    return (xs, dist, losses, cov, comm, tau, tau_cov, times, stale,
            cbytes, pbytes)


def _config(problem, *, mu, lr, curvature, hutchinson_samples,
            projection: str = "eigh"):
    if curvature not in ("dense", "diag"):
        raise ValueError(f"unknown curvature {curvature!r}")
    if projection not in ("eigh", "ns"):
        raise ValueError(f"unknown projection {projection!r}")
    return dict(mu=float(problem.mu) if mu is None else float(mu),
                lr=float(lr), curvature=curvature,
                hutch_samples=int(hutchinson_samples))


def _subsampled(result: RanlResult, record_every: int) -> RanlResult:
    """Keep x⁰, x¹, every ``record_every``-th round's iterate and the
    last one on ``xs``/``dist_sq``/``losses``; per-round traces stay full
    length."""
    k = int(record_every)
    if k <= 1:
        return result
    T = result.dist_sq.shape[-1] - 2
    rounds = sorted(set(range(k, T + 1, k)) | ({T} if T > 0 else set()))
    idx = torch.as_tensor([0, 1] + [1 + r for r in rounds],
                          device=result.xs.device)
    return dc_replace(result, xs=result.xs.index_select(0, idx),
                      dist_sq=result.dist_sq.index_select(0, idx),
                      losses=result.losses.index_select(0, idx))


def _scan_args(problem, key, opts: RanlOptions, *, controller=None,
               cost=None):
    """-> (args, static) for ``_scan_rounds``; the init phase runs here."""
    ctrl, cost = _hetero_defaults(problem, opts.policy, controller, cost)
    projection = opts.projection or "eigh"
    cfg = _config(problem, mu=opts.mu, lr=opts.lr, curvature=opts.curvature,
                  hutchinson_samples=opts.hutchinson_samples,
                  projection=projection)
    hutch = cfg.pop("hutch_samples")
    k_init, k_loop = prng.split(key)
    x1, C0, chol, hdiag = _init_phase(
        problem, k_init, mu=cfg["mu"], lr=cfg["lr"],
        curvature=cfg["curvature"], hutch_samples=hutch,
        projection=projection, ns_iters=opts.ns_iters)
    args = (problem, k_loop, x1, C0, chol, hdiag, cost)
    static = dict(num_rounds=int(opts.num_rounds),
                  num_regions=int(opts.num_regions), controller=ctrl,
                  use_kernel=bool(opts.use_kernel), **cfg)
    return args, static


def _run_scan(problem, key, opts: RanlOptions, *, controller=None,
              cost=None) -> RanlResult:
    """Engine ``"scan"`` of ``repro_torch.run``.

    ``curvature="dense"`` keeps the exact Definition-4 projection
    (``projection`` ``"eigh"`` or ``"ns"``); ``"diag"`` uses a Hutchinson
    diagonal and the fused ``ranl_update`` kernel (``use_kernel=False``
    for the plain aggregation and step)."""
    args, static = _scan_args(problem, key, opts, controller=controller,
                              cost=cost)
    (xs, dist, losses, cov, comm, tau, tau_cov, times, stale,
     cbytes, pbytes) = _scan_rounds(*args, **static)
    return _subsampled(RanlResult(
        xs=xs, dist_sq=dist, losses=losses, coverage=cov,
        comm_floats=comm, tau_star=tau, tau_covered=tau_cov,
        round_time=times, max_stale=stale, comm_bytes=cbytes,
        pod_bytes=pbytes), opts.record_every)


def _reference_program(problem, key, cost, *, opts: RanlOptions,
                       controller):
    """The reference engine's loop: per-worker init gradients, plain
    aggregation, and [H]_μ re-factored for every solve.  Returns
    ``(xs, cov, comm, tau, tau_cov, times, stale, cbytes)``."""
    from ..hetero.controller import initial_telemetry
    N, d, dev = problem.num_workers, problem.dim, problem.device
    Q = opts.num_regions
    mu = problem.mu if opts.mu is None else opts.mu
    lr = float(opts.lr)
    region_ids = contiguous_regions(d, Q, dev)
    sizes_q = region_sizes(region_ids, Q)
    k_init, k_loop = prng.split(key)

    x0 = torch.zeros(d, dtype=_F32, device=dev)
    hkeys = prng.split(prng.fold_in(k_init, 0), N)
    gkeys = prng.split(prng.fold_in(k_init, 1), N)
    H_mu = project_psd(running_mean_hessian(problem, x0, hkeys), mu)
    g0 = torch.stack([problem.worker_grad(i, x0, gkeys[i])
                      for i in range(N)])
    C = g0
    x = x0 - lr * solve_projected(H_mu, g0.sum(dim=0) / N)

    xs = [x0, x]
    rows = []
    ctrl_state = controller.init_state(N, Q)
    telem = initial_telemetry(N, Q, dev)
    for t in range(1, opts.num_rounds + 1):
        kt = prng.fold_in(k_loop, t)
        M, ctrl_state = _controller_mask(controller, cost, ctrl_state, telem,
                                         kt, t, N, Q, dev)
        Mx = expand_mask(M, region_ids)
        x_pruned = torch.where(Mx, x[None, :], 0.0)
        gk = prng.split(prng.fold_in(kt, 7), N)
        G = problem.worker_grads(x_pruned, gk) * Mx
        ubytes = uplink_bytes(None, M, sizes_q)
        g, C = server_aggregate(G, Mx, C)
        count_q = M.sum(dim=0).to(torch.int32)
        telem = _observe_round(cost, telem, M, count_q, sizes_q, t, ubytes)
        x = x - lr * solve_projected(H_mu, g)
        xs.append(x)
        rows.append(_trace_row(Mx, count_q, telem, ubytes, N))
    return (torch.stack(xs), *_stack_rows(rows, N, dev))


def _run_reference(problem, key, opts: RanlOptions, *, controller=None,
                   cost=None) -> RanlResult:
    """Engine ``"reference"`` of ``repro_torch.run``: the host-loop oracle
    the scan engine is held against (dense ``eigh`` only)."""
    ctrl, cost = _hetero_defaults(problem, opts.policy, controller, cost)
    xs, cov, comm, tau, tau_cov, times, stale, cbytes = _reference_program(
        problem, key, cost, opts=opts, controller=ctrl)
    dist = ((xs - problem.x_star[None, :]) ** 2).sum(dim=1)
    losses = torch.stack([problem.loss(xi) for xi in xs])
    return _subsampled(RanlResult(
        xs=xs, dist_sq=dist, losses=losses, coverage=cov, comm_floats=comm,
        tau_star=tau, tau_covered=tau_cov, round_time=times,
        max_stale=stale, comm_bytes=cbytes), opts.record_every)
