"""RANL engines — Algorithm 1 on one device, eager PyTorch.

Round 0 (init): workers send stochastic local gradients and Hessians at x⁰;
the server aggregates H = mean ∇²F_i(x⁰, ξ⁰), projects [H]_μ (Definition 4),
seeds the memory C_i^{0,q} = ∇F_i^q(x⁰, ξ⁰), and takes one unpruned Newton
step.  Rounds t ≥ 1: workers draw masks m_i^t ~ P, train pruned sub-models
x_i = x ⊙ m_i, send pruned gradients; the server aggregates per region with
memory fallback and updates x^{t+1} = x^t − [H]_μ^{-1} ∇F^t.

Three engines, as in the reference:

* ``_run_batch`` (engine ``"batch"``): B independent seeds.  The init
  phase runs per seed; then ONE Python loop over rounds carries all B
  seeds on a leading axis, so each round's device-heavy work runs once for
  all of them: the gradient oracle is one product over A or X with a
  (B·N)-column right-hand side (A is read once a round whatever B is),
  the aggregation one launch of the seed-batched kernel, the step one
  pair of batched triangular solves or a diagonal division.  Masks for
  all seeds come from one draw over the stacked keys, equal to each
  seed's own;
* ``_run_scan`` (engine ``"scan"``): the same loop at B = 1.  With
  ``use_kernel`` (the default) each round's aggregation goes to the
  hand-written kernels: ``region_aggregate`` before the dense Cholesky
  step, and the fused aggregate + diagonal Newton step ``ranl_update`` for
  ``curvature="diag"``;
* ``_run_reference`` (engine ``"reference"``): the host-loop oracle —
  per-worker init gradients, plain aggregation, a fresh factorization of
  [H]_μ every round.  Dense ``eigh`` curvature only.

Round variants, each a branch of the loop as in the reference: quorum
rounds (``RanlOptions.quorum``) commit at the quorum deadline and fold
late work through a ``(max_delay, d)`` late buffer; compressed uplinks
(``compression``) carry an (N, d) error-feedback residual.  Both bypass
the fused ``ranl_update`` kernel, which has no late-fold or
error-feedback form.  ``hessian_rank`` builds [H]_μ by low-rank updates.

Hierarchical pod-of-pods rounds (``hierarchy``) split the N workers into
P contiguous pods of N/P, each running the flat round on its own iterate
with pod-local counts, memory fallback and quorum deadlines; every
``period`` rounds the pods exchange anchored deltas (optionally int8- or
bf16-compressed) and damp toward their mean.  The loop carries B seeds'
P pods as B·P rows of N/P workers, so a synchronous, uncompressed pod
round is still one kernel launch for all of them, where the reference's
pod rounds take its plain aggregation.  A flat run is the same loop at
P = 1 with no exchange.

Keys are host-side (``repro_torch.prng``) and reproduce the reference's
streams, so masks, coverage, ``comm_floats`` and the coverage minima equal
the reference's exactly.  Per-round traces stay on the device and are
stacked after the loop.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace

import numpy as np
import torch

from .. import prng
from ..kernels import ops as kernel_ops
from .aggregation import quorum_aggregate, server_aggregate
from .compression import compressed_quorum_aggregate, \
    compressed_server_aggregate, lowrank_hmu_factor, parse_compression, \
    pod_sum_compressed, uplink_bytes
from .hessian import cho_factor, cho_solve, cho_solve_rows, hutchinson_diag, \
    project_diag, project_psd, project_psd_ns, running_mean_hessian, \
    solve_projected
from .options import HierarchySpec, RanlOptions
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
                               # (0 if any region went uncovered); a (B,)
                               # int32 tensor for batched runs
    tau_covered: int = 0       # min coverage over COVERED regions only
    round_time: torch.Tensor = None   # (T,) simulated wall-clock per round
    max_stale: torch.Tensor = None    # (T,) int32 max region staleness
    comm_bytes: torch.Tensor = None   # (T,) modeled uplink bytes
    pod_bytes: torch.Tensor = None    # (T,) inter-pod bytes (0 for flat
                                      # runs without a pod topology)
    xs_pods: torch.Tensor = None      # (T+2, P, d) pod iterates of
                                      # hierarchical runs (xs is their mean)
    collectives: tuple = ()           # the run's collective log
                                      # (core.collectives; sharded runs)
    # batched runs carry a leading seed axis (B, ...) on every array


def _init_phase(problem, k_init, *, mu: float, lr: float, curvature: str,
                hutch_samples: int, projection: str = "eigh",
                ns_iters=60, hessian_rank: int | None = None):
    """Alg. 1 lines 1–8 for one seed.  Returns (x1, C0, chol, hdiag): the
    post-init iterate, the seeded gradient memory, and the curvature
    state — the lower Cholesky factor of [H]_μ (dense) or the Hutchinson
    diagonal (diag); the unused one is None."""
    N, d = problem.num_workers, problem.dim
    x0 = torch.zeros(d, dtype=_F32, device=problem.device)
    hkeys = prng.split(prng.fold_in(k_init, 0), N)
    gkeys = prng.split(prng.fold_in(k_init, 1), N)
    g0 = problem.worker_grads(x0.expand(N, d), gkeys)       # (N, d)
    g0_mean = g0.sum(dim=0) / N

    if curvature == "dense" and hessian_rank is not None:
        # worker 0's Hessian projected once, the top-r eigenpairs of the
        # others folded by Cholesky rank-1 updates (compression.py)
        chol, hdiag = lowrank_hmu_factor(problem, x0, hkeys, mu,
                                         rank=hessian_rank), None
        step0 = cho_solve(chol, g0_mean)
    elif curvature == "dense":
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


def _init_seeds(problem, k_init, **cfg):
    """``_init_phase`` for each of the B keys of ``k_init`` (B, 2), one
    after another; returns the four results stacked on a seed axis (None
    stays None)."""
    outs = [_init_phase(problem, k, **cfg) for k in k_init]
    return tuple(None if col[0] is None else torch.stack(col)
                 for col in zip(*outs))


def _round_diagnostics(covered_q, count_q, n_workers: int):
    """Per-round (coverage_mean, min_count, min_covered_count), each over
    the last two (pod, region) axes: the raw count minimum feeds
    ``tau_star``; uncovered regions map to N in the second, which feeds
    ``tau_covered``.  The mean is the sum times the f32 reciprocal of
    P·Q, which is how the reference's mean evaluates."""
    inv_q = float(np.float32(1.0) / np.float32(covered_q.shape[-2]
                                               * covered_q.shape[-1]))
    dims = (-2, -1)
    return (covered_q.to(_F32).sum(dim=dims) * inv_q, count_q.amin(dim=dims),
            torch.where(covered_q, count_q,
                        torch.full_like(count_q, n_workers)).amin(dim=dims))


def _trace_row(work, count_pq, round_t, telem, ubytes, n_workers: int,
               pbytes=None):
    """One round's device-side trace entries, each (...,) over seeds:
    (coverage, comm_floats, min_count, min_covered_count, round_time,
    max_stale, comm_bytes, pod_bytes).  ``work`` (..., N): each worker's
    trained coordinates (their sum is the round's uplink floats);
    ``count_pq`` (..., P, Q): each pod's coverage counts, of
    ``n_workers`` workers each (P = 1: flat)."""
    cov_mean, min_count, min_cov_count = _round_diagnostics(
        count_pq > 0, count_pq, n_workers)
    return (cov_mean, work.sum(dim=-1).to(torch.int32), min_count,
            min_cov_count, round_t, telem.stale_q.amax(dim=-1),
            ubytes.sum(dim=-1), torch.zeros_like(round_t)
            if pbytes is None else pbytes)


def _stack_rows(rows, batch: tuple, device):
    """Per-round rows -> (cov, comm, min_counts, min_cov_counts, times,
    stale, cbytes, pbytes), each ``batch + (T,)``."""
    if not rows:
        empty_f = torch.zeros(batch + (0,), dtype=_F32, device=device)
        empty_i = torch.zeros(batch + (0,), dtype=torch.int32,
                              device=device)
        return (empty_f, empty_i, empty_i, empty_i, empty_f, empty_i,
                empty_f, empty_f)
    return tuple(torch.stack(col, dim=-1) for col in zip(*rows))


def _tau_pair(min_counts, min_cov_counts, n_workers: int):
    """Over-rounds minima capped at N -> (tau_star, tau_covered), int32
    over the leading axes (N when there are no rounds)."""
    def cap(m):
        if not m.shape[-1]:
            return torch.full(m.shape[:-1], n_workers, dtype=torch.int32,
                              device=m.device)
        return torch.clamp_max(m.amin(dim=-1), n_workers).to(torch.int32)
    return cap(min_counts), cap(min_cov_counts)


def _controller_mask(controller, cost, ctrl_state, telem, kt, t: int,
                     num_workers: int, num_regions: int, device):
    """One controller step + the cost model's availability filter (no
    draws at all when the cost model has no dropout or churn)."""
    from ..hetero.cost import available
    M, ctrl_state = controller.step(ctrl_state, telem, kt, t, num_workers,
                                    num_regions, device)
    if cost.dropout_prob > 0.0 or cost.churn_period > 0:
        M = M & available(cost, kt, t)[..., None]
    return M, ctrl_state


def _clock(cost, M, sizes_q, ubytes, t: int, qspec, pods: int = 1,
           overlap: bool = False):
    """The round's simulated clock: (work, times, round_time, on_time,
    delays).  Synchronous rounds end at the slowest participant; quorum
    rounds at the latest of the ``pods`` pods' quorum deadlines (each
    pod's split over its own workers), with each worker's on-time flag
    and delay (None for synchronous rounds).  ``overlap``: the pipelined
    rounds' clock (``worker_times``)."""
    from ..hetero.cost import quorum_split, worker_times
    work = (M * sizes_q).sum(dim=-1).to(torch.int32)
    times = worker_times(cost, work, t, ubytes, overlap=overlap)
    if qspec is None:
        return work, times, times.amax(dim=-1), None, None
    deadline, on_time, delays = quorum_split(
        times.unflatten(-1, (pods, -1)), M.unflatten(-2, (pods, -1)),
        quorum=qspec.quorum, quorum_tau=qspec.quorum_tau,
        max_delay=qspec.max_delay)
    return (work, times, deadline.amax(dim=-1), on_time.flatten(-2),
            delays.flatten(-2))


def _aggregate(G, Mx, C, err, late_buf, on_time, delays, *, region_ids,
               num_regions: int, qspec, comp, use_kernel: bool):
    """One round's server aggregation, every branch of the reference's:
    synchronous or quorum, plain or compressed.  Returns (g, C, err,
    late_buf)."""
    if qspec is None and comp is None:
        g, C = server_aggregate(G, Mx, C, use_kernel=use_kernel)
    elif qspec is None:
        g, C, err = compressed_server_aggregate(
            G, Mx, C, err, comp, region_ids=region_ids,
            num_regions=num_regions)
    elif comp is None:
        g, C, late_buf = quorum_aggregate(
            G, Mx, C, on_time, delays, late_buf, gamma=qspec.gamma,
            max_delay=qspec.max_delay)
    else:
        g, C, err, late_buf = compressed_quorum_aggregate(
            G, Mx, C, err, on_time, delays, late_buf, comp,
            region_ids=region_ids, num_regions=num_regions,
            gamma=qspec.gamma, max_delay=qspec.max_delay)
    return g, C, err, late_buf


def _observe(telem, M, on_time, work, times, pods: int = 1):
    """-> (count_pq (..., P, Q), telemetry): each pod's coverage counts
    (on-time workers only in quorum rounds), their sum over the pods
    folded into the telemetry."""
    from ..hetero.controller import next_telemetry
    if on_time is not None:
        M = M & on_time[..., None]
    count_pq = M.unflatten(-2, (pods, -1)).sum(dim=-2).to(torch.int32)
    return count_pq, next_telemetry(telem, count_pq.sum(dim=-2), work,
                                    times)


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


def _pod_wire_bytes(comp, n_coords: int) -> float:
    """Modeled bytes of an ``n_coords``-float payload crossing the
    inter-pod links under the ``core.compression`` wire model (int8: one
    byte a coordinate plus the 4-byte shared scale; bf16: two;
    uncompressed or top-k: four): what ``RanlResult.pod_bytes`` meters
    and ``pod_exchange_time`` charges."""
    if comp is None:
        return 4.0 * n_coords
    if comp.kind == "int8":
        return float(n_coords) + 4.0
    if comp.kind == "bf16":
        return 2.0 * n_coords
    return 4.0 * n_coords


def _check_hier(problem, hspec: HierarchySpec | None, num_rounds: int):
    """Dispatch-time divisibility checks of a hierarchical run."""
    if hspec is None:
        return
    if problem.num_workers % hspec.pods:
        raise ValueError(
            f"num_workers={problem.num_workers} must divide evenly "
            f"across hierarchy pods={hspec.pods}")
    if num_rounds > 0 and num_rounds % hspec.period:
        raise ValueError(
            f"num_rounds={num_rounds} must be a multiple of the "
            f"hierarchy exchange period={hspec.period}")


class _Exchange:
    """The inter-pod exchange of a hierarchical run, every ``period``
    rounds: anchored deltas summed over the pods (through
    ``pod_sum_compressed`` when the exchange is compressed, with its own
    error-feedback residual), then each pod damped toward the mean,

        Δ_p = x_p − anchor;  x̄ = anchor + Σ_p Δ_p / P;
        x_p += γ (x̄ − x_p);  anchor = x̄,

    the anchor starting at the post-init iterate ``x1`` (B, d)."""

    def __init__(self, hspec: HierarchySpec, x1):
        self.pods, self.gamma = hspec.pods, hspec.gamma
        self.comp = parse_compression(hspec.compression)
        self.anchor = x1
        self.err = (None if self.comp is None else
                    torch.zeros(x1.shape[:1] + (self.pods,) + x1.shape[1:],
                                dtype=_F32, device=x1.device))

    def __call__(self, x):
        """x (B, P, d) -> the damped pod iterates."""
        delta = x - self.anchor[:, None, :]
        if self.comp is None:
            total = delta.sum(dim=1)
        else:
            total, self.err = pod_sum_compressed(self.comp, delta, self.err)
        self.anchor = self.anchor + total / self.pods
        return x + self.gamma * (self.anchor[:, None, :] - x)


def _scan_rounds(problem, k_loop, x1, C0, chol, hdiag, cost, *,
                 num_rounds: int, num_regions: int, controller, mu: float,
                 lr: float, curvature: str, use_kernel: bool, qspec=None,
                 comp=None, hspec: HierarchySpec | None = None):
    """Alg. 1 lines 9–23 as a Python loop over rounds, for B seeds at once
    on a leading axis: ``k_loop`` (B, 2), ``x1`` (B, d), ``C0`` (B, N, d),
    ``chol`` (B, d, d) or ``hdiag`` (B, d).

    The P pods of a hierarchical run (P = 1 for a flat one) ride the same
    axis: the loop state holds R = B·P rows of N/P workers — the
    iterates (R, d), the memory (R, N/P, d), the error-feedback residual
    and the late buffer, which exist only when compression or quorum
    rounds are on — and the controller state and telemetry over all N
    workers.  Every P-th row is one seed's first pod.  A flat round on a
    cost model with a pod topology pays one crossing of the param
    aggregate; a hierarchical run pays its exchange on each window's last
    round, whose recorded iterates are those before the exchange.
    Returns (xs, dist, losses, cov, comm, min_counts, min_cov_counts,
    times, stale, cbytes, pbytes, xs_pods), each with the seed axis
    first; ``xs`` is the pods' mean and ``xs_pods`` (B, T+2, P, d) is
    None for flat runs."""
    from ..hetero.controller import initial_telemetry
    from ..hetero.cost import pod_exchange_time
    N, d, dev = problem.num_workers, problem.dim, problem.device
    B, Q = k_loop.shape[0], num_regions
    P = 1 if hspec is None else hspec.pods
    n_pod, R = N // P, B * P
    region_ids = contiguous_regions(d, Q, dev)
    sizes_q = region_sizes(region_ids, Q)
    x = x1.repeat_interleave(P, dim=0)                   # (R, d)
    C = C0.reshape(R, n_pod, d)
    err = (None if comp is None
           else torch.zeros((R, n_pod, d), dtype=_F32, device=dev))
    late_buf = (None if qspec is None else torch.zeros(
        (R, qspec.max_delay, d), dtype=_F32, device=dev))
    hdiag_r = None if hdiag is None else hdiag.repeat_interleave(P, dim=0)
    ctrl_state = controller.init_state(N, Q, dev)
    telem = initial_telemetry(N, Q, dev, batch=(B,))
    fused = (curvature == "diag" and use_kernel and qspec is None
             and comp is None)
    exchange = None if hspec is None else _Exchange(hspec, x1)
    charge = None             # (time, bytes) of one crossing of the pods
    if hspec is not None or cost.pod_bw is not None:
        wire = _pod_wire_bytes(comp if hspec is None else exchange.comp, d)
        charge = (pod_exchange_time(cost, wire),
                  torch.full((B,), wire, dtype=_F32, device=dev))
    xs = [torch.zeros((B, P, d), dtype=_F32, device=dev),
          x1[:, None, :].expand(B, P, d)]
    rows = []
    for t in range(1, num_rounds + 1):
        kt = prng.fold_in(k_loop, t)                     # (B, 2)
        M, ctrl_state = _controller_mask(controller, cost, ctrl_state,
                                         telem, kt, t, N, Q, dev)
        Mx = expand_mask(M, region_ids)                  # (B, N, d) bool
        x_pruned = torch.where(Mx.view(B, P, n_pod, d),  # x_pod ⊙ m_i
                               x.view(B, P, 1, d), 0.0).view(B, N, d)
        gk = prng.split(prng.fold_in(kt, 7), N)          # (B, N, 2)
        G = problem.worker_grads(x_pruned, gk) * Mx      # ∇F_i ⊙ m_i
        ubytes = uplink_bytes(comp, M, sizes_q)          # (B, N) wire model
        work, times, round_t, on_time, delays = _clock(
            cost, M, sizes_q, ubytes, t, qspec, pods=P)
        Gr, Mr = G.view(R, n_pod, d), Mx.view(R, n_pod, d)
        if fused:
            x, C = kernel_ops.ranl_update(x, hdiag_r, Gr, Mr, C, mu=mu,
                                          lr=lr)
        else:
            # synchronous uncompressed rounds aggregate through the
            # region_aggregate kernel (the reference's dense and pod
            # rounds always take its jnp form)
            g, C, err, late_buf = _aggregate(
                Gr, Mr, C, err, late_buf,
                None if on_time is None else on_time.view(R, n_pod),
                None if delays is None else delays.view(R, n_pod),
                region_ids=region_ids, num_regions=Q, qspec=qspec,
                comp=comp, use_kernel=use_kernel)
            if curvature == "dense":
                # one pair of triangular solves a seed, P right-hand sides
                step = cho_solve_rows(chol, g.view(B, P, d)).reshape(R, d)
            else:
                step = g / project_diag(hdiag_r, mu)
            x = x - lr * step
        count_pq, telem = _observe(telem, M, on_time, work, times, pods=P)
        xs.append(x.view(B, P, d))
        exchanged = exchange is not None and t % hspec.period == 0
        if exchanged:
            x = exchange(x.view(B, P, d)).reshape(R, d)
        pbytes = None
        if charge is not None and (exchange is None or exchanged):
            round_t, pbytes = round_t + charge[0], charge[1]
        rows.append(_trace_row(work, count_pq, round_t, telem, ubytes,
                               n_pod, pbytes))
    xs_pods = torch.stack(xs, dim=1)                     # (B, T+2, P, d)
    xs = xs_pods[:, :, 0] if hspec is None else xs_pods.sum(dim=2) / P
    dist = ((xs - problem.x_star) ** 2).sum(dim=-1)
    losses = problem.losses(xs.reshape(-1, d)).reshape(B, -1)
    return (xs, dist, losses, *_stack_rows(rows, (B,), dev),
            None if hspec is None else xs_pods)


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
    last one on ``xs``/``xs_pods``/``dist_sq``/``losses`` (batched runs
    along their iterate axis); per-round traces stay full length."""
    k = int(record_every)
    if k <= 1:
        return result
    T = result.dist_sq.shape[-1] - 2
    rounds = sorted(set(range(k, T + 1, k)) | ({T} if T > 0 else set()))
    idx = torch.as_tensor([0, 1] + [1 + r for r in rounds],
                          device=result.xs.device)
    return dc_replace(result, xs=result.xs.index_select(-2, idx),
                      xs_pods=None if result.xs_pods is None
                      else result.xs_pods.index_select(-3, idx),
                      dist_sq=result.dist_sq.index_select(-1, idx),
                      losses=result.losses.index_select(-1, idx))


def _run_seeds(problem, keys, opts: RanlOptions, *, controller=None,
               cost=None):
    """Init each of the B keys (B, 2), then run the rounds of all B seeds
    in one loop.  Returns (``_scan_rounds``'s arrays, the coverage cap:
    the workers of a pod)."""
    ctrl, cost = _hetero_defaults(problem, opts.policy, controller, cost)
    hspec = opts.hierarchy_spec()
    _check_hier(problem, hspec, int(opts.num_rounds))
    projection = opts.projection or "eigh"
    cfg = _config(problem, mu=opts.mu, lr=opts.lr, curvature=opts.curvature,
                  hutchinson_samples=opts.hutchinson_samples,
                  projection=projection)
    hutch = cfg.pop("hutch_samples")
    pair = prng.split(keys)
    k_init, k_loop = pair[:, 0], pair[:, 1]
    x1, C0, chol, hdiag = _init_seeds(
        problem, k_init, mu=cfg["mu"], lr=cfg["lr"],
        curvature=cfg["curvature"], hutch_samples=hutch,
        projection=projection, ns_iters=opts.ns_iters,
        hessian_rank=opts.hessian_rank)
    arrays = _scan_rounds(
        problem, k_loop, x1, C0, chol, hdiag, cost,
        num_rounds=int(opts.num_rounds), num_regions=int(opts.num_regions),
        controller=ctrl, use_kernel=bool(opts.use_kernel),
        qspec=opts.quorum_spec(), comp=opts.compression_spec(),
        hspec=hspec, **cfg)
    pods = 1 if hspec is None else hspec.pods
    return arrays, problem.num_workers // pods


def _result(arrays, n_cap: int, record_every: int,
            seed: int | None = None) -> RanlResult:
    """``_scan_rounds``'s arrays -> RanlResult; the coverage minima are
    capped at ``n_cap``; ``seed`` picks one seed (the scan engine), with
    the coverage minima as Python ints."""
    (xs, dist, losses, cov, comm, min_counts, min_cov, times, stale,
     cbytes, pbytes, xs_pods) = arrays if seed is None else (
        None if a is None else a[seed] for a in arrays)
    tau, tau_cov = _tau_pair(min_counts, min_cov, n_cap)
    if seed is not None:              # the run's one sync
        tau, tau_cov = (int(v) for v in torch.stack([tau, tau_cov]).tolist())
    return _subsampled(RanlResult(
        xs=xs, dist_sq=dist, losses=losses, coverage=cov, comm_floats=comm,
        tau_star=tau, tau_covered=tau_cov, round_time=times,
        max_stale=stale, comm_bytes=cbytes, pod_bytes=pbytes,
        xs_pods=xs_pods), record_every)


def _run_scan(problem, key, opts: RanlOptions, *, controller=None,
              cost=None) -> RanlResult:
    """Engine ``"scan"`` of ``repro_torch.run``: one seed.

    ``curvature="dense"`` keeps the exact Definition-4 projection
    (``projection`` ``"eigh"`` or ``"ns"``; ``hessian_rank`` for the
    low-rank init); ``"diag"`` uses a Hutchinson diagonal and the fused
    ``ranl_update`` kernel (``use_kernel=False`` for the plain aggregation
    and step).  ``hierarchy`` runs pod-of-pods rounds (``_scan_rounds``)."""
    arrays, n_cap = _run_seeds(problem, prng.as_key(key)[None], opts,
                               controller=controller, cost=cost)
    return _result(arrays, n_cap, opts.record_every, seed=0)


def _run_batch(problem, keys, opts: RanlOptions, *, controller=None,
               cost=None) -> RanlResult:
    """Engine ``"batch"`` of ``repro_torch.run``: B seeds, keys (B, 2).

    Every array of the result carries a leading seed axis; ``tau_star``
    and ``tau_covered`` are (B,) int32 tensors.  Row b equals a
    ``"scan"`` run on ``keys[b]``: the same masks and integer traces, and
    iterates within the rounding of a product over B columns instead of
    one."""
    arrays, n_cap = _run_seeds(problem, keys, opts, controller=controller,
                               cost=cost)
    return _result(arrays, n_cap, opts.record_every)


def _reference_program(problem, key, cost, *, opts: RanlOptions,
                       controller):
    """The reference engine's loop: per-worker init gradients, plain
    aggregation (every quorum and compression branch of the reference's),
    and [H]_μ re-factored for every solve.  Returns ``(xs, cov, comm,
    min_counts, min_cov_counts, times, stale, cbytes)``."""
    from ..hetero.controller import initial_telemetry
    N, d, dev = problem.num_workers, problem.dim, problem.device
    Q = opts.num_regions
    qspec, comp = opts.quorum_spec(), opts.compression_spec()
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
    ctrl_state = controller.init_state(N, Q, dev)
    telem = initial_telemetry(N, Q, dev)
    err = None if comp is None else torch.zeros((N, d), dtype=_F32,
                                                 device=dev)
    late_buf = None if qspec is None else torch.zeros(
        (qspec.max_delay, d), dtype=_F32, device=dev)
    for t in range(1, opts.num_rounds + 1):
        kt = prng.fold_in(k_loop, t)
        M, ctrl_state = _controller_mask(controller, cost, ctrl_state, telem,
                                         kt, t, N, Q, dev)
        Mx = expand_mask(M, region_ids)
        x_pruned = torch.where(Mx, x[None, :], 0.0)
        gk = prng.split(prng.fold_in(kt, 7), N)
        G = problem.worker_grads(x_pruned, gk) * Mx
        ubytes = uplink_bytes(comp, M, sizes_q)
        work, times, round_t, on_time, delays = _clock(cost, M, sizes_q,
                                                       ubytes, t, qspec)
        g, C, err, late_buf = _aggregate(
            G, Mx, C, err, late_buf, on_time, delays, region_ids=region_ids,
            num_regions=Q, qspec=qspec, comp=comp, use_kernel=False)
        count_pq, telem = _observe(telem, M, on_time, work, times)
        x = x - lr * solve_projected(H_mu, g)
        xs.append(x)
        rows.append(_trace_row(work, count_pq, round_t, telem, ubytes, N))
    return (torch.stack(xs), *_stack_rows(rows, (), dev)[:-1])


def _run_reference(problem, key, opts: RanlOptions, *, controller=None,
                   cost=None) -> RanlResult:
    """Engine ``"reference"`` of ``repro_torch.run``: the host-loop oracle
    the scan engine is held against (dense ``eigh`` only)."""
    ctrl, cost = _hetero_defaults(problem, opts.policy, controller, cost)
    xs, cov, comm, min_counts, min_cov, times, stale, cbytes = \
        _reference_program(problem, key, cost, opts=opts, controller=ctrl)
    tau, tau_cov = (int(v) for v in _tau_pair(min_counts, min_cov,
                                              problem.num_workers))
    dist = ((xs - problem.x_star[None, :]) ** 2).sum(dim=1)
    losses = torch.stack([problem.loss(xi) for xi in xs])
    return _subsampled(RanlResult(
        xs=xs, dist_sq=dist, losses=losses, coverage=cov, comm_floats=comm,
        tau_star=tau, tau_covered=tau_cov, round_time=times,
        max_stale=stale, comm_bytes=cbytes), opts.record_every)
