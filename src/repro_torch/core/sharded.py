"""The 1-D sharded engine on ``torch.distributed`` (engine ``"sharded"``)
and the batch engine's seed sharding (``engine="batch"`` with a mesh).

SPMD: every process (rank) calls ``repro_torch.run`` with the same
arguments and a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions — ``("data",)``, or ``("pod", "data")`` for a hierarchical
run; ``init_device_mesh``'s row-major rank order is the reference's
pod-major worker layout — and every rank returns the same
``RanlResult``.  NCCL on the card, gloo on the CPU.

The init phase runs replicated on the full problem (``ranl._init_phase``,
the scan engine's code).  The round loop then holds the rank's n_local
workers only: views of the worker-indexed problem leaves (leading dim N,
ndim ≥ 2) and its own rows of the gradient memory C (the engine's full C
is freed).  Each round (``_sharded_rounds``):

* the controller steps and the masks are drawn on the full (N, Q) on
  every rank, so the streams stay those of the one-card engines bit for
  bit; the rank takes its workers' rows at ``start = (pod·n_data +
  shard)·n_local``, of the masks and of the gradient keys alike;
* the coverage counts are one Q-int all-reduce over ``"data"``;
* each local worker contributes ``where(covered, G/denom, C/n_pop)``
  (n_pop = N / pods, the pod's population, not n_local); quorum rounds
  add the rank's due late-buffer row; the local sum is the round's ONE
  param-sized all-reduce, compressed under ``compression``
  (``psum_compressed``, with the rank's own error-feedback residual).
  C and the late buffer never leave the rank;
* ``overlap=True`` starts that all-reduce asynchronously, then folds the
  round's telemetry, samples round t+1 (whose count all-reduce queues
  behind the param one on the same group, so every rank starts its
  collectives in one order) and computes the diagnostics, and waits only
  for the step: the same values as the sequential loop, bit for bit.

Under ``hierarchy`` the counts and the param all-reduce run over
``"data"`` only, so they are pod-local; every ``period`` rounds the pods
exchange their anchored deltas in one all-reduce over ``"pod"``
(compressed with its own residual when the exchange is), and one
all-gather over ``"pod"`` after the loop gives every rank ``xs_pods``.
As in the reference, the aggregation is the collective form: this engine
launches none of the port's kernels.  The 2-D engine (``core.sharded2d``)
runs the same loop on its model shard's coordinates.  Every collective goes through the
recorder of ``core.collectives``; the result carries its log.
"""

from __future__ import annotations

from dataclasses import fields, replace as dc_replace

import torch

from .. import prng
from .aggregation import _shift_in, late_fold_updates
from .collectives import Collectives
from .compression import parse_compression, psum_compressed, \
    uplink_bytes
from .hessian import cho_solve, project_diag
from .ranl import RanlResult, _check_hier, _clock, _config, \
    _controller_mask, _hetero_defaults, _init_phase, _observe, \
    _pod_wire_bytes, _result, _run_scan, _run_seeds, _stack_rows, \
    _subsampled, _tau_pair, _trace_row
from .regions import contiguous_regions, expand_mask, region_sizes

_F32 = torch.float32


def _check_mesh(problem, mesh, axis_name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh {names} has no {axis_name!r} axis to "
                         f"shard workers over")
    n_dev = mesh.size(names.index(axis_name))
    if problem.num_workers % n_dev:
        raise ValueError(
            f"num_workers={problem.num_workers} must divide evenly across "
            f"the {n_dev} devices of the {axis_name!r} mesh axis")
    return n_dev


def _check_pod_mesh(problem, mesh, axis_name: str, pod_axis: str, hspec,
                    num_rounds: int):
    """A hierarchical run's mesh carries a ``pod_axis`` whose extent is
    the pod count, and each pod's workers divide across the data axis."""
    _check_hier(problem, hspec, num_rounds)
    names = tuple(mesh.mesh_dim_names or ())
    if pod_axis not in names:
        raise ValueError(
            f"hierarchy pods={hspec.pods} needs a {pod_axis!r} axis on "
            f"the mesh (got {names}; build one with init_device_mesh("
            f"..., (pods, n_data), mesh_dim_names=({pod_axis!r}, "
            f"{axis_name!r})))")
    if mesh.size(names.index(pod_axis)) != hspec.pods:
        raise ValueError(
            f"hierarchy pods={hspec.pods} != mesh {pod_axis!r} axis "
            f"extent {mesh.size(names.index(pod_axis))}")
    n_pop = problem.num_workers // hspec.pods
    n_data = mesh.size(names.index(axis_name))
    if n_pop % n_data:
        raise ValueError(
            f"per-pod workers {n_pop} must divide evenly across the "
            f"{n_data} devices of the {axis_name!r} mesh axis")


def _local_problem(problem, start: int, n_local: int):
    """The problem restricted to workers start … start+n_local−1: views
    of every worker-indexed leaf (leading dim N, ndim ≥ 2)."""
    N = problem.num_workers
    rows = {}
    for f in fields(problem):
        v = getattr(problem, f.name)
        if isinstance(v, torch.Tensor) and v.ndim >= 2 and v.shape[0] == N:
            rows[f.name] = v[start:start + n_local]
    return dc_replace(problem, **rows)


def _sharded_rounds(problem, k_loop, x1, C, cost, coll, *, step, cols,
                    axis_name: str, pod_axis: str, start: int,
                    num_workers: int, num_rounds: int, num_regions: int,
                    controller, overlap: bool, qspec=None, comp=None,
                    hspec=None, fused=None):
    """This rank's round loop: ``problem`` and ``C`` hold its workers,
    from global index ``start``; ``x1`` is replicated.  The rank
    aggregates the coordinates ``cols`` = (row_start, p): all d on the
    1-D engine, the model shard's on the 2-D engine; ``C`` is (n_local,
    p), the gradients ``problem.worker_grads_rows``.  ``step(x, g)``
    takes the round's all-reduced aggregate g (p,) to the new iterate
    (the curvature's solve); ``fused(x, G, Mx, C)`` -> (x, C), when
    given, aggregates and steps in one, in place of that all-reduce and
    ``step``.  Returns (xs, cov, comm, min_counts, min_cov_counts, times,
    stale, cbytes, pbytes, xs_pods): xs (T+2, d) the pods' mean, xs_pods
    (T+2, P, d) or None for a flat run."""
    from ..hetero.controller import initial_telemetry
    from ..hetero.cost import pod_exchange_time
    from ..kernels.region_aggregate import local_region_ids
    N, d, dev = num_workers, x1.shape[0], x1.device
    Q, n_local = num_regions, problem.num_workers
    region_ids = contiguous_regions(d, Q, dev)
    sizes_q = region_sizes(region_ids, Q)
    p = cols[1]
    ids_loc = local_region_ids(d, Q, cols[0], p, dev)
    pods = 1 if hspec is None else hspec.pods
    n_pop = N // pods
    me_pod = start // n_pop                  # this rank's pod
    # the ranks joining the param all-reduce: the data axis (all of them
    # when flat, the pod's under hierarchy); the int8 clip depends on it
    n_agg = coll.size(axis_name)
    local = slice(start, start + n_local)

    def sample_round(t, ctrl_state, telem):
        """Everything of round t that does not read x: the masks and keys
        (full, then this rank's rows), the coverage counts' all-reduce,
        the clock (and quorum split) from the full masks."""
        kt = prng.fold_in(k_loop, t)
        M_full, ctrl_state = _controller_mask(controller, cost, ctrl_state,
                                              telem, kt, t, N, Q, dev)
        gk = prng.split(prng.fold_in(kt, 7), N)[local]
        M = M_full[local]
        count_q = coll.all_reduce(M.sum(dim=0).to(torch.int32),
                                  axis_name).wait()
        ubytes = uplink_bytes(comp, M_full, sizes_q)
        work, times, round_t, on_time, delays = _clock(
            cost, M_full, sizes_q, ubytes, t, qspec, pods=pods,
            overlap=overlap)
        return dict(M_full=M_full, M=M, gk=gk, count_q=count_q, work=work,
                    times=times, round_t=round_t, on_time=on_time,
                    delays=delays, ubytes=ubytes), ctrl_state

    def psum(y, err):
        """The round's one param-sized all-reduce."""
        if comp is None:
            return coll.all_reduce(y, axis_name, async_op=overlap), err
        return psum_compressed(comp, y, err, coll=coll, dim=axis_name,
                               n_agg=n_agg, region_ids=ids_loc,
                               num_regions=Q, async_op=overlap)

    def round_update(x, C, err, late_buf, s):
        """The local gradients and the single-reduction contribution, up
        to issuing the param all-reduce; then the rank's memory (and late
        buffer) update.  Returns (finish, C, err, late_buf): ``finish()``
        waits for the all-reduce and returns the new iterate."""
        Mx_full = expand_mask(s["M"], region_ids)        # (n_local, d)
        Mx = Mx_full if p == d else expand_mask(s["M"], ids_loc)
        x_pruned = torch.where(Mx_full, x[None, :], 0.0)
        G = problem.worker_grads_rows(x_pruned, s["gk"], *cols) * Mx
        if fused is not None:
            x_new, C = fused(x, G, Mx, C)
            return (lambda: x_new), C, err, late_buf
        count_x = s["count_q"].index_select(0, ids_loc)
        denom = torch.clamp_min(count_x, 1).to(_F32)
        if qspec is None:
            contrib = torch.where((count_x > 0)[None, :], G / denom,
                                  C / n_pop)
            pending, err = psum(contrib.sum(dim=0), err)
            return ((lambda: step(x, pending.wait())),
                    torch.where(Mx, G, C), err, late_buf)
        on_loc, delays_loc = s["on_time"][local], s["delays"][local]
        # covered: an on-time worker of this rank's pod trained it
        on_pod = s["M_full"].view(pods, n_pop, Q)[me_pod] \
            & s["on_time"].view(pods, n_pop)[me_pod][:, None]
        covered_x = (on_pod.sum(dim=0) > 0).index_select(0, ids_loc)
        fresh = torch.where(on_loc[:, None], G, 0.0)
        contrib = torch.where(covered_x[None, :], fresh / denom, C / n_pop)
        pending, err = psum(contrib.sum(dim=0) + late_buf[0], err)
        adds = late_fold_updates(G, Mx, count_x.to(_F32), delays_loc,
                                 gamma=qspec.gamma,
                                 max_delay=qspec.max_delay)
        dropped = delays_loc > qspec.max_delay
        C = torch.where(Mx & ~dropped[:, None], G, C)
        return ((lambda: step(x, pending.wait())), C, err,
                _shift_in(late_buf, adds))

    def observe(telem, s):
        """Fold round s into the telemetry; -> (telemetry, trace row)."""
        count_pq, telem = _observe(telem, s["M_full"], s["on_time"],
                                   s["work"], s["times"], pods=pods)
        round_t, pbytes = s["round_t"], None
        if flat_charge is not None:
            round_t, pbytes = round_t + flat_charge[0], flat_charge[1]
        return telem, _trace_row(s["work"], count_pq, round_t, telem,
                                 s["ubytes"], n_pop, pbytes)

    flat_charge = None         # a flat round on a pod topology: one crossing
    if hspec is None and cost.pod_bw is not None:
        wire = _pod_wire_bytes(comp, d)
        flat_charge = (pod_exchange_time(cost, wire),
                       torch.tensor(wire, dtype=_F32, device=dev))
    err = None if comp is None else torch.zeros(p, dtype=_F32, device=dev)
    late_buf = None if qspec is None else torch.zeros(
        (qspec.max_delay, p), dtype=_F32, device=dev)
    if hspec is not None:
        hcomp = parse_compression(hspec.compression)
        hier_wire = _pod_wire_bytes(hcomp, d)
        anchor = x1
        err_pod = None if hcomp is None else torch.zeros_like(x1)
    ctrl_state = controller.init_state(N, Q, dev)
    telem = initial_telemetry(N, Q, dev)
    x, xs, rows = x1, [torch.zeros_like(x1), x1], []
    coll.round = None
    if overlap:
        nxt, ctrl_state = sample_round(1, ctrl_state, telem)
    for t in range(1, num_rounds + 1):
        coll.round = t
        if overlap:
            s = nxt
            finish, C, err, late_buf = round_update(x, C, err, late_buf, s)
            # in flight: fold round t and its diagnostics, sample t+1
            telem, row = observe(telem, s)
            nxt, ctrl_state = sample_round(t + 1, ctrl_state, telem)
            x = finish()
        else:
            s, ctrl_state = sample_round(t, ctrl_state, telem)
            finish, C, err, late_buf = round_update(x, C, err, late_buf, s)
            x = finish()
            telem, row = observe(telem, s)
        xs.append(x)
        if hspec is not None and t % hspec.period == 0:
            delta = x - anchor
            if hcomp is None:
                total = coll.all_reduce(delta, pod_axis).wait()
            else:
                pending, err_pod = psum_compressed(
                    hcomp, delta, err_pod, coll=coll, dim=pod_axis,
                    n_agg=pods, region_ids=region_ids, num_regions=Q)
                total = pending.wait()
            anchor = anchor + total / pods
            x = x + hspec.gamma * (anchor - x)
            # the window's last round pays the exchange
            cov, comm, mn, mn_cov, round_t, stale, cbytes, pbytes = row
            row = (cov, comm, mn, mn_cov,
                   round_t + pod_exchange_time(cost, hier_wire), stale,
                   cbytes, pbytes + hier_wire)
        rows.append(row)
    coll.round = None
    xs = torch.stack(xs)                                 # (T+2, d)
    xs_pods = None
    if hspec is not None:                                # (T+2, P, d)
        xs_pods = coll.all_gather(xs, pod_axis).permute(1, 0, 2)
        xs = xs_pods.sum(dim=1) / pods
    return (xs, *_stack_rows(rows, (), dev), xs_pods)


def _worker_start(coll, num_workers: int, n_data: int, hspec,
                  axis_name: str, pod_axis: str) -> tuple[int, int]:
    """(start, n_local): this rank's first worker and its count, pod-major
    over (``pod_axis``, ``axis_name``)."""
    pods = 1 if hspec is None else hspec.pods
    n_local = num_workers // pods // n_data
    me_pod = 0 if hspec is None else coll.rank(pod_axis)
    return (me_pod * n_data + coll.rank(axis_name)) * n_local, n_local


def _finish(problem, arrays, coll, n_pop: int, record_every: int,
            losses=None) -> RanlResult:
    """The rounds' arrays -> the run's RanlResult, with the collective
    log; ``losses`` (T+2,) when the engine computed them itself."""
    (xs, cov, comm, min_counts, min_cov, times, stale, cbytes, pbytes,
     xs_pods) = arrays
    tau, tau_cov = (int(v) for v in torch.stack(
        _tau_pair(min_counts, min_cov, n_pop)).tolist())
    return _subsampled(RanlResult(
        xs=xs, dist_sq=((xs - problem.x_star) ** 2).sum(dim=-1),
        losses=problem.losses(xs) if losses is None else losses,
        coverage=cov, comm_floats=comm, tau_star=tau, tau_covered=tau_cov,
        round_time=times, max_stale=stale, comm_bytes=cbytes,
        pod_bytes=pbytes, xs_pods=xs_pods, collectives=tuple(coll.log)),
        record_every)


def _run_sharded(problem, key, opts, *, mesh, axis_name: str = "data",
                 pod_axis: str = "pod", controller=None,
                 cost=None) -> RanlResult:
    """Engine ``"sharded"`` of ``repro_torch.run``: Algorithm 1 with the
    worker axis sharded over the ``axis_name`` dimension of ``mesh`` (and
    over ``pod_axis`` too under ``hierarchy``).  ``num_workers`` must
    divide across it; ``num_rounds <= 0`` validates the mesh and runs
    the scan engine, as the reference does."""
    n_data = _check_mesh(problem, mesh, axis_name)
    if opts.num_rounds <= 0:
        return _run_scan(problem, key, opts, controller=controller,
                         cost=cost)
    hspec = opts.hierarchy_spec()
    if hspec is not None:
        _check_pod_mesh(problem, mesh, axis_name, pod_axis, hspec,
                        int(opts.num_rounds))
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
        projection=projection, ns_iters=opts.ns_iters,
        hessian_rank=opts.hessian_rank)
    coll = Collectives(mesh)
    N = problem.num_workers
    start, n_local = _worker_start(coll, N, n_data, hspec, axis_name,
                                   pod_axis)
    C = C0[start:start + n_local].clone()
    del C0
    mu, lr = cfg["mu"], cfg["lr"]

    def step(x, g):
        if cfg["curvature"] == "dense":
            return x - lr * cho_solve(chol, g)
        return x - lr * (g / project_diag(hdiag, mu))

    arrays = _sharded_rounds(
        _local_problem(problem, start, n_local), k_loop, x1, C, cost, coll,
        step=step, cols=(0, problem.dim), axis_name=axis_name,
        pod_axis=pod_axis, start=start,
        num_workers=N, num_rounds=int(opts.num_rounds),
        num_regions=int(opts.num_regions), controller=ctrl,
        overlap=bool(opts.overlap), qspec=opts.quorum_spec(),
        comp=opts.compression_spec(), hspec=hspec)
    pods = 1 if hspec is None else hspec.pods
    return _finish(problem, arrays, coll, N // pods, opts.record_every)


def _gather_rows(coll, arrays, dim: str):
    """Each rank's seed rows of ``arrays`` (None stays None) -> every
    rank's, in rank order along ``dim``: ONE all-gather of the rows'
    bytes, so every dtype comes back bit for bit."""
    present = [a for a in arrays if a is not None]
    b = present[0].shape[0]
    raw = [a.contiguous().view(b, -1).view(torch.uint8) for a in present]
    got = coll.all_gather(torch.cat(raw, dim=1), dim)    # (n, b, bytes)
    got = got.reshape(-1, got.shape[-1])
    out, at = [], 0
    for a, r in zip(present, raw):
        width = r.shape[1]
        out.append(got[:, at:at + width].contiguous().view(a.dtype)
                   .reshape((-1,) + a.shape[1:]))
        at += width
    it = iter(out)
    return tuple(None if a is None else next(it) for a in arrays)


def _run_batch_sharded(problem, keys, opts, *, mesh,
                       axis_name: str = "data", controller=None,
                       cost=None) -> RanlResult:
    """Engine ``"batch"`` with a mesh: the B seeds split over the
    ``axis_name`` dimension (B divisible by its extent), B/n_dev seeds a
    rank, no collective in the round loop; one all-gather of the result
    rows after it gives every rank the (B, …) result."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh {names} has no {axis_name!r} axis to "
                         f"shard seeds over")
    n_dev = mesh.size(names.index(axis_name))
    B = keys.shape[0]
    if B % n_dev:
        raise ValueError(
            f"batch of {B} seeds must divide evenly across the {n_dev} "
            f"devices of the {axis_name!r} axis")
    coll = Collectives(mesh)
    b = B // n_dev
    r = coll.rank(axis_name)
    arrays, n_cap = _run_seeds(problem, keys[r * b:(r + 1) * b], opts,
                               controller=controller, cost=cost)
    arrays = _gather_rows(coll, arrays, axis_name)
    return dc_replace(_result(arrays, n_cap, opts.record_every),
                      collectives=tuple(coll.log))

