"""The 2-D engine on ``torch.distributed`` (engine ``"sharded2d"``):
workers sharded over ``"data"``, the parameter dimension over
``"model"``.

SPMD as the 1-D engine (``core.sharded``): every rank calls
``repro_torch.run`` with the same arguments and a ``DeviceMesh`` with
dimensions ``("data", "model")``, or ``("pod", "data", "model")`` under
``hierarchy`` (``init_device_mesh``'s row-major rank order: pod-major
workers, model fastest), and every rank returns the same ``RanlResult``.

A rank holds n_local = N / (pods · n_data) workers and the p = d / n_model
coordinates [row_start, row_start + p) of its model shard: its (n_local,
p) tile of the gradient memory C, its slice of ``hdiag``, of the late
buffer and of the error-feedback residual, and — dense curvature — its
(p, d) row panel of the lower Cholesky factor of [H]_μ.  Its problem is
a view: its workers' leaves, A cut to its rows (``row_panel``).  The
iterate x is replicated: the gradient oracles need all of it.

* ``curvature="dense"`` shards the whole program, init included
  (``_dense_init``): the mean Hessian's row panel as a running sum of
  ``worker_hessian_rows`` over the local workers, one all-reduce over
  ``"data"`` (and ``"pod"``); the Newton–Schulz projection over row
  panels (``hessian.project_psd_ns_panels``); the blocked right-looking
  factorization over the panels (``_factor_panels``); the first step by
  blocked substitution (``_solve_panels``).  No tensor the engine makes
  is larger than one (p, d) panel (``analysis.memory``).
* ``curvature="diag"`` runs the scan engine's init replicated and keeps
  the slices.

The rounds are the 1-D engine's loop (``sharded._sharded_rounds``) on the
rank's coordinates: masks on the full (N, Q) on every rank, the rank's
rows of them; the round's ONE data-axis all-reduce carries p floats
(compressed on the slice under ``compression``); the step assembles the
full (d,) step with model-axis all-reduces of at most d floats — the
blocked solve (dense) or one scatter of the slices (diag).  With one data
rank and no quorum, compression or hierarchy, a diag round is one K2
(``kernels.ops.ranl_update``) on the rank's d-slice, whose workers are
all local, and one scatter.  Every collective goes through the recorder
of ``core.collectives``; the result carries its log.
"""

from __future__ import annotations

import torch

from .. import prng
from ..kernels import ops as kernel_ops
from .collectives import Collectives
from .hessian import project_diag, project_psd_ns_panels
from .ranl import RanlResult, _config, _hetero_defaults, _init_phase, \
    _run_scan
from .sharded import _check_pod_mesh, _finish, _local_problem, \
    _sharded_rounds, _worker_start

_F32 = torch.float32


def _check_mesh2d(problem, mesh, data_axis: str, model_axis: str):
    """-> (n_data, n_model); raises naming a missing dimension, or N or d
    not dividing across it."""
    names = tuple(mesh.mesh_dim_names or ())
    for ax in (data_axis, model_axis):
        if ax not in names:
            raise ValueError(f"mesh {names} has no {ax!r} axis — the 2-D "
                             f"engine needs a ({data_axis!r}, "
                             f"{model_axis!r}) mesh")
    n_data = mesh.size(names.index(data_axis))
    n_model = mesh.size(names.index(model_axis))
    if problem.num_workers % n_data:
        raise ValueError(
            f"num_workers={problem.num_workers} must divide evenly across "
            f"the {n_data} devices of the {data_axis!r} mesh axis")
    if problem.dim % n_model:
        raise ValueError(
            f"dim={problem.dim} must divide evenly across the {n_model} "
            f"devices of the {model_axis!r} mesh axis")
    return n_data, n_model


def _scatter(coll, vec_loc, row_start: int, d: int, dim: str):
    """The replicated (d,) vector from every model shard's slice: one
    all-reduce of d floats over ``dim``."""
    full = torch.zeros(d, dtype=vec_loc.dtype, device=vec_loc.device)
    full[row_start:row_start + vec_loc.shape[0]] = vec_loc
    return coll.all_reduce(full, dim).wait()


def _factor_panels(h_panel, *, coll, dim: str):
    """Blocked right-looking Cholesky over row panels: this rank's (p, d)
    rows of [H]_μ -> the same rows of the lower factor L.  Column block
    j: one all-reduce of the (p, p) diagonal block from rank j, which
    every rank factors; the ranks below solve their piece of the block
    column; one all-gather of the finished (d, p) column block; the
    trailing update, locally."""
    me, n = coll.rank(dim), coll.size(dim)
    p = h_panel.shape[0]
    W = h_panel.clone()
    for j in range(n):
        s, e = j * p, (j + 1) * p
        blk = W[:, s:e]
        diag = coll.all_reduce(blk.clone() if me == j
                               else torch.zeros_like(blk), dim).wait()
        l_jj = torch.linalg.cholesky(diag)
        if me == j:
            col = l_jj
        elif me > j:
            col = torch.linalg.solve_triangular(l_jj, blk.T,
                                                upper=False).T
        else:                  # above the diagonal block: 0 in L
            col = torch.zeros_like(blk)
        W[:, s:e] = col
        if j + 1 < n:
            col_all = coll.all_gather(col, dim).reshape(-1, p)   # (d, p)
            W[:, e:] -= col @ col_all[e:].T
    return W


def _solve_panels(l_panel, g_loc, *, coll, dim: str, row_start: int):
    """Solve (L Lᵀ) s = g over row panels; returns the FULL (d,) step.
    ``l_panel``: this rank's (p, d) rows of L; ``g_loc``: its (p,) rows
    of g.  Block forward and backward substitution, the block loop over
    the model shards: each collective is an all-reduce of d floats (a
    freshly solved block, or the partial Lᵀs), and the backward sweep
    leaves every rank with the whole step."""
    me, n = coll.rank(dim), coll.size(dim)
    p, d = l_panel.shape
    rows = slice(row_start, row_start + p)
    diag = l_panel[:, rows]

    def solved(rhs, upper):
        out = torch.zeros(d, dtype=l_panel.dtype, device=l_panel.device)
        out[rows] = torch.linalg.solve_triangular(
            diag.T if upper else diag, rhs[:, None], upper=upper)[:, 0]
        return out

    y = torch.zeros(d, dtype=l_panel.dtype, device=l_panel.device)
    for j in range(n):                               # forward: L y = g
        mine = (solved(g_loc - l_panel @ y, False) if me == j
                else torch.zeros_like(y))
        y = y + coll.all_reduce(mine, dim).wait()
    y_loc = y[rows]
    s = torch.zeros_like(y)
    for j in reversed(range(n)):                     # backward: Lᵀ s = y
        lts = coll.all_reduce(l_panel.T @ s[rows], dim).wait()
        mine = (solved(y_loc - lts[rows], True) if me == j
                else torch.zeros_like(s))
        s = s + coll.all_reduce(mine, dim).wait()
    return s


def _dense_init(local, k_init, coll, *, start: int, row_start: int,
                num_workers: int, mu: float, lr: float, ns_iters,
                worker_dims, model_axis: str):
    """Alg. 1 lines 1–8 with every d×d object as row panels.  ``local``:
    the rank's problem view.  Returns (x1, C0, L panel): the replicated
    post-init iterate, the rank's (n_local, p) memory tile and its rows
    of the lower factor."""
    N, d, dev = num_workers, local.dim, local.device
    n_local = local.num_workers
    p = d // coll.size(model_axis)
    own = slice(start, start + n_local)
    hkeys = prng.split(prng.fold_in(k_init, 0), N)[own]
    gkeys = prng.split(prng.fold_in(k_init, 1), N)[own]
    x0 = torch.zeros(d, dtype=_F32, device=dev)
    h = torch.zeros((p, d), dtype=_F32, device=dev)
    for i in range(n_local):          # one worker's rows in flight
        h = h + local.worker_hessian_rows(i, x0, hkeys[i], row_start, p)

    def worker_sum(t):                # over every worker: data (+ pod)
        for dim in worker_dims:
            t = coll.all_reduce(t, dim).wait()
        return t

    h = worker_sum(h) / N
    h_mu = project_psd_ns_panels(h, mu, coll=coll, dim=model_axis,
                                 num_iters=ns_iters)
    del h
    chol = _factor_panels(h_mu, coll=coll, dim=model_axis)
    del h_mu
    g0 = local.worker_grads_rows(x0.expand(n_local, d), gkeys, row_start, p)
    gbar = worker_sum(g0.sum(dim=0)) / N
    step0 = _solve_panels(chol, gbar, coll=coll, dim=model_axis,
                          row_start=row_start)
    return x0 - lr * step0, g0, chol


def _chunked_losses(problem, xs, rows: int):
    """``problem.losses`` over ``rows`` iterates at a time, so that its
    (N, d, rows) temporaries stay within a panel."""
    return torch.cat([problem.losses(xs[a:a + rows])
                      for a in range(0, xs.shape[0], rows)])


def _run_sharded2d(problem, key, opts, *, mesh, data_axis: str = "data",
                   model_axis: str = "model", pod_axis: str = "pod",
                   controller=None, cost=None) -> RanlResult:
    """Engine ``"sharded2d"`` of ``repro_torch.run``: Algorithm 1 with the
    workers sharded over ``data_axis`` (and ``pod_axis`` under
    ``hierarchy``) and the parameter dimension over ``model_axis``.
    ``num_workers`` must divide across the data dimension and ``dim``
    across the model dimension.  Dense curvature takes ``projection``
    ``"ns"`` (the default here; ``"eigh"`` is a ``ValueError``: it needs
    the d×d matrix on one rank).  ``num_rounds <= 0`` validates the mesh
    and runs the scan engine with that projection, as the reference
    does."""
    n_data, n_model = _check_mesh2d(problem, mesh, data_axis, model_axis)
    dense = opts.curvature == "dense"
    projection = opts.projection or ("ns" if dense else "eigh")
    if opts.num_rounds <= 0:
        return _run_scan(problem, key, opts.merged(projection=projection),
                         controller=controller, cost=cost)
    T = int(opts.num_rounds)
    hspec = opts.hierarchy_spec()
    if hspec is not None:
        _check_pod_mesh(problem, mesh, data_axis, pod_axis, hspec, T)
    ctrl, cost = _hetero_defaults(problem, opts.policy, controller, cost)
    if dense and projection == "eigh":
        raise ValueError(
            "projection='eigh' is not implementable on the 2-D dense path "
            "(no rank may hold a d×d buffer) — use projection='ns' or "
            "leave projection=None for the engine default")
    cfg = _config(problem, mu=opts.mu, lr=opts.lr, curvature=opts.curvature,
                  hutchinson_samples=opts.hutchinson_samples,
                  projection=projection)
    mu, lr = cfg["mu"], cfg["lr"]
    qspec, comp = opts.quorum_spec(), opts.compression_spec()
    coll = Collectives(mesh)
    N, d = problem.num_workers, problem.dim
    start, n_local = _worker_start(coll, N, n_data, hspec, data_axis,
                                   pod_axis)
    p = d // n_model
    row_start = coll.rank(model_axis) * p
    rows = slice(row_start, row_start + p)
    local = _local_problem(problem, start, n_local).row_panel(row_start, p)
    k_init, k_loop = prng.split(key)

    def scatter(vec_loc):
        return _scatter(coll, vec_loc, row_start, d, model_axis)

    fused = None
    if dense:
        worker_dims = (data_axis,) if hspec is None else (data_axis,
                                                          pod_axis)
        x1, C, chol = _dense_init(
            local, k_init, coll, start=start, row_start=row_start,
            num_workers=N, mu=mu, lr=lr, ns_iters=opts.ns_iters,
            worker_dims=worker_dims, model_axis=model_axis)

        def step(x, g):
            return x - lr * _solve_panels(chol, g, coll=coll, dim=model_axis,
                                          row_start=row_start)
    else:
        x1, C0, _, hdiag = _init_phase(
            problem, k_init, mu=mu, lr=lr, curvature="diag",
            hutch_samples=cfg["hutch_samples"])
        C = C0[start:start + n_local, rows].clone()
        del C0
        hdiag = hdiag[rows].clone()

        def step(x, g):
            return x - lr * scatter(g / project_diag(hdiag, mu))

        if (opts.use_kernel and n_data == 1 and qspec is None
                and comp is None and hspec is None):
            # every worker is on this rank: K2 on its d-slice
            def fused(x, G, Mx, C):
                x_loc, C = kernel_ops.ranl_update(
                    x[rows], hdiag, G, Mx, C, mu=mu, lr=lr)
                return scatter(x_loc), C

    arrays = _sharded_rounds(
        local, k_loop, x1, C, cost, coll, step=step, cols=(row_start, p),
        axis_name=data_axis, pod_axis=pod_axis, start=start, num_workers=N,
        num_rounds=T, num_regions=int(opts.num_regions), controller=ctrl,
        overlap=bool(opts.overlap), qspec=qspec, comp=comp, hspec=hspec,
        fused=fused)
    pods = 1 if hspec is None else hspec.pods
    losses = _chunked_losses(problem, arrays[0], max(1, p // N))
    return _finish(problem, arrays, coll, N // pods, opts.record_every,
                   losses=losses)

