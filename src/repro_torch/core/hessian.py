"""Hessian utilities: Definition 4 projection, one-shot estimators.

``project_psd``/``[A]_μ`` projects a symmetric matrix onto
{M : Mᵀ = M, μI ⪯ M} by eigenvalue clamping — the paper's
``[A]_μ := [A − μI]_0 + μI``.  For the diagonal path the same operator
specializes to ``max(h, μ)`` elementwise.

``project_psd_ns`` computes the same operator without an
eigendecomposition, via ``[A]_μ = (sym(A) + μI + |sym(A) − μI|) / 2``
with the matrix absolute value from a Newton–Schulz sign iteration.

The dense solve factors [H]_μ with ``torch.linalg.cholesky`` (the LOWER
factor) and solves with two triangular solves.  The reference factors
the upper triangle, so the two agree to rounding, not bit for bit.

The 2-D engine's panel forms: ``project_psd_ns_panels`` runs the same
Newton–Schulz iteration on model-shard row panels ((d/n, d) slabs, n the
extent of the model dimension), each product assembled by all-reduces
through the collective recorder (``core.collectives``), so no rank holds
a d×d buffer; ``blocked_cholesky``/``blocked_cho_solve`` are the
single-device schedule ``core.sharded2d`` spreads over those panels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import prng


def symmetrize(a):
    return 0.5 * (a + a.T)


def sym_eigh(a):
    """Eigendecomposition of sym(a), ascending (the reference's
    ``jnp.linalg.eigh`` symmetrizes its input the same way)."""
    return torch.linalg.eigh(symmetrize(a))


def project_psd(a, mu: float):
    """[A]_μ (Definition 4): clamp eigenvalues of sym(A) at μ."""
    w, v = torch.linalg.eigh(symmetrize(a))
    w = torch.clamp_min(w, float(mu))
    return (v * w) @ v.T


def _ns_sign_step(x):
    """One cubic Newton–Schulz step x ↦ 1.5x − 0.5x³, re-symmetrized
    (the sign map doubles antisymmetric rounding drift every step)."""
    return symmetrize(1.5 * x - 0.5 * (x @ (x @ x)))


def ns_auto_iters(dim: int) -> int:
    """Newton–Schulz step count from the Frobenius-prescaled spectral
    bound: ``ceil(log(√d / rtol) / log 1.5) + 6`` with ``rtol = eps^0.75``
    of f32, clamped to [10, 60]."""
    rtol = float(np.finfo(np.float32).eps) ** 0.75
    linear = math.log(math.sqrt(float(dim)) / rtol) / math.log(1.5)
    return min(60, max(10, math.ceil(linear) + 6))


def resolve_ns_iters(num_iters, dim: int) -> int:
    """``"auto"`` -> ``ns_auto_iters(dim)``; anything else -> int."""
    if num_iters == "auto":
        return ns_auto_iters(dim)
    return int(num_iters)


def project_psd_ns(a, mu: float, *, num_iters: int | str = 60,
                   tol: float | None = None):
    """[A]_μ by matmuls only: Newton–Schulz |·| instead of ``eigh``.

    ``B = sym(a) − μI`` is scaled by its Frobenius norm, ``sign(B)`` is
    iterated ``num_iters`` times (or until the iterate moves less than
    ``tol`` in max-norm), and ``[A]_μ = (B + B·sign(B))/2 + μI``."""
    d = a.shape[0]
    num_iters = resolve_ns_iters(num_iters, d)
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    b = symmetrize(a) - float(mu) * eye
    s = torch.sqrt(torch.sum(b * b)) + torch.finfo(a.dtype).tiny
    x = b / s
    for _ in range(num_iters):
        x, prev = _ns_sign_step(x), x
        if tol is not None and float(torch.max(torch.abs(x - prev))) <= tol:
            break
    abs_b = symmetrize(b @ x)                       # |B| = B·sign(B)
    return 0.5 * (b + abs_b) + float(mu) * eye


def _panel_products(a_panel, b_panel, *, coll, dim: str):
    """This rank's rows of A @ B for symmetric A, B held as row panels
    over the mesh dimension ``dim``.  With Aᵀ = A, shard j's rows are
    Σᵢ (Aᵢ[:, blkⱼ])ᵀ @ Bᵢ, each term a product of panels rank i holds:
    per destination j one all-reduce of a (p, d) panel, kept by rank j.
    (A ``reduce`` to j would move half the bytes, but gloo reduces host
    tensors only, and two ranks on one card run gloo on CUDA tensors.)"""
    me, n = coll.rank(dim), coll.size(dim)
    p = a_panel.shape[0]
    out = None
    for j in range(n):
        part = a_panel[:, j * p:(j + 1) * p].T @ b_panel
        total = coll.all_reduce(part, dim).wait()
        if j == me:
            out = total
    return out


def _panel_transpose(x_panel, *, coll, dim: str):
    """This rank's rows of Xᵀ from X's row panels: shard j's column
    block i is (X[blkᵢ, blkⱼ])ᵀ, a (p, p) block rank i holds; each rank
    puts its block in its column slot of a zero (p, d) panel and one
    all-reduce per destination assembles the rows."""
    me, n = coll.rank(dim), coll.size(dim)
    p = x_panel.shape[0]
    out = None
    for j in range(n):
        contrib = torch.zeros_like(x_panel)
        contrib[:, me * p:(me + 1) * p] = x_panel[:, j * p:(j + 1) * p].T
        total = coll.all_reduce(contrib, dim).wait()
        if j == me:
            out = total
    return out


def _eye_panel(p: int, d: int, row_start: int, like):
    cols = torch.arange(d, device=like.device)
    rows = row_start + torch.arange(p, device=like.device)
    return (cols[None, :] == rows[:, None]).to(like.dtype)


def project_psd_ns_panels(h_panel, mu: float, *, coll, dim: str,
                          num_iters: int | str = 60):
    """``project_psd_ns`` over row panels: ``h_panel`` is this rank's
    (p, d) rows of sym(A) on the mesh dimension ``dim`` (p = d / its
    extent, rank r holding rows r·p …).  Every matmul becomes
    ``_panel_products`` and the per-step symmetrization
    ``_panel_transpose``: three rounds of panel all-reduces a step, the
    cube associated as (X·X)·X.  Returns this rank's rows of [A]_μ."""
    p, d = h_panel.shape
    num_iters = resolve_ns_iters(num_iters, d)
    eye = _eye_panel(p, d, coll.rank(dim) * p, h_panel)
    b = h_panel - float(mu) * eye
    s = torch.sqrt(coll.all_reduce(torch.sum(b * b), dim).wait()) \
        + torch.finfo(h_panel.dtype).tiny
    x = b / s
    for _ in range(num_iters):
        xn = 1.5 * x - 0.5 * _panel_products(
            _panel_products(x, x, coll=coll, dim=dim), x, coll=coll,
            dim=dim)
        x = 0.5 * (xn + _panel_transpose(xn, coll=coll, dim=dim))
    abs_b = _panel_products(b / s, x, coll=coll, dim=dim) * s   # |B| rows
    return 0.5 * (b + abs_b) + float(mu) * eye


def project_psd_sharded(a, mu: float, *, mesh, axis_name: str = "model",
                        num_iters: int | str = 60):
    """[A]_μ with the rows split over the ``axis_name`` dimension of the
    ``DeviceMesh`` ``mesh``: every rank passes the same d×d ``a`` and
    gets back its own (d/n, d) row panel of the projection
    (``project_psd_ns_panels`` on its rows of sym(a)).  d must divide
    across the dimension's n ranks."""
    from .collectives import Collectives
    coll = Collectives(mesh)
    n = coll.size(axis_name)
    d = a.shape[0]
    if d % n:
        raise ValueError(f"dim={d} must divide evenly across the {n} "
                         f"devices of the {axis_name!r} mesh axis")
    p = d // n
    r0 = coll.rank(axis_name) * p
    rows = 0.5 * (a[r0:r0 + p] + a[:, r0:r0 + p].T)
    return project_psd_ns_panels(rows, mu, coll=coll, dim=axis_name,
                                 num_iters=resolve_ns_iters(num_iters, d))


def blocked_cholesky(a, block_size: int):
    """Right-looking blocked Cholesky: the lower factor L, a = L Lᵀ.
    ``block_size`` columns at a time (the last block may be ragged):
    factor the diagonal block, solve the panel below it, apply the
    symmetric trailing update.  The schedule ``core.sharded2d`` spreads
    over the model dimension's row panels."""
    if block_size < 1:
        raise ValueError(f"need block_size >= 1, got {block_size}")
    d = a.shape[0]
    L = torch.zeros_like(a)
    W = a.clone()
    for s in range(0, d, block_size):
        e = min(s + block_size, d)
        ljj = torch.linalg.cholesky(W[s:e, s:e])
        L[s:e, s:e] = ljj
        if e < d:
            # panel solve: L[e:, s:e] = W[e:, s:e] L_jj⁻ᵀ
            panel = torch.linalg.solve_triangular(
                ljj, W[e:, s:e].T, upper=False).T
            L[e:, s:e] = panel
            W[e:, e:] -= panel @ panel.T
    return L


def blocked_cho_solve(chol_l, b, block_size: int):
    """Solve (L Lᵀ) x = b for a vector b by blocked forward and backward
    substitution, one (block, block) diagonal tile at a time."""
    if block_size < 1:
        raise ValueError(f"need block_size >= 1, got {block_size}")
    d = chol_l.shape[0]
    starts = range(0, d, block_size)
    y = torch.zeros_like(b)
    for s in starts:                               # forward: L y = b
        e = min(s + block_size, d)
        rhs = b[s:e] - chol_l[s:e, :s] @ y[:s]
        y[s:e] = torch.linalg.solve_triangular(
            chol_l[s:e, s:e], rhs[:, None], upper=False)[:, 0]
    x = torch.zeros_like(b)
    for s in reversed(starts):                     # backward: Lᵀ x = y
        e = min(s + block_size, d)
        rhs = y[s:e] - chol_l[e:, s:e].T @ x[e:]
        x[s:e] = torch.linalg.solve_triangular(
            chol_l[s:e, s:e].T, rhs[:, None], upper=True)[:, 0]
    return x


def project_diag(h, mu: float):
    """Diagonal specialization of [·]_μ: elementwise max(h, μ)."""
    return torch.clamp_min(h, float(mu))


def cho_factor(a_mu):
    """Lower Cholesky factor of [H]_μ (⪰ μI > 0)."""
    return torch.linalg.cholesky(a_mu)


def cho_solve(chol_l, g):
    """Solve (L Lᵀ) x = g for a vector g (d,), or for B of them (B, d)
    against B factors (B, d, d): two triangular solves.

    ``torch.cholesky_solve`` computes the same two solves, bit for bit on
    the host, but on an H100 it takes B = 8 factors of d = 8192 in about
    17× the time of these two batched calls (PERF.md §5)."""
    return cho_solve_rows(chol_l, g[..., None, :])[..., 0, :]


def cho_solve_rows(chol_l, g):
    """Solve (L Lᵀ) x = g_p for the P rows of g (..., P, d) against the
    factor(s) (..., d, d): the same two triangular solves, with P
    right-hand sides.  Returns (..., P, d)."""
    y = torch.linalg.solve_triangular(chol_l, g.mT, upper=False)
    return torch.linalg.solve_triangular(chol_l.mT, y, upper=True).mT


def solve_projected(a_mu, g):
    """x-update direction [H]_μ^{-1} g via a Cholesky solve."""
    return cho_solve(cho_factor(a_mu), g)


def running_mean_hessian(problem, x, hkeys):
    """Mean worker Hessian as an eager left-to-right running sum — one
    Hessian in flight (O(d²) peak) and the reference's summation order,
    which is what keeps scan-vs-reference parity tight."""
    N, d = problem.num_workers, problem.dim
    H = torch.zeros((d, d), dtype=torch.float32, device=problem.device)
    for i in range(N):
        H = H + problem.worker_hessian(i, x, hkeys[i])
    return H / N


def hutchinson_diag(grad_fn, params, key, num_samples: int = 8):
    """Diagonal Hessian estimate diag(H) ≈ E[z ⊙ (Hz)], z ~ Rademacher.

    ``grad_fn``: (d,) -> (d,).  Each probe is one Hessian-vector product,
    a ``torch.func.jvp`` of the gradient; probe s draws
    ``rademacher(fold_in(fold_in(key, s), 0))`` (the reference's key for
    the first and only parameter leaf)."""
    probes = []
    for s in range(int(num_samples)):
        z = prng.rademacher(prng.fold_in(prng.fold_in(key, s), 0),
                            params.shape, params.device)
        hz = torch.func.jvp(grad_fn, (params,), (z,))[1]
        probes.append(z * hz)
    return torch.stack(probes).sum(dim=0) / num_samples


def fisher_diag(grad_fn, params, keys):
    """Empirical-Fisher diagonal: the mean over ``keys`` of the squared
    gradients ``grad_fn(params, key)`` (a parameter tree, or a tensor).
    ``keys``: stacked ``prng`` keys (K, 2); one gradient a key, in order."""
    from ..tree import tree_map
    keys = prng.as_key(keys)
    total = None
    for k in keys:
        sq = tree_map(torch.square, grad_fn(params, k))
        total = sq if total is None else tree_map(torch.add, total, sq)
    return tree_map(lambda a: a / len(keys), total)
