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
