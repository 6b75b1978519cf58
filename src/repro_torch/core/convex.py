"""Convex problem zoo for the paper-faithful RANL reproduction.

Each problem exposes per-worker stochastic oracles with controllable
constants from the paper's assumptions: condition number κ = L_g/μ,
gradient noise Δ, Hessian noise σ at x⁰, and data heterogeneity.

Problems are frozen dataclasses of tensors on one device.  The engines
call the batched oracle ``worker_grads`` (all N workers in one product,
and all B seeds of the batch engine in the same product, so A or X is
read once a round whatever B is); ``worker_grad``/``worker_hessian`` are
the single-worker forms.  A zero noise scale adds exact zeros in the
reference, so the draw is skipped.

The ``*_rows`` oracles give rows [row_start, row_start+num_rows) of
their full counterparts, bit for bit, for the 2-D engine's model shards
(``core.sharded2d``): from a row panel of A (a ``row_panel`` view, or
the whole A, which they slice) and from a column slice of Xᵢ, never
holding a d×d buffer.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import prng
from ..device import resolve_device

_F32 = torch.float32


def _sym_noise(key, d: int, device):
    """Symmetric Hessian noise (z + zᵀ)/2; row r of z is
    ``normal(fold_in(key, r), (d,)) / d`` — its own key stream."""
    z = prng.normal(prng.fold_in(key, np.arange(d)), (d,), device) / d
    return 0.5 * (z + z.T)


def _sym_noise_rows(key, d: int, row_start: int, num_rows: int, device):
    """Rows [row_start, row_start+num_rows) of ``_sym_noise(key, d)``,
    bit for bit.  z's rows come from their own streams; its columns at
    the panel (entry [c, r] lives in row c's stream) from every source
    row, a chunk of rows at a time, keeping the chunk's slice of the
    panel's columns.  A chunk is half the panel's rows: the draw's int64
    and float64 temporaries then stay within one (num_rows, d) f32
    panel, so no tensor exceeds the output's size."""
    chunk = max(1, num_rows // 2)
    panel = slice(row_start, row_start + num_rows)

    def z(r0, r1):                       # z[r0:r1, :]
        return prng.normal(prng.fold_in(key, np.arange(r0, r1)), (d,),
                           device) / d

    rows = torch.empty((num_rows, d), dtype=_F32, device=device)
    for a in range(0, num_rows, chunk):
        b = min(a + chunk, num_rows)
        rows[a:b] = z(row_start + a, row_start + b)
    cols = torch.empty((d, num_rows), dtype=_F32, device=device)
    for a in range(0, d, chunk):         # z[:, panel]
        b = min(a + chunk, d)
        cols[a:b] = z(a, b)[:, panel]
    return 0.5 * (rows + cols.T)


def _rows_of(m, row_start: int, num_rows: int):
    """Rows [row_start, row_start+num_rows) of ``m`` (..., R, d) along
    dim -2, or ``m`` itself when it holds exactly ``num_rows`` rows (a
    ``row_panel`` view's A)."""
    if m.shape[-2] == num_rows:
        return m
    return m[..., row_start:row_start + num_rows, :]


def _row_dots(m, v):
    """m @ v as a product and a sum over each row: unlike a BLAS matrix-
    vector product, a row's value does not depend on how many rows come
    with it, so a panel's rows equal the full product's."""
    return (m * v).sum(dim=-1)


_GRAM_BLOCK = 16


def _gram_rows(X, s, row_start: int, num_rows: int):
    """Rows [row_start, row_start+num_rows) of Xᵀ diag(s) X, X (n, d).
    The rows are computed in blocks of ``_GRAM_BLOCK`` at fixed offsets
    (multiples of the block), each one (block, n) @ (n, d) product: a
    matrix product's rounding depends on its row count, so fixing the
    blocks makes a panel's rows those of the whole matrix, bit for bit."""
    d = X.shape[1]
    out = torch.empty((num_rows, d), dtype=X.dtype, device=X.device)
    end = row_start + num_rows
    for a in range(row_start - row_start % _GRAM_BLOCK, end, _GRAM_BLOCK):
        b = min(a + _GRAM_BLOCK, d)
        blk = (X[:, a:b].T * s) @ X
        lo, hi = max(a, row_start), min(b, end)
        out[lo - row_start:hi - row_start] = blk[lo - a:hi - a]
    return out


def _eye_rows(d: int, row_start: int, num_rows: int, device):
    """Rows [row_start, row_start+num_rows) of the d×d identity."""
    cols = torch.arange(d, device=device)
    rows = row_start + torch.arange(num_rows, device=device)
    return (cols[None, :] == rows[:, None]).to(_F32)


def _grad_noise(scale: float, keys, d: int, device):
    """``scale · normal(key_i, (d,)) / √d`` per worker key; (N, d)."""
    return scale * prng.normal(keys, (d,), device) \
        / float(np.float32(math.sqrt(d * 1.0)))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _per_worker_columns(v, n_workers: int):
    """(..., N, d) -> (N, d, S): each worker's S = prod(...) vectors as the
    columns of one right-hand side."""
    d = v.shape[-1]
    return v.reshape(-1, n_workers, d).permute(1, 2, 0)


def _from_columns(cols, shape):
    """(N, d, S) -> ``shape`` = (..., N, d), contiguous: the inverse of
    ``_per_worker_columns``."""
    return cols.permute(2, 0, 1).reshape(shape).contiguous()


@dataclass(frozen=True)
class Quadratic:
    """f_i(x) = ½ (x − b_i)ᵀ A_i (x − b_i);  f = mean_i f_i."""
    A: torch.Tensor         # (N, d, d) per-worker PSD Hessians
    b: torch.Tensor         # (N, d) per-worker optima
    grad_noise: float       # Δ
    hess_noise: float       # σ
    x_star: torch.Tensor    # argmin of the average loss
    mu: float               # λ_min of mean Hessian
    L_g: float              # λ_max of mean Hessian

    @property
    def dim(self) -> int:
        return self.b.shape[1]

    @property
    def num_workers(self) -> int:
        return self.b.shape[0]

    @property
    def device(self) -> torch.device:
        return self.b.device

    def tensors(self):
        return (self.A, self.b, self.x_star)

    def loss(self, x):
        return self.losses(x[None, :])[0]

    def losses(self, xs):
        """(T, d) iterates -> (T,) losses; A is read once for all T
        (never broadcast to (T, N, d, d))."""
        r = (xs[:, None, :] - self.b[None]).permute(1, 2, 0)   # (N, d, T)
        quad = (r * torch.bmm(self.A, r)).sum(dim=1)            # (N, T)
        return 0.5 * (quad.sum(dim=0) / self.num_workers)

    def worker_grads(self, xs, keys):
        """Stochastic ∇F_i(x_i, ξ_i) for every worker: xs (..., N, d), keys
        (..., N, 2) -> (..., N, d), one product over A."""
        N = self.num_workers
        g = _from_columns(torch.bmm(self.A, _per_worker_columns(
            xs - self.b, N)), xs.shape)
        if self.grad_noise:
            g = g + _grad_noise(self.grad_noise, keys, self.dim, self.device)
        return g

    def worker_grad(self, i, x, key):
        g = _row_dots(self.A[i], x - self.b[i])
        if self.grad_noise:
            g = g + _grad_noise(self.grad_noise, key, self.dim, self.device)
        return g

    def worker_hessian(self, i, x, key):
        """Stochastic ∇²F_i(x⁰, ξ): exact + symmetric noise (Frobenius σ)."""
        if not self.hess_noise:
            return self.A[i]
        return self.A[i] + self.hess_noise * _sym_noise(key, self.dim,
                                                        self.device)

    def mean_hessian(self):
        return self.A.sum(dim=0) / self.num_workers

    def row_panel(self, row_start: int, num_rows: int) -> "Quadratic":
        """The problem with A cut to its rows [row_start, row_start +
        num_rows) (a view): what a model shard of the 2-D engine holds.
        Only the ``*_rows`` oracles read it."""
        return dataclasses.replace(
            self, A=self.A[:, row_start:row_start + num_rows])

    def worker_grad_rows(self, i, x, key, row_start: int, num_rows: int):
        """Rows [row_start, row_start+num_rows) of ``worker_grad``, bit
        for bit: a panel of A times x − bᵢ (``_row_dots``), the noise
        drawn at full length and sliced."""
        g = _row_dots(_rows_of(self.A[i], row_start, num_rows),
                      x - self.b[i])
        if self.grad_noise:
            g = g + _grad_noise(self.grad_noise, key, self.dim, self.device
                                )[row_start:row_start + num_rows]
        return g

    def worker_grads_rows(self, xs, keys, row_start: int, num_rows: int):
        """Rows [row_start, row_start+num_rows) of ``worker_grads``: xs
        (..., N, d), keys (..., N, 2) -> (..., N, num_rows), one product
        over the panel of A."""
        N = self.num_workers
        g = _from_columns(torch.bmm(
            _rows_of(self.A, row_start, num_rows),
            _per_worker_columns(xs - self.b, N)),
            xs.shape[:-1] + (num_rows,))
        if self.grad_noise:
            g = g + _grad_noise(self.grad_noise, keys, self.dim, self.device
                                )[..., row_start:row_start + num_rows]
        return g

    def worker_hessian_rows(self, i, x, key, row_start: int,
                            num_rows: int):
        """Rows [row_start, row_start+num_rows) of ``worker_hessian``: a
        panel of A plus the noise panel (``_sym_noise_rows``)."""
        rows = _rows_of(self.A[i], row_start, num_rows)
        if not self.hess_noise:
            return rows
        return rows + self.hess_noise * _sym_noise_rows(
            key, self.dim, row_start, num_rows, self.device)


def _worker_het_scales(heterogeneity: float, worker_weights,
                       num_workers: int, device):
    """(N,) per-worker heterogeneity scales (1/√w skew for mean-1 data
    shares ``worker_weights``; uniform when None)."""
    if worker_weights is None:
        return torch.full((num_workers,), float(heterogeneity), dtype=_F32,
                          device=device)
    w = torch.as_tensor(worker_weights, dtype=_F32).to(device)
    if tuple(w.shape) != (num_workers,):
        raise ValueError(f"worker_weights shape {tuple(w.shape)} != "
                         f"({num_workers},)")
    return heterogeneity / torch.sqrt(torch.clamp_min(w, 1e-3))


def _qr_q(a):
    return torch.linalg.qr(a).Q


def make_quadratic(key, *, num_workers: int = 16, dim: int = 64,
                   kappa: float = 100.0, mu: float = 1.0,
                   heterogeneity: float = 0.0, grad_noise: float = 0.0,
                   hess_noise: float = 0.0, coupling: float = 1.0,
                   num_regions: int = 1, worker_weights=None,
                   device=None) -> Quadratic:
    """Shared eigenbasis, eigenvalues logspace(μ … μκ); per-worker Hessian
    and optimum perturbed at rate ``heterogeneity``.

    ``coupling`` 0.0 gives a block-diagonal Hessian aligned to
    ``num_regions`` contiguous regions, 1.0 a fully coupled dense
    eigenbasis, and values between a re-orthogonalized blend.  Same keys
    and draws as the reference, so the arrays agree to f32 rounding."""
    dev = resolve_device(device)
    kq, kb, kp, ke, kq2 = prng.split(key, 5)
    d, N = dim, num_workers
    het = _worker_het_scales(heterogeneity, worker_weights, N, dev)

    def block_orthobasis(k):
        bounds = np.linspace(0, d, num_regions + 1).astype(int)
        mats = [_qr_q(prng.normal(prng.fold_in(k, q), (sz, sz), dev))
                for q, sz in enumerate(np.diff(bounds))]
        return torch.block_diag(*mats)

    lin = torch.linspace(0.0, float(np.float32(np.log10(kappa))), d,
                         dtype=_F32, device=dev)
    eigs = mu * torch.pow(10.0, lin)
    if coupling >= 1.0:
        qmat = _qr_q(prng.normal(kq, (d, d), dev))
    elif coupling <= 0.0:
        qmat = block_orthobasis(kq)
    else:
        qb = block_orthobasis(kq)
        qg = _qr_q(prng.normal(kq2, (d, d), dev))
        qmat = _qr_q((1.0 - coupling) * qb + coupling * qg)

    jit = torch.clamp_min(1.0 + het[:, None] * prng.uniform(
        kp, (N, d), dev, minval=-0.5, maxval=0.5), 0.05)
    lam = jit * eigs                                     # (N, d)
    A = torch.empty((N, d, d), dtype=_F32, device=dev)
    for n in range(N):                                   # one (d, d) temp
        torch.matmul(qmat * lam[n], qmat.T, out=A[n])

    b0 = prng.normal(kb, (d,), dev)
    b = b0[None, :] + het[:, None] * prng.normal(ke, (N, d), dev)

    Abar = A.sum(dim=0) / N
    rhs = torch.bmm(A, b[:, :, None])[:, :, 0].sum(dim=0) / N
    x_star = torch.linalg.solve(Abar, rhs)
    w = torch.linalg.eigvalsh(Abar)
    return Quadratic(A=A, b=b, grad_noise=grad_noise, hess_noise=hess_noise,
                     x_star=x_star, mu=float(w[0]), L_g=float(w[-1]))


@dataclass(frozen=True)
class Logistic:
    """ℓ2-regularized logistic regression; per-worker datasets (non-IID)."""
    X: torch.Tensor         # (N, n, d)
    y: torch.Tensor         # (N, n) in {−1, +1}
    lam: float
    grad_noise: float
    hess_noise: float
    x_star: torch.Tensor
    mu: float
    L_g: float

    @property
    def dim(self) -> int:
        return self.X.shape[2]

    @property
    def num_workers(self) -> int:
        return self.X.shape[0]

    @property
    def device(self) -> torch.device:
        return self.X.device

    def tensors(self):
        return (self.X, self.y, self.x_star)

    def loss(self, x):
        return self.losses(x[None, :])[0]

    def losses(self, xs):
        """(T, d) iterates -> (T,) losses."""
        N, n, d = self.X.shape
        z = (self.X.reshape(N * n, d) @ xs.T) * self.y.reshape(N * n, 1)
        reg = 0.5 * self.lam * (xs * xs).sum(dim=1)
        return _softplus(-z).sum(dim=0) / (N * n) + reg

    def worker_grads(self, xs, keys):
        """xs (..., N, d), keys (..., N, 2) -> (..., N, d) per-worker
        gradients, one product each way over X."""
        N = self.num_workers
        y = self.y[:, :, None]
        z = torch.bmm(self.X, _per_worker_columns(xs, N)) * y  # (N, n, S)
        s = torch.sigmoid(-z)
        g = -_from_columns(torch.bmm(self.X.transpose(1, 2), s * y),
                           xs.shape) / self.y.shape[1] + self.lam * xs
        if self.grad_noise:
            g = g + _grad_noise(self.grad_noise, keys, self.dim, self.device)
        return g

    def worker_grad(self, i, x, key):
        Xi, yi = self.X[i], self.y[i]
        s = torch.sigmoid(-(Xi @ x) * yi)
        g = -(Xi.T @ (s * yi)) / yi.shape[0] + self.lam * x
        if self.grad_noise:
            g = g + _grad_noise(self.grad_noise, key, self.dim, self.device)
        return g

    def worker_hessian(self, i, x, key):
        Xi, yi = self.X[i], self.y[i]
        z = (Xi @ x) * yi
        s = torch.sigmoid(z) * torch.sigmoid(-z)            # σ'(z)
        H = _gram_rows(Xi, s, 0, self.dim) / yi.shape[0] + self.lam * \
            torch.eye(self.dim, dtype=_F32, device=self.device)
        if self.hess_noise:
            H = H + self.hess_noise * _sym_noise(key, self.dim, self.device)
        return H

    def mean_hessian(self):
        return _logistic_full_hessian(self.X, self.y, self.lam, self.x_star)

    def row_panel(self, row_start: int, num_rows: int) -> "Logistic":
        """Logistic holds no O(d²) state (X is N×n×d): a model shard
        keeps it whole, and the ``*_rows`` oracles slice."""
        return self

    def worker_grad_rows(self, i, x, key, row_start: int, num_rows: int):
        """Rows [row_start, row_start+num_rows) of ``worker_grad``: the
        full gradient, sliced (O(n·d) work a shard, no communication)."""
        return self.worker_grad(i, x, key)[row_start:row_start + num_rows]

    def worker_grads_rows(self, xs, keys, row_start: int, num_rows: int):
        """Rows [row_start, row_start+num_rows) of ``worker_grads``
        (..., N, num_rows), contiguous."""
        return self.worker_grads(xs, keys)[
            ..., row_start:row_start + num_rows].contiguous()

    def worker_hessian_rows(self, i, x, key, row_start: int,
                            num_rows: int):
        """Rows [row_start, row_start+num_rows) of ``worker_hessian``:
        the Gauss–Newton rows from a column slice of Xᵢ,
        (Xᵢ[:, rows]ᵀ·σ′) @ Xᵢ / n (``_gram_rows``) — O(n·d) work, a
        (num_rows, d) result — plus λ on the identity's rows and the
        noise panel."""
        Xi, yi = self.X[i], self.y[i]
        z = (Xi @ x) * yi
        s = torch.sigmoid(z) * torch.sigmoid(-z)
        H = _gram_rows(Xi, s, row_start, num_rows) / yi.shape[0] \
            + self.lam * _eye_rows(self.dim, row_start, num_rows,
                                   self.device)
        if self.hess_noise:
            H = H + self.hess_noise * _sym_noise_rows(
                key, self.dim, row_start, num_rows, self.device)
        return H


def _logistic_full_grad(X, y, lam, x):
    N, n, d = X.shape
    Xf, yf = X.reshape(N * n, d), y.reshape(N * n)
    s = torch.sigmoid(-(Xf @ x) * yf)
    return -(Xf.T @ (s * yf)) / (N * n) + lam * x


def _logistic_full_hessian(X, y, lam, x):
    """Analytic Hessian of the mean loss: Xᵀ diag(σ′) X / (N n) + λI."""
    N, n, d = X.shape
    Xf, yf = X.reshape(N * n, d), y.reshape(N * n)
    z = (Xf @ x) * yf
    s = torch.sigmoid(z) * torch.sigmoid(-z)
    eye = torch.eye(d, dtype=_F32, device=X.device)
    return (Xf.T @ (Xf * s[:, None])) / (N * n) + lam * eye


def make_logistic(key, *, num_workers: int = 16, per_worker: int = 128,
                  dim: int = 32, lam: float = 1e-2,
                  heterogeneity: float = 0.0, grad_noise: float = 0.0,
                  hess_noise: float = 0.0, worker_weights=None,
                  device=None) -> Logistic:
    """Per-worker Gaussian designs shifted at rate ``heterogeneity`` and
    labels from a random true model; x* from 30 exact Newton steps on the
    full loss (analytic Hessian)."""
    dev = resolve_device(device)
    kw, kx, ky, kshift = prng.split(key, 4)
    N, n, d = num_workers, per_worker, dim
    het = _worker_het_scales(heterogeneity, worker_weights, N, dev)
    w_true = prng.normal(kw, (d,), dev) / float(np.float32(math.sqrt(d)))
    shifts = het[:, None, None] * prng.normal(kshift, (N, 1, d), dev)
    X = prng.normal(kx, (N, n, d), dev) + shifts
    logits = (X.reshape(N * n, d) @ w_true).reshape(N, n)
    y = torch.where(prng.uniform(ky, (N, n), dev) < torch.sigmoid(logits),
                    1.0, -1.0).to(_F32)

    x = torch.zeros(d, dtype=_F32, device=dev)
    for _ in range(30):
        x = x - torch.linalg.solve(_logistic_full_hessian(X, y, lam, x),
                                   _logistic_full_grad(X, y, lam, x))
    w = torch.linalg.eigvalsh(_logistic_full_hessian(X, y, lam, x))
    return Logistic(X=X, y=y, lam=lam, grad_noise=grad_noise,
                    hess_noise=hess_noise, x_star=x,
                    mu=float(w[0]), L_g=float(w[-1]))
