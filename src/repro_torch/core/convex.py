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
"""

from __future__ import annotations

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
        g = self.A[i] @ (x - self.b[i])
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
        H = (Xi.T * s) @ Xi / yi.shape[0] + self.lam * torch.eye(
            self.dim, dtype=_F32, device=self.device)
        if self.hess_noise:
            H = H + self.hess_noise * _sym_noise(key, self.dim, self.device)
        return H

    def mean_hessian(self):
        return _logistic_full_hessian(self.X, self.y, self.lam, self.x_star)


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
