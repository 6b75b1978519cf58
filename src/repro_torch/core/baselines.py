"""Baselines the paper positions RANL against.

First-order: distributed GD / SGD (condition-number-sensitive, tuned step).
Second-order: NewtonExact (fresh full Hessian every round — the expensive
upper bound) and NewtonZero (one-shot Hessian, no pruning — RANL's ancestor
[20]; RANL with full masks matches it).  The reference's keys and draws;
each round's N worker gradients are one product (``worker_grads``).
"""

from __future__ import annotations

import torch

from .. import prng
from .hessian import project_psd, running_mean_hessian, solve_projected

_F32 = torch.float32


def _trajectory(problem, xs):
    xs = torch.stack(xs)
    return xs, ((xs - problem.x_star[None, :]) ** 2).sum(dim=1)


def _mean_grad(problem, x, keys):
    """Mean of the N workers' stochastic gradients at one point x."""
    N, d = problem.num_workers, problem.dim
    return problem.worker_grads(x.expand(N, d), keys).sum(dim=0) / N


def run_gd(problem, key, *, num_rounds: int = 30, lr: float | None = None):
    """Distributed full-gradient descent, lr = 1/L_g (the safe tuned step).
    Returns (xs (T+1, d), dist_sq (T+1,))."""
    lr = 1.0 / problem.L_g if lr is None else lr
    N = problem.num_workers
    x = torch.zeros(problem.dim, dtype=_F32, device=problem.device)
    xs = [x]
    for t in range(num_rounds):
        g = _mean_grad(problem, x, prng.split(prng.fold_in(key, t), N))
        x = x - lr * g
        xs.append(x)
    return _trajectory(problem, xs)


def run_sgd(problem, key, *, num_rounds: int = 30, lr: float | None = None):
    """GD with the stochastic oracle noise kept (Δ > 0 problems); a
    separate entry point for experiment clarity."""
    return run_gd(problem, key, num_rounds=num_rounds, lr=lr)


def run_newton_exact(problem, key, *, num_rounds: int = 30,
                     mu: float | None = None):
    """Fresh aggregated Hessian at x^t every round (communication-heavy)."""
    mu = problem.mu if mu is None else mu
    N = problem.num_workers
    x = torch.zeros(problem.dim, dtype=_F32, device=problem.device)
    xs = [x]
    for t in range(num_rounds):
        kt = prng.fold_in(key, t)
        H = running_mean_hessian(problem, x,
                                 prng.split(prng.fold_in(kt, 0), N))
        g = _mean_grad(problem, x, prng.split(prng.fold_in(kt, 1), N))
        x = x - solve_projected(project_psd(H, mu), g)
        xs.append(x)
    return _trajectory(problem, xs)


def run_newton_zero(problem, key, *, num_rounds: int = 30,
                    mu: float | None = None):
    """One-shot Hessian at x⁰ (FedNL's Newton Zero [20]); no pruning."""
    mu = problem.mu if mu is None else mu
    N = problem.num_workers
    x = torch.zeros(problem.dim, dtype=_F32, device=problem.device)
    k_init, k_loop = prng.split(key)
    H_mu = project_psd(running_mean_hessian(
        problem, x, prng.split(prng.fold_in(k_init, 0), N)), mu)
    g0 = _mean_grad(problem, x, prng.split(prng.fold_in(k_init, 1), N))
    xs = [x]
    x = x - solve_projected(H_mu, g0)
    xs.append(x)
    for t in range(1, num_rounds):
        g = _mean_grad(problem, x, prng.split(prng.fold_in(k_loop, t), N))
        x = x - solve_projected(H_mu, g)
        xs.append(x)
    return _trajectory(problem, xs)


def rounds_to_tol(dist_sq, tol: float) -> int:
    """First round index with ‖x−x*‖² ≤ tol (len(dist)-1 if never)."""
    hit = torch.nonzero(torch.as_tensor(dist_sq) <= tol)
    return int(hit[0, 0]) if len(hit) else int(len(dist_sq) - 1)
