"""Compressed uplink communication and the low-rank [H]_μ init.

* ``CompressionSpec`` / ``parse_compression``: ``"int8"`` (per-row absmax
  over 127 levels), ``"bf16"`` (a bfloat16 round trip) and ``"topk:k"``
  (keep the k highest-energy regions of each row);
* every compressor runs under ERROR FEEDBACK: a worker sends
  ``C(y + e)`` and keeps ``e' = (y + e) − C(y + e)``, which the round
  loop carries;
* ``compress_rows`` / ``compressed_server_aggregate`` /
  ``compressed_quorum_aggregate`` compress each worker's uplink row, the
  single-reduction contribution ``where(covered, G_i/denom, C_i/N)``; the
  gradient memory C stays exact (it is server state, not wire traffic);
* ``pod_sum_compressed``: the hierarchical runs' inter-pod exchange,
  one compressed sum over a pod axis with its own error feedback;
* ``psum_compressed``: the sharded engine's compressed all-reduce of each
  rank's partial sum over a mesh dimension (int8 on the wire);
* ``uplink_bytes``: the metered bytes on the wire (4 a coordinate
  uncompressed, 1 plus a 4-byte scale for int8, 2 for bf16, for top-k
  the k largest trained regions plus 4 bytes of metadata each);
* ``lowrank_hmu_factor``: instead of N dense worker Hessians, worker 0's
  projected Hessian plus the top-``rank`` eigenpairs of every other
  worker's, folded in by Cholesky updates (``kernels.ops.chol_update``:
  one launch of the hand-written kernel per worker on the card).

The reference's rules, values and draws.  Top-k breaks ties in energy by
the lower region index, as ``jax.lax.top_k`` does, through a stable sort,
so the card and the host select the same regions.  Every function
broadcasts over a leading seed axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .aggregation import _shift_in, late_fold_updates

_KINDS = ("int8", "bf16", "topk")
_EPS = 1e-30


@dataclass(frozen=True)
class CompressionSpec:
    """Static compressor parameters: ``kind`` is ``"int8"``, ``"bf16"``
    or ``"topk"`` (keep the ``k`` highest-energy regions)."""
    kind: str
    k: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown compression kind {self.kind!r} "
                             f"(expected one of {_KINDS})")
        if self.kind == "topk" and self.k < 1:
            raise ValueError(f"topk compression needs k >= 1, got "
                             f"k={self.k}")


def parse_compression(value) -> CompressionSpec | None:
    """``None | "int8" | "bf16" | "topk:k"`` -> CompressionSpec | None."""
    if value is None or isinstance(value, CompressionSpec):
        return value
    s = str(value)
    if s in ("int8", "bf16"):
        return CompressionSpec(kind=s)
    if s.startswith("topk:"):
        try:
            k = int(s.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"compression={value!r}: top-k count must "
                             f"be an int (e.g. 'topk:2')") from None
        return CompressionSpec(kind="topk", k=k)
    raise ValueError(f"compression={value!r} must be None, 'int8', "
                     f"'bf16' or 'topk:k'")


def _topk_region_mask(y_sq, region_ids, num_regions: int, k: int):
    """(..., d) bool keep-mask of the ``k`` regions of highest energy
    (per-region sums of ``y_sq``); ties go to the lower region index."""
    Q = int(num_regions)
    kk = min(int(k), Q)
    onehot = (region_ids[None, :] == torch.arange(
        Q, device=y_sq.device)[:, None]).to(y_sq.dtype)       # (Q, d)
    scores = y_sq @ onehot.T                                   # (..., Q)
    idx = torch.sort(-scores, dim=-1, stable=True).indices[..., :kk]
    keep_q = torch.zeros(scores.shape, dtype=torch.bool,
                         device=y_sq.device).scatter_(-1, idx, True)
    return keep_q.index_select(-1, region_ids)


def compress_rows(comp: CompressionSpec | None, Y, region_ids,
                  num_regions: int):
    """What the server decodes from each worker's row of ``Y`` (..., N, d);
    the caller's error-feedback residual is ``Y − compress_rows(...)``."""
    if comp is None:
        return Y
    if comp.kind == "int8":
        scale = Y.abs().amax(dim=-1, keepdim=True)
        step = torch.clamp_min(scale, _EPS) / 127.0
        q = torch.clamp(torch.round(Y / step), -127, 127)
        return q * step
    if comp.kind == "bf16":
        return Y.to(torch.bfloat16).to(Y.dtype)
    keep = _topk_region_mask(Y * Y, region_ids, num_regions, comp.k)
    return torch.where(keep, Y, torch.zeros_like(Y))


def psum_compressed(comp: CompressionSpec, y, err, *, coll, dim: str,
                    n_agg: int, region_ids, num_regions: int,
                    async_op: bool = False):
    """Compressed all-reduce of this rank's partial sum ``y`` (d,) over
    the mesh dimension ``dim`` of the recorder ``coll``
    (``core.collectives``), under the rank's error feedback ``err``.
    Sends ``C(y + err)``; returns (a ``Pending`` of the decoded sum,
    ``(y + err) − C(y + err)``).

    int8: one scale shared by the ``n_agg`` ranks (a scalar MAX
    all-reduce of |y|), each rank clipped to ±(127 // n_agg) levels, so
    the integers summed in the int8 all-reduce — one byte a coordinate
    on the wire — cannot wrap.  bf16: the bfloat16-rounded payload,
    summed in float32 as the reference's compiled program sums it (its
    CPU program all-reduces an f32 operand); the metered uplink stays 2
    bytes a coordinate (``uplink_bytes``).  top-k: the ``k`` regions of
    highest energy of the partial sum, the rest to the residual.  Only
    the payload's all-reduce honours ``async_op``."""
    y = y + err
    if comp.kind == "int8":
        scale = coll.all_reduce(y.abs().amax(), dim, "max").wait()
        cap = max(127 // max(int(n_agg), 1), 1)
        step = torch.clamp_min(scale, _EPS) / cap
        q = torch.clamp(torch.round(y / step), -cap, cap)
        pending = coll.all_reduce(q.to(torch.int8), dim, async_op=async_op,
                                  then=lambda s: s.to(y.dtype) * step)
        return pending, y - q * step
    if comp.kind == "bf16":
        sent = y.to(torch.bfloat16).to(y.dtype)
    else:
        keep = _topk_region_mask(y * y, region_ids, num_regions, comp.k)
        sent = torch.where(keep, y, torch.zeros_like(y))
    return coll.all_reduce(sent.clone(), dim, async_op=async_op), y - sent


def pod_sum_compressed(comp: CompressionSpec, y, err):
    """The compressed sum over the pod axis of ``y`` (..., P, d), the
    per-pod payloads, under error feedback ``err`` (same shape).
    Returns (total (..., d), new_err).  int8: one scale shared by the
    pods (the max over all of them), each pod clipped to ±(127 // P)
    levels so that the summed integers fit in int8; bf16: the rounded
    payloads summed."""
    n_agg = y.shape[-2]
    y = y + err
    if comp.kind == "int8":
        scale = y.abs().amax(dim=(-2, -1), keepdim=True)
        cap = max(127 // max(int(n_agg), 1), 1)
        step = torch.clamp_min(scale, _EPS) / cap
        q = torch.clamp(torch.round(y / step), -cap, cap)
        total = q.to(torch.int32).sum(dim=-2).to(y.dtype) * step[..., 0, :]
        return total, y - q * step
    if comp.kind == "bf16":
        sent = y.to(torch.bfloat16).to(y.dtype)
        return sent.sum(dim=-2), y - sent
    raise ValueError(f"pod exchange compression {comp.kind!r} is not "
                     f"supported (int8/bf16 only)")


def uplink_bytes(comp: CompressionSpec | None, M: torch.Tensor,
                 sizes_q: torch.Tensor) -> torch.Tensor:
    """(..., N) f32 modeled uplink bytes per worker for one round's
    (..., N, Q) mask; workers that train nothing send nothing."""
    kept = M.to(torch.float32) * sizes_q.to(torch.float32)
    work = kept.sum(dim=-1)
    if comp is None:
        return 4.0 * work
    zero = torch.zeros_like(work)
    if comp.kind == "int8":
        return torch.where(work > 0, work + 4.0, zero)
    if comp.kind == "bf16":
        return 2.0 * work
    kk = min(int(comp.k), int(sizes_q.shape[0]))
    top = torch.sort(kept, dim=-1).values[..., -kk:].sum(dim=-1)
    return torch.where(work > 0, 4.0 * top + 4.0 * kk, zero)


def _contributions(fresh, C, covered, denom):
    """Each worker's uplink row in single-reduction form:
    ``where(covered, fresh/denom, C/N)``."""
    return torch.where(covered[..., None, :], fresh / denom[..., None, :],
                       C / C.shape[-2])


def compressed_server_aggregate(G, Mx, C, err, comp: CompressionSpec, *,
                                region_ids, num_regions: int):
    """``server_aggregate`` with each worker's uplink compressed under
    error feedback.  Returns (global_grad, new_memory, new_err)."""
    m = Mx.to(G.dtype)
    count = m.sum(dim=-2)
    y = _contributions(G * m, C, count > 0,
                       torch.clamp_min(count, 1.0)) + err
    sent = compress_rows(comp, y, region_ids, num_regions)
    return sent.sum(dim=-2), torch.where(Mx, G, C), y - sent


def compressed_quorum_aggregate(G, Mx, C, err, on_time, delays, late_buf,
                                comp: CompressionSpec, *, region_ids,
                                num_regions: int, gamma: float,
                                max_delay: int):
    """``quorum_aggregate`` with the on-time uplinks compressed under error
    feedback; late arrivals fold uncompressed (they are already damped).
    Returns (global_grad, new_memory, new_err, new_late_buf)."""
    m = Mx.to(G.dtype)
    on = on_time.to(G.dtype)[..., None]
    count_full = m.sum(dim=-2)
    count_on = (m * on).sum(dim=-2)
    y = _contributions(G * m * on, C, count_on > 0,
                       torch.clamp_min(count_full, 1.0)) + err
    sent = compress_rows(comp, y, region_ids, num_regions)
    g = sent.sum(dim=-2) + late_buf[..., 0, :]
    adds = late_fold_updates(G, Mx, count_full, delays, gamma=gamma,
                             max_delay=max_delay)
    dropped = delays > int(max_delay)
    new_memory = torch.where(Mx & ~dropped[..., None], G, C)
    return g, new_memory, y - sent, _shift_in(late_buf, adds)


# --------------------------------------------------------------------------
# low-rank running update to [H]_μ (init-phase Hessian compression)
# --------------------------------------------------------------------------

def lowrank_hmu_factor(problem, x0, hkeys, mu: float, *, rank: int):
    """The low-rank running [H]_μ build: a lower Cholesky factor of

        S/N,  S = [H_0]_μ + Σ_{i≥1} (μI + top_r(clamp(H_i − μI, 0)))

    with each worker's top-``rank`` eigenpairs folded into chol(S) by
    ``kernels.ops.chol_update``, one call per worker (the eigenpairs in
    ascending order, as the reference folds them).  The factor is kept
    column-major, the layout the kernel updates.  Every summand dominates
    μI, so S/N ⪰ μI without a final projection; at ``rank = d`` with
    every H_i ⪰ μI it is chol(mean_i H_i)."""
    from ..kernels import ops
    from .hessian import project_psd, sym_eigh
    N, d = problem.num_workers, problem.dim
    r = min(int(rank), d)
    eye = torch.eye(d, dtype=torch.float32, device=problem.device)
    S0 = project_psd(problem.worker_hessian(0, x0, hkeys[0]), mu) \
        + (N - 1) * mu * eye
    L = torch.linalg.cholesky(S0).mT.contiguous().mT
    for i in range(1, N):
        w, V = sym_eigh(problem.worker_hessian(i, x0, hkeys[i]))
        L = ops.chol_update(L, V[:, d - r:].mT.contiguous(),
                            torch.clamp_min(w[d - r:] - mu, 0.0))
    return (L / float(math.sqrt(float(N)))).contiguous()
