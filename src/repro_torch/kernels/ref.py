"""Plain PyTorch versions of the hand-written kernels.

They define what each kernel computes: the tests hold the kernels (and
the reference's Pallas kernels) against them, and the dispatch in
``ops.py`` runs them for tensors on the CPU.
"""

from __future__ import annotations

import torch


def region_aggregate_ref(grads, masks, memory):
    """Algorithm 1 lines 15–22 (see ``core.aggregation``).

    grads, memory: (N, D) f32, or (B, N, D) for B seeds; masks: bool, the
    same shape.  Returns (global_grad (D,) or (B, D), new_memory)."""
    m = masks.to(grads.dtype)
    count = m.sum(dim=-2)
    fresh = (grads * m).sum(dim=-2) / torch.clamp_min(count, 1.0)
    stale = memory.sum(dim=-2) / memory.shape[-2]
    g = torch.where(count > 0, fresh, stale)
    new_memory = torch.where(masks, grads, memory)
    return g, new_memory


def ranl_update_ref(params, hdiag, grads, masks, memory, *, mu: float,
                    lr: float):
    """Fused aggregate + diagonal projected-Newton step.

    params, hdiag: (D,) with grads/memory/masks (N, D), or (B, D) with
    (B, N, D).  Returns (new_params, new_memory)."""
    g, new_memory = region_aggregate_ref(grads, masks, memory)
    h_mu = torch.clamp_min(hdiag, float(mu))
    new_params = params - float(lr) * g / h_mu
    return new_params, new_memory


def masked_aggregate_ref(G, mask, C):
    """Server aggregation of one leaf (Algorithm 1 lines 15–22): the plain
    version of ``masked_aggregate``.

    G: (N, *leaf); C: the stored memory, (N, *leaf) in its own type;
    mask: bool (N, ...) broadcastable to G.  Returns (g, C_new): covered
    coordinates average the covering workers' G, uncovered ones the
    memory over all N; C_new is G where the worker trained, else C, in C's
    type.  Each worker's contribution is the reference's,
    ``where(covered, m·G/count, C/N)`` computed in G's type, added in
    worker order, one worker at a time: the memory is decoded and the new
    memory encoded a worker row at a time, so no (N, *leaf) temporary is
    made."""
    N = G.shape[0]
    m = mask.reshape(mask.shape + (1,) * (G.ndim - mask.ndim))
    mf = m.to(G.dtype)
    count = mf.sum(dim=0)
    covered = count > 0
    count = torch.clamp_min(count, 1.0)
    g = None
    C_new = torch.empty_like(C)
    for i in range(N):
        c_i = C[i].to(G.dtype)
        part = torch.where(covered, mf[i] * G[i] / count, c_i / N)
        g = part if g is None else g + part
        C_new[i] = torch.where(m[i], G[i], c_i).to(C.dtype)
    return g, C_new


def grouped_matmul_ref(x, w, offsets):
    """x (M, K), w (G, K, N), offsets (G+1,) int, non-decreasing ->
    y (M, N): rows [offsets[g], offsets[g+1]) of y are those rows of x
    times w[g]; a row outside every group is 0.  An empty group is
    allowed."""
    y = x.new_zeros((x.shape[0], w.shape[-1]))
    b = offsets.tolist()
    for g in range(w.shape[0]):
        if b[g + 1] > b[g]:
            y[b[g]:b[g + 1]] = x[b[g]:b[g + 1]] @ w[g]
    return y


def grouped_matmul_wgrad_ref(x, dy, offsets, groups: int):
    """x (M, K), dy (M, N) -> dw (groups, K, N): dw[g] = x[rows of g]ᵀ ·
    dy[rows of g], 0 for an empty group (the weights' gradient of
    ``grouped_matmul_ref``)."""
    dw = x.new_zeros((groups, x.shape[1], dy.shape[1]))
    b = offsets.tolist()
    for g in range(groups):
        if b[g + 1] > b[g]:
            dw[g] = x[b[g]:b[g + 1]].T @ dy[b[g]:b[g + 1]]
    return dw


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None, return_lse: bool = False):
    """Full-softmax attention: the plain version of ``flash_attention``.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0.
    Sliding ``window`` (0 = unbounded) measured in absolute positions,
    q positions = arange(Skv - Sq, Skv) (suffix alignment), k = arange(Skv).
    Returns (B, Sq, H, hd) in q.dtype, and with ``return_lse`` also each
    row's log-sum-exp of its masked scaled scores, (B, H, Sq) f32."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    groups = H // KV
    scale = hd ** -0.5 if scale is None else scale
    kr = k.repeat_interleave(groups, dim=2).float()
    vr = v.repeat_interleave(groups, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    qpos = torch.arange(Skv - Sq, Skv, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kpos <= qpos
    if window:
        valid &= kpos > qpos - window
    s = torch.where(valid[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def rwkv_wkv_ref(r, k, v, w, u, state):
    """RWKV-6 wkv recurrence, a sequential loop over time: the plain
    version of ``rwkv_wkv``.

        y_t = r_t · (S + u ⊙ k_t v_tᵀ),   S ← diag(w_t) S + k_t v_tᵀ

    r, k, v, w: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) f32.
    Returns (y (B, S, H, hd) f32, final state)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()[None, :, :, None]
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B, H, hd, hd)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True,
                            window: int = 0, lse=None):
    """The gradients of ``flash_attention_ref`` at (q, k, v), given its
    output ``o``, the output's gradient ``do`` and optionally its
    log-sum-exp ``lse`` (B, H, Sq) (else computed here): the plain version
    of ``flash_attention_bwd``, written out on full score matrices with the
    kv heads kept at KV width (query head h = c·G + g of kv head c).

        P = exp(s − L),  L = logsumexp(s) over the row's unmasked keys
        dV = Pᵀ dO,  dP = dO Vᵀ,  dS = P ⊙ (dP − D),  D = rowsum(dO ⊙ O)
        dQ = scale · dS K,  dK = scale · dSᵀ Q

    with dV and dK summed over the G query heads of each kv head.  Shapes
    and masks as ``flash_attention_ref``; arithmetic in f32.  Returns (dq,
    dk, dv), each in its input's type."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf = q.float().reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()
    of = o.float().reshape(B, Sq, KV, G, hd)
    dof = do.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqcgd,bkcd->bcgqk", qf, kf) * scale
    qpos = torch.arange(Skv - Sq, Skv, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kpos <= qpos
    if window:
        valid &= kpos > qpos - window
    s = torch.where(valid, s, -1e30)
    lse = (torch.logsumexp(s, dim=-1, keepdim=True) if lse is None else
           lse.float().reshape(B, KV, G, Sq, 1))
    p = torch.where(valid, torch.exp(s - lse), 0.0)
    d = torch.einsum("bqcgd,bqcgd->bcgq", dof, of)[..., None]
    dv = torch.einsum("bcgqk,bqcgd->bkcd", p, dof)
    dp = torch.einsum("bqcgd,bkcd->bcgqk", dof, vf)
    ds = p * (dp - d)
    dq = torch.einsum("bcgqk,bkcd->bqcgd", ds, kf) * scale
    dk = torch.einsum("bcgqk,bqcgd->bkcd", ds, qf) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def rwkv_wkv_bwd_ref(r, k, v, w, u, state, dy, ds, chunk: int = 64):
    """The gradients of ``rwkv_wkv_ref`` at its inputs, given the
    gradients ``dy`` (B, S, H, hd) of y and ``ds`` (B, H, hd, hd) of the
    final state: the plain version of ``rwkv_wkv_bwd``, the reverse loop
    written out.  With S_t the state before step t and dS_{t+1} the
    gradient of the state after it (dS_T = ds):

        dS_t  = diag(w_t) dS_{t+1} + r_t dy_tᵀ
        dr_t  = (S_t + u ⊙ k_t v_tᵀ) dy_t
        dk_t  = u ⊙ r_t (v_t · dy_t) + dS_{t+1} v_t
        dv_t  = (r_t · (u ⊙ k_t)) dy_t + dS_{t+1}ᵀ k_t
        dw_t  = rowsum(dS_{t+1} ⊙ S_t)
        du    = Σ_{b,t} r_t ⊙ k_t (v_t · dy_t),   dstate = dS_0

    S_t comes from checkpoints: the forward keeps S at every ``chunk``-th
    step, and each chunk's states are rebuilt from its checkpoint in the
    reverse pass (the reference's checkpointed scan), so the extra memory
    is S/chunk states and one chunk's, never one state a step.  Arithmetic
    in f32.  Returns (dr, dk, dv, dw, du, dstate), each in its input's
    type."""
    rf, kf, vf, wf, dyf = (t.float() for t in (r, k, v, w, dy))
    uf = u.float()
    T = rf.shape[1]

    def step(S, t):
        return (wf[:, t, :, :, None] * S
                + kf[:, t, :, :, None] * vf[:, t, :, None, :])

    ckpts, S = [], state.float()
    for t in range(T):
        if t % chunk == 0:
            ckpts.append(S)
        S = step(S, t)
    dS = ds.float()
    grads = [torch.empty_like(rf) for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros_like(dS[..., 0])                    # (B, H, hd)
    for c in reversed(range(len(ckpts))):
        t0, t1 = c * chunk, min(T, (c + 1) * chunk)
        states = [ckpts[c]]
        for t in range(t0, t1 - 1):
            states.append(step(states[-1], t))
        for t in reversed(range(t0, t1)):
            St = states.pop()
            rt, kt, vt, dyt = rf[:, t], kf[:, t], vf[:, t], dyf[:, t]
            vd = (vt * dyt).sum(-1, keepdim=True)        # (B, H, 1)
            dr[:, t] = (torch.einsum("bhij,bhj->bhi", St, dyt)
                        + uf * kt * vd)
            dk[:, t] = (torch.einsum("bhij,bhj->bhi", dS, vt)
                        + uf * rt * vd)
            dv[:, t] = (torch.einsum("bhij,bhi->bhj", dS, kt)
                        + (rt * uf * kt).sum(-1, keepdim=True) * dyt)
            dw[:, t] = (dS * St).sum(-1)
            du += rt * kt * vd
            dS = wf[:, t, :, :, None] * dS + rt[..., None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.sum(0).to(u.dtype), dS.to(state.dtype))


def chol_rank1_update(L, u, alpha):
    """Lower Cholesky factor of ``L Lᵀ + alpha u uᵀ`` (alpha clamped at 0),
    O(d²): the rotation sweep over columns, one column a step, as the
    reference's ``lax.scan`` (``repro/core/compression.py``)."""
    L = L.clone()
    n = L.shape[0]
    w = torch.sqrt(torch.clamp_min(torch.as_tensor(
        alpha, dtype=L.dtype, device=L.device), 0.0)) * u
    for k in range(n):
        lkk, wk = L[k, k], w[k]
        r = torch.sqrt(lkk * lkk + wk * wk)
        c = r / lkk
        s = wk / lkk
        col = (L[k + 1:, k] + s * w[k + 1:]) / c
        w[k + 1:] = c * w[k + 1:] - s * col
        L[k + 1:, k] = col
        L[k, k] = r
    return L


def chol_update_ref(L, V, alpha):
    """Lower Cholesky factor of ``L Lᵀ + Σⱼ alpha_j v_j v_jᵀ``: the plain
    version of ``chol_update``, one rank-1 sweep per row of ``V`` (r, n)
    in order.  L (n, n) in any layout; the result keeps L's."""
    for j in range(V.shape[0]):
        L = chol_rank1_update(L, V[j], alpha[j])
    return L
