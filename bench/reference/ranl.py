"""A plain RANL round for a deep net (the paper's Algorithm 1 on layers):
the workers' gradients, the server's masked aggregate against the
gradient memory, and the diagonal Newton step with its curvature floor
and trust ratio.

Leaves are keyed by their path (``("layers", 3, "attn", "wq")``).  A
per-layer leaf belongs to its layer's region; every other leaf (embed,
head, final norm) is glue, trained by every worker each round.  The
curvature is the workers' mean squared gradient at the start (the
one-shot empirical Fisher diagonal); the memory holds each worker's
latest gradient of each region in bfloat16.  The Newton step's floor,
mean and norms are taken over all layers of a leaf together.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def precision(tf32: bool):
    """Float32 products with TF32 off (the reference), or on (the
    control one precision step below); restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def flatten(tree, prefix=()):
    """{path: tensor} over a nested dict whose ``"layers"`` is a list."""
    out = {}
    if isinstance(tree, list):
        for i, node in enumerate(tree):
            out.update(flatten(node, prefix + (i,)))
    elif isinstance(tree, dict):
        for k, node in tree.items():
            out.update(flatten(node, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def unflatten(flat):
    """The nested tree of ``flatten``'s output: an int key is a list
    index."""
    root = {}
    for path, t in flat.items():
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            empty = [] if isinstance(nxt, int) else {}
            if isinstance(node, list):
                node.extend([None] * (key + 1 - len(node)))
                if node[key] is None:
                    node[key] = empty
                node = node[key]
            else:
                node = node.setdefault(key, empty)
        node[path[-1]] = t
    return root


def layer_of(path):
    """The layer index of a per-layer leaf, else None (glue)."""
    return path[1] if path[0] == "layers" else None


def group_of(path):
    """The leaf as the Newton step sees it: a per-layer leaf with its
    layer index dropped, so all layers of it are one group."""
    return path[:1] + path[2:] if path[0] == "layers" else path


def worker_rows(batch, n: int, i: int):
    rows = batch["tokens"].shape[0] // n
    return {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}


def loss_and_grads(arch, cfg, flat, batch):
    live = {p: t.detach().requires_grad_(True) for p, t in flat.items()}
    with torch.enable_grad():
        loss = arch.loss(unflatten(live), batch, cfg)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
    return loss.detach(), {p: (torch.zeros_like(t) if g is None else g)
                           for (p, t), g in zip(live.items(), grads)}


def init(arch, cfg, flat, batch, n: int, memory_dtype=torch.bfloat16):
    """Round 0: (curvature {path: f32}, memory {path: (n, *leaf)})."""
    h = {p: torch.zeros_like(t) for p, t in flat.items()}
    memory = {p: torch.empty((n,) + tuple(t.shape), dtype=memory_dtype,
                             device=t.device) for p, t in flat.items()}
    for i in range(n):
        _, G = loss_and_grads(arch, cfg, flat, worker_rows(batch, n, i))
        for p, g in G.items():
            h[p] += g.square()
            memory[p][i] = g.to(memory_dtype)
        del G
    for p in h:
        h[p] /= n
    return h, memory


def coverage(masks, path):
    """(this leaf's mask, a list of one bool a worker, and its count):
    glue is trained by every worker."""
    q = layer_of(path)
    m = [True] * masks.shape[0] if q is None else masks[:, q].tolist()
    return m, sum(m)


def round_(arch, cfg, flat, h, memory, batch, masks, rcfg):
    """One round.  ``masks`` (n, Q) bool, column q < L for layer q.
    ``memory`` is updated in place: a worker's row of a leaf is read
    (uncovered) or written (trained), never both.  Returns (new params,
    mean loss, aggregate g)."""
    n = masks.shape[0]
    on = {p: coverage(masks, p) for p in flat}
    g = {p: torch.zeros_like(t) for p, t in flat.items()}
    losses = []
    for i in range(n):
        loss, G = loss_and_grads(arch, cfg, flat, worker_rows(batch, n, i))
        losses.append(loss)
        for p, Gi in G.items():
            m, count = on[p]
            if count == 0:                      # uncovered: the memory
                g[p] += memory[p][i].float() / n
            elif m[i]:
                g[p] += Gi / count
                memory[p][i] = Gi.to(memory[p].dtype)
        del G
    return newton(flat, g, h, rcfg), torch.stack(losses).mean(), g


def newton(flat, g, h, rcfg):
    """p − scale·lr·g / max(h, μ + μ_rel·mean h), scale =
    min(1, trust·(‖p‖ + 1) / ‖Δ‖), a group (all layers of a leaf) at a
    time."""
    groups = {}
    for p in flat:
        groups.setdefault(group_of(p), []).append(p)
    out = {}
    for paths in groups.values():
        mean_h = (sum(h[p].sum() for p in paths)
                  / sum(h[p].numel() for p in paths))
        floor = rcfg["mu"] + rcfg["mu_rel"] * mean_h
        delta = {p: rcfg["lr"] * g[p] / torch.maximum(h[p], floor)
                 for p in paths}
        dn = torch.sqrt(sum(d.square().sum() for d in delta.values()))
        pn = torch.sqrt(sum(flat[p].square().sum() for p in paths))
        scale = torch.clamp_max(rcfg["trust_ratio"] * (pn + 1.0)
                                / torch.clamp_min(dn, 1e-20), 1.0)
        for p in paths:
            out[p] = flat[p] - scale * delta[p]
    return out


def run(arch, cfg, flat0, batches, masks, rcfg, steps: int):
    """Round 0 on ``batches[0]``, then ``steps`` rounds on ``batches[1:]``
    with ``masks[t]``.  Returns the numbers the check compares:
    {"loss": [steps], "curvature", "grad" (round 1's aggregate, worked
    out from the memory after it, as ``grad_from_memory``), "change"
    (‖p_steps − p_0‖)}: each {path: norm} besides the losses."""
    n = masks.shape[1]
    h, memory = init(arch, cfg, flat0, batches[0], n)
    out = {"loss": [], "curvature": norms(h)}
    flat = flat0
    for t in range(steps):
        flat, loss, _ = round_(arch, cfg, flat, h, memory,
                                       batches[1 + t], masks[t], rcfg)
        out["loss"].append(float(loss))
        if t == 0:
            out["grad"] = norms(grad_from_memory(memory, masks[0]))
    out["change"] = {p: float(torch.linalg.vector_norm(flat[p] - flat0[p]))
                     for p in flat}
    return out


def grad_from_memory(memory, masks, workers=None):
    """A round's aggregate g as the memory after it gives it back: where
    a region is covered, the mean of the gradients its trainers just
    stored; where not, the mean of every worker's memory.  ``workers``:
    the workers whose rows ``memory`` holds, in order (all by default);
    the sums over parts of the workers add up to the whole."""
    n = masks.shape[0]
    workers = list(range(n)) if workers is None else list(workers)
    g = {}
    for p, C in memory.items():
        m, count = coverage(masks, p)
        g[p] = torch.zeros(C.shape[1:], dtype=torch.float32, device=C.device)
        for row, i in enumerate(workers):
            if m[i] or not count:
                g[p] += C[row].float()
        g[p] /= count or n
    return g


def norms(tree):
    return {p: float(torch.linalg.vector_norm(t.float()))
            for p, t in tree.items()}
