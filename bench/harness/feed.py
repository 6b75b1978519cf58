"""The benchmark's inputs, made from the seed on the device: the weights
(the architecture's parameter layout, one normal draw for all of them),
a pool of next-token batches (an affine bigram chain with noise) and each
round's region masks (heterogeneous Bernoulli keep masks with a coverage
repair).  Copies of the program's generator and mask policy, drawn from
``torch.Generator`` streams of the seed; the program gets only what these
make."""

from __future__ import annotations

import math

import torch

# stream ids of one seed's generators
WEIGHTS, TOKENS, MASKS = 0, 1, 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + stream) % (1 << 64))
    return g


def make_weights(specs, seed: int, device, dtype=torch.float32):
    """{path: tensor}: the ``("normal", std)`` leaves are views of one
    standard-normal draw clipped to [−2, 2] and scaled; the ``("const",
    value)`` leaves are filled.  The same seed gives the same weights."""
    n = sum(math.prod(shape) for _, shape, (kind, _) in specs
            if kind == "normal")
    buf = torch.randn(n, generator=generator(seed, WEIGHTS, device),
                      device=device, dtype=dtype).clamp_(-2.0, 2.0)
    flat, off = {}, 0
    for path, shape, (kind, value) in specs:
        if kind == "normal":
            size = math.prod(shape)
            flat[path] = buf[off:off + size].view(shape).mul_(value)
            off += size
        elif kind == "const":
            flat[path] = torch.full(shape, float(value), dtype=dtype,
                                    device=device)
        else:
            raise ValueError(f"unknown init {kind!r} for {path}")
    return flat


def bigram_tokens(g, vocab: int, rows: int, length: int, noise: float,
                  a: int = 31, b: int = 17):
    """(rows, length) int32: x_{t+1} = (a·x_t + b) mod V, or a uniform
    draw with probability ``noise``."""
    dev = g.device
    x = torch.randint(0, vocab, (rows,), generator=g, device=dev)
    uni = torch.randint(0, vocab, (length, rows), generator=g, device=dev)
    flip = torch.rand((length, rows), generator=g, device=dev) < noise
    xs = []
    for t in range(length):
        x = torch.where(flip[t], uni[t], (a * x + b) % vocab)
        xs.append(x)
    return torch.stack(xs, dim=1).to(torch.int32)


def make_batches(traffic, vocab: int, seed: int, device):
    """``traffic["pool"]`` batches of ``{"tokens", "labels"}`` (batch,
    seq), every row its own chain, made in one draw."""
    B, S, pool = traffic["batch"], traffic["seq"], traffic["pool"]
    toks = bigram_tokens(generator(seed, TOKENS, device), vocab, pool * B,
                         S + 1, traffic["noise"])
    return [{"tokens": toks[i * B:(i + 1) * B, :S],
             "labels": toks[i * B:(i + 1) * B, 1:]} for i in range(pool)]


def worker_keep_probs(g, n: int, base: float, heterogeneous: bool):
    """Each worker's keep probability, uniform on the widest interval
    about ``base`` inside [0, 1], or ``base`` for all."""
    if not heterogeneous:
        return torch.full((n,), base, device=g.device)
    half = min(base * 0.5, 1.0 - base)
    u = torch.rand((n,), generator=g, device=g.device)
    return (base - half) + 2.0 * half * u


def ensure_coverage(mask, tau: int):
    """``mask`` (..., N, Q) with every region covered by at least ``tau``
    workers: worker (q + j) mod N is forced onto an under-covered region
    q in the order of j, workers already on it ranked last."""
    N, Q = mask.shape[-2:]
    dev = mask.device
    need = torch.clamp_min(tau - mask.sum(dim=-2), 0)
    j = torch.arange(N, device=dev)[:, None]
    q = torch.arange(Q, device=dev)[None, :]
    order = (j - q) % N + N * mask.to(torch.int64)
    rank = (order[..., None, :, :] < order[..., :, None, :]).sum(dim=-2)
    return mask | (rank < need[..., None, :])


def make_masks(traffic, regions: int, seed: int, device):
    """(rounds, N, Q) bool: round r's masks, each worker keeping each
    region with its own probability, then the coverage repair."""
    m = traffic["masks"]
    N = traffic["workers"]
    g = generator(seed, MASKS, device)
    probs = worker_keep_probs(g, N, m["keep_prob"], m["heterogeneous"])
    u = torch.rand((traffic["mask_rounds"], N, regions), generator=g,
                   device=device)
    masks = u < probs[None, :, None]
    return ensure_coverage(masks, m["tau_star"]) if m["tau_star"] else masks


class Feed:
    """One seed's traffic: round r (0 = the curvature's round) takes
    batch r of the pool, cyclically, and the masks of its row, round r
    ≥ 1 row r − 1."""

    def __init__(self, traffic, vocab: int, regions: int, seed: int, device):
        self.batches = make_batches(traffic, vocab, seed, device)
        self.masks = make_masks(traffic, regions, seed, device)

    def batch(self, r: int):
        return self.batches[r % len(self.batches)]

    def mask(self, r: int):
        return self.masks[(r - 1) % self.masks.shape[0]]
