"""Serving driver: batched prefill + greedy decode with KV cache.

Port of the reference's ``launch/serve.py``.  Runs on the CUDA card unless
``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke --arch rwkv6-3b

``--smoke`` (the default) serves the config's reduced smoke variant;
``--no-smoke`` serves the published config at full width.  Parameters are
random, from ``--seed``, in the config's ``dtype``.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from ..configs import get_config, smoke_variant
from ..data import make_batch
from ..device import resolve_device
from ..models import forward, init_model
from ..models.io import decode_window


def prefill_step(params, batch, cfg, *, q_chunk=1024, kv_chunk=1024):
    logits, cache, _ = forward(params, batch, cfg, mode="prefill",
                               q_chunk=q_chunk, kv_chunk=kv_chunk)
    return logits, cache


def serve_step(params, cache, tokens, pos, cfg, *, window=0, kv_chunk=1024):
    """One decode step: tokens (B, 1), pos int -> (next tokens (B, 1),
    cache)."""
    batch = {"tokens": tokens, "pos": pos}
    logits, cache, _ = forward(params, batch, cfg, mode="decode",
                               cache=cache, window=window,
                               kv_chunk=kv_chunk)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return nxt[:, None], cache


def pad_cache(cache, cache_len: int):
    """Grow a prefill cache (S slots) to ``cache_len`` decode slots."""
    def grow(name, leaf):
        if isinstance(leaf, dict):
            return {k: grow(k, v) for k, v in leaf.items()}
        if name in ("k", "v"):                 # (L, B, S, KV, hd)
            return F.pad(leaf, (0, 0, 0, 0, 0, cache_len - leaf.shape[2]))
        if name == "slot_pos":                 # (L, S)
            return F.pad(leaf, (0, cache_len - leaf.shape[1]), value=-1)
        return leaf
    return grow("", cache)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, prompt, cfg, gen: int):
    """Prefill ``prompt`` ({"tokens": (B, P)}), then decode greedily until
    ``gen`` tokens are out.  Returns (tokens (B, gen) int32, times), where
    times = {"prefill_s", "decode_s"} on the host's clock, each ending in
    a synchronise of the device.  Chunks are min(1024, length), as the
    reference's CLI sets them."""
    tokens = prompt["tokens"]
    device = tokens.device
    P = tokens.shape[1]
    total = P + gen
    window = decode_window(cfg, total)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, prompt, cfg, q_chunk=min(1024, P),
                                 kv_chunk=min(1024, P))
    if not cfg.attn_free:
        cache = pad_cache(cache, total)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok, cache = serve_step(params, cache, tok, P + i, cfg,
                                window=window,
                                kv_chunk=min(1024, total))
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1), {"prefill_s": t_prefill,
                                   "decode_s": t_decode}


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    device = resolve_device(args.device)
    g = torch.Generator(device=device).manual_seed(args.seed)
    params = init_model(cfg, g, getattr(torch, cfg.dtype))
    prompt = make_batch(cfg, g, args.batch, args.prompt_len,
                        kind="prefill", pattern="bigram")

    with torch.inference_mode():
        gen, times = generate(params, prompt, cfg, args.gen)
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{times['prefill_s']:.2f}s; decode {args.gen - 1} steps: "
          f"{times['decode_s']:.2f}s")
    print("generated:", gen[0].tolist())
    return gen


if __name__ == "__main__":
    run()
