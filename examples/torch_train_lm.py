"""End-to-end training on the PyTorch port: train a ~100M-param dense LM
with RANL for a few hundred steps on synthetic structured data, with
checkpointing and an AdamW comparison arm (the CUDA card; ``--device
cpu`` runs on the host).

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --tiny --steps 20 --device cpu
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import save  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_model, lm_loss  # noqa: E402
from repro_torch.optim import (AdamWConfig, RanlLLMConfig,  # noqa: E402
                               adamw_init, adamw_step, init_state,
                               train_step)
from repro_torch.optim.first_order import value_and_grad  # noqa: E402


def model_100m():
    """~100M-param phi4-mini family variant (12 layers, d=768)."""
    base = get_config("phi4-mini-3.8b")
    return dataclasses.replace(
        base, name="phi4-100m", num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=4096,
        dtype="float32")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--optimizer", default="ranl",
                    choices=["ranl", "adamw"])
    ap.add_argument("--ckpt", default="experiments/torch_train_lm_ckpt")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the host")
    args = ap.parse_args()

    cfg = (smoke_variant(get_config("phi4-mini-3.8b")) if args.tiny
           else model_100m())
    n_params = cfg.param_count()
    print(f"config {cfg.name}: {n_params/1e6:.1f}M params")

    device = resolve_device(args.device)
    key = prng.PRNGKey(0)
    g = torch.Generator(device=device).manual_seed(0)
    params = init_model(cfg, g)

    def loss_fn(p, b):
        return lm_loss(p, b, cfg, q_chunk=min(256, args.seq),
                       kv_chunk=min(256, args.seq))

    def next_batch():
        return make_batch(cfg, g, args.batch, args.seq, pattern="bigram")
    batch0 = next_batch()

    t_start = time.perf_counter()
    if args.optimizer == "ranl":
        # small-batch regime: gentler Newton scale, EMA curvature
        # refresh (beyond-paper knob) — the one-shot Fisher from a few
        # hundred tokens is too noisy to freeze forever
        rcfg = RanlLLMConfig(num_workers=args.workers, keep_prob=0.9,
                             lr=0.5, trust_ratio=0.05, precond_beta=0.1)
        state = init_state(params, loss_fn, batch0, rcfg, key)
        for t in range(args.steps):
            params, state, m = train_step(params, state, next_batch(), key,
                                          loss_fn=loss_fn, cfg=rcfg)
            if t % 10 == 0 or t == args.steps - 1:
                print(f"step {t:4d} loss={float(m['loss']):.4f} "
                      f"uplink={float(m['uplink_frac']):.2f} "
                      f"[{time.perf_counter()-t_start:.0f}s]")
        final = float(m["loss"])
    else:
        acfg = AdamWConfig(lr=3e-4)
        state = adamw_init(params, acfg)
        for t in range(args.steps):
            loss, grads = value_and_grad(loss_fn, params, next_batch())
            params, state = adamw_step(params, state, grads, acfg)
            del grads
            if t % 10 == 0 or t == args.steps - 1:
                print(f"step {t:4d} loss={float(loss):.4f} "
                      f"[{time.perf_counter()-t_start:.0f}s]")
        final = float(loss)

    save(params, args.ckpt, step=args.steps)
    print(json.dumps({"params_m": n_params / 1e6, "steps": args.steps,
                      "final_loss": final, "ckpt": args.ckpt}))


if __name__ == "__main__":
    main()
