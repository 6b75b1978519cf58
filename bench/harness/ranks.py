"""A cell on several cards: one spawned process a rank, joined in one
process group (NCCL, a card a rank; gloo on the CPU for the tests), its
rendezvous a file store in a fresh directory under ``TMPDIR`` that is
removed afterwards.  Every process started here is ended and waited
for before ``launch`` returns."""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import shutil
import tempfile
import time

RESULT = "rank0.json"


def _entry(fn, rank: int, world: int, device: str, tmp: str, args):
    import torch
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        backend = "gloo"
    dist.init_process_group(backend, init_method="file://" + os.path.join(
        tmp, "store"), rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, RESULT), "w") as f:
            json.dump(out, f)


def launch(fn, world: int, device: str, *args):
    """``fn(rank, world, *args)`` in ``world`` processes; returns rank 0's
    return value (made of JSON types).  A rank that fails ends the
    others, and ``launch`` raises."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="bench-ranks-",
                           dir=os.environ.get("TMPDIR"))
    procs = [ctx.Process(target=_entry, args=(fn, r, world, device, tmp,
                                              args)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
        failed = {r: p.exitcode for r, p in enumerate(procs)
                  if p.exitcode not in (None, 0)}
        if failed:
            raise RuntimeError(f"ranks failed: {failed} (exit codes)")
        with open(os.path.join(tmp, RESULT)) as f:
            return json.load(f)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
