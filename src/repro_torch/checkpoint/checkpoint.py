"""Parameter-tree checkpoints: an npz payload and a json manifest.

Port of the reference's ``checkpoint/checkpoint.py``, writing the
reference's layout, so that a checkpoint written by either package
restores in the other: ``shard_{k}.npz`` holds ``leaf_{i}`` for the
tree's leaves in the reference's order (sorted keys, the per-layer list
stacked on a leading L axis), and ``manifest.json`` the step and each
leaf's key, path (``layers/attn/wq``), shape and dtype.  bf16 leaves are
written widened to f32 (exactly: numpy has no bf16 of its own); restore
casts every leaf to the type of the tree it restores into.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..tree import get, leaf_paths, num_layers, rebuild, stacked, to_numpy


def save(tree, directory: str, *, step: int | None = None,
         shard: int = 0) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = stacked(tree, to_numpy)
    payload = {}
    manifest = {"step": step, "leaves": []}
    for i, (keys, _) in enumerate(leaf_paths(tree)):
        key = f"leaf_{i}"
        payload[key] = arr = get(arrays, keys)
        manifest["leaves"].append(
            {"key": key, "path": "/".join(keys), "shape": list(arr.shape),
             "dtype": str(arr.dtype)})
    np.savez(os.path.join(directory, f"shard_{shard}.npz"), **payload)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return directory


def _tensor(arr, dtype_name: str):
    """An npz array as a tensor; the reference's bf16 leaves load as
    2-byte opaque records (npz keeps no bf16 type)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            and dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(tree_like, directory: str, *, shard: int = 0):
    """Restore into the structure, types and devices of ``tree_like``
    (leaf count and shapes validated)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(directory, f"shard_{shard}.npz"))
    paths = leaf_paths(tree_like)
    entries = manifest["leaves"]
    if len(entries) != len(paths):
        raise ValueError(
            f"checkpoint has {len(entries)} leaves, tree needs {len(paths)}")
    L = num_layers(tree_like)
    values = {}
    for (keys, layered), entry in zip(paths, entries):
        arr = data[entry["key"]]
        like = get(tree_like, keys, 0 if layered else None)
        want = ((L,) if layered else ()) + tuple(like.shape)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"shape mismatch at {entry['path']}: "
                f"{tuple(arr.shape)} vs {want}")
        t = _tensor(arr, entry.get("dtype", "")).to(dtype=like.dtype,
                                                    device=like.device)
        for q in (range(L) if layered else (None,)):
            values[keys, q] = t if q is None else t[q].clone()
    return rebuild(tree_like, lambda keys, layer: values[keys, layer])
