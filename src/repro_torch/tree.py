"""Parameter trees, walked in the reference's leaf order.

The port's model parameters are nested dicts of tensors whose
``"layers"`` entry is a list of per-layer dicts; the reference stacks
those on a leading L axis and flattens trees with ``jax.tree_util``,
which sorts dict keys.  These helpers give every leaf its reference path
(``("layers", "attn", "wq")``) and walk the leaves in the reference's
order, so that region ids, checkpoints and interop line up with it.  A
``{"q", "scale"}`` dict (an int8-encoded leaf) counts as one leaf.
"""

from __future__ import annotations

import torch


def is_quantized(node) -> bool:
    """An int8-encoded leaf: ``{"q": int8, "scale": f32}``."""
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def leaf_paths(tree) -> list[tuple[tuple[str, ...], bool]]:
    """[(keys, layered)] in the reference's order: dict keys sorted at
    every level; a per-layer list stands for one stacked tree, walked as
    its first element, and its leaves are ``layered``."""
    out = []

    def walk(node, keys, layered):
        if isinstance(node, list):
            if node:
                walk(node[0], keys, True)
        elif isinstance(node, dict) and not is_quantized(node):
            for k in sorted(node):
                walk(node[k], keys + (k,), layered)
        else:
            out.append((keys, layered))
    walk(tree, (), False)
    return out


def get(tree, keys, layer=None):
    """The leaf at ``keys``; ``layer`` indexes the per-layer list."""
    node = tree
    for k in keys:
        node = node[k]
        if isinstance(node, list):
            node = node[layer]
    return node


def put(tree, keys, layer, value):
    """Set the leaf at ``keys`` (and ``layer``) in place."""
    node = tree
    for k in keys[:-1]:
        node = node[k]
        if isinstance(node, list):
            node = node[layer]
    node[keys[-1]] = value


def rebuild(like, fn, keys=(), layer=None):
    """A tree shaped like ``like`` with ``fn(keys, layer)`` at each leaf."""
    if isinstance(like, list):
        return [rebuild(x, fn, keys, i) for i, x in enumerate(like)]
    if isinstance(like, dict) and not is_quantized(like):
        return {k: rebuild(v, fn, keys + (k,), layer)
                for k, v in like.items()}
    return fn(keys, layer)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure."""
    return rebuild(tree, lambda keys, layer: fn(
        get(tree, keys, layer), *(get(t, keys, layer) for t in rest)))


def leaves(tree) -> list:
    """Every leaf (each layer's apart), in the reference's order."""
    out = []
    for keys, layered in leaf_paths(tree):
        layers = range(num_layers(tree)) if layered else (None,)
        out += [get(tree, keys, i) for i in layers]
    return out


def from_leaves(like, values):
    """The inverse of ``leaves``: a tree shaped like ``like`` holding
    ``values`` (one a leaf, each layer's apart, in the reference's
    order)."""
    L = num_layers(like)
    it = iter(values)
    flat = {(keys, layer): next(it) for keys, layered in leaf_paths(like)
            for layer in (range(L) if layered else (None,))}
    return rebuild(like, lambda keys, layer: flat[keys, layer])


def num_layers(tree) -> int:
    """Length of the tree's per-layer list (0 without one)."""
    def find(node):
        if isinstance(node, list):
            return len(node)
        if isinstance(node, dict) and not is_quantized(node):
            for v in node.values():
                n = find(v)
                if n is not None:
                    return n
        return None
    return find(tree) or 0


def to_numpy(t):
    """A tensor as numpy, on the host; bf16 widens to f32 (exactly), as
    numpy has no bf16 of its own."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def stacked(tree, convert=lambda t: t):
    """The reference's layout: a nested dict whose per-layer leaves are
    stacked on a leading L axis (``torch.stack``), each leaf passed
    through ``convert``."""
    L = num_layers(tree)
    out = {}
    for keys, layered in leaf_paths(tree):
        leaf = (torch.stack([get(tree, keys, i) for i in range(L)])
                if layered else get(tree, keys))
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = convert(leaf)
    return out
