"""Shared pieces of the deep-net training parity tests
(``tests/test_torch_train*.py``): the same numpy inputs for the port and
the reference, and the comparisons with their tolerances.

The reference's parameters (``repro.models.init_model``) are carried
across with ``interop.model_params_from_numpy`` and its RANL state with
``interop.ranl_state_from_numpy``; both sides get the same numpy tokens.
On the CPU the port's attention and wkv calls take the kernels' plain
twins.  Smoke configs, f32.

Tolerances:
- integer traces (masks, coverage, uplink_frac, region ids and counts,
  the hetero CLI's simulated clock) exactly;
- losses within rtol 1e-5; gradients, params and precond within 1e-4 of
  each leaf's max |value| (the frameworks sum in other orders, and the
  reference's attention is a blocked online softmax where the twin's is
  one full softmax); in ``train_step``, rwkv6 within ``STEP_TOL`` = 2e-3:
  its time mix normalises each head's wkv output (``ln_x``), which
  amplifies f32 rounding where a head's output is small — one worker's
  second-round gradient differs by 2.1e-4 of its leaf's max with the
  forward at 2e-5, and a Newton step then divides by curvatures near the
  floor (worst measured: 9.2e-4 with ``precond_beta``);
- bf16 memory within one bf16 step (2⁻⁷ of the value: a value within an
  f32 rounding of a bf16 tie rounds either way) on top of the gradients'
  own 1e-4 of the leaf's max (the memory is the gradients, encoded: a
  gradient a millionth of its leaf's max differs by more than a bf16
  step between the frameworks);
- int8 memory: codes within 1 (the same tie argument), scales within
  1e-4 of the leaf's max scale (a scale is a gradient's |max| / 127);
- compressed uplinks (``compression="int8"`` / ``"bf16"``): the
  quantizer is discontinuous, and a gradient within an f32 rounding of a
  quantization boundary lands one quantum apart between the frameworks,
  which the Newton step then divides by its curvature; params and memory
  within ``FLIP`` of the leaf's max (2/127 for int8, 2⁻⁷ for bf16: two
  quanta), as the convex tests hold compressed runs to a quantum;
- each round starts from the same inputs on both sides (the port's state
  carried back into the reference): a Newton step divides gradient
  rounding by curvatures near the floor, so errors compound across
  rounds, in the reference too (its compiled and eager runs of the
  rwkv6 ``precond_beta`` case differ by 9.4e-4 of a leaf's max after two
  rounds);
- ``masked_aggregate``: C′ exactly (a select), ḡ rtol 1e-6;
- the first-order steps on identical inputs: rtol 1e-5."""


import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import lm_loss as jlm_loss  # noqa: E402
from repro.optim import ranl_llm as jr  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import lm_loss  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402, F401

KEY = jax.random.PRNGKey(0)
TOL = 1e-4
BF16_STEP = 2.0 ** -7
FLIP = {"int8": 2 / 127, "bf16": 2.0 ** -7}
TRAINED = ["phi4-mini-3.8b", "rwkv6-3b"]
STEP_TOL = {"phi4-mini-3.8b": TOL, "rwkv6-3b": 2e-3}


def cfgs(arch, **replace):
    j = jconfigs.smoke_variant(jconfigs.get_config(arch))
    t = tconfigs.smoke_variant(tconfigs.get_config(arch))
    if replace:
        j, t = (dataclasses.replace(j, **replace),
                dataclasses.replace(t, **replace))
    return j, t


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def make_params(jcfg, tcfg, seed=0):
    p = jinit(jcfg, jax.random.PRNGKey(seed))
    return p, interop.model_params_from_numpy(tcfg, to_np(p), device="cpu")


def make_batches(cfg, b, s, seed=1):
    """The same train batch for both sides: (jax dict, torch dict)."""
    rng = np.random.default_rng(seed)
    extra = (cfg.num_codebooks,) if cfg.modality == "audio" else ()
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1) + extra).astype(
        np.int32)
    np_batch = {"tokens": toks[:, :s], "labels": toks[:, 1:]}
    if cfg.modality == "vision":
        np_batch["patch_embeds"] = rng.normal(
            size=(b, cfg.vision_tokens, cfg.vision_embed_dim)).astype(
                np.float32)
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    tb = {k: torch.tensor(v) for k, v in np_batch.items()}
    return jb, tb


def loss_fns(jcfg, tcfg):
    return (lambda p, b: jlm_loss(p, b, jcfg, q_chunk=16, kv_chunk=16),
            lambda p, b: lm_loss(p, b, tcfg))


def within(err, bound, scale, flip, what):
    """err <= bound everywhere; with ``flip``, err <= flip x scale."""
    if flip is not None:
        bound = flip * scale
    assert (err <= bound).all(), (f"{what}: max |err| {float(err.max())} "
                                  f"past its bound (leaf max {scale})")


def close_to_leaf_max(got, want, tol=TOL, what="", flip=None):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    within(np.abs(got - want), tol * scale, scale, flip, what)


def ref_leaves(tree, is_leaf=None):
    return [(jax.tree_util.keystr(p, simple=True, separator="/"), np.asarray(x)
             if not isinstance(x, dict) else to_np(x))
            for p, x in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=is_leaf)]


def assert_params_close(jtree, ttree, tcfg, tol=TOL, what="params",
                        flip=None):
    """A port tree (per-layer list) against a reference tree (stacked),
    leaf by leaf in the reference's order."""
    ours = interop.params_to_numpy(tcfg, ttree)
    for path, want in ref_leaves(jtree):
        got = ours
        for k in path.split("/"):
            got = got[k]
        close_to_leaf_max(got, want, tol, f"{what} {path}", flip)


def memory_is_leaf(x):
    return isinstance(x, dict) and "q" in x


def assert_memory_close(jmem, tmem, tcfg, int8, flip=None, tol=TOL):
    """Memory: bf16 values within one bf16 step (and the gradients'
    tolerance); int8 codes within 1 and scales within the gradients'
    tolerance (the per-layer leaves against the slices of the stacked
    leaves)."""
    for path, want in ref_leaves(jmem, memory_is_leaf):
        keys = tuple(path.split("/"))
        layered = keys[0] == "layers"
        for q in (range(tcfg.num_layers) if layered else (None,)):
            node = tmem
            for k in keys:
                node = node[k]
                if isinstance(node, list):
                    node = node[q]
            if int8:
                wq = want["q"] if q is None else want["q"][:, q]
                ws = want["scale"] if q is None else want["scale"][:, q]
                assert node["q"].dtype == torch.int8
                assert tuple(node["scale"].shape) == ws.shape, path
                assert np.abs(node["q"].numpy().astype(np.int32)
                              - wq.astype(np.int32)).max() <= 1, path
                close_to_leaf_max(node["scale"].numpy(), ws, tol,
                                  what=f"scale {path}")
            else:
                w = np.asarray(want if q is None else want[:, q], np.float32)
                assert node.dtype == torch.bfloat16, path
                got = node.float().numpy()
                assert got.shape == w.shape, path
                scale = float(np.abs(w).max())
                within(np.abs(got - w), BF16_STEP * np.abs(w) + tol * scale,
                        scale, flip, f"memory {path}")



STATES = {}


def ref_state(arch, memory_int8, jcfg, jp, jb, jloss):
    """The reference's init_state, compiled once per (arch, memory)."""
    key = (arch, memory_int8)
    if key not in STATES:
        rcfg = jr.RanlLLMConfig(num_workers=4, memory_int8=memory_int8)
        STATES[key] = jax.jit(lambda p, b: jr.init_state(
            p, jloss, b, rcfg, KEY))(jp, jb)
    return STATES[key]


def to_reference(tcfg, params, state):
    """The port's params and RANL state in the reference's layout (jax
    arrays): per-layer memory leaves (N, ...) stacked on axis 1, bf16
    memory as bf16."""
    def memory(node):
        if isinstance(node, dict) and set(node) == {"q", "scale"}:
            return {k: memory(v) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: memory(v) for k, v in node.items()}
        if isinstance(node, list):
            return jax.tree.map(lambda *xs: jnp.stack(xs, axis=1),
                                *[memory(x) for x in node])
        a = jnp.asarray(node.float().numpy())
        return a.astype(jnp.bfloat16) if node.dtype == torch.bfloat16 else (
            jnp.asarray(node.numpy()) if node.dtype == torch.int8 else a)
    js = {"step": jnp.int32(int(state["step"])),
          "precond": jax.tree.map(jnp.asarray, interop.params_to_numpy(
              tcfg, state["precond"])),
          "memory": memory(state["memory"])}
    return (jax.tree.map(jnp.asarray, interop.params_to_numpy(tcfg, params)),
            js)
