"""The block kinds of the port's models beyond RWKV and the dense block —
the hybrid attention+SSM block (hymba), MoE (phi3.5-moe, llama4-scout),
the vision frontend (llava) and the audio frontend (musicgen) — against
the reference's, on the CPU.

The reference's parameters are carried across with
``interop.model_params_from_numpy`` and both sides get the same numpy
tokens (and patch embeddings).  Smoke configs, f32.

Tolerances, as tests/test_torch_models.py holds the served archs:
logits, caches, states and the MoE aux loss within 1e-4 (the frameworks
sum in other orders; the SSM recurrence is a loop here and an
associative scan there); a ``train_step`` round within 1e-4 of each
leaf's max for params and precond, the memory within one bf16 step plus
that, masks, coverage and uplink_frac exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import pad_cache as jpad  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_decode_cache as jinit_cache  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import lm_loss as jlm_loss  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import ranl_llm as jr  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch.serve import pad_cache  # noqa: E402
from repro_torch.models import forward, init_decode_cache, init_model  # noqa: E402
from repro_torch.models import lm_loss  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim import ranl_llm as tr  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

from _torch_train_helpers import one_torch_thread  # noqa: E402, F401

BLOCKS = ["hymba-1.5b", "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e",
          "llava-next-mistral-7b", "musicgen-medium"]
TOL = dict(rtol=1e-4, atol=1e-4)
LEAF_TOL = 1e-4
BF16_STEP = 2.0 ** -7


def _cfgs(arch, **replace):
    j = jconfigs.smoke_variant(jconfigs.get_config(arch))
    t = tconfigs.smoke_variant(tconfigs.get_config(arch))
    if replace:
        j, t = (dataclasses.replace(j, **replace),
                dataclasses.replace(t, **replace))
    return j, t


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(jcfg, tcfg, seed=0):
    p = jinit(jcfg, jax.random.PRNGKey(seed))
    return p, interop.model_params_from_numpy(tcfg, _np(p), device="cpu")


def _batch(cfg, b, s, seed=1, labels=True):
    rng = np.random.default_rng(seed)
    extra = (cfg.num_codebooks,) if cfg.modality == "audio" else ()
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1) + extra).astype(
        np.int32)
    out = {"tokens": toks[:, :s]}
    if labels:
        out["labels"] = toks[:, 1:]
    if cfg.modality == "vision":
        out["patch_embeds"] = rng.normal(
            size=(b, cfg.vision_tokens, cfg.vision_embed_dim)).astype(
                np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.tensor(v) for k, v in out.items()})


def _assert_tree_close(jtree, ttree, **tol):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree)
        for k in jtree:
            _assert_tree_close(jtree[k], ttree[k], **tol)
        return
    j = np.asarray(jtree)
    assert j.shape == tuple(ttree.shape)
    np.testing.assert_allclose(ttree.float().numpy(), j.astype(np.float32),
                               **tol)


# --------------------------------------------------------------------------
# forward: train / prefill / decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", BLOCKS)
def test_forward_train_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg, 2, 24, labels=False)
    want, _, jaux = jforward(jp, jb, jcfg, mode="train", q_chunk=16,
                             kv_chunk=16)
    got, cache, aux = forward(tp, tb, tcfg, mode="train")
    assert cache is None
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    if tcfg.num_experts:
        assert float(aux) > 0.0


@pytest.mark.parametrize("arch", BLOCKS)
def test_forward_prefill_then_decode_match_reference(arch):
    """Prefill logits and cache (the SSM state and conv tail included),
    then three decode steps' logits and caches, step for step."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    P, T = 10, 13
    jb, tb = _batch(jcfg, 2, T, labels=False)
    jpre = {k: (v[:, :P] if k == "tokens" else v) for k, v in jb.items()}
    tpre = {k: (v[:, :P] if k == "tokens" else v) for k, v in tb.items()}
    jl, jc, _ = jforward(jp, jpre, jcfg, mode="prefill", q_chunk=16,
                         kv_chunk=16)
    tl, tc, _ = forward(tp, tpre, tcfg, mode="prefill")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(_np(jc), tc, **TOL)
    jc, tc = jpad(jc, T), pad_cache(tc, T)
    for t in range(P, T):
        jl, jc, _ = jforward(jp, {"tokens": jb["tokens"][:, t:t + 1],
                                  "pos": jnp.int32(t)}, jcfg, mode="decode",
                             cache=jc, kv_chunk=16)
        tl, tc, _ = forward(tp, {"tokens": tb["tokens"][:, t:t + 1],
                                 "pos": t}, tcfg, mode="decode", cache=tc,
                            kv_chunk=16)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_tree_close(_np(jc), tc, **TOL)


@pytest.mark.parametrize("arch", BLOCKS)
def test_decode_from_an_empty_cache_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    jc = jinit_cache(jcfg, 2, 6, jnp.float32)
    tc = init_decode_cache(tcfg, 2, 6, torch.float32, device="cpu")
    _assert_tree_close(_np(jc), tc, rtol=0, atol=0)
    jb, tb = _batch(jcfg, 2, 4, labels=False)
    for t in range(4):
        jl, jc, _ = jforward(jp, {"tokens": jb["tokens"][:, t:t + 1],
                                  "pos": jnp.int32(t)}, jcfg, mode="decode",
                             cache=jc, kv_chunk=4)
        tl, tc, _ = forward(tp, {"tokens": tb["tokens"][:, t:t + 1],
                                 "pos": t}, tcfg, mode="decode", cache=tc,
                            kv_chunk=4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(_np(jc), tc, **TOL)


@pytest.mark.parametrize("arch", BLOCKS)
def test_init_model_sizes_equal_the_reference(arch):
    """The same leaves at the same shapes (stacked), in bf16."""
    jcfg, tcfg = _cfgs(arch)
    params = init_model(tcfg, torch.Generator().manual_seed(0),
                        torch.bfloat16)
    assert len(params["layers"]) == tcfg.num_layers
    assert all(t.dtype == torch.bfloat16 for t in leaves(params))
    stacked = interop.params_to_numpy(tcfg, params)
    ref = jinit(jcfg, jax.random.PRNGKey(0))
    ours = jax.tree_util.tree_leaves_with_path(stacked)
    want = jax.tree_util.tree_leaves_with_path(ref)
    assert [(jax.tree_util.keystr(p), a.shape) for p, a in ours] == [
        (jax.tree_util.keystr(p), a.shape) for p, a in want]


# --------------------------------------------------------------------------
# one RANL round
# --------------------------------------------------------------------------

def _close_to_leaf_max(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= LEAF_TOL * scale, f"{what}: max |err| {err} (max {scale})"


@pytest.mark.parametrize("arch", BLOCKS)
def test_train_step_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg, 4, 12)

    def jloss(p, b):
        return jlm_loss(p, b, jcfg, q_chunk=16, kv_chunk=16)

    def tloss(p, b):
        return lm_loss(p, b, tcfg)
    key = jax.random.PRNGKey(0)
    rcfg = dict(num_workers=2, protect_glue=False, keep_prob=0.5)
    js = jax.jit(lambda p, b: jr.init_state(
        p, jloss, b, jr.RanlLLMConfig(**rcfg), key))(jp, jb)
    ts = interop.ranl_state_from_numpy(tcfg, _np(js), device="cpu")
    jb, tb = _batch(jcfg, 4, 12, seed=5)
    rng = jax.random.PRNGKey(3)
    jn, js2, jm = jax.jit(lambda p, s, b: jr.train_step(
        p, s, b, rng, loss_fn=jloss, cfg=jr.RanlLLMConfig(**rcfg)))(
            jp, js, jb)
    tn, ts2, tm = tr.train_step(tp, ts, tb, np.asarray(rng), loss_fn=tloss,
                                cfg=tr.RanlLLMConfig(**rcfg))
    for k in ("coverage", "uplink_frac"):
        assert float(tm[k]) == float(jm[k]), k
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    ours = interop.params_to_numpy(tcfg, tn)
    prec = interop.params_to_numpy(tcfg, ts2["precond"])
    for (path, want), (_, hw) in zip(
            jax.tree_util.tree_leaves_with_path(jn),
            jax.tree_util.tree_leaves_with_path(js2["precond"])):
        got, gh = ours, prec
        for k in path:
            got, gh = got[k.key], gh[k.key]
        name = jax.tree_util.keystr(path)
        _close_to_leaf_max(got, want, f"params {name}")
        _close_to_leaf_max(gh, hw, f"precond {name}")
    for path, want in jax.tree_util.tree_leaves_with_path(js2["memory"]):
        keys = [k.key for k in path]
        w = np.asarray(want, np.float32)
        bound = BF16_STEP * np.abs(w) + LEAF_TOL * np.abs(w).max()
        if keys[0] == "layers":
            for q in range(tcfg.num_layers):
                node = ts2["memory"]["layers"][q]
                for k in keys[1:]:
                    node = node[k]
                assert (np.abs(node.float().numpy() - w[:, q])
                        <= bound[:, q]).all(), keys
        else:
            got = ts2["memory"][keys[0]].float().numpy()
            assert (np.abs(got - w) <= bound).all(), keys


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------

def test_ssm_scan_matches_the_associative_scan():
    """The loop over t against the reference's associative scan, from a
    zero and from a given state."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 1.0, (2, 37, 5, 3)).astype(np.float32)
    b = rng.normal(size=(2, 37, 5, 3)).astype(np.float32)
    h0 = rng.normal(size=(2, 5, 3)).astype(np.float32)
    for init in (None, h0):
        want = jssm._ssm_scan(jnp.asarray(a), jnp.asarray(b),
                              None if init is None else jnp.asarray(init))
        got = tssm._ssm_scan(torch.tensor(a), torch.tensor(b),
                             None if init is None else torch.tensor(init))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_causal_conv_with_a_carried_state_matches_reference():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(2, 7, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for state in (None, st):
        jy, js = jssm._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                   None if state is None
                                   else jnp.asarray(state))
        ty, ts = tssm._causal_conv(torch.tensor(u), torch.tensor(w),
                                   None if state is None
                                   else torch.tensor(state))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_top_k_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = tmoe.top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]


@pytest.mark.parametrize("tokens", [48, 160], ids=["worst_case", "capacity"])
def test_moe_matches_reference_with_and_without_capacity_drops(tokens):
    """At 160 tokens (> 64) the capacity is 1.25 × the even share, so
    tokens past an expert's slots drop, the same ones on both sides."""
    jcfg, tcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    jp, tp = _params(jcfg, tcfg)
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tlp = tp["layers"][0]["moe"]
    x = np.random.default_rng(2).normal(
        size=(2, tokens // 2, jcfg.d_model)).astype(np.float32)
    want, jaux = jmoe.apply_moe(lp, jnp.asarray(x), jcfg)
    got, aux = tmoe.apply_moe(tlp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    if tokens > 64:
        assert tmoe.capacity(tcfg, tokens) < tokens * tcfg.experts_per_token


def test_vision_patches_overwrite_the_first_positions():
    _, tcfg = _cfgs("llava-next-mistral-7b")
    params = init_model(tcfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 12), dtype=torch.int32)
    pe = torch.randn(1, tcfg.vision_tokens, tcfg.vision_embed_dim)
    a, _, _ = forward(params, {"tokens": toks, "patch_embeds": pe}, tcfg)
    b, _, _ = forward(params, {"tokens": toks}, tcfg)
    P = tcfg.vision_tokens
    assert not torch.allclose(a[:, :P], b[:, :P])
    with pytest.raises(ValueError, match="do not fit"):
        forward(params, {"tokens": toks[:, :P - 1], "patch_embeds": pe},
                tcfg)
