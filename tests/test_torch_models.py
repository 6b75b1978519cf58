"""The port's deep-net models against the reference's, on the CPU.

The reference's parameters (``repro.models.init_model``) are carried
across with ``repro_torch.interop.model_params_from_numpy`` and the same
numpy tokens go to both sides, so both compute the same function.  On
the CPU the port's attention and wkv calls take the kernels' plain twins.

Tolerances (f32): logits, caches and states within 1e-4 — the two
frameworks take their sums in another order (products, softmax, the wkv
recurrence), and the reference's train/prefill attention is its blocked
online softmax where the port's is one full softmax.  The port's own
prefill+decode against its full forward is held to the reference's
tests/test_models.py tolerances (2e-3 prefill, 3e-3 decode)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_decode_cache as jinit_cache  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models.attention import blocked_attention as jblocked  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.data import make_batch, token_stream  # noqa: E402
from repro_torch.launch.serve import pad_cache  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import forward, init_decode_cache, init_model  # noqa: E402
from repro_torch.models import io as tio  # noqa: E402
from repro_torch.models.attention import blocked_attention  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

KEY = jax.random.PRNGKey(0)
SERVED = ["phi4-mini-3.8b", "rwkv6-3b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **replace):
    j = jconfigs.smoke_variant(jconfigs.get_config(arch))
    t = tconfigs.smoke_variant(tconfigs.get_config(arch))
    if replace:
        j, t = dataclasses.replace(j, **replace), dataclasses.replace(t, **replace)
    return j, t


def _params(jcfg, tcfg, seed=0):
    p = jinit(jcfg, jax.random.PRNGKey(seed))
    return p, interop.model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, p), device="cpu")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


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
# configs
# --------------------------------------------------------------------------

def _same_config(j, t):
    """The port's fields that the reference has equal its; the port's
    own fields (AFMoE's) at their defaults, which leave a configuration
    as the reference has it."""
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert {k: td[k] for k in jd} == jd
    extra = {f.name: f.default for f in dataclasses.fields(t)
             if f.name not in jd}
    assert {k: td[k] for k in extra} == extra


@pytest.mark.parametrize("arch", jconfigs.ALL_ARCHS)
def test_configs_equal_the_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    _same_config(j, t)
    assert j.param_count() == t.param_count()
    assert j.active_param_count() == t.active_param_count()
    js, ts = jconfigs.smoke_variant(j), tconfigs.smoke_variant(t)
    _same_config(js, ts)
    assert js.param_count() == ts.param_count()


def test_config_registry_and_shapes_equal_the_reference():
    assert tconfigs.ALL_ARCHS == jconfigs.ALL_ARCHS
    assert tconfigs.list_configs() == jconfigs.list_configs()
    assert ({k: dataclasses.asdict(v) for k, v in tconfigs.INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jconfigs.INPUT_SHAPES.items()})
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-9")


@pytest.mark.parametrize("arch", jconfigs.ALL_ARCHS)
def test_decode_cache_sizing_equals_the_reference(arch):
    from repro.models import io as jio
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for seq in (16, 4096, 32_768, 524_288):
        assert tio.decode_cache_len(t, seq) == jio.decode_cache_len(j, seq)
        assert tio.decode_window(t, seq) == jio.decode_window(j, seq)


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    s = rng.normal(size=(48,)).astype(np.float32)
    got = tcommon.rms_norm(torch.tensor(x).to(getattr(torch, dtype)),
                           torch.tensor(s))
    want = jcommon.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(s))
    assert str(got.dtype).endswith(dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_rope_and_swiglu_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    pos = np.tile(np.arange(100, 107, dtype=np.int32), (2, 1))
    got = tcommon.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    p = {k: rng.normal(size=sh).astype(np.float32) * 0.1
         for k, sh in (("gate", (32, 48)), ("up", (32, 48)),
                       ("down", (48, 32)))}
    h = rng.normal(size=(3, 32)).astype(np.float32)
    got = tcommon.apply_swiglu({k: torch.tensor(v) for k, v in p.items()},
                               torch.tensor(h))
    want = jcommon.apply_swiglu({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 6, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, (2, 6)).astype(np.int32)
    got = tcommon.softmax_cross_entropy(torch.tensor(logits),
                                        torch.tensor(labels))
    want = jcommon.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_init_helpers_draw_truncated_normals_on_the_generator():
    g = torch.Generator().manual_seed(0)
    w = tcommon.dense_init(g, (256, 512), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 512)
    wf = w.float()
    assert float(wf.abs().max()) <= 2 / 16 + 1e-3      # |z| <= 2, std 1/16
    assert abs(float(wf.std()) * 16 - 0.88) < 0.03      # trunc-normal std
    e = tcommon.embed_init(torch.Generator().manual_seed(0), (64, 32))
    assert float(e.abs().max()) <= 0.04 + 1e-6
    again = tcommon.dense_init(torch.Generator().manual_seed(0), (256, 512),
                               torch.bfloat16)
    assert torch.equal(w, again)


@pytest.mark.parametrize("window", [0, 5])
def test_blocked_attention_with_cache_slots_matches_reference(window):
    """Decode-style attention over a cache with empty (−1) slots and
    positions that wrap: the (KV, G) group split and the masks."""
    rng = np.random.default_rng(3)
    B, Sq, H, KV, hd, W = 2, 1, 4, 2, 32, 12
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, W, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, W, KV, hd)).astype(np.float32)
    slot = np.array([12, 13, 14, 3, 4, 5, 6, 7, 8, 9, 10, -1], np.int32)
    kpos = np.tile(slot, (B, 1))
    qpos = np.full((B, Sq), 14, np.int32)
    got = blocked_attention(*(torch.tensor(a) for a in (q, k, v, qpos, kpos)),
                            window=window, kv_chunk=5)
    want = jblocked(*(jnp.asarray(a) for a in (q, k, v, qpos, kpos)),
                    window=window, kv_chunk=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# forward: train / prefill / decode against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVED + ["qwen3-32b"])
def test_forward_train_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 24)
    want, _, _ = jforward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                          mode="train", q_chunk=16, kv_chunk=16)
    got, cache, aux = forward(tp, {"tokens": torch.tensor(toks)}, tcfg,
                              mode="train")
    assert cache is None and float(aux) == 0.0
    assert got.shape == (2, 24, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", SERVED)
def test_train_forward_gives_every_attention_and_time_mix_weight_a_grad(
        arch):
    """A backward through ``forward(mode="train")`` of a 2-layer model
    reaches every weight of every attention and time-mix block (on the
    card the attention and wkv calls go through K3/K4, whose backward is
    the plain twin's; ``test_torch_kernels`` holds those gradients to
    the twins')."""
    _, tcfg = _cfgs(arch, num_layers=2)
    params = init_model(tcfg, torch.Generator().manual_seed(0))
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    toks = torch.tensor(_tokens(tcfg, 2, 16))
    logits, _, _ = forward(params, {"tokens": toks}, tcfg, mode="train")
    tcommon.softmax_cross_entropy(logits[:, :-1], toks[:, 1:]).backward()
    blocks = [lp["tmix" if tcfg.attn_free else "attn"]
              for lp in params["layers"]]
    assert len(blocks) == 2
    for block in blocks:
        for name, w in block.items():
            assert w.grad is not None, name
            assert torch.isfinite(w.grad).all(), name


def _leaves(node):
    if isinstance(node, dict):
        return [x for v in node.values() for x in _leaves(v)]
    if isinstance(node, list):
        return [x for v in node for x in _leaves(v)]
    return [node]


@pytest.mark.parametrize("arch", SERVED)
def test_forward_prefill_then_decode_match_reference(arch):
    """Prefill logits and cache, then three decode steps' logits and
    caches (the RWKV state included), step for step."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 11)
    P, T = 8, 11
    jl, jc, _ = jforward(jp, {"tokens": jnp.asarray(toks[:, :P])}, jcfg,
                         mode="prefill", q_chunk=16, kv_chunk=16)
    tl, tc, _ = forward(tp, {"tokens": torch.tensor(toks[:, :P])}, tcfg,
                        mode="prefill")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(jax.tree.map(np.asarray, jc), tc, **TOL)
    if not jcfg.attn_free:
        from repro.launch.serve import pad_cache as jpad
        jc, tc = jpad(jc, T), pad_cache(tc, T)
    for t in range(P, T):
        jl, jc, _ = jforward(jp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                  "pos": jnp.int32(t)}, jcfg, mode="decode",
                             cache=jc, kv_chunk=16)
        tl, tc, _ = forward(tp, {"tokens": torch.tensor(toks[:, t:t + 1]),
                                 "pos": t}, tcfg, mode="decode", cache=tc,
                            kv_chunk=16)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_tree_close(jax.tree.map(np.asarray, jc), tc, **TOL)


@pytest.mark.parametrize("arch", SERVED)
def test_decode_from_an_empty_cache_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    jc = jinit_cache(jcfg, 2, 6, jnp.float32)
    tc = init_decode_cache(tcfg, 2, 6, torch.float32, device="cpu")
    _assert_tree_close(jax.tree.map(np.asarray, jc), tc, rtol=0, atol=0)
    toks = _tokens(jcfg, 2, 4)
    for t in range(4):
        jl, jc, _ = jforward(jp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                  "pos": jnp.int32(t)}, jcfg, mode="decode",
                             cache=jc, kv_chunk=4)
        tl, tc, _ = forward(tp, {"tokens": torch.tensor(toks[:, t:t + 1]),
                                 "pos": t}, tcfg, mode="decode", cache=tc,
                            kv_chunk=4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(jax.tree.map(np.asarray, jc), tc, **TOL)


def test_bf16_parameters_carry_across_exactly():
    """The reference's bf16 leaves (numpy has no bf16 of its own) arrive
    as the same bf16 values."""
    jcfg, tcfg = _cfgs("rwkv6-3b")
    jp = jinit(jcfg, KEY, jnp.bfloat16)
    tp = interop.model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    want = np.asarray(jp["layers"]["tmix"]["w_r"][1]).astype(np.float32)
    np.testing.assert_array_equal(
        tp["layers"][1]["tmix"]["w_r"].float().numpy(), want)
    f32 = interop.model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.float32)
    assert f32["layers"][0]["ln1"].dtype == torch.float32


def test_decode_leaves_the_given_cache_unchanged():
    _, tcfg = _cfgs("phi4-mini-3.8b")
    tp = init_model(tcfg, torch.Generator().manual_seed(0))
    cache = init_decode_cache(tcfg, 1, 4, torch.float32, device="cpu")
    before = {k: v.clone() for k, v in cache["layers"]["attn"].items()}
    forward(tp, {"tokens": torch.zeros((1, 1), dtype=torch.int32), "pos": 0},
            tcfg, mode="decode", cache=cache)
    for k, v in before.items():
        assert torch.equal(cache["layers"]["attn"][k], v)


# --------------------------------------------------------------------------
# the port on its own
# --------------------------------------------------------------------------

def _tcfg(arch, **replace):
    return _cfgs(arch, **replace)[1]


@pytest.mark.parametrize("arch", SERVED + ["qwen3-32b"])
def test_prefill_decode_matches_full_forward(arch):
    """Teacher-forced prefill+decode reproduces the train-mode logits, as
    tests/test_models.py asks of the reference."""
    cfg = _tcfg(arch)
    g = torch.Generator().manual_seed(0)
    params = init_model(cfg, g)
    T, Tp = 12, 8
    toks = make_batch(cfg, g, batch=2, seq=T, kind="train")["tokens"]
    full, _, _ = forward(params, {"tokens": toks}, cfg, mode="train")
    pre, cache, _ = forward(params, {"tokens": toks[:, :Tp]}, cfg,
                            mode="prefill")
    if not cfg.attn_free:
        cache = pad_cache(cache, T)
    torch.testing.assert_close(pre[:, -1], full[:, Tp - 1], rtol=2e-3,
                               atol=2e-3)
    for t in range(Tp, T):
        logits, cache, _ = forward(params, {"tokens": toks[:, t:t + 1],
                                            "pos": t}, cfg, mode="decode",
                                   cache=cache, kv_chunk=16)
        torch.testing.assert_close(logits[:, 0], full[:, t], rtol=3e-3,
                                   atol=3e-3)


def test_sliding_window_decode_matches_windowed_forward():
    cfg = _tcfg("mistral-nemo-12b", sliding_window=8)
    g = torch.Generator().manual_seed(0)
    params = init_model(cfg, g)
    T, W = 16, 8
    toks = make_batch(cfg, g, batch=1, seq=T)["tokens"]
    full, _, _ = forward(params, {"tokens": toks}, cfg, mode="train",
                         window=W)
    cache = init_decode_cache(cfg, 1, W, torch.float32, device="cpu")
    for t in range(T):
        logits, cache, _ = forward(params, {"tokens": toks[:, t:t + 1],
                                            "pos": t}, cfg, mode="decode",
                                   cache=cache, window=W, kv_chunk=16)
        torch.testing.assert_close(logits[:, 0], full[:, t], rtol=3e-3,
                                   atol=3e-3)


@pytest.mark.parametrize("arch", SERVED)
def test_init_model_sizes_and_types(arch):
    cfg = _tcfg(arch)
    params = init_model(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    leaves = [params["embed"], params["final_norm"]] + (
        [params["lm_head"]] if "lm_head" in params else [])

    def walk(node):
        for v in node.values():
            yield from (walk(v) if isinstance(v, dict) else [v])
    for lp in params["layers"]:
        leaves += list(walk(lp))
    assert len(params["layers"]) == cfg.num_layers
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    actual = sum(t.numel() for t in leaves)
    jcfg = _cfgs(arch)[0]
    ref_actual = sum(x.size for x in jax.tree.leaves(jinit(jcfg, KEY)))
    assert actual == ref_actual


def test_positions_without_a_cache_must_be_arange():
    from repro_torch.models.attention import apply_attention
    cfg = _tcfg("phi4-mini-3.8b")
    params = init_model(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(1, 4, cfg.d_model)
    with pytest.raises(ValueError, match="arange"):
        apply_attention(params["layers"][0]["attn"], x, cfg,
                        torch.arange(1, 5)[None])


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_make_batch_shapes_and_bigram_chain():
    cfg = _tcfg("rwkv6-3b")
    g = torch.Generator().manual_seed(0)
    batch = make_batch(cfg, g, batch=3, seq=200, kind="train",
                       pattern="bigram")
    toks, labels = batch["tokens"], batch["labels"]
    assert toks.shape == labels.shape == (3, 200)
    assert toks.dtype == torch.int32
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    follows = (labels.long() == (31 * toks.long() + 17) % cfg.vocab_size)
    assert 0.8 < float(follows.float().mean()) < 0.97     # noise 0.1
    prompt = make_batch(cfg, torch.Generator().manual_seed(0), 3, 200,
                        kind="prefill", pattern="bigram")
    assert set(prompt) == {"tokens"} and torch.equal(prompt["tokens"], toks)


def test_token_stream_uniform_and_worker_skew():
    cfg = _tcfg("phi4-mini-3.8b")
    g = torch.Generator().manual_seed(0)
    toks = token_stream(cfg, g, 4, 500)
    assert toks.shape == (4, 500) and int(toks.min()) >= 0
    assert int(toks.max()) < cfg.vocab_size
    skew = token_stream(cfg, g, 4, 500, worker=1, num_workers=4,
                        heterogeneity=1.0)
    band = cfg.vocab_size // 4
    assert bool(((skew >= band) & (skew < 2 * band)).all())
    audio = _tcfg("musicgen-medium")
    a = token_stream(audio, g, 2, 10, pattern="bigram")
    assert a.shape == (2, 10, audio.num_codebooks)
    assert torch.equal(a[..., 1], (a[..., 0] + 1) % audio.vocab_size)
