"""The masked aggregate of one leaf (``kernels.ops.masked_aggregate``):
the plain version against the rule written out in numpy, the wrapper's
checks, how ``optim.ranl_llm.aggregate`` routes each leaf, and — on a
card — the CUDA kernel (``csrc/masked_aggregate.cu``) against the plain
version at the benchmark cells' leaf shapes.

Tolerances: C′ is a select and a rounding, so it is bit-equal
everywhere.  g is bit-equal where the leaf is covered (the same IEEE
operations in the same order); where it is uncovered the plain version
on the CPU divides C by N, the rule below multiplies by the f32
reciprocal (as PyTorch does on the card and the kernel does), which
rounds apart for an N that is no power of two: rtol 1e-6, atol 1e-7
(``tests/_torch_train_helpers.py``'s for ``masked_aggregate``).  On the
card the kernel and the plain version agree bit for bit in both cases."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402, F401

from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402
from repro_torch.kernels import masked_aggregate as MA  # noqa: E402
from repro_torch.optim import RanlLLMConfig  # noqa: E402
from repro_torch.optim import ranl_llm  # noqa: E402
from repro_torch.tree import get, leaf_paths, leaves, rebuild  # noqa: E402

MASKS = ("all", "mixed", "one", "none")
MEMORY = {"bf16": torch.bfloat16, "f32": torch.float32}


def _mask(kind, n, rng):
    if kind == "all":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "one":
        m = np.zeros(n, bool)
        m[rng.integers(n)] = True
        return m
    m = rng.random(n) < 0.5
    m[0], m[-1] = True, n == 1         # mixed: on and (for n > 1) off
    return m


def _inputs(n, leaf, kind, memory, seed=0, device="cpu"):
    rng = np.random.default_rng(seed + 7 * n + sum(leaf))
    G = torch.tensor(rng.normal(size=(n, *leaf)).astype(np.float32))
    C = torch.tensor(rng.normal(size=(n, *leaf)).astype(np.float32))
    m = torch.tensor(_mask(kind, n, rng))
    return G.to(device), m.to(device), C.to(MEMORY[memory]).to(device)


def _rule(G, m, C):
    """The aggregate written out in numpy f32, worker by worker: g =
    Σᵢ (covered ? (mᵢ·Gᵢ)/max(count, 1) : Cᵢ·(1/N)), C′ᵢ = mᵢ ? Gᵢ
    rounded to C's type : Cᵢ."""
    n = G.shape[0]
    Gn, mn = G.numpy(), m.numpy()
    Cf = C.float().numpy()
    count = np.float32(mn.sum())
    div, inv = max(count, np.float32(1)), np.float32(1) / np.float32(n)
    g = None
    for i in range(n):
        part = (np.float32(mn[i]) * Gn[i] / div if count > 0
                else Cf[i] * inv)
        g = part if g is None else g + part
    C_new = C.clone()
    C_new[torch.tensor(mn)] = G[torch.tensor(mn)].to(C.dtype)
    return torch.tensor(g), C_new


CPU_LEAVES = [(4, (3, 8)), (1, (16,)), (12, (5, 7)), (3, (2, 3, 4)),
              (12, (2, 5))]


@pytest.mark.parametrize("memory", sorted(MEMORY))
@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n,leaf", CPU_LEAVES, ids=str)
def test_plain_version_is_the_rule(n, leaf, kind, memory):
    G, m, C = _inputs(n, leaf, kind, memory)
    g, C_new = ops.masked_aggregate(G, m, C)      # the CPU: the plain version
    want_g, want_c = _rule(G, m, C)
    assert C_new.dtype == C.dtype and torch.equal(C_new, want_c)
    assert g.dtype == torch.float32 and g.shape == G.shape[1:]
    if m.any():
        assert torch.equal(g, want_g)
    else:
        torch.testing.assert_close(g, want_g, rtol=1e-6, atol=1e-7)
    # the optimizer's name for it is the same function
    g2, c2 = ranl_llm.masked_aggregate(G, m, C)
    assert torch.equal(g2, g) and torch.equal(c2, C_new)


def _meta(n=4, leaf=(8,), g=torch.float32, c=torch.bfloat16):
    return (torch.empty((n, *leaf), dtype=g, device="meta"),
            torch.empty(n, dtype=torch.bool, device="meta"),
            torch.empty((n, *leaf), dtype=c, device="meta"))


def _wrong(case):
    G, m, C = _meta()
    if case == "g_dtype":
        return (G.to(torch.float16), m, C), TypeError, "float32"
    if case == "c_dtype":
        return (G, m, C.to(torch.int8)), TypeError, "memory"
    if case == "shape":
        return (G, m, C[:, :4]), ValueError, "shape"
    if case == "mask_shape":
        return (G, m[:, None], C), ValueError, "mask"
    if case == "mask_dtype":
        return (G, m.float(), C), ValueError, "mask"
    if case == "strided":
        wide = torch.empty((4, 16), device="meta")
        return (wide[:, ::2], m, C), ValueError, "contiguous"
    return (G[:0], m[:0], C[:0]), ValueError, "N >= 1"


@pytest.mark.parametrize("case", ["g_dtype", "c_dtype", "shape",
                                  "mask_shape", "mask_dtype", "strided",
                                  "empty"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, err, match = _wrong(case)
    with pytest.raises(err, match=match):
        MA.check(*args)


def test_the_wrapper_takes_cuda_tensors_only():
    G, m, C = _inputs(2, (8,), "mixed", "bf16")
    assert MA.check(G, m, C) == (2, 8)
    assert MA.check(G, torch.ones(2, 3, dtype=torch.bool)[:, 1], C) == \
        (2, 8)                                  # a mask at a stride
    with pytest.raises(ValueError, match="CUDA"):
        MA.masked_aggregate(G, m, C)
    with pytest.raises(ValueError):
        ops.masked_aggregate(*_meta())


def _tree(n, dtype, seed):
    """A params tree of two layers and a glue leaf, its (N, *leaf)
    gradients and the round's masks (N, Q = 3)."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32)).to(
            dtype)
    params = {"embed": t(5, 4), "layers": [{"w": t(4, 3)}, {"w": t(4, 3)}]}
    G = {"embed": t(n, 5, 4), "layers": [{"w": t(n, 4, 3)},
                                         {"w": t(n, 4, 3)}]}
    masks = torch.tensor(rng.random((n, 3)) < 0.5)
    masks[:, 1] = False                         # layer 1 uncovered
    return params, G, masks


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("memory", ["bfloat16", "float32", "int8"])
def test_aggregate_routes_each_leaf_by_what_it_holds(monkeypatch, memory,
                                                     g_dtype):
    """Every leaf goes to ``ops.masked_aggregate`` (the kernel on a card)
    with the memory as it is stored, an int8 memory decoded to G's type
    first, whatever G's type: there is no second path beside the
    dispatch.  Each leaf's result is the plain version's on the decoded
    memory, and the memory is stored back in its own encoding."""
    n = 3
    dtype = getattr(torch, g_dtype)
    cfg = RanlLLMConfig(num_workers=n, memory_int8=memory == "int8",
                        memory_dtype="bfloat16" if memory == "int8"
                        else memory, protect_glue=False)
    params, G, masks = _tree(n, dtype, seed=len(memory))
    _, Gm, _ = _tree(n, torch.float32, seed=99)
    memory_tree = rebuild(Gm, lambda keys, layer: (
        ranl_llm._encode_memory(get(Gm, keys, layer), cfg,
                                layer is not None)))
    seen = []
    kernel = ops.masked_aggregate

    def spy(Gl, ml, Cl):
        seen.append((Gl.dtype, Cl.dtype))
        return kernel(Gl, ml, Cl)
    monkeypatch.setattr(ops, "masked_aggregate", spy)
    want_G = rebuild(G, lambda keys, layer: get(
        G, keys, layer).clone())
    g, C_new, gsq = ranl_llm.aggregate(G, memory_tree, masks, params, cfg)
    assert gsq is None
    stored = getattr(torch, cfg.memory_dtype)
    assert seen == [(dtype, dtype if memory == "int8" else stored)] * 3
    _, L, infos = ranl_llm.region_layout(params)
    lmasks = ranl_llm.leaf_masks(masks, infos, cfg.protect_glue)
    for (keys, layered), lm in zip(leaf_paths(params), lmasks):
        for layer in (range(L) if layered else (None,)):
            C = get(memory_tree, keys, layer)
            if memory == "int8":
                C = ranl_llm.dequantize_memory(C).to(dtype)
            wg, wc = ref.masked_aggregate_ref(
                get(want_G, keys, layer),
                lm[:, layer] if layered else lm[:, 0], C)
            assert torch.equal(get(g, keys, layer), wg)
            got_c = get(C_new, keys, layer)
            if memory == "int8":
                want_c = ranl_llm.quantize_memory(wc, layer=layered)
                assert all(torch.equal(got_c[k], want_c[k]) for k in want_c)
            else:
                assert got_c.dtype == stored and torch.equal(got_c, wc)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_inputs(n, leaf, kind, memory, cuda, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed + n)
    G = torch.randn((n, *leaf), generator=gen, device=cuda)
    C = torch.randn((n, *leaf), generator=gen, device=cuda).to(
        MEMORY[memory])
    m = torch.tensor(_mask(kind, n, np.random.default_rng(seed + n)),
                     device=cuda)
    return G, m, C


def _same(got, want):
    assert torch.equal(got[1], want[1]), "C' differs"
    assert torch.equal(got[0], want[0]), "g differs"


# the cells' leaves: phi4-mini's tied head and a layer's MLP weight at
# N = 4, rwkv6-3b's embedding at N = 12; then a norm's, N = 1, rows not a
# multiple of 8 (the scalar kernel) and N = 12 at a leaf of its own
CARD_LEAVES = [(4, (200064, 3072)), (12, (65536, 2560)), (4, (8192, 3072)),
               (4, (3072,)), (1, (4096,)), (12, (999,)), (3, (1037,)),
               (12, (7, 13))]


@pytest.mark.gpu
@pytest.mark.parametrize("memory", sorted(MEMORY))
@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n,leaf", CARD_LEAVES, ids=str)
def test_kernel_matches_plain_on_card(cuda, n, leaf, kind, memory):
    G, m, C = _card_inputs(n, leaf, kind, memory, cuda)
    before = LAUNCHES["masked_aggregate"]
    got = MA.masked_aggregate(G, m, C)
    assert LAUNCHES["masked_aggregate"] == before + 1
    want = ref.masked_aggregate_ref(G, m, C)
    _same(got, want)
    assert got[1].dtype == C.dtype and got[0].shape == G.shape[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("memory", ["bf16", "f32", "f16"])
def test_kernel_on_a_strided_mask_and_unaligned_rows(cuda, memory):
    """A mask column of an (N, Q) mask, a float16 memory, and G, C whose
    rows start 4 bytes off 16 (the scalar kernel): each as the plain
    version gives it."""
    types = {**MEMORY, "f16": torch.float16}
    n, p = 5, 4096
    gen = torch.Generator(device=cuda).manual_seed(3)
    masks = torch.rand((n, 7), generator=gen, device=cuda) < 0.5
    masks[0, 2] = True
    G = torch.randn((n, p), generator=gen, device=cuda)
    C = torch.randn((n, p), generator=gen, device=cuda).to(
        types[memory])
    _same(MA.masked_aggregate(G, masks[:, 2], C),
          ref.masked_aggregate_ref(G, masks[:, 2], C))
    flat_g = torch.empty(n * p + 1, device=cuda)
    flat_c = torch.empty(n * p + 8, dtype=C.dtype, device=cuda)
    G_off = flat_g[1:].view(n, p)
    C_off = flat_c[8 // C.element_size():][:n * p].view(n, p)
    G_off.copy_(G)
    C_off.copy_(C)
    _same(MA.masked_aggregate(G_off, masks[:, 2], C_off),
          ref.masked_aggregate_ref(G, masks[:, 2], C))


@pytest.mark.gpu
def test_a_g_the_kernel_does_not_take_is_refused_on_the_card(cuda):
    """On the card nothing falls back to the plain loop: the dispatch
    refuses a bf16 G, and no launch is counted."""
    G, m, C = _card_inputs(4, (4096,), "mixed", "bf16", cuda)
    before = LAUNCHES["masked_aggregate"]
    with pytest.raises(TypeError, match="float32"):
        ops.masked_aggregate(G.to(torch.bfloat16), m, C)
    assert LAUNCHES["masked_aggregate"] == before


@pytest.mark.gpu
def test_kernel_makes_no_temporary_at_the_head(cuda):
    """At phi4-mini's head with N = 4 the card holds the inputs and the
    outputs, and within 1 % nothing more: no (N, *leaf) f32 copy."""
    G, m, C = _card_inputs(4, (200064, 3072), "mixed", "bf16", cuda)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = MA.masked_aggregate(G, m, C)
    torch.cuda.synchronize()
    made = sum(t.numel() * t.element_size() for t in out)
    assert torch.cuda.max_memory_allocated() <= 1.01 * (held + made)


@pytest.mark.gpu
@pytest.mark.parametrize("memory_int8", [False, True])
def test_a_rounds_aggregate_on_the_card_launches_it_once_a_leaf(
        cuda, memory_int8):
    """``ranl_llm.aggregate`` on the card (smoke phi4-mini, N = 2, one
    region uncovered): the kernel once a leaf and no wait of the host on
    the card, no codec span for the bf16 memory and one of each a leaf
    for int8, g and the new memory bit-equal to the plain loop's on the
    same gradients."""
    from repro_torch import prng
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import make_batch
    from repro_torch.models import init_model, lm_loss
    from repro_torch.obs import tracing
    cfg = smoke_variant(get_config("phi4-mini-3.8b"))
    gen = torch.Generator().manual_seed(0)
    host = init_model(cfg, gen)
    params = rebuild(host, lambda keys, layer: get(host, keys,
                                                   layer).to(cuda))
    batch = {k: v.to(cuda) for k, v in make_batch(cfg, gen, 4, 16).items()}

    def loss_fn(p, b):
        return lm_loss(p, b, cfg)
    rcfg = RanlLLMConfig(num_workers=2, memory_int8=memory_int8)
    state = ranl_llm.init_state(params, loss_fn, batch, rcfg,
                                prng.PRNGKey(0))
    _, G = ranl_llm.per_worker_grads(loss_fn, params, batch, 2)
    G2 = rebuild(G, lambda keys, layer: get(G, keys, layer).clone())
    Q = ranl_llm.region_layout(params)[0]
    masks = torch.rand((2, Q), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda) < 0.5
    masks[:, 0] = False                     # layer 0 uncovered
    before = LAUNCHES["masked_aggregate"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")     # the host never waits
    try:
        with tracing() as tr:
            g1, c1, _ = ranl_llm.aggregate(G, state["memory"], masks,
                                           params, rcfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n_leaves = len(leaves(params))
    assert LAUNCHES["masked_aggregate"] == before + n_leaves
    codec = [s for s in tr.spans if s.name.startswith("ranl.memory_")]
    assert len(codec) == (2 * n_leaves if memory_int8 else 0)
    saved = MA.masked_aggregate
    try:
        MA.masked_aggregate = ref.masked_aggregate_ref
        g2, c2, _ = ranl_llm.aggregate(G2, state["memory"], masks, params,
                                       rcfg)
    finally:
        MA.masked_aggregate = saved
    assert LAUNCHES["masked_aggregate"] == before + n_leaves
    assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))
    for a, b in zip(leaves(c1), leaves(c2)):
        if memory_int8:
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)
