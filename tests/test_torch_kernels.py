"""The port's kernels: the plain versions against the reference's oracles
and its Pallas kernels (interpret mode, as tests/test_kernels.py runs
them), the dispatch by device, and — on a card — the Triton and CUDA
kernels against the plain versions.

Tolerances: C′ is a select, so it is bit-equal everywhere.  ḡ and x′ sum
N rows in another order than the reference (rtol 1e-4, atol 1e-5
against the reference, 1e-5/1e-6 kernel against plain on the card).
Attention and the wkv recurrence take their sums in another order too:
those of tests/test_kernels.py, 2e-4 in f32 and 2e-2 in bf16."""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import region_aggregate as K  # noqa: E402
from repro_torch.kernels import rwkv_wkv as WKV  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

SHAPES = [(1, 1), (3, 129), (7, 513)]
MASKS = ["random", "all_false", "all_true"]
MU, LR = 0.1, 0.7


def _inputs(n, d, kind, seed=0):
    rng = np.random.default_rng(seed + 31 * n + d)
    if kind == "random":
        m = rng.random((n, d)) < 0.5
    else:
        m = np.full((n, d), kind == "all_true")
    g = (rng.normal(size=(n, d)) * m).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    x = rng.normal(size=d).astype(np.float32)
    h = (np.abs(rng.normal(size=d)) + 0.01).astype(np.float32)
    return g, m, c, x, h


def _t(*arrays, device="cpu"):
    return [torch.tensor(a, device=device) for a in arrays]


@pytest.fixture
def reference():
    """The reference's oracles and Pallas dispatch, on the CPU.  Only
    these tests need the reference's framework, which a GPU host may
    lack."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_region_aggregate_matches_reference(reference, n, d, kind):
    jnp, jops, jref = reference
    g, m, c, _, _ = _inputs(n, d, kind)
    got = ref.region_aggregate_ref(*_t(g, m, c))
    for want in (jref.region_aggregate_ref(g, m, c),
                 jops.region_aggregate(jnp.asarray(g), jnp.asarray(m),
                                       jnp.asarray(c))):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_ranl_update_matches_reference(reference, n, d, kind):
    jnp, jops, jref = reference
    g, m, c, x, h = _inputs(n, d, kind)
    got = ref.ranl_update_ref(*_t(x, h, g, m, c), mu=MU, lr=LR)
    for want in (jref.ranl_update_ref(x, h, g, m, c, mu=MU, lr=LR),
                 jops.ranl_update(jnp.asarray(x), jnp.asarray(h),
                                  jnp.asarray(g), jnp.asarray(m),
                                  jnp.asarray(c), mu=MU, lr=LR)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_all_uncovered_steps_along_memory_mean():
    g, m, c, x, h = _inputs(4, 33, "all_false")
    xn, cn = ref.ranl_update_ref(*_t(x, h, g, m, c), mu=1e-3, lr=1.0)
    expect = x - c.sum(0) / 4 / np.maximum(h, 1e-3)
    np.testing.assert_allclose(xn.numpy(), expect, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(cn.numpy(), c)


def test_cpu_dispatch_takes_plain_version_and_counts_no_launch():
    g, m, c, x, h = _t(*_inputs(3, 40, "random"))
    before = dict(LAUNCHES)
    a = ops.region_aggregate(g, m, c)
    b = ref.region_aggregate_ref(g, m, c)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    a = ops.ranl_update(x, h, g, m, c, mu=MU, lr=LR)
    b = ref.ranl_update_ref(x, h, g, m, c, mu=MU, lr=LR)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_server_aggregate_runs_the_plain_version_on_the_host(use_kernel,
                                                             kind):
    """Both routes of the engine's aggregation reach the one plain
    definition for CPU tensors, bit for bit."""
    from repro_torch.core.aggregation import server_aggregate
    g, m, c, _, _ = _t(*_inputs(5, 77, kind))
    got = server_aggregate(g, m, c, use_kernel=use_kernel)
    want = ref.region_aggregate_ref(g, m, c)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_wrappers_reject_what_the_kernel_does_not_take():
    g, m, c, x, h = _t(*_inputs(3, 40, "random"))
    with pytest.raises(ValueError, match="CUDA"):
        K.region_aggregate(g, m, c)
    with pytest.raises(ValueError, match="CUDA"):
        K.ranl_update(x, h, g, m, c, mu=MU, lr=LR)
    with pytest.raises(ValueError):
        ops.region_aggregate(g.to("meta"), m.to("meta"), c.to("meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n,d", SHAPES + [
    (32, 4096), (32, 8192), (32, (1 << 16) + 37), (1, 4096), (7, 4096),
    (31, 4096)])
def test_triton_kernels_match_plain_on_card(cuda, n, d, kind):
    g, m, c, x, h = _t(*_inputs(n, d, kind), device=cuda)
    before = dict(LAUNCHES)
    got = K.region_aggregate(g, m, c)
    want = ref.region_aggregate_ref(g, m, c)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], want[1])
    got = K.ranl_update(x, h, g, m, c, mu=MU, lr=LR)
    want = ref.ranl_update_ref(x, h, g, m, c, mu=MU, lr=LR)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], want[1])
    assert LAUNCHES["region_aggregate"] == before["region_aggregate"] + 1
    assert LAUNCHES["ranl_update"] == before["ranl_update"] + 1


def _batched_inputs(b, n, d, kind, seed=0):
    """B seeds' inputs stacked: (b, n, d) and (b, d)."""
    return [np.stack(arrs) for arrs in zip(*(
        _inputs(n, d, kind, seed=seed + 101 * i) for i in range(b)))]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("b,n,d", [(8, 32, 8192), (8, 32, 4096), (1, 32, 4096),
                                   (3, 7, 513), (2, 32, (1 << 16) + 37),
                                   (2, 5, (1 << 18) + 3)])
def test_seed_batched_kernels_match_plain_on_card(cuda, b, n, d, kind):
    """One launch for B seeds: C′ bit-equal, ḡ and x′ as the unbatched
    kernels', and each seed's row as the kernel on that seed alone: C′
    bit-equal, x′ within the kernel tolerance (B seeds may take a wider
    tile, which sums the rows in another order).  A ragged D, B = 1 and
    the row-loop path included."""
    g, m, c, x, h = _t(*_batched_inputs(b, n, d, kind), device=cuda)
    before = dict(LAUNCHES)
    got = K.region_aggregate(g, m, c)
    want = ref.region_aggregate_ref(g, m, c)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], want[1])
    gotx = K.ranl_update(x, h, g, m, c, mu=MU, lr=LR)
    wantx = ref.ranl_update_ref(x, h, g, m, c, mu=MU, lr=LR)
    torch.testing.assert_close(gotx[0], wantx[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(gotx[1], wantx[1])
    assert LAUNCHES["region_aggregate"] == before["region_aggregate"] + 1
    assert LAUNCHES["ranl_update"] == before["ranl_update"] + 1
    for i in range(b):
        one = K.ranl_update(x[i], h[i], g[i], m[i], c[i], mu=MU, lr=LR)
        torch.testing.assert_close(gotx[0][i], one[0], rtol=1e-5, atol=1e-6)
        assert torch.equal(gotx[1][i], one[1])


@pytest.mark.parametrize("n,d", [(32, 4096), (32, 8192)])
def test_launch_config_spreads_the_main_shapes_over_the_card(n, d):
    """The main path's shapes take the tile body (every row at once) with
    at least 128 programs for the card's 132 SMs (256 as configured)."""
    block_n, block_d, warps = K._launch_config(n, d)
    assert block_n >= n and -(-d // block_d) >= 128
    assert block_n * block_d <= K.TILE_ELEMS and 1 <= warps <= 4


@pytest.mark.parametrize("b,n,d", [(8, 32, 8192), (8, 32, 4096), (2, 7, 513),
                                   (64, 32, 4096)])
def test_launch_config_counts_programs_over_the_seeds(b, n, d):
    """The seed axis counts toward the programs: B seeds of a shape take a
    tile at least as wide as one seed's, and still fill the card."""
    bn, bd, warps = K._launch_config(n, d, b)
    bn1, bd1, _ = K._launch_config(n, d)
    assert bn == bn1 and bd >= bd1
    assert -(-d // bd) * b >= min(K.MIN_PROGRAMS, -(-d // 16) * b)
    assert bn * bd <= K.TILE_ELEMS and 1 <= warps <= 4


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("b,n,d", [(1, 3, 129), (4, 7, 513), (2, 1, 1)])
def test_plain_versions_broadcast_over_seeds(reference, b, n, d, kind):
    """The plain versions on (B, N, D) equal the reference's oracles seed
    by seed (C′ bit-equal)."""
    jnp, jops, jref = reference
    g, m, c, x, h = _batched_inputs(b, n, d, kind)
    agg = ref.region_aggregate_ref(*_t(g, m, c))
    upd = ref.ranl_update_ref(*_t(x, h, g, m, c), mu=MU, lr=LR)
    for i in range(b):
        want = jref.region_aggregate_ref(g[i], m[i], c[i])
        np.testing.assert_allclose(agg[0][i].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(agg[1][i].numpy(),
                                      np.asarray(want[1]))
        want = jref.ranl_update_ref(x[i], h[i], g[i], m[i], c[i], mu=MU,
                                    lr=LR)
        np.testing.assert_allclose(upd[0][i].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(upd[1][i].numpy(),
                                      np.asarray(want[1]))


def test_seed_batched_wrappers_check_shapes_on_the_host():
    """The batched form's shape rules are checked before any launch."""
    g, m, c, x, h = _t(*_batched_inputs(2, 3, 40, "random"))
    with pytest.raises(ValueError, match="CUDA"):
        K.ranl_update(x, h, g, m, c, mu=MU, lr=LR)
    got = ops.ranl_update(x, h, g, m, c, mu=MU, lr=LR)
    assert got[0].shape == (2, 40) and got[1].shape == (2, 3, 40)


def test_launch_config_keeps_the_row_loop_at_large_d():
    assert K._launch_config(32, 1 << 22) == (0, 1024, 4)
    assert K._launch_config(33, 4096) == (0, 1024, 4)   # more rows than a tile


@pytest.mark.parametrize("n", [1, 2, 7, 31, 32])
@pytest.mark.parametrize("d", [1, 129, 4096, (1 << 16) + 37])
def test_launch_config_tiles_cover_every_row(n, d):
    block_n, block_d, warps = K._launch_config(n, d)
    assert block_n >= n and block_n & (block_n - 1) == 0
    assert block_d & (block_d - 1) == 0 and block_d >= 16
    assert block_n * block_d <= K.TILE_ELEMS and 1 <= warps <= 4


@pytest.mark.gpu
def test_triton_wrappers_check_inputs_on_card(cuda):
    g, m, c, x, h = _t(*_inputs(3, 40, "random"), device=cuda)
    with pytest.raises(ValueError, match="shape"):
        K.ranl_update(x[None].expand(2, 40).contiguous(), h, g[None], m[None],
                      c[None], mu=MU, lr=LR)
    with pytest.raises(ValueError):
        K.region_aggregate(g[None, None], m[None, None], c[None, None])
    with pytest.raises(TypeError):
        K.region_aggregate(g.double(), m, c)
    with pytest.raises(ValueError):
        K.region_aggregate(g, m[:, :20], c)
    with pytest.raises(ValueError, match="contiguous"):
        K.region_aggregate(g[:, ::2], m[:, ::2], c[:, ::2])


# --------------------------------------------------------------------------
# flash attention (K3) and the wkv recurrence (K4)
# --------------------------------------------------------------------------

# the cases of tests/test_kernels.py: (b, s, h, kv, hd, window)
ATTN_CASES = [
    (1, 128, 2, 2, 64, 0),       # MHA
    (2, 256, 4, 2, 64, 0),       # GQA
    (1, 256, 4, 1, 128, 0),      # MQA
    (2, 256, 4, 2, 64, 100),     # sliding window
    (1, 256, 2, 2, 32, 64),      # narrow window
]
WKV_CASES = [(1, 64, 2, 16), (2, 128, 4, 64), (1, 256, 1, 32)]


def _attn_inputs(b, s, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed + 7 * s + hd)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32))


def _wkv_inputs(b, s, h, hd, seed=0, state=True):
    rng = np.random.default_rng(seed + 13 * s + hd)
    r, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    w = (0.45 + 0.5 / (1 + np.exp(-rng.normal(size=(b, s, h, hd))))
         ).astype(np.float32)
    u = (rng.normal(size=(h, hd)) * 0.3).astype(np.float32)
    s0 = (rng.normal(size=(b, h, hd, hd)) * 0.1 * state).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd,win", ATTN_CASES, ids=str)
def test_plain_flash_attention_matches_reference(reference, b, s, h, kv, hd,
                                                 win, dtype):
    jnp, jops, jref = reference
    arrays = _attn_inputs(b, s, h, kv, hd)
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]
    got = ref.flash_attention_ref(*tx, causal=True, window=win)
    assert got.dtype == tx[0].dtype and got.shape == (b, s, h, hd)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for want in (jops.flash_attention(*jx, causal=True, window=win,
                                      block_q=64, block_k=64),
                 jref.flash_attention_ref(*jx, causal=True, window=win)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_plain_flash_attention_matches_reference_without_causal_mask(
        reference):
    jnp, _, jref = reference
    arrays = _attn_inputs(1, 48, 4, 2, 32)
    got = ref.flash_attention_ref(*_t(*arrays), causal=False, window=0)
    want = jref.flash_attention_ref(*map(jnp.asarray, arrays), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("b,s,h,hd", WKV_CASES, ids=str)
def test_plain_rwkv_wkv_matches_reference(reference, b, s, h, hd):
    jnp, jops, jref = reference
    from repro.models.rwkv import _wkv_scan
    arrays = _wkv_inputs(b, s, h, hd)
    y, sf = ref.rwkv_wkv_ref(*_t(*arrays))
    assert y.dtype == torch.float32 and y.shape == (b, s, h, hd)
    jx = [jnp.asarray(a) for a in arrays]
    for want in (jops.rwkv_wkv(*jx, block_t=min(64, s)),
                 jref.rwkv_wkv_ref(*jx), _wkv_scan(*jx)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(sf.numpy(), np.asarray(want[1]),
                                   rtol=2e-4, atol=2e-4)


def test_plain_rwkv_wkv_takes_bf16_inputs_in_f32(reference):
    """r, k, v, u in bf16 (the serve dtype) are widened, not rounded
    further: the same as the reference's scan on the same bf16 values."""
    jnp, _, _ = reference
    from repro.models.rwkv import _wkv_scan
    r, k, v, w, u, s0 = _wkv_inputs(2, 37, 3, 64)
    tb = [torch.tensor(a).to(torch.bfloat16) for a in (r, k, v, u)]
    y, sf = ref.rwkv_wkv_ref(tb[0], tb[1], tb[2], torch.tensor(w), tb[3],
                             torch.tensor(s0))
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (r, k, v, u)]
    want = _wkv_scan(jb[0], jb[1], jb[2], jnp.asarray(w), jb[3],
                     jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(sf.numpy(), np.asarray(want[1]), rtol=2e-4,
                               atol=2e-4)


def test_cpu_dispatch_of_attention_and_wkv_takes_plain_version():
    before = dict(LAUNCHES)
    q, k, v = _t(*_attn_inputs(1, 40, 4, 2, 32))
    assert torch.equal(ops.flash_attention(q, k, v, causal=True, window=8),
                       ref.flash_attention_ref(q, k, v, causal=True,
                                               window=8))
    args = _t(*_wkv_inputs(1, 9, 2, 16))
    a, b = ops.rwkv_wkv(*args), ref.rwkv_wkv_ref(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert dict(LAUNCHES) == before


def test_plain_flash_attention_returns_lse_beside_the_same_output():
    """With ``return_lse`` the plain forward returns the same output and
    each row's log-sum-exp (B, H, S) f32: the softmax's normaliser, so
    exp(s - L) sums to one over a row's kept keys."""
    q, k, v = _t(*_attn_inputs(2, 40, 6, 2, 32))
    out, lse = ref.flash_attention_ref(q, k, v, window=9, return_lse=True)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, window=9))
    assert lse.shape == (2, 6, 40) and lse.dtype == torch.float32
    kr = k.repeat_interleave(3, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(32)
    pos = torch.arange(40)
    keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - 9)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones(2, 6, 40), rtol=0,
                               atol=1e-5)


def test_cuda_wrappers_reject_host_tensors():
    q, k, v = _t(*_attn_inputs(1, 8, 2, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        WKV.rwkv_wkv(*_t(*_wkv_inputs(1, 4, 2, 16)))
    with pytest.raises(ValueError):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# the kernels' shapes on the card: the model's main path, a ragged S, a
# window, f32 at hd 64, MQA
CARD_ATTN_CASES = ATTN_CASES + [(2, 1000, 24, 8, 128, 0),
                                (1, 1000, 8, 8, 128, 100),
                                (1, 77, 4, 1, 64, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd,win", CARD_ATTN_CASES, ids=str)
def test_flash_attention_kernel_matches_plain_on_card(cuda, b, s, h, kv, hd,
                                                      win, dtype):
    q, k, v = (t.to(getattr(torch, dtype))
               for t in _t(*_attn_inputs(b, s, h, kv, hd), device=cuda))
    before = LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=True, window=win)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=win)
    assert LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == q.dtype
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd,win", CARD_ATTN_CASES, ids=str)
def test_flash_attention_kernel_lse_matches_plain_on_card(cuda, b, s, h, kv,
                                                          hd, win, dtype):
    """Both bodies' log-sum-exp (the backward's L) against the plain
    forward's; the output is the same with and without it."""
    q, k, v = (t.to(getattr(torch, dtype))
               for t in _t(*_attn_inputs(b, s, h, kv, hd), device=cuda))
    out, lse = FA.flash_attention(q, k, v, window=win, return_lse=True)
    assert torch.equal(out, FA.flash_attention(q, k, v, window=win))
    _, want = ref.flash_attention_ref(q, k, v, window=win, return_lse=True)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(lse, want, rtol=0, atol=tol)


@pytest.mark.gpu
def test_flash_attention_kernel_reads_strided_inputs_on_card(cuda):
    """q/k/v as views of one fused projection (strided rows), and
    causal=False, agree with the plain version on contiguous copies."""
    qkv = torch.randn(2, 70, 4 + 2 + 2, 64, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    for causal in (True, False):
        got = FA.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=causal)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# K3's two bodies: the route by (dtype, hd), the TMA checks and tensor-map
# arguments on the host, and the tensor-core body on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,hd,body", [
    ("float32", 32, "simt"), ("float32", 64, "simt"),
    ("float32", 128, "simt"), ("bfloat16", 32, "simt"),
    ("bfloat16", 64, "tc"), ("bfloat16", 128, "tc")])
def test_flash_attention_route_is_fixed_by_dtype_and_head_dim(dtype, hd,
                                                              body):
    assert FA.route(getattr(torch, dtype), hd) == body


def test_flash_attention_route_refuses_what_no_body_takes():
    with pytest.raises(ValueError, match="head dim"):
        FA.route(torch.bfloat16, 96)
    with pytest.raises(TypeError):
        FA.route(torch.float16, 64)


def _bf16(*shape, device="cpu"):
    return torch.zeros(*shape, dtype=torch.bfloat16, device=device)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_tma_alignment_check_accepts_aligned_tensors_and_views(device):
    q, k, v = (_bf16(2, 70, n, 64, device=device) for n in (4, 2, 2))
    FA.check_tma_alignment(q, k, v)
    qkv = _bf16(2, 70, 8, 64, device=device)        # one fused projection
    FA.check_tma_alignment(qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:])
    one = _bf16(1, 1, 1, 64, device=device)[:, :, :, :]
    FA.check_tma_alignment(one, one, one)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_tma_alignment_check_refuses_odd_offsets_and_strides(device):
    ok = _bf16(1, 16, 2, 64, device=device)
    flat = _bf16(1 + 16 * 2 * 64, device=device)
    odd_base = flat[1:].view(1, 16, 2, 64)             # 2-byte offset
    with pytest.raises(ValueError, match="base address"):
        FA.check_tma_alignment(odd_base, ok, ok)
    wide = _bf16(1, 16, 2, 68, device=device)[..., :64]   # 136-byte rows
    with pytest.raises(ValueError, match="stride"):
        FA.check_tma_alignment(ok, wide, ok)
    gapped = _bf16(1, 16, 3, 64, device=device)[:, :, :, :].as_strided(
        (1, 16, 2, 64), (16 * 2 * 68, 2 * 68, 68, 1))
    with pytest.raises(ValueError, match="stride"):
        FA.check_tma_alignment(ok, ok, gapped)


def test_tensor_map_args_give_dims_byte_strides_and_box():
    q = _bf16(4, 1024, 24, 128)
    assert FA.tensor_map_args(q, FA.BLOCK_Q) == (
        128, 24, 1024, 4, 256, 24 * 256, 1024 * 24 * 256, 64, 1, 128, 1)
    qkv = _bf16(2, 70, 8, 64)
    k = qkv[:, :, 4:6]
    assert FA.tensor_map_args(k, FA.BLOCK_K) == (
        64, 2, 70, 2, 128, 8 * 128, 70 * 8 * 128, 64, 1, 128, 1)
    # a dim of size 1 is never stepped over: packed strides stand in
    odd = _bf16(1, 5, 1, 64).as_strided((1, 5, 1, 64), (3, 64, 7, 1))
    assert FA.tensor_map_args(odd, 128)[4:7] == (128, 128, 640)
    assert (FA.BLOCK_Q, FA.BLOCK_K, FA.BOX_COLS) == (128, 128, 64)


def test_build_hash_covers_headers_in_csrc(monkeypatch, tmp_path):
    """A changed header rebuilds every library (no stale reuse)."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text("// source\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    bare = build.library_path("k")
    (tmp_path / "common.cuh").write_text("// header 1\n")
    with_header = build.library_path("k")
    (tmp_path / "common.cuh").write_text("// header 2\n")
    changed = build.library_path("k")
    assert len({bare, with_header, changed}) == 3
    assert build.library_path("k") == changed


TC_S = [1, 63, 64, 65, 127, 128, 129, 1000, 1024, 2048]


def _tc_check(cuda, b, s, h, kv, hd, win, causal=True, seed=0):
    q, k, v = (t.to(torch.bfloat16) for t in
               _t(*_attn_inputs(b, s, h, kv, hd, seed), device=cuda))
    assert FA.route(q.dtype, hd) == "tc"
    before = LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal, window=win)
    assert LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=win)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, hd)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("win", [0, 1, 100, 128])
@pytest.mark.parametrize("s", TC_S)
@pytest.mark.parametrize("hd", [64, 128])
def test_tc_flash_attention_matches_plain_on_card(cuda, hd, s, win):
    _tc_check(cuda, 2, s, 4, 2, hd, win)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv", [(4, 4), (6, 2), (16, 2), (5, 1)],
                         ids=["groups1", "groups3", "groups8", "mqa"])
@pytest.mark.parametrize("s", [129, 1000])
@pytest.mark.parametrize("hd", [64, 128])
def test_tc_flash_attention_kv_groups_on_card(cuda, hd, s, h, kv):
    _tc_check(cuda, 1, s, h, kv, hd, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 65, 1000])
@pytest.mark.parametrize("hd", [64, 128])
def test_tc_flash_attention_without_causal_mask_on_card(cuda, hd, s):
    _tc_check(cuda, 2, s, 4, 2, hd, 0, causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
def test_tc_flash_attention_reads_fused_projection_views_on_card(cuda, hd,
                                                                 causal):
    """bf16 q/k/v as strided views of one fused projection."""
    qkv = torch.randn(2, 200, 4 + 2 + 2, hd, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    before = LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal)
    assert LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
def test_tc_flash_attention_refuses_unaligned_views_on_card(cuda):
    flat = torch.zeros(1 + 2 * 64 * 4 * 64, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(2, 64, 4, 64)
    ok = torch.zeros(2, 64, 4, 64, device=cuda, dtype=torch.bfloat16)
    before = LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="base address"):
        FA.flash_attention(q, ok, ok)
    assert LAUNCHES["flash_attention"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hd", WKV_CASES + [(4, 1024, 40, 64),
                                                  (4, 1, 40, 64),
                                                  (1, 37, 3, 64),
                                                  (1, 50, 2, 128),
                                                  (2, 300, 3, 64),
                                                  (1, 300, 2, 16),
                                                  (1, 300, 1, 128),
                                                  (8, 40, 40, 64),
                                                  (8, 1, 40, 64),
                                                  (1, 1, 2, 16),
                                                  (2, 1, 3, 32),
                                                  (1, 1, 1, 128)], ids=str)
def test_rwkv_wkv_kernel_matches_plain_on_card(cuda, b, s, h, hd, dtype):
    r, k, v, w, u, s0 = _t(*_wkv_inputs(b, s, h, hd), device=cuda)
    dt = getattr(torch, dtype)
    r, k, v, u = (t.to(dt) for t in (r, k, v, u))
    before = LAUNCHES["rwkv_wkv"]
    y, sf = WKV.rwkv_wkv(r, k, v, w, u, s0)
    assert LAUNCHES["rwkv_wkv"] == before + 1
    y_ref, sf_ref = ref.rwkv_wkv_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(sf, sf_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [300, 1])
def test_rwkv_wkv_kernel_reads_a_strided_r_on_card(cuda, dtype, s):
    """r as one half of a wider projection (strided heads), over many
    chunks and in one decode step, against the plain version on a
    contiguous copy."""
    _, k, v, w, u, s0 = _t(*_wkv_inputs(2, s, 3, 64), device=cuda)
    dt = getattr(torch, dtype)
    wide = torch.randn(2, s, 3, 128, device=cuda).to(dt)
    r = wide[..., 64:]
    k, v, u = (t.to(dt) for t in (k, v, u))
    y, sf = WKV.rwkv_wkv(r, k, v, w, u, s0)
    y_ref, sf_ref = ref.rwkv_wkv_ref(r.contiguous(), k, v, w, u, s0)
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(sf, sf_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hd", [(2, 3, 64), (4, 40, 64), (1, 2, 16),
                                    (2, 3, 32), (1, 2, 128), (4, 40, 128)],
                         ids=str)
def test_rwkv_wkv_decode_steps_equal_one_run_on_card(cuda, dtype, b, h, hd):
    """A prefill and then one-step calls from the state before give, bit
    for bit, what one call over all the steps gives: the serve path's
    decode computes what its prefill would have, on both tiles."""
    r, k, v, w, u, s0 = _t(*_wkv_inputs(b, 40, h, hd), device=cuda)
    dt = getattr(torch, dtype)
    r, k, v, u = (t.to(dt) for t in (r, k, v, u))
    y_all, s_all = WKV.rwkv_wkv(r, k, v, w, u, s0)
    y, state = WKV.rwkv_wkv(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u,
                            s0)
    ys = [y]
    for t in range(32, 40):
        y, state = WKV.rwkv_wkv(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                                w[:, t:t + 1], u, state)
        ys.append(y)
    assert torch.equal(torch.cat(ys, dim=1), y_all)
    assert torch.equal(state, s_all)


@pytest.mark.gpu
def test_rwkv_wkv_kernel_refuses_unaligned_views_on_card(cuda):
    r, k, v, w, u, s0 = _t(*_wkv_inputs(1, 16, 2, 64), device=cuda)
    odd = torch.zeros(1 + 16 * 2 * 64, device=cuda)[1:].view(1, 16, 2, 64)
    before = LAUNCHES["rwkv_wkv"]
    with pytest.raises(ValueError, match="base address"):
        WKV.rwkv_wkv(odd, k, v, w, u, s0)
    assert LAUNCHES["rwkv_wkv"] == before


@pytest.mark.gpu
def test_cuda_wrappers_check_inputs_on_card(cuda):
    q, k, v = _t(*_attn_inputs(1, 8, 2, 1, 32), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q[..., :16], k[..., :16], v[..., :16])
    with pytest.raises(TypeError):
        FA.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           k, v)
    r, kk, vv, w, u, s0 = _t(*_wkv_inputs(1, 4, 2, 16), device=cuda)
    with pytest.raises(TypeError):
        WKV.rwkv_wkv(r, kk, vv, w.double(), u, s0)
    with pytest.raises(ValueError):
        WKV.rwkv_wkv(r, kk, vv, w, u, s0[:, :1])


@functools.cache
def _owned_cells(geo):
    """Every (row, column) of one (b, h)'s state, in the order the blocks,
    warps and lanes of ``geo`` hold them."""
    return [cell for block in range(geo.blocks_per_head)
            for warp in range(geo.warps) for lane in range(32)
            for cell in geo.cells(block, warp, lane)]


@pytest.mark.parametrize("t", [1, 37, 1024])
@pytest.mark.parametrize("hd", WKV.HEAD_DIMS)
def test_wkv_geometry_owns_each_state_entry_once(hd, t):
    """For every B * H from 1 to 160 (the geometry depends on the product,
    not on T): rows per lane × lanes = hd, every entry of every (b, h)'s
    state, so each of its columns, is held by exactly one lane, and the
    grid is B * H times the blocks of one (b, h)."""
    for bh in range(1, 161):
        geo = WKV.launch_geometry(1, bh, hd, num_sms=132)
        assert geo.rows * geo.lanes == hd
        assert geo.lanes * geo.col_blocks == 32
        assert (geo.rows, geo.cols) in WKV.TILES and geo.cols <= geo.lanes
        assert geo.warps in WKV.WARPS_PER_BLOCK
        assert (geo.warps * geo.col_blocks * geo.cols * geo.blocks_per_head
                == hd)
        assert geo.blocks == bh * geo.blocks_per_head
        cells = _owned_cells(geo)
        assert len(cells) == hd * hd
        assert set(cells) == {(i, j) for i in range(hd) for j in range(hd)}
        assert WKV.launch_geometry(bh, 1, hd, num_sms=132) == geo


@pytest.mark.parametrize("hd", WKV.HEAD_DIMS)
def test_wkv_geometry_past_the_serve_shape(hd):
    """More heads than rwkv6-3b's serve (B·H from 264: batch 7 and up)
    still take a tile of ``TILES`` and own each state entry once."""
    for bh in (264, 320, 1000):
        geo = WKV.launch_geometry(bh, 1, hd, num_sms=132)
        assert (geo.rows, geo.cols) in WKV.TILES
        assert geo.blocks == bh * geo.blocks_per_head
        cells = _owned_cells(geo)
        assert len(cells) == hd * hd
        assert set(cells) == {(i, j) for i in range(hd) for j in range(hd)}


def test_wkv_geometry_at_the_serve_shape():
    """rwkv6-3b (B·H = 160, hd 64) on 132 SMs: 8 × 2 state entries a lane,
    at least 8 warps per SM, the busiest SM within 25 % of the average;
    few heads take the smallest tile, for the most warps."""
    geo = WKV.launch_geometry(4, 40, 64, num_sms=132)
    assert (geo.rows, geo.cols, geo.lanes, geo.warps,
            geo.blocks_per_head) == (8, 2, 8, 4, 2)
    assert geo.blocks * geo.warps >= 8 * 132
    assert -(-geo.blocks // 132) * geo.warps <= 1.25 * (
        geo.blocks * geo.warps / 132)
    assert WKV.launch_geometry(1, 1, 128, num_sms=132)[:2] == (4, 2)
    with pytest.raises(ValueError, match="head dim"):
        WKV.launch_geometry(1, 1, 96, num_sms=132)


def _serve_views(B=2, S=5, H=3, hd=64, dtype=torch.bfloat16):
    """r, k, v, w as the serve path makes them: reshapes of projection
    outputs, and the decay in f32."""
    x = torch.zeros(B, S, 48, dtype=dtype)
    wr = torch.zeros(48, H * hd, dtype=dtype)
    r, k, v = ((x @ wr).reshape(B, S, H, hd) for _ in range(3))
    w = torch.exp(-torch.exp(torch.zeros(B, S, H * hd))).reshape(B, S, H, hd)
    return r, k, v, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", WKV.HEAD_DIMS)
def test_wkv_copy_alignment_accepts_the_serve_path_views(hd, dtype):
    dt = getattr(torch, dtype)
    WKV.check_copy_alignment(*_serve_views(hd=hd, dtype=dt))
    WKV.check_copy_alignment(*_serve_views(S=1, hd=hd, dtype=dt))  # decode
    wide = torch.zeros(2, 5, 3, 2 * hd, dtype=dt)      # a fused projection
    _, k, v, w = _serve_views(hd=hd, dtype=dt)
    WKV.check_copy_alignment(wide[..., :hd], k, v, w)
    WKV.check_copy_alignment(wide[..., hd:], k, v, w)


def test_wkv_copy_alignment_refuses_odd_offsets_and_strides():
    r, k, v, w = _serve_views(B=1, S=16, H=2)
    flat = torch.zeros(1 + 16 * 2 * 64, dtype=torch.bfloat16)
    odd_base = flat[1:].view(1, 16, 2, 64)              # 2-byte offset
    with pytest.raises(ValueError, match="base address"):
        WKV.check_copy_alignment(odd_base, k, v, w)
    wide = torch.zeros(1, 16, 2, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="stride"):     # 136-byte heads
        WKV.check_copy_alignment(r, wide, v, w)
    gapped = torch.zeros(1, 16 * 2 * 64 + 64).as_strided(
        (1, 16, 2, 64), (16 * 130, 130, 64, 1))           # 520-byte steps
    with pytest.raises(ValueError, match="stride 130 in dim 1"):
        WKV.check_copy_alignment(r, k, v, gapped)


def test_build_names_each_library_by_its_source_and_needs_nvcc(monkeypatch):
    """The CUDA libraries are keyed by a hash of source and flags, so only
    a changed source rebuilds; without nvcc the build raises."""
    from repro_torch.kernels import build
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert set(paths) == {"flash_attention", "flash_attention_bwd",
                          "rwkv_wkv", "rwkv_wkv_bwd", "chol_update",
                          "masked_aggregate", "grouped_matmul",
                          "newton_step"}
    for name, path in paths.items():
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").is_file()
        assert build.library_path(name) == path
    monkeypatch.setattr(build, "FLAGS", build.FLAGS + ("-DX",))
    assert build.library_path("rwkv_wkv") != paths["rwkv_wkv"]
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        build.check_launch(9, "rwkv_wkv")


# --------------------------------------------------------------------------
# chol_update: the low-rank Cholesky update
# --------------------------------------------------------------------------

def _chol_inputs(n, r, seed=0, col_major=True):
    rng = np.random.default_rng(seed)
    L = np.linalg.cholesky(np.cov(rng.normal(size=(n, 3 * n)))
                           + np.eye(n)).astype(np.float32)
    V = rng.normal(size=(r, n)).astype(np.float32)
    alpha = rng.normal(size=r).astype(np.float32)
    L = torch.tensor(L)
    return (L.mT.contiguous().mT if col_major else L, torch.tensor(V),
            torch.tensor(alpha))


@pytest.mark.parametrize("n,r", [(1, 1), (7, 3), (40, 8), (33, 11)])
def test_plain_chol_update_is_the_update_and_keeps_the_layout(n, r):
    """The twin is the r rank-1 sweeps in order: the factor of
    L Lᵀ + Σ max(α, 0) v vᵀ, lower, in L's layout; the dispatch takes
    it for CPU tensors."""
    L, V, alpha = _chol_inputs(n, r)
    got = ops.chol_update(L, V, alpha)
    assert got.stride() == L.stride()
    a = torch.clamp_min(alpha, 0.0).double()
    want = L.double() @ L.double().T + (V.double().T * a) @ V.double()
    torch.testing.assert_close(got.double() @ got.double().T, want,
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    one_by_one = L
    for j in range(r):
        one_by_one = ref.chol_rank1_update(one_by_one, V[j], alpha[j])
    assert torch.equal(got, one_by_one)


def test_chol_update_wrapper_rejects_what_the_kernel_does_not_take():
    from repro_torch.kernels import chol_update as CU
    L, V, alpha = _chol_inputs(6, 2)
    with pytest.raises(ValueError, match="CUDA"):
        CU.chol_update(L, V, alpha)
    meta = [t.to("meta") for t in (L, V, alpha)]
    with pytest.raises(ValueError):
        ops.chol_update(*meta)


@pytest.mark.gpu
@pytest.mark.parametrize("n,r", [(1, 1), (7, 3), (127, 4), (129, 4),
                                 (512, 4), (700, 8), (300, 11),
                                 (2048, 4)])
def test_chol_update_kernel_matches_plain_on_card(cuda, n, r):
    """The kernel against the plain loop on the card: the same IEEE
    operations in the same order for every element, so within rtol 1e-5
    of max|L| (and bit-equal where the card rounds as the loop's
    kernels do); one launch per 8 vectors, L's strictly upper part
    carried over, the layout kept.  Row-major L is refused."""
    from repro_torch.kernels import chol_update as CU
    L, V, alpha = (t.to(cuda) for t in _chol_inputs(n, r, seed=n))
    before = LAUNCHES["chol_update"]
    got = CU.chol_update(L, V, alpha)
    assert LAUNCHES["chol_update"] == before + -(-r // CU.MAX_RANK)
    want = ref.chol_update_ref(L, V, alpha)
    torch.cuda.synchronize()
    assert got.stride() == L.stride()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    assert torch.equal(torch.triu(got, 1), torch.triu(L, 1))
    if n > 1:
        with pytest.raises(ValueError, match="column-major"):
            CU.chol_update(L.contiguous(), V, alpha)


def _chol_card(n, r, seed, cuda):
    """``_chol_inputs`` on the card, L's strict upper triangle filled with
    values the update must carry over as they are."""
    L, V, alpha = _chol_inputs(n, r, seed=seed)
    junk = torch.triu(torch.tensor(np.random.default_rng(seed).normal(
        size=(n, n)).astype(np.float32)), 1)
    L = (L + junk).mT.contiguous().mT
    return L.to(cuda), V.to(cuda), alpha.to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 4, 8])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 127, 128, 129, 300, 1000])
def test_chol_update_kernel_is_bit_equal_to_plain_on_card(cuda, n, r):
    """Panels of 32 columns, blocks of 128 rows and the rank wavefront:
    every element goes through the plain loop's IEEE operations in its
    order, so the factor is bit for bit the loop's, in one launch, with
    L's strict upper triangle carried over and the layout kept."""
    from repro_torch.kernels import chol_update as CU
    L, V, alpha = _chol_card(n, r, 7 * n + r, cuda)
    before = LAUNCHES["chol_update"]
    got = CU.chol_update(L, V, alpha)
    assert LAUNCHES["chol_update"] == before + 1
    want = ref.chol_update_ref(L, V, alpha)
    torch.cuda.synchronize()
    assert got.stride() == L.stride()
    assert torch.equal(got, want)
    assert torch.equal(torch.triu(got, 1), torch.triu(L, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2])
def test_chol_update_division_rounds_as_fdiv_rn_on_card(cuda, seed):
    """The kernel's branch-free division (div.rn.f32's fast path) gives
    __fdiv_rn's bits on 2^28 operand pairs over its whole range, signed
    zero numerators among them."""
    from repro_torch.kernels import chol_update as CU
    assert CU.div_check(1 << 28, seed, cuda) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n,r", [(33, 9), (300, 9), (129, 17)])
def test_chol_update_kernel_takes_more_vectors_in_more_launches_on_card(
        cuda, n, r):
    """One launch per 8 vectors, each on the last one's factor:
    bit-equal to the loop over all r."""
    from repro_torch.kernels import chol_update as CU
    L, V, alpha = _chol_card(n, r, n + r, cuda)
    before = LAUNCHES["chol_update"]
    got = CU.chol_update(L, V, alpha)
    assert LAUNCHES["chol_update"] == before + -(-r // CU.MAX_RANK)
    want = ref.chol_update_ref(L, V, alpha)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(torch.triu(got, 1), torch.triu(L, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [32, 200])
def test_chol_update_kernel_skips_zero_and_negative_alpha_on_card(cuda, n):
    """alpha is clamped at 0, and a vector of weight 0 is an exact
    identity (c = 1, s = 0): the update with a zero and a negative alpha
    is bit-equal to the loop and to the update by the other vectors."""
    from repro_torch.kernels import chol_update as CU
    L, V, _ = _chol_card(n, 4, n, cuda)
    alpha = torch.tensor([0.7, 0.0, -1.3, 2.0], device=cuda)
    got = CU.chol_update(L, V, alpha)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.chol_update_ref(L, V, alpha))
    keep = torch.tensor([0, 3], device=cuda)
    assert torch.equal(got, CU.chol_update(L, V[keep].contiguous(),
                                           alpha[keep].contiguous()))


# --------------------------------------------------------------------------
# hierarchical pod rounds: K1/K2 on B·P rows of N/P workers
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("rows,n_pod,d", [(2, 16, 8192), (4, 8, 4096),
                                          (32, 8, 4096), (6, 3, 513)])
def test_kernels_at_pod_row_shapes_on_card(cuda, rows, n_pod, d):
    """K1/K2 at the hierarchical rounds' shapes (the main paths' pods and
    8 seeds of 4 pods): C′ bit-equal to the plain version, ḡ and x′
    within rtol 1e-5, one launch each."""
    g, m, c, x, h = _t(*_batched_inputs(rows, n_pod, d, "random"),
                       device=cuda)
    before = dict(LAUNCHES)
    got, want = K.region_aggregate(g, m, c), ref.region_aggregate_ref(g, m, c)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], want[1])
    got = K.ranl_update(x, h, g, m, c, mu=MU, lr=LR)
    want = ref.ranl_update_ref(x, h, g, m, c, mu=MU, lr=LR)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], want[1])
    assert LAUNCHES["region_aggregate"] == before["region_aggregate"] + 1
    assert LAUNCHES["ranl_update"] == before["ranl_update"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("curvature,spec", [
    ("dense", "pods=2,period=3"),
    ("diag", "pods=4,period=2,gamma=0.5,compression=int8")])
def test_hierarchical_run_on_card_matches_host(cuda, curvature, spec):
    """A hierarchical run on the card: one kernel launch a round for all
    pods, the host run's integer traces, pod_bytes and clock, and pod
    iterates within 1e-4·max|x| (5e-2 under the int8 exchange, one
    quantization step)."""
    import dataclasses

    import repro_torch
    from repro_torch import prng
    if curvature == "dense":
        host = repro_torch.make_quadratic(prng.PRNGKey(0), num_workers=8,
                                          dim=48, kappa=50.0, coupling=0.0,
                                          num_regions=6, grad_noise=0.1,
                                          device="cpu")
    else:
        host = repro_torch.make_logistic(prng.PRNGKey(0), num_workers=8,
                                         per_worker=64, dim=48,
                                         device="cpu")
    card = dataclasses.replace(host, **{
        f.name: getattr(host, f.name).to(cuda)
        for f in dataclasses.fields(host)
        if isinstance(getattr(host, f.name), torch.Tensor)})
    kw = dict(num_rounds=6, num_regions=6, curvature=curvature,
              hierarchy=spec)
    name = "region_aggregate" if curvature == "dense" else "ranl_update"
    before = LAUNCHES[name]
    got = repro_torch.run(card, prng.PRNGKey(1), **kw)
    assert LAUNCHES[name] == before + 6
    want = repro_torch.run(host, prng.PRNGKey(1), device="cpu", **kw)
    for f in ("coverage", "comm_floats", "pod_bytes", "round_time"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    tol = 5e-2 if "int8" in spec else 1e-4
    scale = float(want.xs_pods.abs().max())
    assert float((got.xs_pods.cpu() - want.xs_pods).abs().max()) <= \
        tol * scale


# --------------------------------------------------------------------------
# the 1-D sharded engine on the card: NCCL at world size 1, and two ranks
# on the one card over gloo (NCCL refuses two ranks on one GPU)
# --------------------------------------------------------------------------

def _on_card_problem(curvature, device):
    import repro_torch
    from repro_torch import prng
    if curvature == "dense":
        return repro_torch.make_quadratic(prng.PRNGKey(0), num_workers=8,
                                          dim=48, kappa=50.0, coupling=0.0,
                                          num_regions=6, grad_noise=0.1,
                                          device=device)
    return repro_torch.make_logistic(prng.PRNGKey(0), num_workers=8,
                                     per_worker=64, dim=48, device=device)


def _sharded_like_scan(sh, scan, tol):
    """Integer traces, clock and pod bytes equal; x¹ bit-equal (the same
    init); x² … x^T within ``tol`` x max |x|."""
    for f in ("coverage", "comm_floats", "comm_bytes", "max_stale",
              "round_time", "pod_bytes"):
        assert torch.equal(getattr(sh, f).cpu(), getattr(scan, f).cpu()), f
    assert (sh.tau_star, sh.tau_covered) == (scan.tau_star,
                                             scan.tau_covered)
    a, b = ((sh.xs_pods, scan.xs_pods) if scan.xs_pods is not None
            else (sh.xs, scan.xs))
    a, b = a.cpu(), b.cpu()
    assert torch.equal(a[1], b[1])
    assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("curvature", ["dense", "diag"])
def test_sharded_engine_on_nccl_at_world_size_one(cuda, tmp_path,
                                                  monkeypatch, curvature):
    """engine="sharded" on a ("data",) mesh of one card over NCCL: the
    scan run's traces, xs within 2e-5·max|x|, no kernel launched, the
    overlapped loop bit-equal, the log within the contract."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch
    from repro_torch import prng
    from repro_torch.analysis import check_log, engine_contract
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        p = _on_card_problem(curvature, cuda)
        opts = repro_torch.RanlOptions(num_rounds=6, num_regions=6,
                                       curvature=curvature)
        before = dict(LAUNCHES)
        sh = repro_torch.run(p, prng.PRNGKey(1), engine="sharded",
                             mesh=mesh, options=opts)
        assert LAUNCHES == before
        ov = repro_torch.run(p, prng.PRNGKey(1), engine="sharded",
                             mesh=mesh, options=opts, overlap=True)
        assert torch.equal(ov.xs, sh.xs)
        _sharded_like_scan(sh, repro_torch.run(p, prng.PRNGKey(1),
                                               options=opts), 2e-5)
        rep = check_log(engine_contract("sharded", opts, dim=48),
                        sh.collectives)
        assert rep["ok"], rep["violations"]
    finally:
        dist.destroy_process_group()


_TWO_RANKS = """
import dataclasses, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
import repro_torch as rt
from repro_torch import prng
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
p = rt.make_logistic(prng.PRNGKey(0), num_workers=8, per_worker=64, dim=48,
                     device="cuda")
res = {}
for label, shape, dims, spec in (
        ("flat", (2,), ("data",), None),
        ("hier", (2, 1), ("pod", "data"), "pods=2,period=3,compression=int8")):
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=dims)
    r = rt.run(p, prng.PRNGKey(1), engine="sharded", mesh=mesh,
               curvature="diag", num_rounds=6, num_regions=6, hierarchy=spec)
    res[label] = dataclasses.replace(r, **{
        f.name: getattr(r, f.name).cpu() for f in dataclasses.fields(r)
        if isinstance(getattr(r, f.name), torch.Tensor)})
torch.save(res, f"{out}.{rank}")
dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_sharded_engine_two_ranks_on_one_card_over_gloo(cuda, tmp_path):
    """Two processes on the one card, gloo carrying CUDA tensors: diag on
    ("data",) = 2 and with an int8 pod exchange on ("pod", "data") =
    (2, 1); both ranks return the same result, equal to the scan run on
    the card within 2e-5·max|x| (5e-2 under the int8 exchange, one
    quantization step)."""
    import os
    import subprocess
    import sys

    import repro_torch
    from repro_torch import prng
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "ranks.py"
    script.write_text(_TWO_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path / "store"), str(tmp_path / "out")],
                              env=env, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    got = [torch.load(f"{tmp_path / 'out'}.{r}", weights_only=False)
           for r in (0, 1)]
    p = _on_card_problem("diag", cuda)
    for label, spec, tol in (("flat", None, 2e-5),
                             ("hier", "pods=2,period=3,compression=int8",
                              5e-2)):
        assert torch.equal(got[0][label].xs, got[1][label].xs)
        scan = repro_torch.run(p, prng.PRNGKey(1), curvature="diag",
                               num_rounds=6, num_regions=6, hierarchy=spec)
        _sharded_like_scan(got[0][label], scan, tol)
