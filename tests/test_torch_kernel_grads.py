"""Gradients through K3 (flash attention) and K4 (the RWKV-6 wkv
recurrence): the plain backwards (``ref.flash_attention_bwd_ref``,
``ref.rwkv_wkv_bwd_ref``) against torch autograd of the plain forwards
and against ``jax.vjp`` of the reference's oracles, of its blocked
attention and of its checkpointed wkv scan; the ``autograd.Function``
wiring of ``ops.flash_attention`` / ``ops.rwkv_wkv`` on the CPU; the
backward wrappers' input checks; and, on a card, the backward kernels
against the plain backwards.

Inputs come from numpy with a fixed seed.  Tolerances, each gradient
against max |grad| of the one it is held to: f32, 1e-5 (the same sums
in another order); bf16 inputs, ``BF16_STEP``, one bf16 step (8
significant bits), since a gradient has its input's type and two f32
sums that round apart may land one step apart.  The reference is
imported inside a fixture, so this file runs on a host without JAX (its
card tests need none)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rwkv_wkv as WKV  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

F32_TOL = 1e-5
BF16_STEP = 2.0 ** -8
# K3 with bf16 inputs: D = rowsum(dO ⊙ O) reads O as stored, rounded to
# bf16, where autograd's softmax backward sums the unrounded f32 O; dS =
# P ⊙ (dP − D) carries that step into dq and dk where dP nearly cancels
# D.  The forward's bf16 tolerance (tests/test_torch_kernels.py).
K3_BF16_TOL = 2e-2


@pytest.fixture
def jax_ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.models.attention import blocked_attention
    from repro.models.rwkv import _wkv_scan
    return jax, jnp, jref, blocked_attention, _wkv_scan


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _np(t):
    return t.float().numpy()


# --------------------------------------------------------------------------
# K4: the wkv recurrence
# --------------------------------------------------------------------------

def _wkv_arrays(b, s, h, hd, *, state=True, ds=True, w="mid", seed=0):
    """r, k, v, w, u, state, dy, ds as f32 numpy arrays.  w is the Finch
    decay exp(-exp(z)): "mid" spreads it over (0.2, 0.9), "near0" puts it
    at 1e-6 .. 1e-2, "near1" at 1 - 1e-5 .. 1 - 1e-3."""
    rng = np.random.default_rng(seed + 1000 * s + hd)
    r, k, v = (rng.normal(size=(b, s, h, hd)) for _ in range(3))
    z = rng.uniform(size=(b, s, h, hd))
    wv = {"mid": 0.2 + 0.7 * z, "near0": 10.0 ** (-6 + 4 * z),
          "near1": 1 - 10.0 ** (-5 + 2 * z)}[w]
    u = 0.5 * rng.normal(size=(h, hd))
    s0 = 0.1 * rng.normal(size=(b, h, hd, hd)) * state
    dy = rng.normal(size=(b, s, h, hd))
    dS = rng.normal(size=(b, h, hd, hd)) * ds
    return [a.astype(np.float32) for a in (r, k, v, wv, u, s0, dy, dS)]


def _wkv_torch(arrays, dtype=torch.float32):
    """The arrays as K4 takes them: r, k, v, u in ``dtype``, the rest
    f32."""
    t = [torch.tensor(a) for a in arrays]
    for i in (0, 1, 2, 4):
        t[i] = t[i].to(dtype)
    return t


def _wkv_autograd(inputs, dy, ds):
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    y, sf = ref.rwkv_wkv_ref(*leaves)
    return torch.autograd.grad((y, sf), leaves, (dy, ds))


WKV_CASES = {
    "S128_hd16": dict(b=2, s=128, h=2, hd=16),
    "S192_hd64": dict(b=1, s=192, h=2, hd=64),
    "S192_hd64_zero_state": dict(b=1, s=192, h=2, hd=64, state=False),
    "S128_hd16_zero_ds": dict(b=2, s=128, h=2, hd=16, ds=False),
    "S128_zero_state_and_ds": dict(b=1, s=128, h=3, hd=16, state=False,
                                   ds=False),
    "S130_w_near0": dict(b=2, s=130, h=2, hd=16, w="near0"),
    "S130_w_near1": dict(b=2, s=130, h=2, hd=16, w="near1"),
    "S1": dict(b=2, s=1, h=3, hd=64),
    "S37_ragged": dict(b=2, s=37, h=2, hd=16),
    "S100_ragged_hd64": dict(b=1, s=100, h=1, hd=64, w="near1"),
}


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_plain_wkv_backward_equals_autograd(case):
    arrays = _wkv_arrays(**WKV_CASES[case])
    *inputs, dy, ds = _wkv_torch(arrays)
    got = ref.rwkv_wkv_bwd_ref(*inputs, dy, ds)
    want = _wkv_autograd(inputs, dy, ds)
    for name, g, w in zip("r k v w u state".split(), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(_np(g), _np(w), F32_TOL, name)


@pytest.mark.parametrize("case", ["S128_hd16", "S130_w_near0", "S1"])
def test_plain_wkv_backward_takes_bf16_inputs(case):
    """r, k, v, u in bf16 (the serve type): the gradients come out in
    bf16, the f32 sums rounded once, as autograd's do."""
    arrays = _wkv_arrays(**WKV_CASES[case])
    *inputs, dy, ds = _wkv_torch(arrays, torch.bfloat16)
    got = ref.rwkv_wkv_bwd_ref(*inputs, dy, ds)
    want = _wkv_autograd(inputs, dy, ds)
    for name, g, w in zip("r k v w u state".split(), got, want):
        assert g.dtype == w.dtype
        _close(_np(g), _np(w), BF16_STEP, name)


@pytest.mark.parametrize("oracle", ["ref", "scan"])
@pytest.mark.parametrize("case", ["S128_hd16", "S192_hd64",
                                  "S192_hd64_zero_state", "S128_hd16_zero_ds",
                                  "S130_w_near0", "S130_w_near1", "S1",
                                  "S37_ragged"])
def test_plain_wkv_backward_equals_reference_vjp(jax_ref, case, oracle):
    """Against jax.vjp of the reference's oracle (a plain scan) and of
    ``_wkv_scan`` (checkpointed chunks of 64 steps where S is a multiple
    of 64 above 64: S = 128 and 192)."""
    jax, jnp, jref, _, wkv_scan = jax_ref
    arrays = _wkv_arrays(**WKV_CASES[case])
    *inputs, dy, ds = arrays
    fn = jref.rwkv_wkv_ref if oracle == "ref" else wkv_scan
    _, vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = ref.rwkv_wkv_bwd_ref(*map(torch.tensor, arrays))
    for name, g, w in zip("r k v w u state".split(), got, want):
        _close(_np(g), np.asarray(w), F32_TOL, name)


def test_plain_wkv_backward_equals_reference_vjp_in_bf16(jax_ref):
    """r, k, v, u in bf16.  The reference's scan carries the cotangent of
    u, a bf16 constant of its body, in bf16 from step to step, so its du
    rounds once a step; du is held to the vjp with u widened to f32 (the
    same bf16 values), the rest to the all-bf16 vjp."""
    jax, jnp, _, _, wkv_scan = jax_ref
    arrays = _wkv_arrays(2, 128, 2, 16)
    *inputs, dy, ds = arrays
    jin = [jnp.asarray(a) for a in inputs]
    for i in (0, 1, 2, 4):
        jin[i] = jin[i].astype(jnp.bfloat16)
    cts = (jnp.asarray(dy), jnp.asarray(ds))
    want = list(jax.vjp(wkv_scan, *jin)[1](cts))
    wide = jin[:4] + [jin[4].astype(jnp.float32)] + jin[5:]
    want[4] = jax.vjp(wkv_scan, *wide)[1](cts)[4].astype(jnp.bfloat16)
    got = ref.rwkv_wkv_bwd_ref(*_wkv_torch(inputs, torch.bfloat16),
                               torch.tensor(dy), torch.tensor(ds))
    for name, g, w in zip("r k v w u state".split(), got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        _close(_np(g), np.asarray(w, np.float32), BF16_STEP, name)


def test_plain_wkv_backward_keeps_states_at_checkpoints_only():
    """The plain backward rebuilds S_t from a checkpoint every ``chunk``
    steps: at most S / chunk + chunk states are alive, never one a step,
    and the chunk length does not change the gradients beyond rounding."""
    arrays = _wkv_arrays(1, 150, 2, 16)
    t = [torch.tensor(a) for a in arrays]
    base = ref.rwkv_wkv_bwd_ref(*t)
    for chunk in (1, 7, 64, 150, 256):
        got = ref.rwkv_wkv_bwd_ref(*t, chunk=chunk)
        for g, w in zip(got, base):
            _close(_np(g), _np(w), F32_TOL)


# --------------------------------------------------------------------------
# K3: flash attention
# --------------------------------------------------------------------------

def _attn_arrays(b, s, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed + 100 * s + hd + h)
    q = rng.normal(size=(b, s, h, hd))
    k = rng.normal(size=(b, s, kv, hd))
    v = rng.normal(size=(b, s, kv, hd))
    do = rng.normal(size=(b, s, h, hd))
    return [a.astype(np.float32) for a in (q, k, v, do)]


# (b, s, h, kv, hd, window, causal)
ATTN_CASES = {
    "mha_hd32": (2, 7, 2, 2, 32, 0, True),
    "gqa3_hd128": (1, 130, 3, 1, 128, 0, True),
    "gqa4_hd64": (2, 130, 8, 2, 64, 0, True),
    "gqa3_window": (1, 130, 6, 2, 64, 17, True),
    "mha_window_hd128": (1, 70, 2, 2, 128, 5, True),
    "S1": (2, 1, 4, 1, 32, 0, True),
    "S1_window": (1, 1, 3, 3, 64, 4, True),
    "noncausal": (1, 33, 4, 1, 32, 0, False),
    "noncausal_window": (1, 40, 6, 2, 32, 9, False),
}


def _attn_torch(arrays, dtype=torch.float32):
    return [torch.tensor(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_plain_attention_backward_equals_autograd(case, dtype):
    b, s, h, kv, hd, win, causal = ATTN_CASES[case]
    q, k, v, do = _attn_torch(_attn_arrays(b, s, h, kv, hd),
                              getattr(torch, dtype))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o = ref.flash_attention_ref(*leaves, causal=causal, window=win)
    want = torch.autograd.grad(o, leaves, do)
    got = ref.flash_attention_bwd_ref(q, k, v, o.detach(), do,
                                      causal=causal, window=win)
    tol = F32_TOL if dtype == "float32" else K3_BF16_TOL
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(_np(g), _np(w), tol, name)


@pytest.mark.parametrize("oracle", ["ref", "blocked"])
@pytest.mark.parametrize("case", ["mha_hd32", "gqa3_hd128", "gqa4_hd64",
                                  "gqa3_window", "S1", "S1_window"])
def test_plain_attention_backward_equals_reference_vjp(jax_ref, case,
                                                       oracle):
    """Against jax.vjp of the reference's oracle (kv repeated to H width,
    full scores) and of ``blocked_attention`` (grouped, online softmax,
    64-row chunks, positions = arange)."""
    jax, jnp, jref, blocked, _ = jax_ref
    b, s, h, kv, hd, win, causal = ATTN_CASES[case]
    q, k, v, do = _attn_arrays(b, s, h, kv, hd)
    if oracle == "ref":
        def fn(q, k, v):
            return jref.flash_attention_ref(q, k, v, causal=causal,
                                            window=win)
    else:
        pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))

        def fn(q, k, v):
            return blocked(q, k, v, pos, pos, window=win, q_chunk=64,
                           kv_chunk=64, static_positions=True)
    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return o, vjp(do)
    o, want = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    got = ref.flash_attention_bwd_ref(
        *map(torch.tensor, (q, k, v, np.asarray(o), do)), causal=causal,
        window=win)
    for name, g, w in zip("qkv", got, want):
        _close(_np(g), np.asarray(w), F32_TOL, name)


def test_plain_attention_backward_equals_reference_vjp_in_bf16(jax_ref):
    jax, jnp, jref, _, _ = jax_ref
    q, k, v, do = _attn_arrays(1, 130, 6, 2, 64)
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do)]
    o, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=True, window=0), *jin[:3])
    want = vjp(jin[3])
    tin = _attn_torch((q, k, v, do), torch.bfloat16)
    got = ref.flash_attention_bwd_ref(
        *tin[:3], torch.tensor(np.asarray(o, np.float32)).to(torch.bfloat16),
        tin[3], causal=True, window=0)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        _close(_np(g), np.asarray(w, np.float32), K3_BF16_TOL, name)


# --------------------------------------------------------------------------
# K3's log-sum-exp, kept from the forward for the backward
# --------------------------------------------------------------------------

def _np_lse(q, k, causal, win):
    """Each row's log-sum-exp of its masked scaled scores, in float64
    numpy: (b, h, s)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    kr = np.repeat(k.astype(np.float64), h // kv, axis=2)
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) / np.sqrt(hd)
    qpos, kpos = np.arange(s)[:, None], np.arange(s)[None, :]
    valid = np.ones((s, s), bool)
    if causal:
        valid &= kpos <= qpos
    if win:
        valid &= kpos > qpos - win
    sc = np.where(valid, sc, -np.inf)
    m = sc.max(axis=-1, keepdims=True)
    return (m + np.log(np.exp(sc - m).sum(axis=-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("case", ["mha_hd32", "gqa3_hd128", "gqa3_window",
                                  "S1", "S1_window", "noncausal_window"])
def test_plain_forward_lse_equals_numpy_logsumexp(case):
    b, s, h, kv, hd, win, causal = ATTN_CASES[case]
    q, k, v, _ = _attn_arrays(b, s, h, kv, hd)
    out, lse = ref.flash_attention_ref(*_attn_torch((q, k, v)),
                                       causal=causal, window=win,
                                       return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    torch.testing.assert_close(out, ref.flash_attention_ref(
        *_attn_torch((q, k, v)), causal=causal, window=win))
    np.testing.assert_allclose(_np(lse), _np_lse(q, k, causal, win),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["gqa4_hd64", "gqa3_window", "S1",
                                  "noncausal"])
def test_plain_backward_takes_the_forward_lse(case, dtype):
    """The gradients from the forward's L equal those from L recomputed."""
    b, s, h, kv, hd, win, causal = ATTN_CASES[case]
    q, k, v, do = _attn_torch(_attn_arrays(b, s, h, kv, hd),
                              getattr(torch, dtype))
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=win,
                                     return_lse=True)
    got = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                      window=win, lse=lse)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       window=win)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _close(_np(g), _np(w), F32_TOL)


def test_attention_function_saves_the_forward_lse(monkeypatch):
    """ops' backward hands the forward's L to the backward."""
    seen = {}
    plain = ref.flash_attention_bwd_ref

    def spy(*args, **kw):
        seen["lse"] = kw.get("lse")
        return plain(*args, **kw)
    monkeypatch.setattr(ref, "flash_attention_bwd_ref", spy)
    leaves, do = _attn_leaves()
    out = ops.flash_attention(*leaves)
    torch.autograd.grad(out, leaves, do)
    _, want = ref.flash_attention_ref(*(t.detach() for t in leaves),
                                      return_lse=True)
    assert seen["lse"] is not None
    torch.testing.assert_close(seen["lse"], want, rtol=0, atol=0)


# --------------------------------------------------------------------------
# K3's backward: its two bodies, routed as the forward routes them
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,hd,body", [
    ("float32", 32, "simt"), ("float32", 64, "simt"),
    ("float32", 128, "simt"), ("bfloat16", 32, "simt"),
    ("bfloat16", 64, "tc"), ("bfloat16", 128, "tc")])
def test_backward_route_and_its_entry(dtype, hd, body):
    """The backward takes the forward's route, and the source defines the
    entry that route binds."""
    from repro_torch.kernels import build
    assert FA.route(getattr(torch, dtype), hd) == body
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert f'extern "C" int {FA.BWD_ENTRIES[body]}(' in src


def test_backward_tma_checks_refuse_misaligned_q_and_repack_do():
    """On the tc route q, k, v must suit TMA (the forward's check, which
    raises); do, an incoming gradient, is repacked when TMA cannot read
    it."""
    flat = torch.zeros(1 + 16 * 2 * 64, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 16, 2, 64)
    ok = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="base address"):
        FA.check_tma_alignment(odd, ok, ok)
    assert FA._tma_aligned(ok) and not FA._tma_aligned(odd)
    wide = torch.zeros(1, 16, 2, 68, dtype=torch.bfloat16)[..., :64]
    assert not FA._tma_aligned(wide)
    assert FA._tma_aligned(wide.clone(memory_format=torch.contiguous_format))


def test_backward_wrapper_checks_lse_on_meta_tensors():
    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")
    q, k, v = meta(2, 8, 4, 32), meta(2, 8, 2, 32), meta(2, 8, 2, 32)
    o, do = meta(2, 8, 4, 32), meta(2, 8, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd(q, k, v, o, do, lse=meta(2, 4, 8))
    with pytest.raises(ValueError, match="lse must be"):
        FA.flash_attention_bwd(q, k, v, o, do, lse=meta(2, 8, 4))
    with pytest.raises(ValueError, match="lse must be"):
        FA.flash_attention_bwd(q, k, v, o, do,
                               lse=meta(2, 4, 8, dtype=torch.bfloat16))


# --------------------------------------------------------------------------
# the autograd.Functions on the CPU
# --------------------------------------------------------------------------

def _attn_leaves(need=(True, True, True), dtype=torch.float32):
    q, k, v, do = _attn_torch(_attn_arrays(2, 37, 6, 2, 32), dtype)
    return [t.requires_grad_(n) for t, n in zip((q, k, v), need)], do


def _wkv_leaves(need=(True,) * 6):
    *inputs, dy, ds = _wkv_torch(_wkv_arrays(2, 70, 3, 16))
    return [t.requires_grad_(n) for t, n in zip(inputs, need)], dy, ds


@pytest.mark.parametrize("need", [(True, False, False), (False, True, False),
                                  (False, False, True), (True, True, True)],
                         ids=str)
def test_attention_function_returns_only_the_grads_asked_for(need):
    leaves, do = _attn_leaves(need)
    out = ops.flash_attention(*leaves, causal=True, window=5)
    assert out.grad_fn is not None
    (out * do).sum().backward()
    want = ref.flash_attention_bwd_ref(*[t.detach() for t in leaves],
                                       out.detach(), do, causal=True,
                                       window=5)
    for t, n, w in zip(leaves, need, want):
        if n:
            assert torch.equal(t.grad, w)
        else:
            assert t.grad is None


@pytest.mark.parametrize("which", [0, 1, 3, 4, 5])
def test_wkv_function_returns_only_the_grads_asked_for(which):
    need = tuple(i == which for i in range(6))
    leaves, dy, ds = _wkv_leaves(need)
    y, sf = ops.rwkv_wkv(*leaves)
    ((y * dy).sum() + (sf * ds).sum()).backward()
    want = ref.rwkv_wkv_bwd_ref(*[t.detach() for t in leaves], dy, ds)
    for t, n, w in zip(leaves, need, want):
        if n:
            assert torch.equal(t.grad, w)
        else:
            assert t.grad is None


@pytest.mark.parametrize("used", ["y", "state"])
def test_wkv_function_takes_an_unused_output_as_zero(used):
    """One of the two outputs does not reach the loss: its gradient is
    zero, and the result equals autograd through the plain forward."""
    leaves, dy, ds = _wkv_leaves()
    y, sf = ops.rwkv_wkv(*leaves)
    loss = (y * dy).sum() if used == "y" else (sf * ds).sum()
    got = torch.autograd.grad(loss, leaves)
    plain = [t.detach().requires_grad_(True) for t in leaves]
    y2, sf2 = ref.rwkv_wkv_ref(*plain)
    want = torch.autograd.grad((y2 * dy).sum() if used == "y"
                               else (sf2 * ds).sum(), plain,
                               allow_unused=True)
    for g, w, p in zip(got, want, plain):
        _close(_np(g), _np(torch.zeros_like(p) if w is None else w),
               F32_TOL)


def test_functions_record_no_graph_when_nothing_needs_grad():
    leaves, _ = _attn_leaves((False, False, False))
    assert ops.flash_attention(*leaves).grad_fn is None
    leaves, _ = _attn_leaves()
    with torch.no_grad():
        assert ops.flash_attention(*leaves).grad_fn is None
    wl, _, _ = _wkv_leaves((False,) * 6)
    assert all(o.grad_fn is None for o in ops.rwkv_wkv(*wl))
    wl, _, _ = _wkv_leaves()
    with torch.no_grad():
        assert all(o.grad_fn is None for o in ops.rwkv_wkv(*wl))


def test_functions_forward_equals_the_plain_forward():
    """With grad on, the CPU forward is the plain forward's bits."""
    leaves, _ = _attn_leaves()
    plain = [t.detach() for t in leaves]
    assert torch.equal(ops.flash_attention(*leaves, window=3).detach(),
                       ref.flash_attention_ref(*plain, window=3))
    wl, _, _ = _wkv_leaves()
    got = ops.rwkv_wkv(*wl)
    want = ref.rwkv_wkv_ref(*[t.detach() for t in wl])
    assert all(torch.equal(a.detach(), b) for a, b in zip(got, want))


def test_two_backward_calls_are_bit_equal():
    leaves, do = _attn_leaves()
    out = ops.flash_attention(*leaves)
    a = torch.autograd.grad(out, leaves, do, retain_graph=True)
    b = torch.autograd.grad(out, leaves, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    wl, dy, ds = _wkv_leaves()
    y, sf = ops.rwkv_wkv(*wl)
    a = torch.autograd.grad((y, sf), wl, (dy, ds), retain_graph=True)
    b = torch.autograd.grad((y, sf), wl, (dy, ds))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["flash_attention", "rwkv_wkv"])
def test_cpu_gradients_launch_nothing(name):
    before = dict(LAUNCHES)
    if name == "flash_attention":
        leaves, do = _attn_leaves()
        (ops.flash_attention(*leaves) * do).sum().backward()
    else:
        leaves, dy, _ = _wkv_leaves()
        (ops.rwkv_wkv(*leaves)[0] * dy).sum().backward()
    assert dict(LAUNCHES) == before
    assert all(t.grad is not None for t in leaves)


# --------------------------------------------------------------------------
# the backward wrappers' input checks (no card needed)
# --------------------------------------------------------------------------

def test_backward_wrappers_reject_host_tensors():
    leaves, do = _attn_leaves((False,) * 3)
    o = ref.flash_attention_ref(*leaves)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd(*leaves, o, do)
    wl, dy, ds = _wkv_leaves((False,) * 6)
    with pytest.raises(ValueError, match="CUDA"):
        WKV.rwkv_wkv_bwd(*wl, dy, ds)


def test_backward_wrappers_check_their_own_inputs_on_meta_tensors():
    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")
    q, k, v = meta(2, 8, 4, 32), meta(2, 8, 2, 32), meta(2, 8, 2, 32)
    with pytest.raises(ValueError, match="o must have q's shape"):
        FA.flash_attention_bwd(q, k, v, meta(2, 8, 4, 16), meta(2, 8, 4, 32))
    with pytest.raises(TypeError, match="do is torch.bfloat16"):
        FA.flash_attention_bwd(q, k, v, meta(2, 8, 4, 32),
                               meta(2, 8, 4, 32, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd(q, k, v, meta(2, 8, 4, 32), meta(2, 8, 4, 32))
    r = meta(1, 5, 2, 16)
    rest = (meta(1, 5, 2, 16), meta(1, 5, 2, 16), meta(1, 5, 2, 16),
            meta(2, 16), meta(1, 2, 16, 16))
    with pytest.raises(ValueError, match="dy must have shape"):
        WKV.rwkv_wkv_bwd(r, *rest, meta(1, 4, 2, 16), meta(1, 2, 16, 16))
    with pytest.raises(TypeError, match="ds must be float32"):
        WKV.rwkv_wkv_bwd(r, *rest, meta(1, 5, 2, 16),
                         meta(1, 2, 16, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        WKV.rwkv_wkv_bwd(r, *rest, meta(1, 5, 2, 16), meta(1, 2, 16, 16))


def test_functions_refuse_meta_tensors():
    q, k, v = (torch.empty(1, 4, 2, 32, device="meta", requires_grad=True)
               for _ in range(3))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.flash_attention(q, k, v)


# --------------------------------------------------------------------------
# K4's backward: its launch geometry (``wkv_bwd_geometry``)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_wkv_bwd_geometry_owns_each_state_row_once(hd, dtype):
    """The cluster size divides hd, and its blocks' rows cover each state
    row (and each dv column) exactly once; a block's lanes hold whole rows
    in whole warps."""
    geo = WKV.wkv_bwd_geometry(hd, dtype)
    assert hd % geo.cluster == 0 and 1 <= geo.cluster <= WKV.BWD_MAX_CLUSTER
    owned = [i for g in range(geo.cluster) for i in geo.rows_of(g)]
    assert sorted(owned) == list(range(hd))
    assert geo.lanes * geo.cols == hd and 4 <= geo.lanes <= 32
    assert geo.cols % 4 == 0
    assert geo.threads == geo.rows * geo.lanes and geo.threads % 32 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_wkv_bwd_geometry_fits_a_chunk_in_shared_memory(hd, dtype):
    """A chunk's states of a block's rows fit the shared memory the
    geometry reserves, beside three ring slots of the chunk's inputs and
    the dv sums; the block fits the card's 227 KB, and at hd 64 three
    blocks fit an SM (the train shape's 320 blocks in one wave on 132
    SMs)."""
    geo = WKV.wkv_bwd_geometry(hd, dtype)
    es = 2 if dtype == torch.bfloat16 else 4
    states = geo.chunk * geo.rows * hd * 4
    assert states <= WKV.BWD_STATE_BYTES
    inputs = 3 * geo.chunk * (hd * (4 + es) + geo.rows * (4 + 2 * es))
    assert geo.smem >= states + inputs
    assert geo.smem <= 232448
    assert geo.chunk & (geo.chunk - 1) == 0
    if hd == 64:
        assert (geo.cluster, geo.rows, geo.chunk) == (4, 16, 8)
        assert 3 * (geo.smem + 1024) <= 233472
        assert 3 * 132 >= 2 * 40 * geo.cluster


@pytest.mark.parametrize("s", [1, 8, 9, 200])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_wkv_bwd_scratch_has_the_kernel_shape(hd, s):
    """The checkpoints the wrapper allocates: one state every chunk
    steps, (B, H, ceil(S / chunk), hd, hd) f32, and du's (B, H, hd)."""
    geo = WKV.wkv_bwd_geometry(hd, torch.float32)
    ckpt, du_part = WKV.bwd_scratch(geo, 2, s, 3, "meta")
    assert tuple(ckpt.shape) == (2, 3, -(-s // geo.chunk), hd, hd)
    assert ckpt.dtype == du_part.dtype == torch.float32
    assert tuple(du_part.shape) == (2, 3, hd)


def test_wkv_bwd_geometry_refuses_what_no_instance_takes():
    with pytest.raises(ValueError, match="head dim"):
        WKV.wkv_bwd_geometry(96, torch.float32)
    with pytest.raises(TypeError):
        WKV.wkv_bwd_geometry(64, torch.float16)


# --------------------------------------------------------------------------
# on a card: the backward kernels against the plain backwards
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, K3_BF16_TOL)])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_backward_kernel_equals_plain_on_card(cuda, case, dtype,
                                                        tol):
    b, s, h, kv, hd, win, causal = ATTN_CASES[case]
    q, k, v, do = (t.to(cuda) for t in _attn_torch(
        _attn_arrays(b, s, h, kv, hd), dtype))
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=win)
    before = LAUNCHES["flash_attention_bwd"]
    got = FA.flash_attention_bwd(q, k, v, o, do, causal=causal, window=win)
    again = FA.flash_attention_bwd(q, k, v, o, do, causal=causal, window=win)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       window=win)
    # where a row sees one key (S = 1), dS = P (dP − D) is zero but for
    # the rounding of dP and D, each summed in its own order: dq and dk
    # are held at the scale of the call's largest gradient (dv = dO there)
    scale = max(float(w.float().abs().max()) for w in want)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and g.dtype == w.dtype
        np.testing.assert_allclose(_np(g.cpu()), _np(w.cpu()), rtol=tol,
                                   atol=tol * scale)


# (b, s, h, kv, hd, window): ragged S, GQA 3 and 4, a window
TC_BWD_CASES = {
    "hd64_S130_gqa3": (1, 130, 3, 1, 64, 0),
    "hd128_S70_gqa4": (2, 70, 4, 1, 128, 0),
    "hd128_S130_gqa3_window": (1, 130, 6, 2, 128, 17),
    "hd64_S70_gqa4_window": (2, 70, 8, 2, 64, 5),
    "hd128_S1": (2, 1, 4, 1, 128, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(TC_BWD_CASES))
def test_tc_backward_with_the_forward_lse_on_card(cuda, case):
    """The tensor-core backward (bf16, hd 64/128) from the forward kernel's
    output and L against the plain backward; two calls bit-equal; the
    forward's L against the plain L."""
    b, s, h, kv, hd, win = TC_BWD_CASES[case]
    q, k, v, do = (t.to(cuda) for t in _attn_torch(
        _attn_arrays(b, s, h, kv, hd), torch.bfloat16))
    assert FA.route(q.dtype, hd) == "tc"
    o, lse = FA.flash_attention(q, k, v, window=win, return_lse=True)
    _, lse_plain = ref.flash_attention_ref(q, k, v, window=win,
                                           return_lse=True)
    torch.testing.assert_close(lse, lse_plain, rtol=0, atol=2e-2)
    before = LAUNCHES["flash_attention_bwd"]
    got = FA.flash_attention_bwd(q, k, v, o, do, window=win, lse=lse)
    again = FA.flash_attention_bwd(q, k, v, o, do, window=win, lse=lse)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, window=win, lse=lse)
    scale = max(float(w.float().abs().max()) for w in want)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and g.dtype == w.dtype
        np.testing.assert_allclose(_np(g.cpu()), _np(w.cpu()),
                                   rtol=K3_BF16_TOL,
                                   atol=K3_BF16_TOL * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["mha_hd32", "gqa3_window", "S1"])
def test_forward_lse_equals_plain_lse_on_card(cuda, case, dtype):
    b, s, h, kv, hd, win, causal = ATTN_CASES[case]
    q, k, v, _ = (t.to(cuda) for t in _attn_torch(
        _attn_arrays(b, s, h, kv, hd), getattr(torch, dtype)))
    before = LAUNCHES["flash_attention"]
    o, lse = FA.flash_attention(q, k, v, causal=causal, window=win,
                                return_lse=True)
    assert LAUNCHES["flash_attention"] == before + 1
    assert torch.equal(o, FA.flash_attention(q, k, v, causal=causal,
                                             window=win))
    _, want = ref.flash_attention_ref(q, k, v, causal=causal, window=win,
                                      return_lse=True)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(lse, want, rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, BF16_STEP)])
@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv_backward_kernel_equals_plain_on_card(cuda, case, dtype, tol):
    *inputs, dy, ds = (t.to(cuda) for t in _wkv_torch(
        _wkv_arrays(**WKV_CASES[case]), dtype))
    before = LAUNCHES["rwkv_wkv_bwd"]
    got = WKV.rwkv_wkv_bwd(*inputs, dy, ds)
    again = WKV.rwkv_wkv_bwd(*inputs, dy, ds)
    torch.cuda.synchronize()
    assert LAUNCHES["rwkv_wkv_bwd"] == before + 2
    want = ref.rwkv_wkv_bwd_ref(*inputs, dy, ds)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and g.dtype == w.dtype
        _close(_np(g.cpu()), _np(w.cpu()), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, BF16_STEP)])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [1, 15, 17, 64, 65, 200])
def test_wkv_backward_kernel_over_chunk_edges_on_card(cuda, s, hd, dtype,
                                                      tol):
    """T on and off the checkpoint interval (8 at hd 32/64, 32 at hd 16,
    4 at hd 128), every head dim and its cluster, a non-zero state and ds,
    r a strided view (one half of a wider projection): against the plain
    backward, and two calls bit-equal."""
    arrays = _wkv_arrays(2, s, 3, hd, seed=hd)
    *inputs, dy, ds = (t.to(cuda) for t in _wkv_torch(arrays, dtype))
    wide = torch.cat([torch.zeros_like(inputs[0]), inputs[0]], dim=-1)
    inputs[0] = wide[..., hd:]
    assert not inputs[0].is_contiguous()
    before = LAUNCHES["rwkv_wkv_bwd"]
    got = WKV.rwkv_wkv_bwd(*inputs, dy, ds)
    again = WKV.rwkv_wkv_bwd(*inputs, dy, ds)
    torch.cuda.synchronize()
    assert LAUNCHES["rwkv_wkv_bwd"] == before + 2
    want = ref.rwkv_wkv_bwd_ref(inputs[0].contiguous(), *inputs[1:], dy, ds)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and g.dtype == w.dtype
        _close(_np(g.cpu()), _np(w.cpu()), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_attention", "rwkv_wkv",
                                  "flash_attention_tc"])
def test_gradients_through_ops_run_the_backward_kernels_on_card(cuda, name):
    """ops on the card: the forward kernel and the backward kernel, one
    launch each, within 2e-4 of autograd through the plain forward (the
    bf16 tensor-core route within ``K3_BF16_TOL``)."""
    tol = 2e-4
    if name == "flash_attention_tc":
        name, tol = "flash_attention", K3_BF16_TOL
        q, k, v, g = _attn_torch(_attn_arrays(2, 70, 8, 2, 128),
                                 torch.bfloat16)
        leaves = [q, k, v]
        fn, plain = ops.flash_attention, ref.flash_attention_ref
        grads = (g.to(cuda),)
    elif name == "flash_attention":
        leaves, g = _attn_leaves()
        fn, plain = ops.flash_attention, ref.flash_attention_ref
        grads = (g.to(cuda),)
    else:
        leaves, dy, ds = _wkv_leaves()
        fn, plain = ops.rwkv_wkv, ref.rwkv_wkv_ref
        grads = (dy.to(cuda), ds.to(cuda))
    leaves = [t.detach().to(cuda).requires_grad_(True) for t in leaves]
    before = dict(LAUNCHES)
    out = fn(*leaves)
    got = torch.autograd.grad(out, leaves, grads)
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
             if LAUNCHES[k] != before[k]}
    assert moved == {name: 1, f"{name}_bwd": 1}
    want = torch.autograd.grad(plain(*leaves), leaves, grads)
    for a, w in zip(got, want):
        _close(_np(a.cpu()), _np(w.cpu()), tol)
