"""RANL's diagonal Newton step (``kernels.ops.newton_step``): the plain
version against the step as the optimizer took it leaf by leaf before it
had one (the one-card step and the mesh path's formula, written out
below), the kernels' table, the wrapper's checks, and — on a card — the
CUDA kernels (``csrc/newton_step.cu``) against the plain version.

Tolerances: on the CPU the plain version is the old step's arithmetic,
so the new params are bit-equal.  On the card Δ and p′ are bit-equal to
the plain formula given the kernels' floor and scale (the same IEEE
operations); the sums (Σh, ‖Δ‖², ‖p‖², ‖g‖²) differ from ``torch.sum``
only in their order.  Each is a sum of non-negative terms, so either
order is within (its longest chain of additions) × 2⁻²⁴ of the exact
sum: here at most ~650 for the kernels (a thread's 592 elements of the
largest chunk, a warp's 5, the block's 8, a group's ≤ 4096 partials
over 256 threads, 5, 8) and fewer for torch's pairwise sums, so
``SUM_RTOL`` = 1e-4 holds both with room."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402, F401

from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402
from repro_torch.kernels import newton_step as NS  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.optim import RanlLLMConfig, ranl_llm  # noqa: E402
from repro_torch.tree import get, holders, leaf_paths, leaves, rebuild  # noqa: E402

SUM_RTOL = 1e-4
CFG = dict(lr=1.0, mu=1e-4, mu_rel=0.05, trust=0.1)


# --------------------------------------------------------------------------
# the step as the optimizer took it before the plain version
# --------------------------------------------------------------------------

def eager_one_card(params, g, precond, cfg):
    """The one-card step, leaf by leaf in eager PyTorch."""
    new = {}
    for keys, layered in leaf_paths(params):
        idx = holders(params, keys) if layered else (None,)
        ps = [get(params, keys, i) for i in idx]
        hs = [get(precond, keys, i) for i in idx]
        mean_h = sum(h.sum() for h in hs) / sum(h.numel() for h in hs)
        floor = cfg.mu + cfg.mu_rel * mean_h
        deltas = [cfg.lr * get(g, keys, i).float() / torch.maximum(h, floor)
                  for i, h in zip(idx, hs)]
        dn = torch.sqrt(sum(torch.sum(torch.square(d)) for d in deltas))
        pn = torch.sqrt(sum(torch.sum(torch.square(p.float())) for p in ps))
        scale = torch.clamp_max(cfg.trust_ratio * (pn + 1.0)
                                / torch.clamp_min(dn, 1e-20), 1.0)
        for i, p, d in zip(idx, ps, deltas):
            new[keys, i] = (p.float() - scale * d).to(p.dtype)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                           for x in leaves(g)))
    return rebuild(params, lambda keys, layer: new[keys, layer]), gnorm


def eager_mesh(ps, gs, hs, cfg, hsum, pn2, over_model):
    """The mesh path's step over groups: Σh of a cut group given with its
    count, ‖p‖² of every group given (from the gathered params), ‖Δ‖² of
    the cut groups summed over "model" by ``over_model``; Δ built twice,
    for ‖Δ‖² and for the update."""
    def deltas(j):
        n = sum(h.numel() for h in hs[j])
        mean_h = (hsum[j][0] / hsum[j][1] if hsum[j] is not None
                  else sum(h.sum() for h in hs[j]) / n)
        floor = cfg.mu + cfg.mu_rel * mean_h
        return [cfg.lr * g.float() / torch.maximum(h, floor)
                for g, h in zip(gs[j], hs[j])]
    dn2 = [sum(torch.sum(torch.square(d)) for d in deltas(j))
           for j in range(len(ps))]
    cut = [j for j in range(len(ps)) if hsum[j] is not None]
    if cut:
        small = over_model(torch.stack([dn2[j] for j in cut]))
        for i, j in enumerate(cut):
            dn2[j] = small[i]
    new = []
    for j in range(len(ps)):
        scale = torch.clamp_max(
            cfg.trust_ratio * (torch.sqrt(pn2[j]) + 1.0)
            / torch.clamp_min(torch.sqrt(dn2[j]), 1e-20), 1.0)
        new.append([(p.float() - scale * d).to(p.dtype)
                    for p, d in zip(ps[j], deltas(j))])
    return new


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def _rcfg(**over):
    return RanlLLMConfig(num_workers=4, mu=CFG["mu"], mu_rel=CFG["mu_rel"],
                         lr=CFG["lr"], trust_ratio=CFG["trust"], **over)


def trinity_small():
    """The AFMoE layout of ``tests/test_torch_afmoe.py``'s ``SMALL``:
    two dense layers, then expert layers, so a per-layer leaf's group is
    the layers that hold it."""
    cfg = json.loads((Path(__file__).resolve().parents[1] / "bench"
                      / "configs" / "trinity-mini.json").read_text())
    cfg.update(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32,
               dense_d_ff=96, shared_d_ff=32, vocab_size=256,
               router_experts=16, num_experts=8, experts_per_token=4,
               sliding_window=8, num_layers=6)
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def model_tree(arch, seed=0):
    cfg = trinity_small() if arch == "trinity" else smoke_variant(
        get_config(arch))
    return init_model(cfg, torch.Generator().manual_seed(seed))


def tree_inputs(params, g_scale, seed=0):
    """The aggregate and the curvature shaped like ``params``: g normal
    times ``g_scale`` (large clips the step, small leaves it unclipped),
    h a squared normal (some entries under the floor)."""
    gen = torch.Generator().manual_seed(seed)
    g = rebuild(params, lambda keys, layer: g_scale * torch.randn(
        get(params, keys, layer).shape, generator=gen))
    h = rebuild(params, lambda keys, layer: torch.randn(
        get(params, keys, layer).shape, generator=gen) ** 2)
    return g, h


def group_inputs(shapes, g_scale, seed=0, device="cpu", p_zero=False):
    """ps, gs, hs as groups of leaves of ``shapes`` (a list of groups,
    each a list of leaf shapes)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def one(shape, kind):
        if kind == "p" and p_zero:
            return torch.zeros(shape, device=device)
        x = torch.randn(shape, generator=gen, device=device)
        return {"p": x, "g": g_scale * x, "h": x * x}[kind]
    return tuple([[one(s, kind) for s in grp] for grp in shapes]
                 for kind in ("p", "g", "h"))


# groups of leaf shapes: a norm, two layers of a weight, a glue leaf whose
# size is no multiple of 4, an empty leaf beside a full one
SHAPES = [[(24,)], [(16, 12), (16, 12)], [(37, 29)], [(0, 8), (5,)]]


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("g_scale", [1e3, 1e-6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "rwkv6-3b", "trinity"])
def test_plain_version_is_the_one_card_step(arch, g_scale):
    """``ranl_llm.newton_step`` on the CPU (the plain version) gives the
    old eager step's params bit for bit, and ‖g‖ within f32 order; the
    trinity layout's groups run over the layers that hold each leaf."""
    params = model_tree(arch, seed=3)
    g, h = tree_inputs(params, g_scale, seed=4)
    cfg = _rcfg()
    got, gnorm = ranl_llm.newton_step(params, g, h, cfg)
    want, want_gnorm = eager_one_card(params, g, h, cfg)
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    torch.testing.assert_close(gnorm, want_gnorm, rtol=1e-6, atol=0)
    _, stats = ops.newton_step(*ranl_llm._groups(params, params, g, h)[1],
                               **CFG)
    scales = torch.clamp_max(CFG["trust"] * (stats[:, 2].sqrt() + 1.0)
                             / stats[:, 1].sqrt(), 1.0)
    if g_scale > 1:
        assert bool((scales < 1).all())
    else:
        assert bool((scales == 1).all())
    if arch == "trinity":
        idx, _ = ranl_llm._groups(params)
        assert any(0 < len(qs) < len(params["layers"]) for _, qs in idx
                   if qs != [None])


def test_plain_version_of_an_empty_leaf_and_ragged_sizes():
    ps, gs, hs = group_inputs(SHAPES, 1.0)
    new, stats = ops.newton_step(ps, gs, hs, **CFG)
    assert stats.shape == (len(SHAPES), 4)
    assert new[3][0].shape == (0, 8) and new[3][1].shape == (5,)
    # the empty leaf adds nothing to its group's sums
    want, want_stats = ref.newton_step_ref([[ps[3][1]]], [[gs[3][1]]],
                                           [[hs[3][1]]], **CFG)
    assert torch.equal(stats[3], want_stats[0])
    assert torch.equal(new[3][1], want[0][0])


@pytest.mark.parametrize("cut", [[], [1], [0, 2]], ids=str)
def test_plain_version_is_the_mesh_formula(cut):
    """With Σh given for the cut groups, ‖p‖² given for every group and
    ``between`` summing the cut groups' ‖Δ‖² over two model ranks, the
    new leaves are the mesh path's old formula's bit for bit."""
    ps, gs, hs = group_inputs(SHAPES[:3], 0.5, seed=7)
    cfg = _rcfg()
    hsum = [(2 * sum(h.sum() for h in hs[j]),
             2 * sum(h.numel() for h in hs[j])) if j in cut else None
            for j in range(3)]
    pn2 = [sum(torch.sum(torch.square(p)) for p in ps[j]) for j in range(3)]

    def over_model(small):
        return small + small                    # two ranks holding the same

    def between(stats):
        if not cut:
            return
        small = over_model(torch.stack([stats[j, 1] for j in cut]))
        for i, j in enumerate(cut):
            stats[j, 1] = small[i]
    got, stats = ops.newton_step(ps, gs, hs, **CFG, hsum=hsum, pn2=pn2,
                                 between=between)
    want = eager_mesh(ps, gs, hs, cfg, hsum, pn2, over_model)
    for a, b in zip(sum(got, []), sum(want, [])):
        assert torch.equal(a, b)
    for j in range(3):
        assert torch.equal(stats[j, 2], pn2[j])


def test_the_round_takes_grad_norm_from_the_step(monkeypatch):
    """``train_step`` reads ‖g‖ from the Newton step: no second sum of
    squares over g."""
    seen = []
    real = ranl_llm.newton_step

    def spy(*args):
        out = real(*args)
        seen.append(out[1])
        return out
    monkeypatch.setattr(ranl_llm, "newton_step", spy)
    from repro_torch import prng
    from repro_torch.data import make_batch
    from repro_torch.models import lm_loss
    cfg = smoke_variant(get_config("phi4-mini-3.8b"))
    gen = torch.Generator().manual_seed(0)
    params = init_model(cfg, gen)
    batch = make_batch(cfg, gen, 4, 16)
    rcfg = RanlLLMConfig(num_workers=2)

    def loss_fn(p, b):
        return lm_loss(p, b, cfg)
    state = ranl_llm.init_state(params, loss_fn, batch, rcfg,
                                prng.PRNGKey(0))
    _, _, m = ranl_llm.train_step(params, state, batch, prng.PRNGKey(1),
                                  loss_fn=loss_fn, cfg=rcfg)
    assert len(seen) == 1 and m["grad_norm"] is seen[0]


# --------------------------------------------------------------------------
# the table and the wrapper's checks
# --------------------------------------------------------------------------

def test_chunks_adapt_to_the_group():
    assert NS.chunk_elems(3072) == NS.STEP * NS.MIN_STEPS
    assert NS.chunk_elems(200064 * 3072) == 151552      # phi4-mini's head
    assert -(-200064 * 3072 // 151552) == 4056
    for total in (1, 10 ** 6, 33554432, 33554433, 614662144, 3 * 10 ** 9):
        c = NS.chunk_elems(total)
        assert c % NS.STEP == 0 and c >= NS.STEP * NS.MIN_STEPS
        assert -(-total // c) <= NS.MAX_PARTS


def test_the_table_lays_groups_out_largest_chunks_first():
    # (address base, numel, group): group 1's leaves are large, 2 empty
    sizes = [(3072, 0), (40_000_000, 1), (40_000_000, 1), (0, 2), (5, 2),
             (9000, 3)]
    leaves_in = [(16 * k, 16 * k + 16, 16 * k + 32,
                  16 * k + (4 if k == 5 else 48), n, j)
                 for k, (n, j) in enumerate(sizes)]
    groups = [(3072, 0, 0), (80_000_000, 0, 0), (5, 1024, 0), (9000, 0, 2048)]
    words, C = NS.layout(leaves_in, groups)
    T, G = len(sizes), len(groups)
    assert words.size == 8 * T + 5 * G + 3 + 2 * G
    tab = words[:8 * T].reshape(T, 8)
    grp = words[8 * T:8 * T + 5 * G].reshape(G, 5)
    assert (words[8 * T + 5 * G:] == 0).all()
    # group 1 (the big chunks) first, then the others in group order
    assert [int(r[7] & 0xffffffff) for r in tab] == [1, 1, 0, 2, 2, 3]
    assert list(tab[:, 5]) == sorted(tab[:, 5], reverse=True)
    # each leaf has at least one chunk; first chunks run on without gaps
    chunks = [max(1, -(-int(r[4]) // int(r[5]))) for r in tab]
    assert list(tab[:, 6]) == list(np.cumsum([0] + chunks[:-1]))
    assert C == sum(chunks)
    for j in range(G):
        rows = [k for k in range(T) if int(tab[k, 7] & 0xffffffff) == j]
        assert grp[j, 0] == tab[rows[0], 6]
        assert grp[j, 1] == sum(chunks[k] for k in rows)
    assert list(grp[:, 2]) == [3072, 80_000_000, 5, 9000]
    assert list(grp[:, 3]) == [0, 0, 1024, 0]
    assert list(grp[:, 4]) == [0, 0, 0, 2048]
    # the leaf whose output is off 16 bytes takes the scalar path
    assert [int(r[7]) >> 32 for r in tab] == [1, 1, 1, 1, 1, 0]


def _meta(shapes=((4, 8),), dtype=torch.float32):
    def t(s):
        return torch.empty(s, dtype=dtype, device="meta")
    return [[t(s) for s in shapes]], [[t(s) for s in shapes]], \
        [[t(s) for s in shapes]]


def _wrong(case):
    ps, gs, hs = _meta()
    if case == "dtype":
        return (*_meta(dtype=torch.bfloat16), None, None), TypeError, \
            "float32"
    if case == "shape":
        return (ps, gs, [[torch.empty(4, 9, device="meta")]], None, None), \
            ValueError, "group 0"
    if case == "strided":
        wide = torch.empty(4, 16, device="meta")
        return (ps, [[wide[:, ::2]]], hs, None, None), ValueError, \
            "contiguous"
    if case == "empty_group":
        return ([[]], [[]], [[]], None, None), ValueError, "group 0"
    if case == "groups":
        return (ps, gs, hs + hs, None, None), ValueError, "same groups"
    if case == "hsum":
        return (ps, gs, hs, [(torch.zeros(2, device="meta"), 8)], None), \
            ValueError, "hsum"
    if case == "cpu":
        return (*group_inputs([[(4, 8)]], 1.0), None, None), ValueError, \
            "CUDA"
    return (ps, gs, hs, None, [None, None]), ValueError, "pn2"


@pytest.mark.parametrize("case", ["dtype", "shape", "strided", "empty_group",
                                  "groups", "hsum", "pn2", "cpu"])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(case):
    args, err, match = _wrong(case)
    with pytest.raises(err, match=match):
        NS.check(*args)


def test_a_meta_tensor_has_no_kernel_nor_plain_version():
    with pytest.raises(ValueError, match="no kernel"):
        ops.newton_step(*_meta(), **CFG)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plain_given(ps, gs, hs, stats):
    """The plain formula on the card from the kernels' floor and sums:
    (new leaves, scales)."""
    new, scales = [], []
    for j in range(len(ps)):
        scale = torch.clamp_max(
            CFG["trust"] * (torch.sqrt(stats[j, 2]) + 1.0)
            / torch.clamp_min(torch.sqrt(stats[j, 1]), 1e-20), 1.0)
        scales.append(scale)
        new.append([ref.newton_update_ref(p, g, h, stats[j, 0], scale,
                                          CFG["lr"])
                    for p, g, h in zip(ps[j], gs[j], hs[j])])
    return new, scales


def _off16(t):
    """``t``'s values in a tensor whose address is 4 bytes off 16."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


# the card's groups: a group past 33.5 M elements (its chunks grow), two
# layers of a weight, a norm, a leaf of a size no multiple of 4, an empty
# leaf beside a full one
CARD_SHAPES = [[(8192, 4608)], [(512, 3072), (512, 3072)], [(3072,)],
               [(1037,)], [(0, 8), (999,)]]


@pytest.mark.gpu
@pytest.mark.parametrize("g_scale", [1e3, 1e-6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("layout", ["aligned", "off16"])
def test_kernels_match_plain_on_card(cuda, layout, g_scale):
    ps, gs, hs = group_inputs(CARD_SHAPES, g_scale, seed=11, device=cuda)
    if layout == "off16":
        ps, gs, hs = ([[_off16(t) for t in grp] for grp in x]
                      for x in (ps, gs, hs))
    before = [[t.clone() for t in grp] for grp in ps + gs + hs]
    launches = LAUNCHES["newton_step"]
    new, stats = NS.newton_step(ps, gs, hs, **CFG)
    assert LAUNCHES["newton_step"] == launches + 3
    assert all(torch.equal(a, b) for a, b in zip(
        sum(before, []), sum(ps + gs + hs, [])))
    _, want = ref.newton_step_ref(ps, gs, hs, **CFG)
    torch.testing.assert_close(stats, want, rtol=SUM_RTOL, atol=0)
    plain, scales = _plain_given(ps, gs, hs, stats)
    for a, b in zip(sum(new, []), sum(plain, [])):
        assert a.shape == b.shape and torch.equal(a, b)
    assert all((s < 1) == (g_scale > 1) for s in scales)
    again, stats2 = NS.newton_step(ps, gs, hs, **CFG)
    assert torch.equal(stats, stats2)
    assert all(torch.equal(a, b) for a, b in zip(sum(new, []),
                                                 sum(again, [])))


@pytest.mark.gpu
def test_delta_is_the_plain_delta_on_card(cuda):
    """With p = 0 and the step unclipped, p′ = −Δ: Δ bit-equal to the
    plain formula's given the kernels' floor."""
    ps, gs, hs = group_inputs(CARD_SHAPES[1:], 1e-6, seed=12, device=cuda,
                              p_zero=True)
    new, stats = NS.newton_step(ps, gs, hs, **CFG)
    for j in range(len(ps)):
        for out, g, h in zip(new[j], gs[j], hs[j]):
            d = CFG["lr"] * g / torch.maximum(h, stats[j, 0])
            assert torch.equal(-out, d)


@pytest.mark.gpu
def test_given_sums_and_between_on_card(cuda):
    """The mesh path's form: Σh given (with its count) and ‖p‖² given for
    some groups, ``between`` writing ‖Δ‖² in place; the given values are
    taken as they are, the floor as PyTorch computes it on the card."""
    ps, gs, hs = group_inputs(CARD_SHAPES[1:4], 0.5, seed=13, device=cuda)
    hsum = [(2 * hs[0][0].sum(), 2 * 2 * hs[0][0].numel()), None, None]
    pn2 = [None, ps[1][0].square().sum(), None]
    calls = []

    def between(stats):
        calls.append(stats.clone())
        stats[0, 1] = 2 * stats[0, 1]
    new, stats = NS.newton_step(ps, gs, hs, **CFG, hsum=hsum, pn2=pn2,
                                between=between)
    assert len(calls) == 1 and torch.equal(stats[0, 1], 2 * calls[0][0, 1])
    floor = CFG["mu"] + CFG["mu_rel"] * (hsum[0][0] / hsum[0][1])
    assert torch.equal(stats[0, 0], floor)
    assert torch.equal(stats[1, 2], pn2[1])
    plain, _ = _plain_given(ps, gs, hs, stats)
    for a, b in zip(sum(new, []), sum(plain, [])):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_three_launches_whatever_the_leaves(cuda):
    for n in (1, 300):
        ps, gs, hs = group_inputs([[(64,)] * 3] * n, 1.0, device=cuda)
        before = LAUNCHES["newton_step"]
        NS.newton_step(ps, gs, hs, **CFG)
        assert LAUNCHES["newton_step"] == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "trinity"])
def test_a_rounds_newton_step_on_the_card(cuda, arch):
    """``ranl_llm.newton_step`` on the card: three launches, no wait of
    the host, the params the plain version's within its sums' order."""
    host = model_tree(arch, seed=5)
    g, h = tree_inputs(host, 1.0, seed=6)
    params, g, h = (rebuild(t, lambda keys, layer, t=t: get(
        t, keys, layer).to(cuda)) for t in (host, g, h))
    cfg = _rcfg()
    before = LAUNCHES["newton_step"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, gnorm = ranl_llm.newton_step(params, g, h, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert LAUNCHES["newton_step"] == before + 3
    want, want_gnorm = eager_one_card(params, g, h, cfg)
    for a, b in zip(leaves(new), leaves(want)):
        torch.testing.assert_close(a, b, rtol=SUM_RTOL, atol=SUM_RTOL * float(
            b.abs().max()))
    torch.testing.assert_close(gnorm, want_gnorm, rtol=SUM_RTOL, atol=0)
