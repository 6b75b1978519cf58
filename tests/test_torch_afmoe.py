"""The AFMoE (Trinity) model of the port against the benchmark's plain
reference (``bench/reference/afmoe.py``, loaded by its path), on the CPU
at a small size: two dense layers then four expert layers, one of them
full attention, a window shorter than the sequence, 8 of 16 routed
experts held.  Also: the expert layer's shares add up to the uncut
layer, one RANL round over layers whose leaves differ against
``bench/reference/ranl.py``, the grouped product's plain twin, and the
stacked layouts that refuse such a model.

Tolerances: the port and the reference compute the same f32 arithmetic
in other orders (K3's plain twin takes blocks of keys with an online
softmax, the reference whole score rows; the grouped products sum a
group's rows as one product): the loss within 2e-6 of itself, each
gradient leaf within 1e-4 of its largest entry.  A routing decision
that rounding flips would break these by far more; at these sizes none
does."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402, F401

from repro_torch import interop, prng  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs.base import ModelConfig, smoke_variant  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import init_model, lm_loss  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.moe import apply_routed_moe, held_pairs  # noqa: E402
from repro_torch.optim import RanlLLMConfig, ranl_llm  # noqa: E402
from repro_torch.optim.first_order import value_and_grad  # noqa: E402
from repro_torch.tree import (get, holders, leaf_paths, leaves,  # noqa: E402
                              stacked)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
SMALL = {"d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 32, "dense_d_ff": 96, "shared_d_ff": 32, "vocab_size": 256,
         "router_experts": 16, "num_experts": 8, "experts_per_token": 4,
         "sliding_window": 8}
B, S = 4, 24


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"bench_ref_{name}", BENCH / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


afmoe = _load("afmoe")
rranl = _load("ranl")


def small_cfg(**over):
    """The benchmark's configuration file at the small size."""
    cfg = json.loads((BENCH / "configs" / "trinity-mini.json").read_text())
    return {**cfg, **SMALL, **over}


def model_config(cfg):
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def weights(cfg, seed=0):
    """{path: f32 tensor} in the reference's layout, from numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape, (kind, v) in afmoe.param_specs(cfg):
        if kind == "normal":
            a = np.clip(rng.standard_normal(shape), -2, 2) * v
        else:
            a = np.full(shape, v)
        out[path] = torch.tensor(a, dtype=torch.float32)
    return out


def batch(cfg, seed=1, rows=B):
    toks = np.random.default_rng(seed).integers(0, cfg["vocab_size"],
                                                (rows, S + 1))
    t = torch.tensor(toks)
    return {"tokens": t[:, :-1].to(torch.int32), "labels": t[:, 1:]}


def port_loss(mcfg):
    return lambda p, b: lm_loss(p, b, mcfg, q_chunk=16, kv_chunk=16)


def ref_grads(cfg, flat, b):
    """The reference's loss and gradients; a leaf its graph does not
    reach (a held router) gets zeros."""
    live = {p: t.clone().requires_grad_(True) for p, t in flat.items()}
    loss = afmoe.loss(rranl.unflatten(live), b, cfg)
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return loss.detach(), {p: torch.zeros_like(t) if g is None else g
                           for (p, t), g in zip(live.items(), grads)}


def close_to_leaf_max(got, want, rel):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()) + 1e-12, err


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("first", [0, 8])
def test_loss_and_every_gradient_equal_the_reference(first):
    """8 of 16 experts held: every leaf but the router is reached; the
    router, held, gets no gradient."""
    cfg = small_cfg(first_expert=first)
    mcfg = model_config(cfg)
    flat = weights(cfg)
    params = rranl.unflatten(flat)
    b = batch(cfg)
    # the port's own init lays the weights out as the reference does
    mine = rranl.flatten(init_model(mcfg, torch.Generator().manual_seed(0)))
    assert {p: tuple(t.shape) for p, t in mine.items()} == {
        p: tuple(t.shape) for p, t in flat.items()}
    loss, grads = value_and_grad(port_loss(mcfg), params, b)
    want, wgrads = ref_grads(cfg, flat, b)
    assert abs(float(loss) - float(want)) <= 2e-6 * abs(float(want))
    got = rranl.flatten(grads)
    assert set(got) == set(wgrads)
    for path, g in wgrads.items():
        if path[-1] == "router":
            assert float(got[path].abs().max()) == 0.0 == float(g.abs().max())
            continue
        assert float(g.abs().max()) > 0, path        # every leaf is reached
        close_to_leaf_max(got[path], g, 1e-4)


def test_a_card_that_holds_every_expert_trains_its_router():
    """All 16 experts held (no cut): the router's gradient, as every
    other leaf's, equals the reference's."""
    cfg = small_cfg(num_experts=16)
    mcfg = model_config(cfg)
    flat = weights(cfg)
    b = batch(cfg)
    loss, grads = value_and_grad(port_loss(mcfg), rranl.unflatten(flat), b)
    want, wgrads = ref_grads(cfg, flat, b)
    assert abs(float(loss) - float(want)) <= 2e-6 * abs(float(want))
    got = rranl.flatten(grads)
    for path, g in wgrads.items():
        assert float(g.abs().max()) > 0, path
        close_to_leaf_max(got[path], g, 1e-4)


def test_layers_take_their_kind_from_the_configuration():
    cfg = small_cfg()
    mcfg = model_config(cfg)
    assert [mcfg.layer_attention(i) for i in range(6)] == [
        (8, True), (8, True), (8, True), (0, False), (8, True), (8, True)]
    params = init_model(mcfg, torch.Generator().manual_seed(0))
    kinds = ["mlp" if "mlp" in lp else "moe" for lp in params["layers"]]
    assert kinds == ["mlp"] * 2 + ["moe"] * 4
    assert params["layers"][2]["moe"]["router"].shape == (64, 16)
    assert params["layers"][2]["moe"]["gate"].shape == (8, 64, 32)
    assert params["layers"][0]["mlp"]["gate"].shape == (64, 96)


def test_new_fields_leave_other_configurations_alone():
    plain = ModelConfig(name="x", family="dense", num_layers=2, d_model=8,
                        num_heads=2, num_kv_heads=1, d_ff=16, vocab_size=32)
    assert plain.layer_attention(1, 5) == (5, True)
    assert plain.dense_layer(0) and plain.routed == 0
    sv = smoke_variant(dataclasses.replace(plain, num_experts=4,
                                           experts_per_token=2))
    assert sv.routed == 4 and not sv.dense_layer(1)
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(plain, layer_types=("sliding_attention",))
    with pytest.raises(ValueError, match="router"):
        dataclasses.replace(plain, num_experts=4, router_experts=8,
                            first_expert=6)


def test_routed_pairs_are_sorted_on_the_device():
    top_e = torch.tensor([[5, 1], [2, 5], [9, 3], [1, 2]])
    order, offsets = held_pairs(top_e, first=1, E=4)   # experts 1..4 held
    assert offsets.dtype == torch.int32
    assert offsets.tolist() == [0, 2, 4, 5, 5]          # expert 4 is empty
    flat = top_e.reshape(-1)
    assert flat[order[:5]].tolist() == [1, 1, 2, 2, 3]
    assert sorted(flat[order[5:]].tolist()) == [5, 5, 9]


def test_routed_rows_are_counted_on_the_device(monkeypatch):
    """Each call of the expert layer adds its held rows (the last offset)
    to ``ROUTED`` on the operands' device, and one call."""
    monkeypatch.setattr(moe_mod, "ROUTED", {"calls": 0, "rows": {}})
    cfg = small_cfg()
    layer = rranl.unflatten(weights(cfg))["layers"][2]["moe"]
    x = torch.randn(2, S, 64, generator=torch.Generator().manual_seed(5))
    seen = []
    real = moe_mod.held_pairs

    def spy(*args):
        order, offsets = real(*args)
        seen.append(int(offsets[-1]))
        return order, offsets
    monkeypatch.setattr(moe_mod, "held_pairs", spy)
    for _ in range(2):
        apply_routed_moe(layer, x, model_config(cfg))
    assert moe_mod.ROUTED["calls"] == 2
    (rows,) = moe_mod.ROUTED["rows"].values()
    assert rows.device == x.device and int(rows) == sum(seen) > 0


def test_expert_shares_add_up_to_the_uncut_layer():
    """Four cards' shares of a layer of 16 experts, 4 held each: their
    outputs, with the shared expert counted once, are the uncut
    reference layer's."""
    cfg = small_cfg(num_experts=16)
    flat = weights(cfg, seed=3)
    moe = rranl.unflatten(flat)["layers"][2]["moe"]
    x = torch.tensor(np.random.default_rng(4).standard_normal((2, S, 64)),
                     dtype=torch.float32)
    want = afmoe.experts(moe, x, cfg)
    shared = afmoe.swiglu(moe["shared"], x)
    total = torch.zeros_like(x)
    for first in range(0, 16, 4):
        part = {**moe, **{k: moe[k][first:first + 4]
                          for k in ("gate", "up", "down")}}
        mcfg = model_config({**cfg, "num_experts": 4, "first_expert": first})
        out, aux = apply_routed_moe(part, x, mcfg)
        assert float(aux) == 0.0
        total += out - shared
    torch.testing.assert_close(total + shared, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the grouped product's plain twin
# --------------------------------------------------------------------------

def test_grouped_product_twin_is_a_product_a_group():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, 12, generator=g)
    w = torch.randn(4, 12, 7, generator=g)
    # group 1 empty; rows 35.. outside every group
    offsets = torch.tensor([0, 10, 10, 30, 35], dtype=torch.int32)
    y = ref.grouped_matmul_ref(x, w, offsets)
    want = torch.cat([x[:10] @ w[0], x[10:30] @ w[2], x[30:35] @ w[3],
                      torch.zeros(5, 7)])
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    # a group of every row
    whole = torch.tensor([0, 40], dtype=torch.int32)
    torch.testing.assert_close(ref.grouped_matmul_ref(x, w[:1], whole),
                               x @ w[0], rtol=0, atol=0)
    dy = torch.randn(40, 7, generator=g)
    dw = ref.grouped_matmul_wgrad_ref(x, dy, offsets, 4)
    assert float(dw[1].abs().max()) == 0.0
    torch.testing.assert_close(dw[2], x[10:30].T @ dy[10:30], rtol=0, atol=0)


def test_grouped_product_gradients_through_ops():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(30, 6, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(3, 6, 5, generator=g, dtype=torch.float64,
                    requires_grad=True)
    offsets = torch.tensor([0, 0, 12, 28], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda x, w: ops.grouped_matmul(x, w, offsets), (x, w))


# --------------------------------------------------------------------------
# RANL over layers whose leaves differ
# --------------------------------------------------------------------------

RCFG = {"mu": 1e-4, "mu_rel": 0.05, "lr": 1.0, "trust_ratio": 0.1}


def test_regions_and_leaves_over_differing_layers():
    cfg = small_cfg()
    params = rranl.unflatten(weights(cfg))
    paths = [k for k, _ in leaf_paths(params)]
    assert paths == sorted(paths)
    assert holders(params, ("layers", "mlp", "gate")) == [0, 1]
    assert holders(params, ("layers", "moe", "shared", "up")) == [2, 3, 4, 5]
    assert holders(params, ("layers", "attn", "wg")) == list(range(6))
    assert len(leaves(params)) == len(rranl.flatten(params))
    Q, L, infos = ranl_llm.region_layout(params)
    glue = [p for p, _, _ in afmoe.param_specs(cfg) if p[0] != "layers"]
    assert (Q, L) == (6 + len(glue), 6)
    assert sorted(v for kind, v in infos if kind == "glue") == list(
        range(6, Q))
    # region q < L counts layer q's leaves, whichever it holds
    counts = ranl_llm.region_param_counts(params)
    for q in range(L):
        assert counts[q] == sum(t.numel() for p, t in
                                rranl.flatten(params).items()
                                if p[:2] == ("layers", q))


def test_one_round_equals_the_plain_round():
    """Round 0 and one round from the same weights, batch and masks
    against ``bench/reference/ranl.py``: the curvature, then, from the
    port's curvature and bf16 memory (one bf16 step apart from the
    reference's where rounding falls on either side), the aggregate and
    the new weights of every leaf, the Newton step's statistics over the
    layers that hold each leaf."""
    cfg = small_cfg()
    mcfg = model_config(cfg)
    flat = weights(cfg, seed=5)
    n = 4
    b0, b1 = batch(cfg, seed=6), batch(cfg, seed=7)
    Q = ranl_llm.region_layout(rranl.unflatten(flat))[0]
    masks = torch.ones(n, Q, dtype=torch.bool)
    masks[:, 3] = False                     # layer 3 uncovered: the memory
    masks[1:, 0] = False                    # layer 0 trained by one worker
    masks[0, 4] = False
    rcfg = RanlLLMConfig(num_workers=n, **RCFG)
    loss_fn = port_loss(mcfg)
    params = rranl.unflatten(flat)
    state = ranl_llm.init_state(params, loss_fn, b0, rcfg, prng.PRNGKey(0))
    h, _ = rranl.init(afmoe, cfg, flat, b0, n)
    got_h = rranl.flatten(state["precond"])
    for p in flat:
        close_to_leaf_max(got_h[p], h[p], 1e-5)
    # the round's parts, as train_step runs them
    _, G = ranl_llm.per_worker_grads(loss_fn, params, b1, n)
    g, _, _ = ranl_llm.aggregate(G, state["memory"], masks, params, rcfg)
    new, gnorm = ranl_llm.newton_step(params, g, state["precond"], rcfg)
    torch.testing.assert_close(gnorm, torch.sqrt(sum(
        torch.sum(torch.square(x)) for x in leaves(g))), rtol=1e-6, atol=0)
    memory = {p: t.clone() for p, t in rranl.flatten(state["memory"]).items()}
    want_new, _, want_g = rranl.round_(afmoe, cfg, flat, got_h, memory, b1,
                                       masks, RCFG)
    got_g, got_new = rranl.flatten(g), rranl.flatten(new)
    for p in flat:
        close_to_leaf_max(got_g[p], want_g[p], 1e-5)
        close_to_leaf_max(got_new[p] - flat[p], want_new[p] - flat[p], 1e-5)
    # train_step is the same round
    p2, s2, m = ranl_llm.train_step(params, state, b1, prng.PRNGKey(0),
                                    loss_fn=loss_fn, cfg=rcfg, masks=masks)
    for p, t in rranl.flatten(p2).items():
        torch.testing.assert_close(t, got_new[p], rtol=0, atol=0)
    assert int(s2["step"]) == 1 and torch.isfinite(m["loss"])


# --------------------------------------------------------------------------
# stacked layouts refuse layers whose leaves differ
# --------------------------------------------------------------------------

def _hetero():
    cfg = small_cfg()
    return model_config(cfg), rranl.unflatten(weights(cfg))


def test_checkpoint_refuses_layers_that_differ(tmp_path):
    _, params = _hetero()
    with pytest.raises(ValueError, match="differ in their leaves"):
        save(params, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="differ in their leaves"):
        restore(params, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="differ in their leaves"):
        stacked(params)


def test_interop_refuses_layers_that_differ():
    mcfg, params = _hetero()
    with pytest.raises(ValueError, match="layers/mlp/down"):
        interop.params_to_numpy(mcfg, params)


def test_mesh_path_refuses_layers_that_differ(tmp_path, monkeypatch):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    mcfg, params = _hetero()
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        rcfg = RanlLLMConfig(num_workers=2, **RCFG)
        with pytest.raises(ValueError, match="the mesh path"):
            ranl_llm.init_state(params, port_loss(mcfg), batch(
                small_cfg(), rows=2), rcfg, prng.PRNGKey(0), mesh=mesh)
        with pytest.raises(ValueError, match="the mesh path"):
            ranl_llm.shard_params(params, mesh)
    finally:
        dist.destroy_process_group()
    # the stacked tree the mesh path needs is all there is to it: the
    # same tree with every layer alike passes
    uniform = {"layers": [{"w": torch.zeros(2)}, {"w": torch.zeros(2)}]}
    assert stacked(uniform)["layers"]["w"].shape == (2, 2)
    assert get(uniform, ("layers", "w"), 1).shape == (2,)
