"""The port's deep-net training against the reference's, on the CPU:
region layout, the masked aggregate and memory encodings, the loss and
per-worker gradients, the Fisher diagonal, the first-order baselines
and checkpoints.  The shared inputs and
tolerances are in ``_torch_train_helpers``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_train_helpers import (  # noqa: E402, F401
    KEY, TRAINED, assert_params_close, cfgs, close_to_leaf_max, loss_fns,
    make_batches, make_params, one_torch_thread, ref_leaves, to_np)
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.checkpoint import save as jsave  # noqa: E402
from repro.core.hessian import fisher_diag as jfisher  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import lm_loss as jlm_loss  # noqa: E402
from repro.optim import ranl_llm as jr  # noqa: E402

from repro_torch import interop, prng  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.core.hessian import fisher_diag  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import init_model, lm_loss  # noqa: E402
from repro_torch.optim import ranl_llm as tr  # noqa: E402
from repro_torch.optim.first_order import value_and_grad  # noqa: E402
from repro_torch.tree import leaf_paths, leaves  # noqa: E402


# --------------------------------------------------------------------------
# region layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ALL_ARCHS)
def test_region_layout_and_counts_equal_the_reference(arch):
    jcfg, tcfg = cfgs(arch)
    # the reference's layout needs only its tree's shapes
    jp = jax.eval_shape(lambda: jinit(jcfg, KEY))
    tp = init_model(tcfg, torch.Generator().manual_seed(0))
    jq, jl, jinfos = jr.region_layout(jp)
    tq, tl, tinfos = tr.region_layout(tp)
    assert (tq, tl, tinfos) == (jq, jl, jinfos)
    # the leaf order (and so the glue ids) is the reference's
    ref_paths = [jax.tree_util.keystr(p, simple=True, separator="/")
                 for p, _ in jax.tree_util.tree_leaves_with_path(jp)]
    assert ["/".join(k) for k, _ in leaf_paths(tp)] == ref_paths
    glue = {"/".join(k): v for (k, _), (kind, v) in zip(leaf_paths(tp),
                                                         tinfos)
            if kind == "glue"}
    L = tcfg.num_layers
    assert glue["embed"] == L and glue["final_norm"] == L + 1
    if "lm_head" in glue:
        assert glue["lm_head"] == L + 2
    counts = tr.region_param_counts(tp)
    assert counts.dtype == torch.float32
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(jr.region_param_counts(jp)))


def test_region_layout_refuses_layers_that_disagree():
    params = {"layers": [{"wq": torch.zeros(8, 8)},
                         {"wq": torch.zeros(8, 9)}],
              "embed": torch.zeros(32, 8)}
    with pytest.raises(ValueError, match="disagree"):
        tr.region_layout(params)
    params["layers"][1]["wq"] = torch.zeros(8, 8)
    assert tr.region_layout(params)[:2] == (3, 2)


# --------------------------------------------------------------------------
# aggregation and memory encodings
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,l,d,p", [(2, 2, 3, 0.5), (4, 3, 17, 0.3),
                                     (6, 5, 9, 0.8), (3, 4, 1, 0.1)])
def test_masked_aggregate_matches_reference(n, l, d, p):
    rng = np.random.default_rng(n * 100 + d)
    G = rng.normal(size=(n, l, d)).astype(np.float32)
    C = rng.normal(size=(n, l, d)).astype(np.float32)
    m = rng.random((n, l)) < p
    jg, jc = jr.masked_aggregate(jnp.asarray(G), jnp.asarray(m),
                                 jnp.asarray(C))
    tg, tc = tr.masked_aggregate(torch.tensor(G), torch.tensor(m),
                                 torch.tensor(C))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    # the per-layer leaf with its layer's mask column gives the same
    for q in range(l):
        g_q, c_q = tr.masked_aggregate(torch.tensor(G[:, q]),
                                       torch.tensor(m[:, q]),
                                       torch.tensor(C[:, q]))
        np.testing.assert_array_equal(c_q.numpy(), np.asarray(jc)[:, q])
        np.testing.assert_allclose(g_q.numpy(), np.asarray(jg)[q],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,layered", [
    ((3, 4, 16), True), ((3, 4, 8, 5), True), ((3, 4, 6), False),
    ((3, 16), False), ((2, 3, 7, 5), False)], ids=str)
def test_quantize_memory_matches_reference(shape, layered):
    """A per-layer leaf (N, ...) is layer q of the reference's stacked
    (N, L, ...) leaf: scales per (worker, layer); a glue leaf quantizes
    as the reference's own."""
    rng = np.random.default_rng(sum(shape))
    G = (rng.normal(size=shape) * 3).astype(np.float32)
    want = jr.quantize_memory(jnp.asarray(G))
    wq, ws = np.asarray(want["q"]), np.asarray(want["scale"])
    cases = ([(G[:, q], wq[:, q], ws[:, q]) for q in range(shape[1])]
             if layered else [(G, wq, ws)])
    for g, q_ref, s_ref in cases:
        got = tr.quantize_memory(torch.tensor(g), layer=layered)
        assert got["q"].dtype == torch.int8
        assert tuple(got["scale"].shape) == s_ref.shape
        np.testing.assert_allclose(got["scale"].numpy(), s_ref, rtol=1e-6)
        assert np.abs(got["q"].numpy().astype(int)
                      - q_ref.astype(int)).max() <= 1
        back = tr.dequantize_memory(got).numpy()
        assert (np.abs(back - g) <= got["scale"].numpy() / 2 + 1e-6).all()


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ALL_ARCHS)
def test_lm_loss_with_chunks_matches_reference(arch):
    jcfg, tcfg = cfgs(arch)
    jp, tp = make_params(jcfg, tcfg)
    jb, tb = make_batches(jcfg, 2, 24)
    want = float(jlm_loss(jp, jb, jcfg, loss_chunk=10, q_chunk=16,
                          kv_chunk=16))
    got = lm_loss(tp, tb, tcfg, loss_chunk=10)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    whole = lm_loss(tp, tb, tcfg)
    np.testing.assert_allclose(float(whole), float(got), rtol=1e-6)


@pytest.mark.parametrize("arch", TRAINED)
def test_per_worker_grads_match_reference(arch):
    jcfg, tcfg = cfgs(arch)
    jp, tp = make_params(jcfg, tcfg)
    jb, tb = make_batches(jcfg, 8, 16)
    jloss, tloss = loss_fns(jcfg, tcfg)
    jl, jG = jax.jit(lambda p, b: jr.per_worker_grads(jloss, p, b, 4))(
        jp, jb)
    tl, tG = tr.per_worker_grads(tloss, tp, tb, 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for (path, want) in ref_leaves(jG):
        keys = tuple(path.split("/"))
        if keys[0] == "layers":
            for q in range(tcfg.num_layers):
                node = tG["layers"][q]
                for k in keys[1:]:
                    node = node[k]
                close_to_leaf_max(node.numpy(), want[:, q],
                                  what=f"G {path}[{q}]")
        else:
            close_to_leaf_max(tG[keys[0]].numpy(), want, what=f"G {path}")


def test_fisher_diag_matches_reference():
    """The mean over keys of squared gradients; key k's batch is drawn
    from k (the reference draws it inside its vmap over keys, the port
    takes the same tokens)."""
    jcfg, tcfg = cfgs("phi4-mini-3.8b")
    jp, tp = make_params(jcfg, tcfg)
    jloss, tloss = loss_fns(jcfg, tcfg)

    def jbatch(k):
        toks = jax.random.randint(k, (2, 13), 0, jcfg.vocab_size, jnp.int32)
        return {"tokens": toks[:, :12], "labels": toks[:, 1:]}

    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    tokens = {tuple(np.asarray(k).tolist()): np.asarray(jbatch(k)["tokens"])
              for k in keys}
    labels = {k: np.asarray(jbatch(jnp.asarray(k, jnp.uint32))["labels"])
              for k in tokens}

    def tgrad(p, k):
        k = tuple(np.asarray(k).tolist())
        b = {"tokens": torch.tensor(tokens[k]),
             "labels": torch.tensor(labels[k])}
        return value_and_grad(tloss, p, b)[1]

    jd = jax.jit(lambda p: jfisher(
        lambda q, k: jax.grad(jloss)(q, jbatch(k)), p, keys))(jp)
    td = fisher_diag(tgrad, tp, np.asarray(keys))
    assert_params_close(jd, td, tcfg, what="fisher")


def test_make_train_step_is_the_train_step():
    jcfg, tcfg = cfgs("phi4-mini-3.8b")
    _, tp = make_params(jcfg, tcfg)
    _, tb = make_batches(jcfg, 8, 16)
    rcfg = tr.RanlLLMConfig(num_workers=4)
    state = tr.init_state(tp, lambda p, b: lm_loss(p, b, tcfg), tb, rcfg,
                          prng.PRNGKey(0))
    step = tsteps.make_train_step(tcfg, rcfg, q_chunk=16, kv_chunk=16)
    a = step(tp, state, tb, prng.PRNGKey(1))
    b = tr.train_step(tp, state, tb, prng.PRNGKey(1),
                      loss_fn=lambda p, b: lm_loss(p, b, tcfg), cfg=rcfg)
    for x, y in zip(leaves(a[0]),
                    leaves(b[0])):
        assert torch.equal(x, y)
    assert a[2].keys() == {"loss", "grad_norm", "coverage", "uplink_frac"}


@pytest.mark.parametrize("fn", ["init_state", "train_step",
                                "per_worker_grads"])
def test_a_mesh_raises_not_implemented(fn):
    """The mesh path is ported (tests/test_torch_train_sharded.py): a
    ``mesh=`` that is not a ``DeviceMesh`` is refused with a TypeError,
    before anything runs."""
    params = {"embed": torch.zeros(4, 2), "layers": []}
    call = {"init_state": lambda: tr.init_state(
                params, None, {}, tr.RanlLLMConfig(2), prng.PRNGKey(0),
                mesh="mesh"),
            "train_step": lambda: tr.train_step(
                params, {}, {}, prng.PRNGKey(0), loss_fn=None,
                cfg=tr.RanlLLMConfig(2), mesh="mesh"),
            "per_worker_grads": lambda: tr.per_worker_grads(
                None, params, {}, 2, mesh="mesh")}[fn]
    with pytest.raises(TypeError, match="DeviceMesh"):
        call()


# --------------------------------------------------------------------------
# first-order baselines
# --------------------------------------------------------------------------

def _random_trees(tcfg, seed):
    """Reference-layout params and three steps' grads (numpy), and the
    same as port trees."""
    jcfg = cfgs("phi4-mini-3.8b")[0]
    jp = to_np(jinit(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), jp) for _ in range(3)]
    port = [interop.model_params_from_numpy(tcfg, t, device="cpu")
            for t in [jp] + grads]
    return jp, grads, port[0], port[1:]


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    tcfg = cfgs("phi4-mini-3.8b")[1]
    jp, jgs, tp, tgs = _random_trees(tcfg, 1)
    jcfg_ = joptim.SGDConfig(lr=0.05, momentum=momentum)
    tcfg_ = toptim.SGDConfig(lr=0.05, momentum=momentum)
    js, ts = joptim.sgd_init(jp, jcfg_), toptim.sgd_init(tp, tcfg_)
    assert (js == {}) == (ts == {})
    for jg, tg in zip(jgs, tgs):
        jp, js = joptim.sgd_step(jp, js, jg, jcfg_)
        tp, ts = toptim.sgd_step(tp, ts, tg, tcfg_)
    assert_params_close(jp, tp, tcfg, tol=1e-5, what="sgd")


def test_adamw_with_weight_decay_matches_reference():
    tcfg = cfgs("phi4-mini-3.8b")[1]
    jp, jgs, tp, tgs = _random_trees(tcfg, 2)
    jcfg_ = joptim.AdamWConfig(lr=1e-2, weight_decay=0.1)
    tcfg_ = toptim.AdamWConfig(lr=1e-2, weight_decay=0.1)
    js, ts = joptim.adamw_init(jp, jcfg_), toptim.adamw_init(tp, tcfg_)
    for jg, tg in zip(jgs, tgs):
        jp, js = joptim.adamw_step(jp, js, jg, jcfg_)
        tp, ts = toptim.adamw_step(tp, ts, tg, tcfg_)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert_params_close(jp, tp, tcfg, tol=1e-5, what="adamw params")
    assert_params_close(js["m"], ts["m"], tcfg, tol=1e-5, what="adamw m")
    assert_params_close(js["v"], ts["v"], tcfg, tol=1e-5, what="adamw v")


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "llava-next-mistral-7b"])
def test_checkpoint_written_by_the_port_restores_in_the_reference(
        arch, tmp_path):
    jcfg, tcfg = cfgs(arch)
    jp, _ = make_params(jcfg, tcfg, seed=0)
    _, tp = make_params(jcfg, tcfg, seed=1)
    save(tp, str(tmp_path), step=5)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["step"] == 5
    assert [e["path"] for e in manifest["leaves"]] == [
        p for p, _ in ref_leaves(jp)]
    back = jrestore(jp, str(tmp_path))
    assert_params_close(back, tp, tcfg, tol=0.0, what="port->reference")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_written_by_the_reference_restores_in_the_port(
        dtype, tmp_path):
    jcfg, tcfg = cfgs("rwkv6-3b")
    jp = jinit(jcfg, jax.random.PRNGKey(4), jnp.dtype(dtype))
    jsave(jp, str(tmp_path), step=2)
    like = interop.model_params_from_numpy(
        tcfg, to_np(jinit(jcfg, jax.random.PRNGKey(0), jnp.dtype(dtype))),
        device="cpu")
    got = restore(like, str(tmp_path))
    assert got["layers"][1]["tmix"]["w_r"].dtype == getattr(torch, dtype)
    want = interop.model_params_from_numpy(tcfg, to_np(jp), device="cpu")
    for a, b in zip(leaves(got),
                    leaves(want)):
        assert torch.equal(a, b)


def test_checkpoint_shape_or_count_mismatch_raises(tmp_path):
    jcfg, tcfg = cfgs("phi4-mini-3.8b")
    _, tp = make_params(jcfg, tcfg)
    save(tp, str(tmp_path))
    wide = make_params(*cfgs("phi4-mini-3.8b", d_ff=640))[1]
    with pytest.raises(ValueError, match="shape mismatch at layers/mlp"):
        restore(wide, str(tmp_path))
    fewer = dict(tp)
    del fewer["final_norm"]
    with pytest.raises(ValueError, match="leaves, tree needs"):
        restore(fewer, str(tmp_path))
    with pytest.raises(ValueError, match="shape mismatch"):
        jrestore(jinit(cfgs("phi4-mini-3.8b", d_ff=640)[0], KEY),
                 str(tmp_path))
