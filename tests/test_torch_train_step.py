"""RANL rounds of the port against the reference's, on the CPU:
``init_state``, and ``train_step`` for phi4-mini and rwkv6 smoke across
the compression, memory, curvature-refresh, glue, given-mask and
trust-ratio options, each round from the same inputs on both sides.  The shared inputs and
tolerances are in ``_torch_train_helpers``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_train_helpers import (  # noqa: E402, F401
    FLIP, KEY, STEP_TOL, TRAINED, assert_memory_close, assert_params_close,
    cfgs, loss_fns, make_batches, make_params, one_torch_thread, ref_leaves,
    ref_state, to_np, to_reference)
from repro.core.masks import sample_masks as jsample_masks  # noqa: E402
from repro.optim import ranl_llm as jr  # noqa: E402

from repro_torch import interop, prng  # noqa: E402
from repro_torch.core.masks import sample_masks  # noqa: E402
from repro_torch.optim import ranl_llm as tr  # noqa: E402


@pytest.mark.parametrize("memory_int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", TRAINED)
def test_init_state_matches_reference(arch, memory_int8):
    jcfg, tcfg = cfgs(arch)
    jp, tp = make_params(jcfg, tcfg)
    jb, tb = make_batches(jcfg, 8, 16)
    jloss, tloss = loss_fns(jcfg, tcfg)
    want = ref_state(arch, memory_int8, jcfg, jp, jb, jloss)
    got = tr.init_state(tp, tloss, tb, tr.RanlLLMConfig(
        num_workers=4, memory_int8=memory_int8), np.asarray(KEY))
    assert int(got["step"]) == 0
    assert_params_close(want["precond"], got["precond"], tcfg,
                        what="precond")
    assert_memory_close(want["memory"], got["memory"], tcfg, memory_int8)
    # the reference's state carried across lands where the port's is
    across = interop.ranl_state_from_numpy(tcfg, to_np(want), device="cpu")
    assert_memory_close(want["memory"], across["memory"], tcfg,
                        memory_int8)


# each option at least once; options that touch different parts of the
# round share a case (one reference compile each)
STEP_CASES = {
    "default": {},
    "compression_int8": dict(compression="int8"),
    "compression_bf16_unprotected_glue": dict(
        compression="bf16", protect_glue=False, keep_prob=0.5),
    "memory_int8_precond_beta": dict(memory_int8=True, precond_beta=0.5),
    "masks_given_trust_ratio_tight": dict(masks=True, trust_ratio=1e-3),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("arch", TRAINED)
def test_train_step_matches_reference(arch, case):
    """Two rounds from the reference's init state, each from the same
    inputs on both sides: masks, coverage and uplink_frac exactly; losses,
    params, precond and the aggregate's norm within the stated
    tolerances; the memory within one bf16 step (or the int8 code
    tolerance)."""
    kw = dict(STEP_CASES[case])
    flip = FLIP.get(kw.get("compression"))
    masks_given = kw.pop("masks", False)
    jcfg, tcfg = cfgs(arch)
    jp, tp = make_params(jcfg, tcfg)
    jb, tb = make_batches(jcfg, 8, 16)
    jloss, tloss = loss_fns(jcfg, tcfg)
    memory_int8 = kw.get("memory_int8", False)
    js = ref_state(arch, memory_int8, jcfg, jp, jb, jloss)
    ts = interop.ranl_state_from_numpy(tcfg, to_np(js), device="cpu")
    jrc = jr.RanlLLMConfig(num_workers=4, **kw)
    trc = tr.RanlLLMConfig(num_workers=4, **kw)
    rng = jax.random.PRNGKey(7)
    Q = tr.region_layout(tp)[0]
    jstep = jax.jit(lambda p, s, b, m: jr.train_step(
        p, s, b, rng, loss_fn=jloss, cfg=jrc, masks=m))
    for t in range(2):
        jb, tb = make_batches(jcfg, 8, 16, seed=10 + t)
        want_masks = np.asarray(jsample_masks(
            jrc.policy, jax.random.fold_in(rng, t), t, 4, Q))
        got_masks = sample_masks(trc.policy, prng.fold_in(np.asarray(rng), t),
                                 t, 4, Q, "cpu")
        np.testing.assert_array_equal(got_masks.numpy(), want_masks)
        given = None
        if masks_given:
            given = np.random.default_rng(t).random((4, Q)) < 0.4
            given[:, 0] = False          # an uncovered layer: the memory path
        jp, js, jm = jstep(jp, js, jb, None if given is None
                           else jnp.asarray(given))
        tp, ts, tm = tr.train_step(
            tp, ts, tb, np.asarray(rng), loss_fn=tloss, cfg=trc,
            masks=None if given is None else torch.tensor(given))
        assert int(ts["step"]) == int(js["step"]) == t + 1
        for k in ("coverage", "uplink_frac"):
            assert float(tm[k]) == float(jm[k]), k
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        tol = STEP_TOL[arch]
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=tol)
        assert_params_close(jp, tp, tcfg, tol, f"{case} step {t} params",
                            flip)
        assert_params_close(js["precond"], ts["precond"], tcfg, tol,
                            f"{case} step {t} precond")
        assert_memory_close(js["memory"], ts["memory"], tcfg, memory_int8,
                            flip, tol)
        jp, js = to_reference(tcfg, tp, ts)


def test_trust_ratio_binds_as_in_the_reference():
    """A tiny trust ratio caps every leaf's step at trust_ratio·(‖p‖+1):
    the port's step equals the reference's and is that small."""
    jcfg, tcfg = cfgs("phi4-mini-3.8b")
    jp, tp = make_params(jcfg, tcfg)
    jb, tb = make_batches(jcfg, 8, 16)
    jloss, tloss = loss_fns(jcfg, tcfg)
    js = ref_state("phi4-mini-3.8b", False, jcfg, jp, jb, jloss)
    ts = interop.ranl_state_from_numpy(tcfg, to_np(js), device="cpu")
    kw = dict(num_workers=4, trust_ratio=1e-6)
    jn, _, _ = jax.jit(lambda p, s, b: jr.train_step(
        p, s, b, KEY, loss_fn=jloss, cfg=jr.RanlLLMConfig(**kw)))(jp, js, jb)
    tn, _, _ = tr.train_step(tp, ts, tb, np.asarray(KEY), loss_fn=tloss,
                             cfg=tr.RanlLLMConfig(**kw))
    assert_params_close(jn, tn, tcfg, what="trust-bound params")
    before = interop.params_to_numpy(tcfg, tp)
    after = interop.params_to_numpy(tcfg, tn)
    for path, a in ref_leaves(before):
        b = after
        for k in path.split("/"):
            b = b[k]
        step = float(np.linalg.norm((b - a).ravel()))
        assert step <= 1e-6 * (float(np.linalg.norm(a.ravel())) + 1) * 1.001
