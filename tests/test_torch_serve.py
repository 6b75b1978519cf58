"""The port's serving driver against the reference's, on the CPU.

``generate`` (prefill, then greedy decode) against the reference's
``prefill_step``/``serve_step`` loop on the same parameters and the same
numpy prompt: the greedy tokens must be equal.  The CLI runs the smoke
variant on the host with ``--device cpu``, and refuses to fall back to
the host without it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models.io import decode_window as jdecode_window  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401


def _reference_loop(params, prompt, cfg, gen):
    """The prefill-then-decode loop of the reference's ``serve.run``."""
    P = prompt.shape[1]
    total = P + gen
    logits, cache = jserve.prefill_step(params, {"tokens": prompt}, cfg,
                                        q_chunk=min(1024, P),
                                        kv_chunk=min(1024, P))
    if not cfg.attn_free:
        cache = jserve.pad_cache(cache, total)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    window = jdecode_window(cfg, total)
    for i in range(gen - 1):
        tok, cache = jserve.serve_step(params, cache, tok, jnp.int32(P + i),
                                       cfg, window=window,
                                       kv_chunk=min(1024, total))
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "rwkv6-3b"])
def test_generate_matches_reference_serve_loop(arch):
    jcfg = jsmoke(jget_config(arch))
    tcfg = smoke_variant(get_config(arch))
    jp = jinit(jcfg, jax.random.PRNGKey(4))
    tp = interop.model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    want = _reference_loop(jp, jnp.asarray(prompt), jcfg, gen=6)
    got, times = serve.generate(tp, {"tokens": torch.tensor(prompt)}, tcfg, 6)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(times) == {"prefill_s", "decode_s"}
    assert all(v >= 0 for v in times.values())


def test_pad_cache_matches_reference():
    rng = np.random.default_rng(0)
    cache = {"layers": {"attn": {
        "k": rng.normal(size=(2, 1, 5, 2, 4)).astype(np.float32),
        "v": rng.normal(size=(2, 1, 5, 2, 4)).astype(np.float32),
        "slot_pos": np.tile(np.arange(5, dtype=np.int32), (2, 1))}}}
    want = jserve.pad_cache(jax.tree.map(jnp.asarray, cache), 9)
    got = serve.pad_cache(
        {"layers": {"attn": {k: torch.tensor(v) for k, v in
                             cache["layers"]["attn"].items()}}}, 9)
    for k in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(got["layers"]["attn"][k].numpy(),
                                      np.asarray(want["layers"]["attn"][k]))


def test_cli_serves_the_smoke_variant_on_the_host(capsys):
    gen = serve.run(["--device", "cpu", "--arch", "phi4-mini-3.8b",
                     "--batch", "2", "--prompt-len", "12", "--gen", "5"])
    assert gen.shape == (2, 5) and gen.dtype == torch.int32
    out = capsys.readouterr().out
    assert "prefill 2x12" in out and "decode 4 steps" in out
    assert "generated:" in out


def test_cli_default_arch_and_smoke_flag():
    cfg = smoke_variant(get_config("rwkv6-3b"))
    gen = serve.run(["--device", "cpu", "--gen", "3", "--prompt-len", "8",
                     "--batch", "1", "--smoke"])
    assert gen.shape == (1, 3)
    assert int(gen.max()) < cfg.vocab_size


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(["--gen", "2", "--prompt-len", "4"])


def test_cli_no_smoke_selects_the_published_config(monkeypatch):
    """``--no-smoke`` serves the config at full width: stop at the first
    step that would allocate it and check what it was handed."""
    seen = {}

    def stop(cfg, generator, dtype):
        seen.update(cfg=cfg, dtype=dtype)
        raise KeyboardInterrupt

    monkeypatch.setattr(serve, "init_model", stop)
    with pytest.raises(KeyboardInterrupt):
        serve.run(["--device", "cpu", "--no-smoke", "--arch",
                   "phi4-mini-3.8b"])
    assert seen["cfg"] == get_config("phi4-mini-3.8b")
    assert seen["dtype"] == torch.bfloat16
