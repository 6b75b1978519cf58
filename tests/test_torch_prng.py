"""repro_torch.prng reproduces the reference's random streams: keys,
bits, uniforms, Rademacher/Bernoulli draws and permutations bit for bit,
normals to a few ulp (the f32 erfinv polynomial runs on another log1p)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

SEEDS = [0, 1, 7, 42, 12345, 2**31 - 1]
SHAPES = [(1,), (2,), (7,), (3, 5), (4, 129), (2, 3, 17)]


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(np.asarray(jk), tk)
    for num in (2, 3, 16):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, num)),
                                      prng.split(tk, num))
    for t in (0, 1, 7, 30, 2**31 - 1, np.int32(5)):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(jk, t)),
                                      prng.fold_in(tk, t))


def test_fold_in_with_traced_round_index_matches_python_int():
    """The scan engine folds a traced int32 t; the port folds Python ints."""
    jk, tk = _key(3)
    traced = jax.jit(lambda k, t: jax.random.fold_in(k, t))
    for t in range(1, 12):
        np.testing.assert_array_equal(
            np.asarray(traced(jk, jnp.int32(t))), prng.fold_in(tk, t))


def test_fold_in_broadcasts_over_data_and_keys():
    jk, tk = _key(11)
    rows = np.arange(9)
    want = np.stack([np.asarray(jax.random.fold_in(jk, r)) for r in rows])
    np.testing.assert_array_equal(prng.fold_in(tk, rows), want)
    ks = prng.split(tk, 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 5))(
        jax.random.split(jk, 4)))
    np.testing.assert_array_equal(prng.fold_in(ks, 5), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 42])
def test_bits_and_uniform_bit_exact(seed, shape):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64),
        prng.bits(tk, shape, "cpu").numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, shape)),
                                  prng.uniform(tk, shape, "cpu").numpy())
    for lo, hi in ((-0.5, 0.5), (0.25, 0.75), (0.1, 3.0)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi)),
            prng.uniform(tk, shape, "cpu", minval=lo, maxval=hi).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_within_4_ulp(shape):
    for seed in (0, 3, 99):
        jk, tk = _key(seed)
        assert _ulp(jax.random.normal(jk, shape),
                    prng.normal(tk, shape, "cpu").numpy()) <= 4


def test_normal_many_draws_within_4_ulp():
    jk, tk = _key(5)
    assert _ulp(jax.random.normal(jk, (65536,)),
                prng.normal(tk, (65536,), "cpu").numpy()) <= 4


@pytest.mark.parametrize("shape", SHAPES)
def test_rademacher_and_bernoulli_bit_exact(shape):
    jk, tk = _key(8)
    np.testing.assert_array_equal(
        np.asarray(jax.random.rademacher(jk, shape, dtype=jnp.float32)),
        prng.rademacher(tk, shape, "cpu").numpy())
    for p in (0.1, 0.5, 0.9):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(jk, p, shape)),
            prng.bernoulli(tk, p, shape, "cpu").numpy())


@pytest.mark.parametrize("n", [1, 2, 5, 64, 1000, 2000])
def test_permutation_bit_exact(n):
    """n = 2000 takes two sort rounds (ceil(3 ln n / ln(2^32 - 1)) = 2)."""
    for seed in (0, 1, 2):
        jk, tk = _key(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(jk, n)),
            prng.permutation(tk, n, "cpu").numpy())


def test_batched_keys_match_vmapped_draws():
    jk, tk = _key(21)
    jks, tks = jax.random.split(jk, 5), prng.split(tk, 5)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3, 4)))(jks)),
        prng.uniform(tks, (3, 4), "cpu").numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 9))(jks)),
        prng.permutation(tks, 9, "cpu").numpy())
    assert _ulp(jax.vmap(lambda k: jax.random.normal(k, (33,)))(jks),
                prng.normal(tks, (33,), "cpu").numpy()) <= 4


def test_bits_chunking_is_invisible(monkeypatch):
    """Streams hashed in several device passes equal one pass."""
    _, tk = _key(4)
    whole = prng.bits(prng.split(tk, 3), (50,), "cpu")
    monkeypatch.setattr(prng, "_CHUNK", 7)
    np.testing.assert_array_equal(
        prng.bits(prng.split(tk, 3), (50,), "cpu").numpy(), whole.numpy())


def test_keys_are_validated():
    with pytest.raises(TypeError):
        prng.as_key(np.zeros(3, np.uint32))
    with pytest.raises(ValueError):
        prng.PRNGKey(2**40)
    with pytest.raises(ValueError):
        prng.bits(prng.PRNGKey(0), (2,), None)
