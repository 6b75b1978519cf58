"""Counter-based threefry2x32 keys, bit-compatible with the reference's
random streams.

The reference draws every mask, probe and noise vector from threefry2x32
keys (the ``threefry_partitionable`` layout).  This module reproduces
those streams bit for bit, so that masks, coverage, communication counts
and the realized coverage minimum come out exactly equal in the port:

* a key is a ``numpy.uint32`` array of shape ``(..., 2)``; key
  derivation (``PRNGKey``, ``split``, ``fold_in``) runs on the host, so a
  round's ``fold_in(k_loop, t)`` costs no device sync;
* ``bits`` hashes the flat element index of the requested shape (split
  into hi/lo 32-bit words) under the key and XORs the two output words —
  this is the only part that runs on the device;
* ``uniform``, ``normal``, ``bernoulli``, ``rademacher`` and
  ``permutation`` are built from ``bits`` exactly as the reference builds
  them (mantissa fill for uniforms, the f32 Giles ``erfinv`` polynomial
  for normals, repeated stable sorts on 32-bit keys for permutations).

A torch ``uint32`` lacks most operators, so the words live in ``int64``
tensors masked to 32 bits.  A batch of keys (shape ``(K, 2)``) draws K
independent streams in one call, each over the full requested shape.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 24   # elements hashed per device pass (bounds int64 temporaries)

# f32 Giles erfinv coefficients, |w| < 5 and |w| >= 5 branches
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on int64 words holding uint32 values.

    Works on numpy int64 arrays and torch int64 tensors alike (only
    ``+ & ^ | << >>`` are used)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def as_key(key) -> np.ndarray:
    """Validate and normalise a key (or stacked keys) to uint32 (..., 2)."""
    k = np.asarray(key)
    if k.shape[-1:] != (2,) or not (np.issubdtype(k.dtype, np.integer)):
        raise TypeError(f"a key is an integer array of shape (..., 2), "
                        f"got {k.dtype} {k.shape}")
    return k.astype(np.uint32)


def _words(key):
    k = as_key(key).astype(np.int64)
    return k[..., 0], k[..., 1]


def PRNGKey(seed: int) -> np.ndarray:
    """Key from an integer seed: the seed's high and low 32-bit words."""
    s = int(seed)
    if not -(1 << 31) <= s < (1 << 32):
        raise ValueError(f"seed {seed} must fit in 32 bits")
    return np.array([0, s & _M32], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """(..., 2) keys -> (..., num, 2): threefry of the counters 0..num-1."""
    k1, k2 = _words(key)
    lo = np.arange(int(num), dtype=np.int64)
    b1, b2 = _threefry2x32(k1[..., None], k2[..., None],
                           np.zeros_like(lo), lo)
    return np.stack([b1, b2], axis=-1).astype(np.uint32)


def fold_in(key, data) -> np.ndarray:
    """Mix the integer(s) ``data`` into ``key``; broadcasts over both."""
    k1, k2 = _words(key)
    d = np.asarray(data, np.int64) & _M32
    b1, b2 = _threefry2x32(k1, k2, np.zeros_like(d), d)
    return np.stack(np.broadcast_arrays(b1, b2), axis=-1).astype(np.uint32)


def _device(device) -> torch.device:
    if device is None:
        raise ValueError("random draws need an explicit device")
    return torch.device(device)


def bits(key, shape, device) -> torch.Tensor:
    """32-bit random words as int64, shape ``key.shape[:-1] + shape``.

    Element j of each key's stream hashes the counter (j >> 32, j & M)
    and XORs the two output words."""
    dev = _device(device)
    shape = tuple(int(s) for s in shape)
    k1, k2 = _words(key)
    batch = k1.shape
    n_keys = int(np.prod(batch, dtype=np.int64))
    size = math.prod(shape)
    total = n_keys * size
    out = torch.empty(total, dtype=torch.int64, device=dev)
    if total and n_keys > 1:   # a host-to-device copy of the key words
        k1_t = torch.as_tensor(k1.reshape(-1), device=dev)
        k2_t = torch.as_tensor(k2.reshape(-1), device=dev)
    for a in range(0, total, _CHUNK):
        p = torch.arange(a, min(a + _CHUNK, total), dtype=torch.int64,
                         device=dev)
        if n_keys == 1:        # Python ints: no copy, no stream sync
            c, w1, w2 = p, int(k1.reshape(-1)[0]), int(k2.reshape(-1)[0])
        else:
            kid = torch.div(p, size, rounding_mode="floor")
            c = p - kid * size
            w1, w2 = k1_t[kid], k2_t[kid]
        b1, b2 = _threefry2x32(w1, w2, c >> 32, c & _M32)
        out[a:a + p.numel()] = b1 ^ b2
    return out.reshape(tuple(batch) + shape)


def _f32(v) -> float:
    """``v`` rounded to f32, as the Python scalar torch casts back exactly."""
    return float(np.float32(v))


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """Words -> floats in [0, 1): random mantissa under exponent 0."""
    fb = ((b >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(key, shape, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval).

    The reference scales with one fused multiply-add (``u·(hi−lo)+lo``
    rounded once); the product is exact in float64, so computing there and
    rounding to f32 reproduces it."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = _unit_floats(bits(key, shape, device)).to(torch.float64)
    scaled = (f * float(hi - lo) + float(lo)).to(torch.float32)
    return torch.clamp_min(scaled, _f32(lo))


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """The f32 Giles polynomial erfinv, with ``w = -log1p(-x²)``."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w_lt = w - 2.5
    w_ge = torch.sqrt(w) - 3.0
    p_lt = torch.full_like(x, _f32(_ERFINV_LT5[0]))
    p_ge = torch.full_like(x, _f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p_lt = p_lt * w_lt + _f32(c_lt)
        p_ge = p_ge * w_ge + _f32(c_ge)
    out = torch.where(lt, p_lt, p_ge) * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal(key, shape, device) -> torch.Tensor:
    """f32 standard normals: √2·erfinv(u), u uniform on (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, device, minval=lo, maxval=1.0)
    return _erfinv_f32(u) * _f32(math.sqrt(2.0))


def bernoulli(key, p: float, shape, device) -> torch.Tensor:
    return uniform(key, shape, device) < _f32(p)


def rademacher(key, shape, device) -> torch.Tensor:
    """±1 f32 draws: 2·bernoulli(0.5) − 1."""
    return 2.0 * bernoulli(key, 0.5, shape, device).to(torch.float32) - 1.0


def permutation(key, n: int, device) -> torch.Tensor:
    """Random permutation(s) of ``arange(n)`` (int64).

    ``ceil(3·ln n / ln(2³²−1))`` rounds of: split the key, draw 32-bit
    sort keys, stable-sort.  A (K, 2) key batch gives (K, n)."""
    k = as_key(key)
    n = int(n)
    dev = _device(device)
    x = torch.arange(n, device=dev).expand(*k.shape[:-1], n).clone()
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        pair = split(k)
        k, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(bits(sub, (n,), dev), dim=-1, stable=True)[1]
        x = torch.gather(x, -1, order)
    return x

