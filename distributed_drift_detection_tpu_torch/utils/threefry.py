"""``jax.random``'s default PRNG, threefry2x32, bit for bit.

The port's twin of ``jax.random`` as jax 0.9.0 runs it with
``jax_threefry_partitionable`` on (its default): a key is two uint32 words
(``jax.random.key_data``), and ``split(key, n)`` and ``random_bits(key,
shape)`` hash the 64-bit flat index ``i`` of each output as the counter
pair ``(i >> 32, i & 0xFFFFFFFF)``. The hash is 32-bit add, rotate and
xor only, so it ports exactly.

Two forms share one hash (:func:`threefry2x32`): numpy ``uint32`` arrays,
for the engines' key chains on the host (:func:`window_fit_keys`,
:func:`loop_fit_keys`), and torch ``int64`` tensors holding uint32 values,
for the plain versions of the kernels. Keys are ``[..., 2]`` arrays or
tensors; every function takes either and answers in the same form.
:func:`uniform` and :func:`normal` answer with float32 tensors.

:func:`normal` reproduces XLA's CPU float32 ``erf_inv`` step for step
(``xla_erf_inv``): the uniform ``u`` in (−1, 1), ``w = −log1p(−u·u)``
with XLA's ``log1p`` (Cephes' rational below |x| = √2 − 1, its ``log(1 +
x)`` above), the two nine-term polynomials at ``w < 5`` with the fused
multiply-adds of XLA's lowering, ``p·u``, then ``×√2``. The uniform can
take 2^23 values, so the map is checked against JAX on each of them
(``tests/test_torch_threefry.py``). ``csrc/threefry.cuh`` is the same
arithmetic on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..ops.prefix import f32, fma, ftz, xla_log

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counters ``(x1, x2)``
    under the key ``(k1, k2)``, all broadcast together: numpy uint32
    arrays, or torch int64 tensors of values in [0, 2^32)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = ((x2 << r) & M32) | (x2 >> (32 - r))
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def _is_numpy(key) -> bool:
    return not isinstance(key, torch.Tensor)


def _words(key):
    """``key [..., 2]`` as its two words, shaped ``[..., 1]`` to broadcast
    against a flat counter axis."""
    if _is_numpy(key):
        key = np.asarray(key, dtype=np.uint32)
    else:
        key = key.long() & M32
    return key[..., 0:1], key[..., 1:2]


def _counters(key, n: int):
    """The flat indices ``0 .. n−1`` as the counter pair ``(hi, lo)``."""
    if _is_numpy(key):
        i = np.arange(n, dtype=np.uint64)
        return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(M32)).astype(np.uint32)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return i >> 32, i & M32


def _hash_flat(key, n: int):
    """``threefry2x32(key, counters of 0 .. n−1)`` → two ``[..., n]``."""
    k1, k2 = _words(key)
    hi, lo = _counters(key, n)
    return threefry2x32(k1, k2, hi, lo)


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))``: ``[2]`` uint32 — the
    seed as a 32-bit integer (as JAX takes it without x64), high word 0."""
    s = int(seed)
    if not -(2**31) <= s < 2**31:
        raise OverflowError(f"seed {seed} is out of the int32 range")
    return np.array([0, s & M32], dtype=np.uint32)


def split(key, n: int = 2):
    """``jax.random.split``: ``key [..., 2]`` → ``[..., n, 2]``."""
    b1, b2 = _hash_flat(key, int(n))
    if _is_numpy(key):
        return np.stack([b1, b2], axis=-1)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    ``(0, data)`` under ``key`` (``threefry_2x32(key, threefry_seed(data))``
    for a 32-bit ``data``). ``key [..., 2]`` and ``data`` (an integer, array
    or tensor of values in [0, 2^32)) broadcast; answers ``[..., 2]`` in the
    key's form."""
    k1, k2 = _words(key)
    if _is_numpy(key):
        d = np.asarray(data, dtype=np.int64).astype(np.uint32)[..., None]
        zero = np.zeros_like(d)
        b1, b2 = threefry2x32(k1, k2, zero, d)
        return np.stack(np.broadcast_arrays(b1, b2), axis=-1)[..., 0, :]
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device)[..., None] & M32
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    b1, b2 = torch.broadcast_tensors(b1, b2)
    return torch.stack([b1, b2], dim=-1)[..., 0, :]


def bits_at(key, counters):
    """``random_bits(key, shape)`` at the flat indices ``counters`` (values in
    [0, 2^32)): ``key [..., 2]`` broadcasts against ``counters [..., n]``;
    torch int64 values in [0, 2^32)."""
    k1, k2 = _words(key)
    c = torch.as_tensor(counters, dtype=torch.int64, device=k1.device) & M32
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(c), c)
    return b1 ^ b2


def unit_floats(bits) -> torch.Tensor:
    """The ``[0, 1)`` float32 of the top 23 of 32 random ``bits`` (int64
    values in [0, 2^32)): ``uniform``'s and ``normal``'s first step."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def random_bits(key, shape):
    """``jax.random.bits(key, shape)`` (32-bit): ``[..., *shape]`` uint32
    (numpy) or int64 values in [0, 2^32) (torch)."""
    shape = tuple(int(d) for d in shape)
    b1, b2 = _hash_flat(key, math.prod(shape))
    bits = b1 ^ b2
    return bits.reshape(tuple(bits.shape[:-1]) + shape)


def _unit_floats(key, shape) -> torch.Tensor:
    """``[1, 2)``'s float32 values from the top 23 bits, minus 1."""
    bits = random_bits(key, shape)
    if _is_numpy(key):
        bits = torch.from_numpy(bits.astype(np.int64))
    return unit_floats(bits)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = f32(minval), f32(maxval)
    u = fma(_unit_floats(key, shape), f32(hi - lo), lo)
    return torch.maximum(u, torch.tensor(lo, dtype=torch.float32, device=u.device))


# XLA's float32 erf_inv (Giles' single-precision polynomials), lowered on
# the CPU as chlo's decomposition: coefficients for w < 5 and for w >= 5.
_ERFINV_LT5 = tuple(f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
))
_ERFINV_GE5 = tuple(f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
))
# XLA's log1p below |x| = √2 − 1: Cephes' rational x − x²/2 + x³·P(x)/Q(x).
_LOG1P_SMALL = f32(0.41421356237309504880)
_LOG1P_NUM = tuple(f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1,
))
_LOG1P_DEN = tuple(f32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1,
))
SQRT2 = f32(math.sqrt(2.0))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p`` of ``x`` in (−1, 0] (every argument
    ``normal`` gives it), operation for operation: the rational form for
    |x| < √2 − 1, else :func:`~..ops.prefix.xla_log` of ``1 + x``."""
    x2 = ftz(x * x)
    zero = x * 0.0
    num = zero + _LOG1P_NUM[0]
    den = zero + _LOG1P_DEN[0]
    for c in _LOG1P_NUM[1:]:
        num = fma(num, x, c)
    for c in _LOG1P_DEN[1:]:
        den = fma(den, x, c)
    cubic = ftz(ftz(x * x2) * (num / den))
    small = x + fma(x2, -0.5, cubic)
    one_plus = x + 1.0
    large = xla_log(torch.where(one_plus > 0, one_plus, torch.ones_like(one_plus)))
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def xla_erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``erf_inv`` of ``x`` in (−1, 1), as ``normal``
    calls it, bit for bit."""
    lg = xla_log1p(ftz(x * -x))  # w = −lg
    lt5 = lg > -5.0
    # the square root correctly rounded (torch's CPU float32 sqrt is not
    # always; the float64 root rounds once more without error)
    root = torch.sqrt(-lg.double()).float()
    t = torch.where(lt5, -2.5 - lg, root - 3.0)
    c = [torch.where(lt5, a, b) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = c[0]
    for ci in c[1:]:
        p = fma(p, t, ci)
    return torch.where(x.abs() == 1.0, x * float("inf"), x * p)


def normal_erf_inv(unit: torch.Tensor) -> torch.Tensor:
    """``erf_inv(u)`` for ``normal``'s ``u = unit·2 + lo`` in (−1, 1), from
    ``unit`` = the ``[0, 1)`` float of the top 23 bits: the normal before
    its factor (:func:`normal_map`)."""
    u = torch.clamp_min(unit * 2.0 + _NORMAL_LO, _NORMAL_LO)  # unit·2 is exact
    return xla_erf_inv(u)


def normal_map(unit: torch.Tensor, factor: float = SQRT2) -> torch.Tensor:
    """``normal``'s float32 value from ``unit`` = the ``[0, 1)`` float of
    the top 23 bits: ``erf_inv(u) · factor`` (:func:`normal_erf_inv`) —
    ``factor`` = f32(√2) is ``jax.random.normal``; a jitted ``scale *
    normal`` is XLA's fold ``factor = f32(√2 · scale)``."""
    return normal_erf_inv(unit) * factor


def normal(key, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``[..., *shape]``."""
    return normal_map(_unit_floats(key, shape))


def random_normal_reference(keys, n: int, factor: float = SQRT2) -> torch.Tensor:
    """``[N, n]`` float32 on the keys' device: row ``k`` is ``normal(keys[k],
    (n,))`` with the factor of :func:`normal_map` — ``jax.random.normal`` at
    the default, ``(f32(√2·scale)/√2)·normal`` as XLA folds a jitted
    ``scale * normal``. ``keys [N, 2]``."""
    return normal_map(_unit_floats(keys, (int(n),)), factor)


# Layers a K8 launch takes (csrc/random_normal.cu kInlineLayers, models/mlp.py
# INLINE_LAYERS); a deeper init takes a launch for each 64.
K8_INLINE_LAYERS = 64


def init_normals_reference(keys, counts, factors, zeros: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`init_normals`, on the keys' device:
    ``split(keys, L)``, then :func:`random_normal_reference` a layer."""
    layer_keys = split(keys, len(counts))  # [P, L, 2]
    parts = [random_normal_reference(layer_keys[:, l], n, factor).reshape(-1)
             for l, (n, factor) in enumerate(zip(counts, factors))]
    parts.append(torch.zeros(int(zeros), dtype=torch.float32, device=layer_keys.device))
    return torch.cat(parts)


@functools.lru_cache(maxsize=64)
def _layer_table(counts: tuple, factors: tuple):
    """A K8 launch's host arrays: the layers' normal counts and factors."""
    return ((ctypes.c_int * len(counts))(*counts),
            (ctypes.c_float * len(factors))(*(f32(x) for x in factors)))


def init_normals(keys: torch.Tensor, counts, factors, zeros: int = 0) -> torch.Tensor:
    """The MLP init's draws in one float32 buffer ``[P·Σ counts + zeros]``:
    layer ``l``'s normals ``[P, counts[l]]`` — row ``p`` the normals of
    ``split(keys[p], L)[l]`` times ``factors[l]``, the factor of
    :func:`normal_map` (``f32(√2·scale)`` for a jitted ``scale * normal``)
    — layer after layer, then ``zeros`` zeros (the biases).

    ``keys [P, 2]`` int32 (uint32 bit patterns) or int64. CUDA tensors
    launch kernel K8 (``csrc/random_normal.cu``), once for every
    :data:`K8_INLINE_LAYERS` layers, adding one to
    ``init_normals.launches`` a launch; CPU tensors run
    :func:`init_normals_reference`."""
    counts = tuple(int(n) for n in counts)
    factors = tuple(float(x) for x in factors)
    if len(counts) != len(factors) or not counts:
        raise ValueError(f"init_normals: {len(counts)} counts and {len(factors)} factors")
    if keys.device.type == "cpu":
        return init_normals_reference(keys, counts, factors, zeros)
    if keys.device.type != "cuda":
        raise ValueError(f"init_normals: unsupported device {keys.device}")
    from .. import kernels

    keys = keys.int().contiguous()
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"init_normals: keys must be [P, 2], got {tuple(keys.shape)}")
    p = keys.shape[0]
    total = p * sum(counts) + int(zeros)
    if not all(0 <= n < 2**31 for n in counts) or int(zeros) < 0 or total >= 2**40:
        raise ValueError(f"init_normals: {p} x {counts} normals and {zeros} zeros is out of range")
    out = torch.empty(total, dtype=torch.float32, device=keys.device)
    fn, stream = kernels.launcher("random_normal"), kernels.stream_handle(keys.device)
    at = out.data_ptr()
    for l0 in range(0, len(counts), K8_INLINE_LAYERS):
        chunk = counts[l0:l0 + K8_INLINE_LAYERS]
        last = l0 + K8_INLINE_LAYERS >= len(counts)
        c_counts, c_factors = _layer_table(chunk, factors[l0:l0 + K8_INLINE_LAYERS])
        code = fn(keys.data_ptr(), p, len(chunk), l0, c_counts, c_factors,
                  int(zeros) if last else 0, at, stream)
        kernels.check("random_normal", code)
        init_normals.launches += 1
        at += 4 * p * sum(chunk)
    return out


init_normals.launches = 0


def fold_chain(keys: np.ndarray, steps: int, width: int, take: int) -> tuple:
    """``steps`` iterations of ``keys, *subs = split(keys, width)`` from
    ``keys [P, 2]``: the chain ``[steps + 1, P, 2]`` (entry ``t`` is the
    key after ``t`` iterations) and the ``take``-th subkey of each
    iteration ``[steps, P, 2]``. Iteration ``t + 1`` hashes only the key
    of iteration ``t`` (counter 0), so the chain runs one hash a step and
    every subkey comes from one hash of the whole chain."""
    keys = np.asarray(keys, dtype=np.uint32)
    chain = np.empty((int(steps) + 1, *keys.shape), np.uint32)
    chain[0] = keys
    zero = np.zeros(keys.shape[:-1], np.uint32)
    k = keys
    for t in range(int(steps)):
        k = np.stack(threefry2x32(k[..., 0], k[..., 1], zero, zero), axis=-1)
        chain[t + 1] = k
    sub = split(chain[:-1], width)[..., take, :]
    return chain, sub


def window_fit_keys(keys: np.ndarray, iters: int, levels: int) -> tuple:
    """The window engine's key chain (``engine/window.py``): each iteration
    ``key, k_fit, k_shuf = split(key, 3)``, then one fit key a level —
    ``k_fit`` itself at one level, else ``split(k_fit, levels)``. Returns
    the chain ``[iters + 1, P, 2]`` and the fit keys ``[iters, levels, P,
    2]``, numpy uint32."""
    chain, k_fit = fold_chain(keys, iters, 3, 1)
    if levels == 1:
        return chain, k_fit[:, None]
    return chain, np.moveaxis(split(k_fit, levels), 2, 1)


def loop_fit_keys(keys: np.ndarray, steps: int) -> tuple:
    """The ``window=1`` engine's key chain (``engine/loop.py``): each step
    ``key, k_shuf, k_fit = split(key, 3)`` — the fit key is the third.
    Returns the chain ``[steps + 1, P, 2]`` and the fit keys ``[steps, P,
    2]``, numpy uint32."""
    return fold_chain(keys, steps, 3, 2)


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _mul32(a, b):
    """``a · b mod 2^32`` of values in [0, 2^32) held in int64 (numpy or
    torch), without a product past 2^49: ``a`` in two 16-bit halves."""
    return (((((a >> 16) * b) & M32) << 16) + (a & 0xFFFF) * b) & M32


def _rem(x, span, where):
    """XLA's unsigned ``rem``: ``x mod span``, and ``x`` where ``span`` is 0."""
    return where(span == 0, x, x % where(span == 0, 1, span))


def randint(key, shape, minval, maxval):
    """``jax.random.randint(key, shape, minval, maxval)`` at its default
    dtype int32 (jax 0.9.0 ``_randint``): ``k1, k2 = split(key)``, 32
    random bits from each, and ``minval + (hi mod span · 2^32 mod span +
    lo mod span) mod span`` in uint32 arithmetic, with ``span = maxval −
    minval`` (1 where ``maxval <= minval``, so ``minval`` comes back; one
    more where ``maxval`` lies past the int32 range). ``key [..., 2]``;
    ``minval`` and ``maxval`` broadcast against ``shape``. Answers int32
    ``[..., *shape]`` in the key's form (numpy, or a torch tensor on its
    device); the uint32 values are held in int64 throughout."""
    shape = tuple(int(d) for d in shape)
    if _is_numpy(key):
        def as_int(v):
            return np.asarray(v, dtype=np.int64)

        where, out = np.where, (lambda v: v.astype(np.int32))
    else:
        def as_int(v):
            return torch.as_tensor(v, dtype=torch.int64, device=key.device)

        where, out = torch.where, (lambda v: v.to(torch.int32))
    lo_v, hi_v = as_int(minval), as_int(maxval)
    out_of_range = hi_v > _I32_MAX
    lo_v = lo_v.clip(_I32_MIN, _I32_MAX)
    hi_v = hi_v.clip(_I32_MIN, _I32_MAX)
    k = split(key, 2)
    high, low = random_bits(k[..., 0, :], shape), random_bits(k[..., 1, :], shape)
    if _is_numpy(key):
        high, low = high.astype(np.int64), low.astype(np.int64)
    span = (hi_v - lo_v) & M32  # the int32 difference, as uint32
    span = where(hi_v <= lo_v, 1, span)
    span = where(out_of_range & (hi_v > lo_v), (span + 1) & M32, span)
    mult = _rem(as_int(1 << 16) + 0 * span, span, where)
    mult = _rem(_mul32(mult, mult), span, where)
    offset = (_mul32(_rem(high, span, where), mult) + _rem(low, span, where)) & M32
    offset = _rem(offset, span, where)
    value = (lo_v + offset) & M32  # the int32 sum, wrapped
    return out(where(value > _I32_MAX, value - (1 << 32), value))
