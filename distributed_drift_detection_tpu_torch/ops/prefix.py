"""Float32 arithmetic as the JAX package's CPU lowering does it.

The zoo's window statistics are held bit for bit against the JAX package,
so their plain versions reproduce these facts about XLA on the CPU
(measured against its outputs):

* :func:`associative_scan` evaluates ``lax.associative_scan``'s combine
  tree — the recursive odd/even pairing of
  ``jax/_src/lax/control_flow/loops.py`` ``associative_scan._scan`` — so a
  scan whose combine rounds gives the same bits;
* XLA contracts ``a*b + c`` into one fused multiply-add wherever the
  product has one use (the Page–Hinkley and HDDM-W composes and their
  final application, EDDM's variance, ADWIN's cut bound): :func:`fma`
  computes it with one rounding;
* XLA rewrites ``x / const`` into ``x * f32(1/const)``: :func:`div_const`;
* XLA's CPU float32 ``log`` is a Cephes polynomial with fused
  multiply-adds, not correctly rounded: :func:`xla_log` computes it
  operation for operation;
* XLA on the CPU flushes subnormal results to zero: :func:`ftz`, applied
  where a product can underflow (a scan's running product of forgetting
  factors, ``α^k`` or ``(1−λ)^k``, underflows after some hundreds of
  elements) and in :func:`fma`.

A Python scalar divided by a tensor must not be written ``s / t``:
``Tensor.__rtruediv__`` is a reciprocal times ``s``. :func:`rdiv` divides.
"""

from __future__ import annotations

import numpy as np
import torch


def f32(x: float) -> float:
    """``x`` rounded to float32 (the JAX package's weak-typed scalars)."""
    return float(np.float32(x))


_FLT_MIN = float(np.finfo(np.float32).tiny)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """``x`` with subnormal values flushed to a zero of the same sign."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def fma(a, b, c) -> torch.Tensor:
    """``a*b + c`` rounded once to float32, as a fused multiply-add.

    The product of two f32 values is exact in float64; the sum is rounded
    to odd there (round to nearest, then one ulp toward the exact value
    when inexact and even), and round-to-odd in 53 bits followed by round
    to nearest in 24 is the correctly rounded result; a subnormal result
    is flushed to zero. Operands broadcast; scalars are taken as
    float32."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = torch.broadcast_tensors(*(
        x.double() if isinstance(x, torch.Tensor)
        else torch.tensor(f32(x), dtype=torch.float64, device=ref.device)
        for x in (a, b, c)
    ))
    s = a * b
    t = s + c
    bb = t - s
    err = (s - (t - bb)) + (c - bb)  # TwoSum: t + err == s + c exactly
    even = (t.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(t.dtype)
    t = torch.where((err != 0) & even, torch.nextafter(t, toward), t)
    return ftz(t.float())


# XLA's CPU float32 log (xla/service/cpu/polynomial_approximations.cc
# GenerateVF32Log, a port of Cephes' logf) with the fused multiply-adds its
# LLVM lowering forms: the nine-term polynomial in three chains, each
# multiply-add fused, and the tail's multiply-adds fused where the product
# has one use.
_LOG_P = tuple(f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
))
_LOG_Q1, _LOG_Q2 = f32(-2.12194440e-4), f32(0.693359375)
_SQRT_HALF = f32(0.707106781186547524)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """``ln x`` for normal float32 ``x > 0``, bit for bit as XLA on the CPU
    computes ``jnp.log``: ``x = m·2^e`` with ``m`` in [√½, √2), then
    ``ln m`` by Cephes' polynomial in ``m − 1``, plus ``e·ln 2`` in two
    parts."""
    bits = x.float().view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    lo = m < _SQRT_HALF
    e = e - lo.float()
    r = (m - 1.0) + torch.where(lo, m, torch.zeros_like(m))
    r2 = r * r
    r3 = r2 * r
    p = _LOG_P
    y = fma(fma(r, p[0], p[1]), r, p[2])
    y1 = fma(fma(r, p[3], p[4]), r, p[5])
    y2 = fma(fma(r, p[6], p[7]), r, p[8])
    y = fma(fma(y, r3, y1), r3, y2)
    y = fma(y, r3, _LOG_Q1 * e)
    r = fma(-r2, 0.5, r)
    return fma(_LOG_Q2, e, r + y)


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c``, as XLA lowers it: ``x * f32(1/c)``."""
    return x * f32(1.0 / c)


def rdiv(s: float, t: torch.Tensor) -> torch.Tensor:
    """IEEE ``s / t`` for a Python scalar ``s`` (float32)."""
    return torch.full_like(t, f32(s)) / t


def associative_scan(fn, elems: tuple) -> tuple:
    """Inclusive scan of the tuple ``elems`` (tensors of equal shape) along
    the last axis with the associative ``fn(earlier, later)``, evaluating
    exactly ``lax.associative_scan``'s combine tree: combine adjacent
    pairs, scan the pairs recursively, then combine each odd prefix with
    the next even element."""
    n = elems[0].shape[-1]
    if n < 2:
        return tuple(elems)
    odd = associative_scan(
        fn, fn(tuple(e[..., 0:-1:2] for e in elems), tuple(e[..., 1::2] for e in elems))
    )
    if n % 2 == 0:
        even = fn(tuple(e[..., :-1] for e in odd), tuple(e[..., 2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[..., 2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        o = torch.empty_like(e)
        o[..., 0] = e[..., 0]
        o[..., 2::2] = ev
        o[..., 1::2] = od
        out.append(o)
    return tuple(out)
