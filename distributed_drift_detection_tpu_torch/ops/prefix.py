"""Float32 arithmetic as the JAX package's CPU lowering does it.

The zoo's window statistics are held bit for bit against the JAX package,
so their plain versions reproduce three facts about XLA on the CPU
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
