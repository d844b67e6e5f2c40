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


_SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's split of a float64 into two halves


def _two_product(a: torch.Tensor, b: torch.Tensor):
    """``(p, e)`` with ``p = RN(a·b)`` and ``p + e == a·b`` exactly (Dekker's
    product on Veltkamp's split; float64 operands far from overflow)."""
    p = a * b
    ca, cb = _SPLIT * a, _SPLIT * b
    ah = ca - (ca - a)
    bh = cb - (cb - b)
    al, bl = a - ah, b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """``(s, e)`` with ``s = RN(a + b)`` and ``s + e == a + b`` exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma64(a, b, c) -> torch.Tensor:
    """``a*b + c`` in float64 rounded once, as a fused multiply-add (the
    emulation of Boldo and Melquiond: the exact product ``ph + pl``, the
    exact sum ``sh + sl = c + ph``, then ``RN(sh + RO(sl + pl))`` with the
    inner sum rounded to odd). Operands are float64 tensors or Python
    floats, broadcast; no overflow or underflow (the sine's range)."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = torch.broadcast_tensors(*(
        x.double() if isinstance(x, torch.Tensor)
        else torch.tensor(float(x), dtype=torch.float64, device=ref.device)
        for x in (a, b, c)
    ))
    ph, pl = _two_product(a, b)
    sh, sl = _two_sum(c, ph)
    v, err = _two_sum(sl, pl)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(v.dtype)
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    return sh + v


# The C library's float32 sine (glibc sysdeps/ieee754/flt-32/s_sinf.c, from
# ARM's optimized-routines), which XLA's CPU `sin` calls: its tables
# (sincosf_data.c) and the multiply-adds that its FMA build (__sinf_fma, the
# one an x86-64 host with FMA and AVX2 runs) fuses. Table 1 is table 0 with
# the cosine polynomial negated, for quadrants 2 and 3.
_SIN_SIGN = (1.0, -1.0, -1.0, 1.0)
_SIN_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")  # 2/π · 2^24
_SIN_HPI = float.fromhex("0x1.921fb54442d18p+0")  # π/2
_SIN_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))
_SIN_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041,
)  # 4/π in 192 bits (glibc __inv_pio4)
_SIN_PI63 = float.fromhex("0x1.921fb54442d18p-62")  # π/2 · 2^-62


def _sinf_poly(x, x2, odd, neg_cos):
    """glibc ``sinf_poly`` in its fused form: the odd sine polynomial of
    ``x``, or (``odd``) the even cosine one of ``x2``, negated where
    ``neg_cos`` (table 1)."""
    s1, s2, s3 = _SIN_S
    x3 = x2 * x
    sp = fma64(x2, s3, s2)
    x5 = x2 * x3
    sin = fma64(sp, x5, fma64(x3, s1, x))
    c = torch.where(neg_cos, -1.0, 1.0).double()
    x4 = x2 * x2
    c1 = fma64(x2, c * _SIN_C[1], c * _SIN_C[0])
    cp = fma64(x2, c * _SIN_C[4], c * _SIN_C[3])
    x6 = x2 * x4
    cos = fma64(cp, x6, fma64(x4, c * _SIN_C[2], c1))
    return torch.where(odd, cos, sin)


def xla_sin(x: torch.Tensor) -> torch.Tensor:
    """``sin x`` of finite float32 ``x``, bit for bit as XLA on the CPU
    computes ``jnp.sin``: the C library's ``sinf`` (above). Below 2^-12
    ``x`` itself; below 0.75 the polynomial of ``x``; below 120 a
    reduction by π/2 in float64 with one fused multiply-add; above, the
    exact integer reduction against 4/π's 192 bits. The result is the
    float64 polynomial rounded once to float32."""
    x = x.float()
    bits = x.view(torch.int32).long() & 0xFFFFFFFF
    top = (bits >> 20) & 0x7FF
    xd = x.double()
    # fast reduction: n = round(x·2/π) through a truncation at 2^24 scale
    r = (xd * _SIN_HPI_INV).clamp(-2.0**31, 2.0**31 - 1).to(torch.int32)
    n_fast = (r + 0x800000) >> 24
    red_fast = fma64(-n_fast.double(), _SIN_HPI, xd)
    # large reduction (glibc reduce_large), in int64 two's complement
    tab = torch.tensor(_INV_PIO4, dtype=torch.int64, device=x.device)
    i = (bits >> 26) & 15
    m = (((bits & 0xFFFFFF) | 0x800000) << ((bits >> 23) & 7)) & 0xFFFFFFFF
    res0 = (m * tab[i]) & 0xFFFFFFFF
    res1 = m * tab[i + 4]
    res2 = m * tab[i + 8]
    # (res2 >> 32) | (res0 << 32), + res1, modulo 2^64
    acc = ((res2 >> 32) | (res0 << 32)) + res1
    n_large = ((acc + (1 << 61)) >> 62) & 3
    acc = acc - (n_large << 62)
    red_large = acc.double() * _SIN_PI63
    sign = bits >> 31
    large = top > 0x42E
    n = torch.where(large, n_large, n_fast.long())
    q = torch.where(large, n + sign, n)
    red = torch.where(large, red_large, red_fast)
    small = top <= 0x3F3
    red = torch.where(small, xd, red)
    q = torch.where(small, torch.zeros_like(q), q)
    n = torch.where(small, torch.zeros_like(n), n)
    sgn = torch.tensor(_SIN_SIGN, dtype=torch.float64, device=x.device)[q & 3]
    xr = red * sgn
    out = _sinf_poly(xr, red * red, (n & 1) == 1, (q & 2) == 2).float()
    return torch.where(top <= 0x397, x, out)


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
