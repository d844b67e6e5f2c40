// threefry2x32 and jax.random.normal's and uniform's float32 maps, bit for
// bit, on the card.
//
// The device twin of utils/threefry.py (jax 0.9.0, jax_threefry_partitionable
// on): a key is two uint32 words; split(key, n)[i] and random_bits(key,
// shape) at flat index i hash the counter pair (i >> 32, i & 0xFFFFFFFF).
// normal's value at i is the uniform u = unit·2 + lo in (−1, 1) from the top
// 23 bits of bits1 ^ bits2, then XLA's CPU float32 erf_inv(u) — log1p of
// −u·u (Cephes' rational below |x| = √2 − 1, Cephes' logf of 1 + x above,
// as XLA's CPU backend lowers them, with the fused multiply-adds of its LLVM
// code), Giles' two nine-term polynomials — times a factor: f32(√2) for
// jax.random.normal, f32(√2·scale) for a jitted scale * normal (XLA folds
// the two constants). Every operation is an explicit round-to-nearest
// intrinsic; a file that includes this header builds with -fmad=false
// -ftz=true (XLA on the CPU flushes subnormals), so nvcc contracts nothing
// on its own. Checked bit for bit against utils/threefry.py, which matches
// JAX on all 2^23 values the uniform can take (tests/test_torch_threefry.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace threefry {

struct Pair {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The Threefry-2x32 hash, 20 rounds, of the counters (x1, x2) under key k.
__device__ __forceinline__ Pair hash(Pair k, uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, rot[i & 1][j]);
      x2 ^= x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {x1, x2};
}

// split(key, n)[i] for i < 2^32.
__device__ __forceinline__ Pair split(Pair k, uint32_t i) { return hash(k, 0u, i); }

// fold_in(key, data): the hash of the counter pair (0, data), as
// jax.random.fold_in hashes a 32-bit data word.
__device__ __forceinline__ Pair fold_in(Pair k, uint32_t data) { return hash(k, 0u, data); }

// random_bits(key, shape) at flat index i (32-bit).
__device__ __forceinline__ uint32_t bits(Pair k, uint64_t i) {
  const Pair h = hash(k, static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i));
  return h.a ^ h.b;
}

// Cephes' logf as XLA's CPU backend emits it (ops/prefix.py xla_log): for
// normal x > 0.
__device__ __forceinline__ float xla_logf(float x) {
  const int bits_x = __float_as_int(x);
  float e = __fadd_rn(static_cast<float>((bits_x >> 23) - 0x7F), 1.0f);
  const float m = __int_as_float((bits_x & ~0x7F800000) | 0x3F000000);
  const bool lo = m < 0.707106781186547524f;
  e = __fsub_rn(e, lo ? 1.0f : 0.0f);
  const float r = __fadd_rn(__fadd_rn(m, -1.0f), lo ? m : 0.0f);
  const float r2 = __fmul_rn(r, r);
  const float r3 = __fmul_rn(r2, r);
  float y = __fmaf_rn(__fmaf_rn(r, 7.0376836292e-2f, -1.1514610310e-1f), r, 1.1676998740e-1f);
  const float y1 =
      __fmaf_rn(__fmaf_rn(r, -1.2420140846e-1f, 1.4249322787e-1f), r, -1.6668057665e-1f);
  const float y2 =
      __fmaf_rn(__fmaf_rn(r, 2.0000714765e-1f, -2.4999993993e-1f), r, 3.3333331174e-1f);
  y = __fmaf_rn(__fmaf_rn(y, r3, y1), r3, y2);
  y = __fmaf_rn(y, r3, __fmul_rn(-2.12194440e-4f, e));
  const float rr = __fmaf_rn(-r2, 0.5f, r);
  return __fmaf_rn(0.693359375f, e, __fadd_rn(rr, y));
}

// XLA's CPU float32 log1p of x in (−1, 0].
__device__ __forceinline__ float xla_log1pf(float x) {
  if (fabsf(x) < 0.41421356237309504880f) {
    const float x2 = __fmul_rn(x, x);
    const float zero = __fmul_rn(x, 0.0f);
    float num = __fadd_rn(zero, 4.5270000862445199635215e-5f);
    num = __fmaf_rn(num, x, 4.9854102823193375972212e-1f);
    num = __fmaf_rn(num, x, 6.5787325942061044846969e0f);
    num = __fmaf_rn(num, x, 2.9911919328553073277375e1f);
    num = __fmaf_rn(num, x, 6.0949667980987787057556e1f);
    num = __fmaf_rn(num, x, 5.7112963590585538103336e1f);
    num = __fmaf_rn(num, x, 2.0039553499201281259648e1f);
    float den = __fadd_rn(zero, 1.0f);
    den = __fmaf_rn(den, x, 1.5062909083469192043167e1f);
    den = __fmaf_rn(den, x, 8.3047565967967209469434e1f);
    den = __fmaf_rn(den, x, 2.2176239823732856465394e2f);
    den = __fmaf_rn(den, x, 3.0909872225312059774938e2f);
    den = __fmaf_rn(den, x, 2.1642788614495947685003e2f);
    den = __fmaf_rn(den, x, 6.0118660497603843919306e1f);
    const float cubic = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den));
    return __fadd_rn(x, __fmaf_rn(x2, -0.5f, cubic));
  }
  return xla_logf(__fadd_rn(x, 1.0f));
}

// XLA's CPU float32 erf_inv of x in (−1, 1), as normal calls it.
__device__ __forceinline__ float xla_erfinvf(float x) {
  const float lg = xla_log1pf(__fmul_rn(x, -x));  // w = −lg
  float p, t;
  if (lg > -5.0f) {
    t = __fsub_rn(-2.5f, lg);
    p = 2.81022636e-08f;
    p = __fmaf_rn(p, t, 3.43273939e-07f);
    p = __fmaf_rn(p, t, -3.5233877e-06f);
    p = __fmaf_rn(p, t, -4.39150654e-06f);
    p = __fmaf_rn(p, t, 0.00021858087f);
    p = __fmaf_rn(p, t, -0.00125372503f);
    p = __fmaf_rn(p, t, -0.00417768164f);
    p = __fmaf_rn(p, t, 0.246640727f);
    p = __fmaf_rn(p, t, 1.50140941f);
  } else {
    t = __fadd_rn(__fsqrt_rn(-lg), -3.0f);
    p = -0.000200214257f;
    p = __fmaf_rn(p, t, 0.000100950558f);
    p = __fmaf_rn(p, t, 0.00134934322f);
    p = __fmaf_rn(p, t, -0.00367342844f);
    p = __fmaf_rn(p, t, 0.00573950773f);
    p = __fmaf_rn(p, t, -0.0076224613f);
    p = __fmaf_rn(p, t, 0.00943887047f);
    p = __fmaf_rn(p, t, 1.00167406f);
    p = __fmaf_rn(p, t, 2.83297682f);
  }
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(x, p);
}

// jax.random.uniform(key, shape, float32, minval, maxval) at flat index i:
// the [0, 1) float of the top 23 bits, then max(unit·(maxval − minval) +
// minval, minval) with the multiply-add fused, as XLA's CPU lowering fuses
// it (utils/threefry.py `uniform`).
__device__ __forceinline__ float uniform(Pair k, uint64_t i, float minval, float maxval) {
  const float unit = __fadd_rn(__uint_as_float((bits(k, i) >> 9) | 0x3F800000u), -1.0f);
  return fmaxf(__fmaf_rn(unit, __fsub_rn(maxval, minval), minval), minval);
}

// erf_inv(u) for the uniform u of normal(key, shape) at flat index i: the
// normal before its factor.
__device__ __forceinline__ float normal_erfinv(Pair k, uint64_t i) {
  const float unit = __fadd_rn(__uint_as_float((bits(k, i) >> 9) | 0x3F800000u), -1.0f);
  const float lo = __int_as_float(0xBF7FFFFF);  // nextafter(−1, 0)
  const float u = fmaxf(__fadd_rn(__fmul_rn(unit, 2.0f), lo), lo);
  return xla_erfinvf(u);
}

// erf_inv(u) · factor for the uniform u of normal(key, shape) at flat
// index i: jax.random.normal's value at factor = f32(√2).
__device__ __forceinline__ float normal(Pair k, uint64_t i, float factor) {
  return __fmul_rn(normal_erfinv(k, i), factor);
}

// jax.random.randint(key, shape, 0, span) at flat index i, for 1 <= span <
// 2^31: k1, k2 = split(key); 32 bits from each; (hi mod span · (2^32 mod
// span) + lo mod span) mod span in uint32 arithmetic (utils/threefry.py
// `randint`).
__device__ __forceinline__ uint32_t randint(Pair k, uint64_t i, uint32_t span) {
  const uint32_t high = bits(split(k, 0u), i), low = bits(split(k, 1u), i);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  return ((high % span) * mult + low % span) % span;
}

}  // namespace threefry
