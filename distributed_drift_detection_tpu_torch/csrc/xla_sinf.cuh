// The float32 sine as XLA on the CPU computes jnp.sin, bit for bit, on the
// card: the C library's sinf (glibc sysdeps/ieee754/flt-32/s_sinf.c, from
// ARM's optimized-routines), with the tables of its sincosf_data.c and the
// fused multiply-adds of its FMA build (__sinf_fma, the one an x86-64 host
// with FMA and AVX2 runs, read off its machine code).
//
// Below |x| = 2^-12 the result is x; below 0.75 the polynomial of x; below
// 120 x is reduced by π/2 in double with one fused multiply-add, n =
// ((int)(x·2/π·2^24) + 2^23) >> 24; above, the exact integer reduction
// against 192 bits of 4/π. The odd sine polynomial (or, in odd quadrants,
// the even cosine one, negated in quadrants 2 and 3) is evaluated in double
// and rounded once to float. Every double operation is an explicit
// round-to-nearest intrinsic, so the header does not depend on -fmad. The
// plain twin is ops/prefix.py `xla_sin`.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xla_sinf_detail {

__device__ __constant__ uint32_t kInvPio4[24] = {
    0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
    0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

constexpr double kHpiInv = 0x1.45f306dc9c883p+23;  // 2/π · 2^24
constexpr double kHpi = 0x1.921fb54442d18p+0;      // π/2
constexpr double kPi63 = 0x1.921fb54442d18p-62;    // π/2 · 2^-62
constexpr double kS1 = -0x1.555545995a603p-3;
constexpr double kS2 = 0x1.1107605230bc4p-7;
constexpr double kS3 = -0x1.994eb3774cf24p-13;
constexpr double kC0 = 0x1p0;
constexpr double kC1 = -0x1.ffffffd0c621cp-2;
constexpr double kC2 = 0x1.55553e1068f19p-5;
constexpr double kC3 = -0x1.6c087e89a359dp-10;
constexpr double kC4 = 0x1.99343027bf8c3p-16;

// glibc sinf_poly: x the signed reduced argument, x2 its square, n the
// quadrant (odd: cosine), neg the negated cosine table (quadrants 2, 3).
__device__ __forceinline__ float poly(double x, double x2, int n, bool neg) {
  if ((n & 1) == 0) {
    const double x3 = __dmul_rn(x2, x);
    const double sp = __fma_rn(x2, kS3, kS2);
    const double x5 = __dmul_rn(x2, x3);
    const double s = __fma_rn(x3, kS1, x);
    return __double2float_rn(__fma_rn(sp, x5, s));
  }
  const double c = neg ? -1.0 : 1.0;
  const double x4 = __dmul_rn(x2, x2);
  const double c1 = __fma_rn(x2, c * kC1, c * kC0);
  const double cp = __fma_rn(x2, c * kC4, c * kC3);
  const double x6 = __dmul_rn(x2, x4);
  const double cc = __fma_rn(x4, c * kC2, c1);
  return __double2float_rn(__fma_rn(cp, x6, cc));
}

}  // namespace xla_sinf_detail

__device__ __forceinline__ float xla_sinf(float y) {
  using namespace xla_sinf_detail;
  const uint32_t bits = __float_as_uint(y);
  const uint32_t top = (bits >> 20) & 0x7ff;
  const double x = static_cast<double>(y);
  if (top <= 0x397) return y;  // |y| < 2^-12
  if (top <= 0x3f3) return poly(x, __dmul_rn(x, x), 0, false);  // |y| < 0.75
  if (top <= 0x42e) {  // |y| < 120
    const int n = (__double2int_rz(__dmul_rn(x, kHpiInv)) + 0x800000) >> 24;
    const double r = __fma_rn(-static_cast<double>(n), kHpi, x);
    const double s = (n & 3) == 1 || (n & 3) == 2 ? -1.0 : 1.0;
    return poly(__dmul_rn(r, s), __dmul_rn(r, r), n, (n & 2) != 0);
  }
  // glibc reduce_large
  const uint32_t* arr = &kInvPio4[(bits >> 26) & 15];
  const int shift = (bits >> 23) & 7;
  const uint32_t xi = ((bits & 0xffffff) | 0x800000) << shift;
  uint64_t res0 = xi * arr[0];
  const uint64_t res1 = static_cast<uint64_t>(xi) * arr[4];
  const uint64_t res2 = static_cast<uint64_t>(xi) * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ull << 61)) >> 62;
  res0 -= n << 62;
  const double r = __dmul_rn(__ll2double_rn(static_cast<long long>(res0)), kPi63);
  const int q = static_cast<int>(n) + static_cast<int>(bits >> 31);
  const double s = (q & 3) == 1 || (q & 3) == 2 ? -1.0 : 1.0;
  return poly(__dmul_rn(r, s), __dmul_rn(r, r), static_cast<int>(n), (q & 2) != 0);
}
