// The oblique forest's shared arithmetic on the card (K11 forest_fit, K12
// forest_predict_err): the projection of a row onto a node, the split test
// and jnp.sort's key order.
//
// A row's projection onto node m is an f32 chain over the features in
// order from +0, each product and each add rounded on its own: mul.rn and
// add.rn in PTX, never fused and never flushed, whatever -fmad and -ftz the
// including file builds with (K11 builds with -ftz=true for the threefry
// normals). So the projection is the same number in K11's thresholds, in
// its routing and in K12, and equal to models/forest.py `project` on the
// CPU. The split test `z > thresh` is setp.gt without .ftz for the same
// reason.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace forest {

__device__ __forceinline__ float mul_rn(float a, float b) {
  float r;
  asm("mul.rn.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float add_rn(float a, float b) {
  float r;
  asm("add.rn.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// a > b, subnormals kept (IEEE; false when either is NaN).
__device__ __forceinline__ bool gt(float a, float b) {
  unsigned r;
  asm("{\n .reg .pred p;\n setp.gt.f32 p, %1, %2;\n selp.u32 %0, 1, 0, p;\n}"
      : "=r"(r) : "f"(a), "f"(b));
  return r != 0;
}

// The row x (feature j at x[j·sx]) · column m of a projection whose
// element (j, m) lies at p[m·sm + j·sj]: the chain described above.
__device__ __forceinline__ float project(const float* x, int sx, const float* p, int f, int m,
                                         int sm, int sj) {
  const float* col = p + static_cast<size_t>(m) * sm;
  float acc = 0.0f;
#pragma unroll 4
  for (int j = 0; j < f; ++j)
    acc = add_rn(acc, mul_rn(x[static_cast<size_t>(j) * sx], col[static_cast<size_t>(j) * sj]));
  return acc;
}

// An int32 key whose order is jnp.sort's order of v: −0 as +0, every NaN as
// +NaN after +inf (models/forest.py `sort_keys`).
// Tested on the bits, so no -ftz flushes a subnormal to a zero here.
__device__ __forceinline__ int sort_key(float v) {
  int bits = __float_as_int(v);
  const int mag = bits & 0x7FFFFFFF;
  if (mag == 0) bits = 0;
  if (mag > 0x7F800000) bits = 0x7FC00000;
  return bits ^ ((bits >> 31) & 0x7FFFFFFF);
}

}  // namespace forest
