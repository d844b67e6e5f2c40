// K6 — the soak generators: count microbatches of every partition written
// straight into the engine's padded row table, bit for bit.
//
// Replaces the XLA-lowered generators of the JAX package's engine/soak.py
// (`_sea_batch` :64, `_hyperplane_batch` :74, `_hyperplane_gradual_batch`
// :102, `_prototype_batch` :113), which the soak's compiled scan runs every
// step from jax.random's threefry keys. The plain version is
// engine/soak.py `soak_batch_reference` on the same threefry arithmetic
// (utils/threefry.py), and the two are equal bit for bit.
//
// Output, for partition p, batch c < count and row i < B, at flat row
// e = (p·count + c)·B + i: table[e, 0:F] the features and table[e, F:stride]
// zero (the row stride of models/base.py `row_stride`), labels[e], and
// rows[e] the row position row_offs[p] + t'·B + i, or −1 where the batch
// t = t0 + c lies past `last` (a window chunk's clamped tail; its features
// and labels are batch `last`'s, t' = min(t, last)). The generator key is
// fold_in(keys[p], t'), the concept id block0s[p] + row / drift_every.
//
// * sea (0): three uniforms ×10; label x0 + x1 <= θ[block mod 4].
// * hyperplane (1), hyperplane_gradual (2): F uniforms of split(key)[0] at
//   i·F + f; the concept's weights are the uniforms of fold_in(key(7),
//   block); the gradual rotation adds 0.3·sin((row mod period)·scale + f)
//   with the multiply-add fused and the sine correctly rounded to float32;
//   the margin is fma(x0, w0, x1·w1), then fma(x_f, w_f, ·) in feature
//   order, minus 0.5·Σw (a chain of adds), as XLA's CPU code forms it.
// * prototypes (3): y = randint(split(key)[0], i, classes); the class's
//   prototype is the normals of fold_in(key(11), block) at y·F + f times
//   f32(√2·3) (XLA's folded factor); x = fma(erf_inv(u), f32(√2·noise),
//   prototype) for the normals' uniforms u of split(key)[1] at i·F + f.
//
// Arithmetic as in the plain version: every float operation an explicit
// round-to-nearest intrinsic, built with -fmad=false -ftz=true
// (csrc/threefry.cuh); the fused multiply-adds are __fmaf_rn where XLA fuses.
//
// Bound on an H100 at the soak's bench geometry (128 partitions × 2000 rows,
// prototypes at F = 8): bytes — the table written once, 8 floats and a label
// and a row position a row, 10.2 MB a batch, 3.1 us at 3.35 TB/s; the
// operations — about 2F + 8 threefry hashes (some 100 integer operations
// each) and 2F erf_inv (some 60 float operations each) a row — exceed the
// bytes, so the hash bounds it. The design is the simplest that is right: a
// thread a row, the prototype and the weights recomputed for every row, no
// shared memory; staging a concept's prototypes or weights, or generating
// inside the model's kernels so the rows never reach device memory, is
// later work (ROADMAP Queue B, K6).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kWeightKey = 7u;  // hyperplane weights: fold_in(key(7), block)
constexpr uint32_t kProtoKey = 11u;  // prototypes: fold_in(key(11), block)

__device__ __forceinline__ float sea_theta(long long block) {
  switch (static_cast<int>(block % 4)) {
    case 0: return 8.0f;
    case 1: return 9.0f;
    case 2: return 7.0f;
    default: return 9.5f;
  }
}

// The hyperplane's weight f of a concept, rotated for the gradual soak.
__device__ __forceinline__ float hyperplane_weight(threefry::Pair wk, int f, int rotate_period,
                                                   float rot_scale, int row) {
  float w = threefry::uniform(wk, static_cast<uint64_t>(f), 0.0f, 1.0f);
  if (rotate_period > 0) {
    const float phase = __fmul_rn(static_cast<float>(row % rotate_period), rot_scale);
    const float arg = __fadd_rn(phase, static_cast<float>(f));
    const float s = __double2float_rn(sin(static_cast<double>(arg)));
    w = __fmaf_rn(s, 0.3f, w);
  }
  return w;
}

__global__ void __launch_bounds__(kThreads)
    soak_batch_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ row_offs,
                      const int* __restrict__ block0s, long long total, int count, int b, int f,
                      int stride, int t0, int last, int drift_every, int generator, int classes,
                      float noise_factor, float proto_factor, int rotate_period, float rot_scale,
                      float* __restrict__ table, int* __restrict__ labels,
                      int* __restrict__ rows_out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int i = static_cast<int>(e % b);
  const long long pc = e / b;
  const int c = static_cast<int>(pc % count);
  const int part = static_cast<int>(pc / count);
  const long long t = static_cast<long long>(t0) + c;
  const int te = static_cast<int>(t < last ? t : last);
  const threefry::Pair kt = threefry::fold_in({keys[2 * part], keys[2 * part + 1]},
                                              static_cast<uint32_t>(te));
  const int row = static_cast<int>(static_cast<long long>(row_offs[part]) +
                                   static_cast<long long>(te) * b + i);
  const long long block = static_cast<long long>(block0s[part]) + row / drift_every;
  float* out = table + e * stride;
  int width, y;
  if (generator == 0) {
    float x[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      x[j] = __fmul_rn(threefry::uniform(kt, static_cast<uint64_t>(i) * 3 + j, 0.0f, 1.0f),
                       10.0f);
      out[j] = x[j];
    }
    y = __fadd_rn(x[0], x[1]) <= sea_theta(block) ? 1 : 0;
    width = 3;
  } else if (generator == 3) {
    const threefry::Pair kc = threefry::split(kt, 0u), kn = threefry::split(kt, 1u);
    y = static_cast<int>(threefry::randint(kc, static_cast<uint64_t>(i), static_cast<uint32_t>(classes)));
    const threefry::Pair pk = threefry::fold_in({0u, kProtoKey}, static_cast<uint32_t>(block));
    for (int j = 0; j < f; ++j) {
      const float proto = __fmul_rn(
          threefry::normal_erfinv(pk, static_cast<uint64_t>(y) * f + j), proto_factor);
      const float n = threefry::normal_erfinv(kn, static_cast<uint64_t>(i) * f + j);
      out[j] = __fmaf_rn(n, noise_factor, proto);
    }
    width = f;
  } else {
    const threefry::Pair kx = threefry::split(kt, 0u);
    const threefry::Pair wk = threefry::fold_in({0u, kWeightKey}, static_cast<uint32_t>(block));
    const uint64_t base = static_cast<uint64_t>(i) * f;
    const float x0 = threefry::uniform(kx, base, 0.0f, 1.0f);
    const float w0 = hyperplane_weight(wk, 0, rotate_period, rot_scale, row);
    out[0] = x0;
    float acc = __fmul_rn(x0, w0), sw = w0;
    if (f > 1) {
      const float x1 = threefry::uniform(kx, base + 1, 0.0f, 1.0f);
      const float w1 = hyperplane_weight(wk, 1, rotate_period, rot_scale, row);
      out[1] = x1;
      acc = __fmaf_rn(x0, w0, __fmul_rn(x1, w1));
      sw = __fadd_rn(sw, w1);
    }
    for (int j = 2; j < f; ++j) {
      const float xj = threefry::uniform(kx, base + j, 0.0f, 1.0f);
      const float wj = hyperplane_weight(wk, j, rotate_period, rot_scale, row);
      out[j] = xj;
      acc = __fmaf_rn(xj, wj, acc);
      sw = __fadd_rn(sw, wj);
    }
    y = __fsub_rn(acc, __fmul_rn(0.5f, sw)) > 0.0f ? 1 : 0;
    width = f;
  }
  for (int j = width; j < stride; ++j) out[j] = 0.0f;
  labels[e] = y;
  rows_out[e] = t <= last ? row : -1;
}

// An empty kernel: launched with K6's grid and block, its time is the floor
// under K6's.
__global__ void soak_batch_floor_kernel() {}

unsigned blocks(long long total) { return static_cast<unsigned>((total + kThreads - 1) / kThreads); }

int stride_of(int f) { return (f + 3) & ~3; }

}  // namespace

extern "C" int soak_batch_launch(const int* keys, const int* row_offs, const int* block0s, int p,
                                 int count, int b, int f, int t0, int last, int drift_every,
                                 int generator, int classes, float noise_factor,
                                 float proto_factor, int rotate_period, float rot_scale,
                                 float* table, int* labels, int* rows, void* stream) {
  const long long total = static_cast<long long>(p) * count * b;
  if (total == 0) return 0;
  soak_batch_kernel<<<blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(keys), row_offs, block0s, total, count, b, f,
      stride_of(f), t0, last, drift_every, generator, classes, noise_factor, proto_factor,
      rotate_period, rot_scale, table, labels, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int soak_batch_floor_launch(int p, int count, int b, void* stream) {
  const long long total = static_cast<long long>(p) * count * b;
  if (total == 0) return 0;
  soak_batch_floor_kernel<<<blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
