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
//   with the multiply-add fused and the sine XLA's CPU sine, the C library's
//   sinf (csrc/xla_sinf.cuh);
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
// What bounds it. The work is threefry hashes: 20 rounds of a 32-bit add, a
// rotate and a xor and the key schedule, 69 integer operations each as
// nvcc compiles them (chip_smoke.py `HASH_INT_OPS`, read off the kernel's
// SASS). An H100 issues 64 32-bit integer operations a clock an SM (CUDA
// C++ Programming Guide, arithmetic throughput, compute capability 9.0),
// 16.7 T/s at 1.98 GHz — a quarter of its f32 rate. The function needs a
// row's own draws only (prototypes: randint's 2 hashes and F noise normals;
// hyperplane: F uniforms; sea: 3 uniforms) plus, once a batch, its keys
// and, once a concept, its prototypes or weights: at the soak's [128,
// 2000], prototypes, F = 8, about 10 hashes a row, 2.57 M hashes, ≈ 11.8 us
// of the integer rate, above the 10.2 MB of output (3.1 us at 3.35 TB/s)
// and the 8 erf_inv a row at the f32 rate (1.3 us). chip_smoke.py `k6_ops`
// counts it for each run's inputs.
//
// The design hashes only that. A CTA takes a tile of kTile rows of one
// (partition, batch), found from blockIdx once. Warp 0 derives the batch's
// keys (fold_in(keys[p], t'), then kx, or kn and randint's two split keys)
// into shared memory while the other warps derive the keys of the concepts
// the tile's rows reach (rows row0 .. row0 + n − 1: concepts row0 / de ..
// (row0 + n − 1) / de, usually one or two); the CTA then fills each
// concept's table — the C·F prototypes (× the factor) or the F weight
// uniforms — in shared memory, and each row hashes only its own draws,
// reading its class's prototype or its concept's weights there (the gradual
// rotation depends on the row and stays a row's work). A tile reaching more
// concepts than `slots` (engine/soak.py `k6_plan`: the table past its
// shared-memory budget, or costing more hashes than its rows would spend)
// or whose rows leave [0, 2^31) computes a row's entries inline, as the
// plain version does. A row's features and zero pad go out as float4 stores
// (the stride is a multiple of 4); labels and row positions are coalesced.
// On an H100 the rows' hashes run at about half the integer rate, in every
// generator and layout; resident CTAs, block size, log1p without its branch
// and unrolling did not move it (chip_k6_probe.py, PERF.md §6).

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"
#include "xla_sinf.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // rows a CTA, one a thread: engine/soak.py K6_TILE
constexpr int kMaxShared = 232448;  // a CTA's dynamic shared memory on an H100
constexpr int kStaticShared = 48 * 1024;
constexpr uint32_t kWeightKey = 7u;  // hyperplane weights: fold_in(key(7), block)
constexpr uint32_t kProtoKey = 11u;  // prototypes: fold_in(key(11), block)

enum Generator { kSea = 0, kHyperplane = 1, kGradual = 2, kPrototypes = 3 };

struct Args {
  const uint32_t* keys;  // [P, 2]
  const int* row_offs;   // [P]
  const int* block0s;    // [P]
  int count, b, f, stride, t0, last, drift_every, classes;
  int tiles;  // CTAs a (partition, batch)
  int slots;  // concepts a tile stages; 0: every row computes its entries
  int per;    // floats of a concept's table: C·F, F, or 0
  float noise_factor, proto_factor;
  int rotate_period;  // 0: no rotation
  float rot_scale;
  float* table;
  int* labels;
  int* rows;
};

__device__ __forceinline__ float sea_theta(long long block) {
  switch (static_cast<int>(block % 4)) {
    case 0: return 8.0f;
    case 1: return 9.0f;
    case 2: return 7.0f;
    default: return 9.5f;
  }
}

// The gradual soak's rotation of weight f at `row`.
__device__ __forceinline__ float rotate(float w, int f, int rotate_period, float rot_scale,
                                        int row) {
  const float phase = __fmul_rn(static_cast<float>(row % rotate_period), rot_scale);
  const float arg = __fadd_rn(phase, static_cast<float>(f));
  return __fmaf_rn(xla_sinf(arg), 0.3f, w);
}

__device__ __forceinline__ void store4(float* out, int g, const float (&v)[4]) {
  reinterpret_cast<float4*>(out)[g >> 2] = make_float4(v[0], v[1], v[2], v[3]);
}

// The hyperplane margin as it accumulates in feature order.
struct Margin {
  float x0, w0, acc, sw;
};

// Features g .. g + 3 of a hyperplane row (those below F, unless kFull):
// drawn, stored, and added to the margin in XLA's order. `w_s` the staged
// weights of the row's concept, or null (then `wk` the concept's key).
template <bool kFull>
__device__ __forceinline__ void hyperplane_group(const Args& a, threefry::Pair kx,
                                                 const float* w_s, threefry::Pair wk,
                                                 uint64_t base, int row, int g, Margin& m,
                                                 float* out) {
  float x[4], w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = g + q;
    x[q] = 0.0f;
    w[q] = 0.0f;
    if (kFull || j < a.f) {
      x[q] = threefry::uniform(kx, base + j, 0.0f, 1.0f);
      w[q] = w_s ? w_s[j] : threefry::uniform(wk, static_cast<uint64_t>(j), 0.0f, 1.0f);
      if (a.rotate_period > 0) w[q] = rotate(w[q], j, a.rotate_period, a.rot_scale, row);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = g + q;
    if (!kFull && j >= a.f) break;
    if (j == 0) {
      m.x0 = x[q];
      m.w0 = w[q];
      m.acc = __fmul_rn(m.x0, m.w0);
      m.sw = m.w0;
    } else if (j == 1) {
      m.acc = __fmaf_rn(m.x0, m.w0, __fmul_rn(x[q], w[q]));
      m.sw = __fadd_rn(m.sw, w[q]);
    } else {
      m.acc = __fmaf_rn(x[q], w[q], m.acc);
      m.sw = __fadd_rn(m.sw, w[q]);
    }
  }
  store4(out, g, x);
}

// One hyperplane row: its features and zero pad, and its label.
__device__ __forceinline__ int hyperplane_row(const Args& a, threefry::Pair kx,
                                              const float* w_s, threefry::Pair wk, int i,
                                              int row, float* out) {
  const uint64_t base = static_cast<uint64_t>(i) * a.f;
  Margin m{0.0f, 0.0f, 0.0f, 0.0f};
  int g = 0;
  for (; g + 4 <= a.f; g += 4) hyperplane_group<true>(a, kx, w_s, wk, base, row, g, m, out);
  if (g < a.stride) hyperplane_group<false>(a, kx, w_s, wk, base, row, g, m, out);
  return __fsub_rn(m.acc, __fmul_rn(0.5f, m.sw)) > 0.0f ? 1 : 0;
}

// Features g .. g + 3 of a prototypes row (those below F, unless kFull):
// `p_s` the staged prototype of its class, or null (then `pk` its
// concept's key).
template <bool kFull>
__device__ __forceinline__ void prototype_group(const Args& a, threefry::Pair kn,
                                                const float* p_s, threefry::Pair pk,
                                                uint64_t nbase, uint64_t pbase, int g,
                                                float* out) {
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = g + q;
    v[q] = 0.0f;
    if (kFull || j < a.f) {
      const float proto =
          p_s ? p_s[j] : __fmul_rn(threefry::normal_erfinv(pk, pbase + j), a.proto_factor);
      const float n = threefry::normal_erfinv(kn, nbase + j);
      v[q] = __fmaf_rn(n, a.noise_factor, proto);
    }
  }
  store4(out, g, v);
}

// One prototypes row of class y: its features and zero pad.
__device__ __forceinline__ void prototype_row(const Args& a, threefry::Pair kn,
                                              const float* p_s, threefry::Pair pk, int i,
                                              int y, float* out) {
  const uint64_t nbase = static_cast<uint64_t>(i) * a.f;
  const uint64_t pbase = static_cast<uint64_t>(y) * a.f;
  int g = 0;
  for (; g + 4 <= a.f; g += 4) prototype_group<true>(a, kn, p_s, pk, nbase, pbase, g, out);
  if (g < a.stride) prototype_group<false>(a, kn, p_s, pk, nbase, pbase, g, out);
}

template <int kGen>
__global__ void __launch_bounds__(kThreads) soak_tile_kernel(const __grid_constant__ Args a) {
  // dynamic shared memory: `slots` concept keys, then their tables
  extern __shared__ uint32_t shared_words[];
  __shared__ threefry::Pair batch_keys[3];
  threefry::Pair* concept_keys = reinterpret_cast<threefry::Pair*>(shared_words);
  float* tables = reinterpret_cast<float*>(shared_words + 2 * a.slots);

  const int tile = static_cast<int>(blockIdx.x % static_cast<unsigned>(a.tiles));
  const int pc = static_cast<int>(blockIdx.x / static_cast<unsigned>(a.tiles));
  const int c = pc % a.count, part = pc / a.count;
  const int i0 = tile * kTile;
  const int n = min(kTile, a.b - i0);
  const long long t = static_cast<long long>(a.t0) + c;
  const int te = static_cast<int>(t < a.last ? t : a.last);
  const long long row0 =
      static_cast<long long>(a.row_offs[part]) + static_cast<long long>(te) * a.b + i0;
  const long long block0 = a.block0s[part];
  const int tid = threadIdx.x;

  // the tile's concepts, staged when its rows lie in [0, 2^31) and reach
  // at most `slots` of them
  int first = 0, span = 0;
  if (kGen != kSea && a.slots > 0 && row0 >= 0 && row0 + n - 1 <= INT_MAX) {
    first = static_cast<int>(row0) / a.drift_every;
    span = static_cast<int>(row0 + n - 1) / a.drift_every - first + 1;
    if (span > a.slots) span = 0;
  }

  // warp 0: the batch's keys; the other warps: the concepts' keys
  if (tid < 3) {
    const threefry::Pair kt = threefry::fold_in({a.keys[2 * part], a.keys[2 * part + 1]},
                                                static_cast<uint32_t>(te));
    if (kGen == kSea) {
      batch_keys[0] = kt;
    } else if (kGen == kPrototypes) {
      // kc = split(kt)[0] and randint's split(kc, 0), split(kc, 1); kn = split(kt)[1]
      const threefry::Pair k1 = threefry::split(kt, tid == 2 ? 1u : 0u);
      const threefry::Pair k2 = threefry::split(k1, static_cast<uint32_t>(tid));
      batch_keys[tid] = tid == 2 ? k1 : k2;
    } else {
      batch_keys[0] = threefry::split(kt, 0u);
    }
  }
  const uint32_t concept_seed = kGen == kPrototypes ? kProtoKey : kWeightKey;
  if (tid >= 32) {
    for (int k = tid - 32; k < span; k += kThreads - 32) {
      concept_keys[k] = threefry::fold_in({0u, concept_seed},
                                          static_cast<uint32_t>(block0 + first + k));
    }
  }
  __syncthreads();
  if (span > 0) {
    const int per = a.per;
    for (int e = tid; e < span * per; e += kThreads) {
      const int k = e / per, j = e - k * per;
      tables[e] = kGen == kPrototypes
                      ? __fmul_rn(threefry::normal_erfinv(concept_keys[k],
                                                          static_cast<uint64_t>(j)),
                                  a.proto_factor)
                      : threefry::uniform(concept_keys[k], static_cast<uint64_t>(j), 0.0f,
                                          1.0f);
    }
    __syncthreads();
  }
  if (tid >= n) return;

  const int i = i0 + tid;
  const long long e = static_cast<long long>(pc) * a.b + i;
  const int row = static_cast<int>(row0 + tid);
  const long long block = block0 + row / a.drift_every;
  // the row's concept table, when staged
  const float* staged = span > 0 ? tables + (row / a.drift_every - first) * a.per : nullptr;
  float* out = a.table + e * a.stride;
  int y;
  if (kGen == kSea) {
    const threefry::Pair kt = batch_keys[0];
    float x[4];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      x[j] = __fmul_rn(threefry::uniform(kt, static_cast<uint64_t>(i) * 3 + j, 0.0f, 1.0f),
                       10.0f);
    }
    x[3] = 0.0f;
    store4(out, 0, x);
    y = __fadd_rn(x[0], x[1]) <= sea_theta(block) ? 1 : 0;
  } else if (kGen == kPrototypes) {
    y = static_cast<int>(threefry::randint_split(batch_keys[0], batch_keys[1],
                                                 static_cast<uint64_t>(i),
                                                 static_cast<uint32_t>(a.classes)));
    threefry::Pair pk{0u, 0u};
    if (!staged) pk = threefry::fold_in({0u, kProtoKey}, static_cast<uint32_t>(block));
    prototype_row(a, batch_keys[2], staged ? staged + y * a.f : nullptr, pk, i, y, out);
  } else {
    threefry::Pair wk{0u, 0u};
    if (!staged) wk = threefry::fold_in({0u, kWeightKey}, static_cast<uint32_t>(block));
    y = hyperplane_row(a, batch_keys[0], staged, wk, i, row, out);
  }
  a.labels[e] = y;
  a.rows[e] = t <= a.last ? row : -1;
}

// An empty kernel: launched with K6's grid and block, its time is the floor
// under K6's.
__global__ void soak_batch_floor_kernel() {}

int stride_of(int f) { return (f + 3) & ~3; }

int tiles_of(int b) { return (b + kTile - 1) / kTile; }

template <int kGen>
int launch(const Args& a, unsigned grid, cudaStream_t stream) {
  const long long bytes =
      static_cast<long long>(a.slots) * (8 + 4 * static_cast<long long>(a.per));
  if (bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > kStaticShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        soak_tile_kernel<kGen>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  soak_tile_kernel<kGen><<<grid, kThreads, static_cast<size_t>(bytes), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `slots`: the concepts a tile stages in shared memory (engine/soak.py
// `k6_plan`); 0 computes every row's table entries inline.
extern "C" int soak_batch_launch(const int* keys, const int* row_offs, const int* block0s, int p,
                                 int count, int b, int f, int t0, int last, int drift_every,
                                 int generator, int classes, float noise_factor,
                                 float proto_factor, int rotate_period, float rot_scale,
                                 int slots, float* table, int* labels, int* rows, void* stream) {
  const long long grid = static_cast<long long>(p) * count * tiles_of(b);
  if (grid == 0) return 0;
  if (grid > INT_MAX || slots < 0 || generator < 0 || generator > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  long long per = 0;
  if (generator == kPrototypes) per = static_cast<long long>(classes) * f;
  else if (generator != kSea) per = f;
  if (slots > 0 && (generator == kSea || per * slots * 4 > kMaxShared))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{reinterpret_cast<const uint32_t*>(keys), row_offs, block0s, count, b, f,
               stride_of(f), t0, last, drift_every, classes, tiles_of(b), slots,
               static_cast<int>(slots > 0 ? per : 0), noise_factor, proto_factor,
               rotate_period, rot_scale, table, labels, rows};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto g = static_cast<unsigned>(grid);
  switch (generator) {
    case kSea: return launch<kSea>(a, g, s);
    case kPrototypes: return launch<kPrototypes>(a, g, s);
    default: return launch<kHyperplane>(a, g, s);
  }
}

extern "C" int soak_batch_floor_launch(int p, int count, int b, void* stream) {
  const long long grid = static_cast<long long>(p) * count * tiles_of(b);
  if (grid == 0) return 0;
  soak_batch_floor_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
