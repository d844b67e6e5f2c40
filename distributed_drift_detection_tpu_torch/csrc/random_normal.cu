// K8 — the MLP's init, jax.random.normal for every layer of every
// partition, in one launch, bit for bit.
//
// Replaces the XLA-lowered init of the JAX package's models/classifiers.py
// `make_mlp.init` (:259-271): keys = split(key, layers), then per layer
// sqrt(2/din) * normal(keys[l], (din, dout)) and zero biases, which XLA
// lowers to the threefry2x32 hash of each output's flat index, the uniform
// from its top 23 bits and erf_inv, the two factors folded into one
// (models/mlp.py `init_scales`). For partition p < P and layer l of a
// launch's table: out[offset_l + p·count_l + i] = erf_inv(u_i)·factor_l for
// the uniforms u of split(keys[p], first + l) — split(key, L)[l] hashes the
// counter pair (0, l) whatever L is — at flat indices i < count_l; then
// `zeros` zeros (the biases). The arithmetic is csrc/threefry.cuh's; the
// plain version is utils/threefry.py `init_normals_reference` (split, then
// `random_normal_reference` a layer), and the two are equal bit for bit.
//
// What bounds it. At the main path's shapes (MLP(128, 64) of 16 partitions
// at F = 21, C = 40: 215,040 normals) a normal is one hash (69 32-bit
// integer operations, at 64 a clock an SM on an H100, 16.7 T/s) and its
// map (about 40 f32 operations): ≈ 1 us of the integer rate, above the 0.86
// MB written (0.26 us at 3.35 TB/s) — and below an empty launch's ≈ 1.3 us.
// So the design spends one launch on the whole init: a CTA takes kPerCta
// normals of one (layer, partition), found from blockIdx by a search of the
// table's CTA offsets (no division a thread); thread 0 derives the layer's
// key into shared memory once; each thread then draws kPer normals, stored
// coalesced (one a thread: about 850 CTAs at the main path's shapes, which
// even out over the SMs better than fewer, longer ones). The CTAs past the
// layers' write the zeros. Up to kInlineLayers layers a launch, in the
// kernel's parameters (models/mlp.py INLINE_LAYERS).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 1;  // normals a thread: 1 ran fastest on an H100 (chip_k6_probe.py)
constexpr int kPerCta = kThreads * kPer;
constexpr int kInlineLayers = 64;  // models/mlp.py INLINE_LAYERS

struct Layers {
  int n;      // layers in this launch
  int first;  // the split counter of its first layer
  long long zeros;
  long long zero_offset;
  unsigned cta_end[kInlineLayers];  // CTAs through layer l: P · chunks, summed
  int chunks[kInlineLayers];        // CTAs a partition of layer l
  int count[kInlineLayers];         // normals a partition of layer l
  long long offset[kInlineLayers];  // layer l's first output
  float factor[kInlineLayers];
};

__global__ void __launch_bounds__(kThreads)
    init_normals_kernel(const uint32_t* __restrict__ keys, const __grid_constant__ Layers t,
                        float* __restrict__ out) {
  const unsigned bid = blockIdx.x;
  if (bid >= t.cta_end[t.n - 1]) {  // the zeros
    const long long base = static_cast<long long>(bid - t.cta_end[t.n - 1]) * kPerCta;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const long long i = base + q * kThreads + threadIdx.x;
      if (i < t.zeros) out[t.zero_offset + i] = 0.0f;
    }
    return;
  }
  int l = 0;
  while (bid >= t.cta_end[l]) ++l;
  const unsigned local = bid - (l ? t.cta_end[l - 1] : 0u);
  const int part = static_cast<int>(local / static_cast<unsigned>(t.chunks[l]));
  const int chunk = static_cast<int>(local - static_cast<unsigned>(part * t.chunks[l]));
  __shared__ threefry::Pair key;
  if (threadIdx.x == 0) {
    key = threefry::split({keys[2 * part], keys[2 * part + 1]},
                          static_cast<uint32_t>(t.first + l));
  }
  __syncthreads();
  const threefry::Pair k = key;
  const int count = t.count[l];
  const float factor = t.factor[l];
  float* dst = out + t.offset[l] + static_cast<long long>(part) * count;
  const long long base = static_cast<long long>(chunk) * kPerCta + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const long long i = base + q * kThreads;
    if (i < count) dst[i] = threefry::normal(k, static_cast<uint64_t>(i), factor);
  }
}

// An empty kernel: launched with K8's grid and block, its time is the
// floor under K8's.
__global__ void init_normals_floor_kernel() {}

// The launch's table and grid from the host's layer counts and factors;
// false if out of range.
bool table(int p, int layers, int first, const int* counts, const float* factors,
           long long zeros, Layers* t, unsigned* grid) {
  if (p <= 0 || layers <= 0 || layers > kInlineLayers || zeros < 0) return false;
  t->n = layers;
  t->first = first;
  long long ctas = 0, offset = 0;
  for (int l = 0; l < layers; ++l) {
    if (counts[l] < 0) return false;
    const int chunks = (counts[l] + kPerCta - 1) / kPerCta;
    ctas += static_cast<long long>(p) * chunks;
    t->cta_end[l] = static_cast<unsigned>(ctas);
    t->chunks[l] = chunks;
    t->count[l] = counts[l];
    t->offset[l] = offset;
    t->factor[l] = factors[l];
    offset += static_cast<long long>(p) * counts[l];
  }
  t->zeros = zeros;
  t->zero_offset = offset;
  ctas += (zeros + kPerCta - 1) / kPerCta;
  if (ctas > 0x7FFFFFFFLL) return false;
  *grid = static_cast<unsigned>(ctas);
  return true;
}

}  // namespace

// keys [P, 2] int32 (uint32 words); counts and factors host arrays of
// `layers` (at most kInlineLayers) entries; out: the layers' normals,
// layer-major, each [P, count], then `zeros` zeros.
extern "C" int init_normals_launch(const int* keys, int p, int layers, int first,
                                   const int* counts, const float* factors, long long zeros,
                                   float* out, void* stream) {
  Layers t;
  unsigned grid = 0;
  if (!table(p, layers, first, counts, factors, zeros, &t, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  init_normals_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(keys), t, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int init_normals_floor_launch(int p, int layers, const int* counts, long long zeros,
                                         void* stream) {
  Layers t;
  unsigned grid = 0;
  static const float kUnused[kInlineLayers] = {};
  if (!table(p, layers, 0, counts, kUnused, zeros, &t, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  init_normals_floor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
