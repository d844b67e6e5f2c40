// K8 — jax.random.normal(key, (n,)) f32 for each of N keys, bit for bit.
//
// Replaces the XLA-lowered jax.random.normal of the JAX package's
// models/classifiers.py `make_mlp.init` (:259-271: per layer,
// sqrt(2/din) * normal(k, (din, dout)) from split(key, layers)), which XLA
// lowers to the threefry2x32 hash of each output's flat index, the uniform
// from its top 23 bits and erf_inv. Row k of out [N, n] is erf_inv(u)·factor
// for the uniforms u of key k at flat indices 0..n−1: factor = f32(√2)
// gives jax.random.normal, f32(√2·scale) the jitted scale * normal as XLA
// folds it (models/mlp.py `init_scales`). The arithmetic is
// csrc/threefry.cuh's; the plain version is utils/threefry.py `normal_map`
// on `random_bits`, and the two are equal bit for bit.
//
// Bound on an H100 at the main path's shapes (the MLP(128, 64) init of 16
// partitions at F = 21, C = 40: 2,688, 8,192 and 2,560 normals a
// partition, one launch a layer): bytes — the output alone, 4 bytes a
// normal, 0.9 MB at most, 0.26 us at 3.35 TB/s; the operations — about
// 200 integer operations for the hash and some 60 float32 ones for the map
// a normal — are some 2 us of the card's integer rate, so the hash bounds
// it. The design is the simplest: a thread a normal, no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    random_normal_kernel(const uint32_t* keys, long long total, int n, float factor,
                         float* out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long k = e / n;
  const threefry::Pair key{keys[2 * k], keys[2 * k + 1]};
  out[e] = threefry::normal(key, static_cast<uint64_t>(e - k * n), factor);
}

// An empty kernel: launched with K8's grid and block, its time is the
// floor under K8's.
__global__ void random_normal_floor_kernel() {}

unsigned blocks(long long total) { return static_cast<unsigned>((total + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int random_normal_launch(const int* keys, int n_keys, int n, float factor, float* out,
                                    void* stream) {
  const long long total = static_cast<long long>(n_keys) * n;
  if (total == 0) return 0;
  random_normal_kernel<<<blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(keys), total, n, factor, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int random_normal_floor_launch(int n_keys, int n, void* stream) {
  const long long total = static_cast<long long>(n_keys) * n;
  if (total == 0) return 0;
  random_normal_floor_kernel<<<blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
