// K7 — the nearest-centroid fit, bit for bit as XLA computes it on the CPU.
//
// Replaces the JAX package's models/classifiers.py `make_centroid.fit`
// (:92-98): onehot = one_hot(y)·w, counts = Σ onehot, sums = onehotᵀ @ X,
// cent = sums / max(counts, 1), bias = -0.5·Σ_f cent² (−inf for absent
// classes) — XLA-lowered there as an XLA dot plus a reduce, vmapped over
// partitions. Per partition, from its training batch X [B, F] f32, labels
// y [B] i32 and {0, 1} weights w [B] f32, it writes cent [C, F] and
// bias [C].
//
// Numerics (measured against XLA's CPU fit of jax 0.9.0 at B <= 384):
// XLA's `onehotᵀ @ X` is a float32 sum over the B rows in row order,
// starting from 0; each product onehot·w·x is exact (0 or x), so the kernel
// adds w·x for the rows of class c in row order with __fadd_rn and skips
// the others (adding a zero product to a sum that started at +0 never
// changes it). The counts are the same sum over an implicit column of
// ones. `Σ_f cent²` is one fused multiply-add chain over the features in
// feature order from 0 (acc = fma(c_f, c_f, acc)), then × -0.5. Built with
// -fmad=false and -ftz=true, as the zoo kernels, so no other contraction
// happens and subnormal results flush as XLA's do; the plain version is
// models/classifiers.py `centroid_fit_reference`, step for step. cuBLAS's
// batched f32 GEMM and torch.cumsum do not sum in row order, which is why
// this is a kernel at all.
//
// Bound on an H100 at the main path's shapes (P = 16, B = 100, F = 21,
// C = 40): bytes — [P, B, F] f32 and two [P, B] vectors in (0.15 MB),
// [P, C, F + 1] f32 out (0.06 MB), 0.06 us at 3.35 TB/s; the operations
// are fewer still. What really bounds it is the dependent chain of B adds
// per (class, feature) sum and of F fused multiply-adds per bias. The
// design keeps those chains short and off global memory: one CTA per
// partition, a thread per (class, feature or count) pair, the batch staged
// in shared memory one tile of rows at a time (coalesced loads, every
// thread reading the same row's label and weight as a broadcast), so a
// thread's B-step chain reads only shared memory; the per-pair partial
// sums sit in shared memory between tiles, so any B fits. Then one thread
// per class runs the bias chain over the centroids, also from shared
// memory.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxTileRows = 256;

// Shared memory: the per-pair sums [C, F + 1] (column F holds the count),
// then a tile of T rows: X [T, F], y [T], w [T].
__global__ void __launch_bounds__(kMaxThreads)
    centroid_fit_kernel(const float* __restrict__ X, const int* __restrict__ y,
                        const float* __restrict__ w, int b, int f, int c, int tile,
                        float* __restrict__ cent, float* __restrict__ bias) {
  extern __shared__ float smem[];
  const int f1 = f + 1;
  const int pairs = c * f1;
  float* acc = smem;
  float* xs = acc + pairs;
  int* ys = reinterpret_cast<int*>(xs + tile * f);
  float* ws = reinterpret_cast<float*>(ys + tile);

  const int part = blockIdx.x;
  const float* Xp = X + static_cast<size_t>(part) * b * f;
  const int* yp = y + static_cast<size_t>(part) * b;
  const float* wp = w + static_cast<size_t>(part) * b;

  for (int i = threadIdx.x; i < pairs; i += blockDim.x) acc[i] = 0.0f;

  for (int t0 = 0; t0 < b; t0 += tile) {
    const int rows = min(tile, b - t0);
    __syncthreads();  // the last tile's readers are done (and acc zeroed)
    for (int i = threadIdx.x; i < rows * f; i += blockDim.x)
      xs[i] = Xp[static_cast<size_t>(t0) * f + i];
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      ys[i] = yp[t0 + i];
      ws[i] = wp[t0 + i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const int k = i / f1;
      const int j = i - k * f1;
      float a = acc[i];
      if (j < f) {
#pragma unroll 4
        for (int r = 0; r < rows; ++r)
          if (ys[r] == k) a = __fadd_rn(a, __fmul_rn(ws[r], xs[r * f + j]));
      } else {
#pragma unroll 4
        for (int r = 0; r < rows; ++r)
          if (ys[r] == k) a = __fadd_rn(a, ws[r]);
      }
      acc[i] = a;
    }
  }
  __syncthreads();

  // cent = sums / max(counts, 1), in place (the count columns stay).
  for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
    const int k = i / f1;
    const int j = i - k * f1;
    if (j < f) {
      const float v = __fdiv_rn(acc[i], fmaxf(acc[k * f1 + f], 1.0f));
      acc[i] = v;
      cent[(static_cast<size_t>(part) * c + k) * f + j] = v;
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    const float* row = acc + k * f1;
    float s = 0.0f;
    for (int j = 0; j < f; ++j) s = __fmaf_rn(row[j], row[j], s);
    bias[static_cast<size_t>(part) * c + k] =
        row[f] > 0.0f ? __fmul_rn(-0.5f, s) : -CUDART_INF_F;
  }
}

}  // namespace

// Shared memory a block needs for `tile` rows; the launcher's tile is the
// largest that fits the card's limit (at most kMaxTileRows, at least 1).
static size_t smem_bytes(int f, int c, int tile) {
  return sizeof(float) * (static_cast<size_t>(c) * (f + 1) +
                          static_cast<size_t>(tile) * (f + 2));
}

extern "C" int centroid_fit_launch(const float* X, const int* y, const float* w, int p,
                                   int b, int f, int c, float* cent, float* bias,
                                   void* stream) {
  if (p == 0) return 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int tile = b < kMaxTileRows ? (b > 0 ? b : 1) : kMaxTileRows;
  while (tile > 1 && smem_bytes(f, c, tile) > static_cast<size_t>(optin)) tile /= 2;
  const size_t smem = smem_bytes(f, c, tile);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      centroid_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int pairs = c * (f + 1);
  int threads = ((pairs + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  centroid_fit_kernel<<<p, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      X, y, w, b, f, c, tile, cent, bias);
  return static_cast<int>(cudaGetLastError());
}
