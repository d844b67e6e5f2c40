// Device building blocks of the zoo's one-CTA window kernels (K5-adwin, and
// the global-scratch paths of K5-ph and K5-hddm_w): one CTA per partition
// row, kThreads threads.
//
// * tree_scan: an inclusive scan with a rounding combine, evaluated on the
//   same combine tree as the plain versions (ops/prefix.py
//   associative_scan), which is lax.associative_scan's: pair adjacent
//   elements, scan the pairs recursively, then combine each odd prefix with
//   the next even element. The levels above the first are stored (in shared
//   memory when they fit, else in a global scratch the wrapper allocates);
//   the first level's elements come from a generator, so the inputs are
//   never staged.
// * block_exclusive_scan: a Hillis–Steele scan over the block's threads for
//   the order-free prefixes (integer counts, error sums of 0/1 indicators,
//   minima, latest records), whose results do not depend on the order.
// * first_flags: per-batch first warning / first change through
//   shared-memory atomicMin, and their early-break summary.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace zoo {

constexpr int kThreads = 512;
constexpr int kMaxLevels = 32;

// Tuples a scan of n elements stores above its first level:
// n/2 + n/4 + ... while the level being halved has two or more.
__host__ __device__ inline long long scan_levels(long long n) {
  long long total = 0;
  for (long long m = n; m >= 2;) {
    m /= 2;
    total += m;
  }
  return total;
}

// Block-wide exclusive scan of v in thread order with the associative
// op(earlier, later); `buf` holds 2 * blockDim.x values.
template <class T, class Op>
__device__ T block_exclusive_scan(T v, T identity, Op op, T* buf) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  buf[tid] = v;
  __syncthreads();
  int in = 0;
  for (int d = 1; d < nt; d <<= 1) {
    T x = buf[in * nt + tid];
    if (tid >= d) x = op(buf[in * nt + tid - d], x);
    in ^= 1;
    buf[in * nt + tid] = x;
    __syncthreads();
  }
  const T excl = tid > 0 ? buf[in * nt + tid - 1] : identity;
  __syncthreads();
  return excl;
}

// Inclusive scan of gen(0..n-1) under comb(earlier, later) on
// lax.associative_scan's tree; emit(j, s_j) receives every prefix. `lev`
// holds scan_levels(n) tuples. Every thread of the block must call it.
template <class T, class Gen, class Comb, class Emit>
__device__ void tree_scan(int n, T* lev, Gen gen, Comb comb, Emit emit) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int offs[kMaxLevels];
  int sizes[kMaxLevels];
  int depth = 0;
  if (n >= 2) {
    depth = 1;
    offs[1] = 0;
    sizes[1] = n / 2;
    for (int i = tid; i < sizes[1]; i += nt) lev[i] = comb(gen(2 * i), gen(2 * i + 1));
    __syncthreads();
    while (sizes[depth] >= 2) {
      offs[depth + 1] = offs[depth] + sizes[depth];
      sizes[depth + 1] = sizes[depth] / 2;
      const T* src = lev + offs[depth];
      T* dst = lev + offs[depth + 1];
      for (int i = tid; i < sizes[depth + 1]; i += nt) dst[i] = comb(src[2 * i], src[2 * i + 1]);
      __syncthreads();
      ++depth;
    }
    // The top level (one tuple) is its own scan; each level below takes
    // its odd prefixes from the level above and combines its even ones.
    for (int l = depth - 1; l >= 1; --l) {
      T* cur = lev + offs[l];
      const T* up = lev + offs[l + 1];
      for (int i = tid; i < sizes[l]; i += nt) {
        if (i & 1)
          cur[i] = up[i >> 1];
        else if (i > 0)
          cur[i] = comb(up[(i >> 1) - 1], cur[i]);
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < n; j += nt) {
    T s;
    if (j & 1)
      s = lev[j >> 1];
    else if (j == 0)
      s = gen(0);
    else
      s = comb(lev[(j >> 1) - 1], gen(j));
    emit(j, s);
  }
}

// The rows of a thread's contiguous chunk of n elements: [lo, hi).
__device__ inline void chunk_of(int n, int& lo, int& hi) {
  const int e = (n + blockDim.x - 1) / blockDim.x;
  lo = min(n, static_cast<int>(threadIdx.x) * e);
  hi = min(n, lo + e);
}

// Per-batch first indices in shared memory: fc[w], fw[w], initialised to b.
__device__ inline void first_init(int* fc, int* fw, int w, int b) {
  for (int k = threadIdx.x; k < w; k += blockDim.x) {
    fc[k] = b;
    fw[k] = b;
  }
}

// Element j of a row of batches of b flagged warning/change.
__device__ inline void first_mark(int* fc, int* fw, int j, int b, bool warning, bool change) {
  if (change) atomicMin(&fc[j / b], j % b);
  if (warning) atomicMin(&fw[j / b], j % b);
}

// A warning counts only at or before its batch's first change; -1 = none.
__device__ inline void first_store(const int* fc, const int* fw, int w, int b,
                                   int* first_warning, int* first_change) {
  for (int k = threadIdx.x; k < w; k += blockDim.x) {
    const int c = fc[k];
    const int x = fw[k];
    first_change[k] = c < b ? c : -1;
    first_warning[k] = (x < b && (c >= b || x <= c)) ? x : -1;
  }
}

// Dynamic shared memory of a launch: [fc (w ints)][fw (w ints)] then, when
// they fit beside the kernel's static shared memory, the scan levels.
// Returns the bytes to request and sets levels_in_smem.
template <class Kernel>
inline cudaError_t dynamic_smem(Kernel kernel, int w, long long level_bytes,
                                size_t& bytes, int& levels_in_smem) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t firsts = (2 * static_cast<size_t>(w) * sizeof(int) + 15) & ~size_t(15);
  const size_t limit = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  levels_in_smem = firsts + level_bytes <= limit ? 1 : 0;
  bytes = firsts + (levels_in_smem ? static_cast<size_t>(level_bytes) : 0);
  if (bytes > limit) return cudaErrorInvalidValue;  // w alone too large
  if (bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Launches the empty kernel `floor` as a one-CTA zoo kernel is launched: p
// CTAs of kThreads with `bytes` of dynamic shared memory (the kernel's
// dynamic_smem). The floor under that kernel's time. Returns a CUDA error
// code.
template <class Kernel>
inline int launch_floor(Kernel floor, int p, size_t bytes, void* stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        floor, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  floor<<<p, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // namespace zoo
