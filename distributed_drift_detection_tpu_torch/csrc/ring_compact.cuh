// The ring-buffer members' one-CTA skeleton (K5-kswin, K5-stepd; their
// cluster path is ring_cluster.cuh), one CTA per partition row of kThreads
// threads, each a contiguous chunk: the
// plain versions' `ops/detectors.py` `_ring_compact` (JAX :944). The row's
// valid elements are compacted behind the carried right-aligned window
// buf[wr]; `pre` receives the zero-led prefix sums of that [wr + nv] row,
// pre[k] = sum of its first k values, so the valid element of compaction
// index q (at wr + q) ends a window of its last k stream elements summing
// to pre[wr+q+1] − pre[wr+q+1−k]; the next carried window is the row's
// last wr values. The values are 0/1 indicators, so every prefix is an
// integer below 2^24 and exact in any order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "zoo_scan.cuh"

namespace ring {

// valid elements and their error sum
struct Counts {
  int n;
  float c;
};

__device__ inline Counts add(Counts x, Counts y) { return Counts{x.n + y.n, __fadd_rn(x.c, y.c)}; }

// Builds pre[0 .. wr + nv] and the end window; returns the valid count and
// error sum before the thread's chunk [lo, hi). `scan` holds 2·blockDim
// Counts; *total receives the row's. Every thread calls it; it ends on a
// barrier.
__device__ inline Counts compact(const float* e, const uint8_t* v, int lo, int hi,
                                 const float* buf, float* buf_out, int wr, float* pre,
                                 Counts* scan, Counts* total) {
  Counts mine{0, 0.0f};
  for (int j = lo; j < hi; ++j)
    if (v[j]) {
      ++mine.n;
      mine.c = __fadd_rn(mine.c, e[j]);
    }
  const Counts first = zoo::block_exclusive_scan(
      mine, Counts{0, 0.0f}, [](Counts x, Counts y) { return add(x, y); }, scan);
  if (threadIdx.x == blockDim.x - 1) *total = add(first, mine);
  if (threadIdx.x == 0) {
    float s = 0.0f;
    pre[0] = s;
    for (int i = 0; i < wr; ++i) {
      s = __fadd_rn(s, buf[i]);
      pre[i + 1] = s;
    }
  }
  __syncthreads();
  const int nv = total->n;
  const float base = pre[wr];
  int q = first.n;
  float inc = first.c;
  for (int j = lo; j < hi; ++j)
    if (v[j]) {
      inc = __fadd_rn(inc, e[j]);
      pre[wr + q + 1] = __fadd_rn(base, inc);
      const int at = q - nv + wr;  // its place in the next window
      if (at >= 0) buf_out[at] = e[j];
      ++q;
    }
  for (int i = threadIdx.x; i < wr - nv; i += blockDim.x) buf_out[i] = buf[nv + i];
  __syncthreads();
  return first;
}

// Dynamic shared memory of a ring kernel's launch: the first flags, then
// `pre` (wr + n + 1 floats) where it fits, else in the global scratch.
template <class Kernel>
inline cudaError_t ring_smem(Kernel kernel, int w, int wr, long long n, size_t& bytes,
                             int& pre_in_smem) {
  return zoo::dynamic_smem(kernel, w, (wr + n + 1) * static_cast<long long>(sizeof(float)),
                           bytes, pre_in_smem);
}

}  // namespace ring
