// Order-free scans across a thread block and a thread-block cluster, for
// kernels that split one partition row over the CTAs of a cluster (the
// cluster paths of K5-ph, K5-hddm_w, K5-eddm, K5-hddm, K5-kswin and
// K5-stepd): integer counts, minima, maxima and "latest record" scans,
// whose results do not depend on the order of their combines. The
// lax-tree scans, whose results do, are in cluster_tree.cuh.
//
// * shfl_up / shfl_down / shfl_idx: a warp shuffle of any trivially
//   copyable value whose size is a multiple of 4 bytes, word by word;
// * warp_inclusive: a shuffle scan over the lanes;
// * block_exclusive: each thread's exclusive prefix in thread order (a
//   warp scan, one shared-memory pass over the warp totals) and the
//   block's total;
// * cluster_exclusive: each CTA's exclusive prefix over the CTAs of lower
//   rank, through distributed shared memory.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <string.h>

namespace cl {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 8;  // CTAs of a cluster (the portable limit)

template <class T>
struct Words {
  static_assert(sizeof(T) % 4 == 0, "shuffled values are whole 32-bit words");
  static constexpr int kN = sizeof(T) / 4;
  int w[kN];
};

template <class T, class F>
__device__ __forceinline__ T shfl_words(const T& v, F f) {
  Words<T> in, out;
  memcpy(in.w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < Words<T>::kN; ++i) out.w[i] = f(in.w[i]);
  T r;
  memcpy(&r, out.w, sizeof(T));
  return r;
}

template <class T>
__device__ __forceinline__ T shfl_up(const T& v, int d) {
  return shfl_words(v, [d](int x) { return __shfl_up_sync(kFull, x, d); });
}

template <class T>
__device__ __forceinline__ T shfl_down(const T& v, int d) {
  return shfl_words(v, [d](int x) { return __shfl_down_sync(kFull, x, d); });
}

template <class T>
__device__ __forceinline__ T shfl_idx(const T& v, int src) {
  return shfl_words(v, [src](int x) { return __shfl_sync(kFull, x, src); });
}

// Inclusive scan of v over the warp's lanes with op(earlier, later).
template <class T, class Op>
__device__ __forceinline__ T warp_inclusive(T v, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = shfl_up(v, d);
    if (lane >= d) v = op(o, v);
  }
  return v;
}

// Exclusive scan of v over the block's threads in thread order; `buf`
// holds one T per warp. `total` gets the block's total. Every thread of
// the block must call it; `buf` is free again on return.
template <class T, class Op>
__device__ __forceinline__ T block_exclusive(T v, T identity, Op op, T* buf, T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const T inc = warp_inclusive(v, op);
  T exc = shfl_up(inc, 1);
  if (lane == 0) exc = identity;
  if (lane == 31) buf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T wv = lane < nw ? buf[lane] : identity;
    wv = warp_inclusive(wv, op);
    if (lane < nw) buf[lane] = wv;
  }
  __syncthreads();
  if (warp > 0) exc = op(buf[warp - 1], exc);
  total = buf[nw - 1];
  __syncthreads();
  return exc;
}

// This CTA's exclusive prefix of `total` over the cluster's CTAs of lower
// rank, in rank order: each CTA publishes its total in `slot` (its own
// shared memory; a slot is written once per launch), cluster.sync(), and
// warp 0 reads the lower ranks' slots side by side and scans them;
// `bcast` passes the result to the block. Every thread must call it.
template <class T, class Op>
__device__ __forceinline__ T cluster_exclusive(cg::cluster_group& cluster, T total,
                                               T identity, Op op, T* slot, T* bcast) {
  if (threadIdx.x == 0) *slot = total;
  cluster.sync();
  if (threadIdx.x < 32) {
    const int rank = static_cast<int>(cluster.block_rank());
    const int lane = threadIdx.x;
    T r = lane < rank ? *cluster.map_shared_rank(slot, lane) : identity;
    r = warp_inclusive(r, op);
    if (lane == kMaxCluster - 1) *bcast = r;
  }
  __syncthreads();
  return *bcast;
}

}  // namespace cl
