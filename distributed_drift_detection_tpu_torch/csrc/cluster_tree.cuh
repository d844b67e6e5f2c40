// lax.associative_scan's combine tree across a thread-block cluster, for the
// zoo kernels' cluster paths (K5-ph, K5-hddm_w): one cluster of
// ceil(N / 2048) CTAs per partition row, CTA r owning the aligned segment
// [2048·r, 2048·(r+1)), each of its 256 threads 8 consecutive elements
// whose state stays in registers.
//
// The rule the tree prefixes rest on: lax.associative_scan's prefix of the
// first m elements is the left fold, most significant first, of the tree's
// values of the aligned power-of-two blocks of m's binary expansion (pinned
// on the CPU by tests/test_torch_detectors.py
// `test_tree_prefix_is_a_fold_of_aligned_blocks`). So a CTA needs only its
// own block values and the values of whole earlier segments: `tree_prefixes`
// builds each scale's blocks where they live — a thread's 8 elements in
// registers, 32 threads by shuffles, 8 warps and <= 8 CTAs by one warp's
// shuffles, one tuple a CTA through distributed shared memory — and folds
// them. A block exists only if it is complete, so ragged tails follow.
//
// Every fold starts from the empty prefix (`then` with its `has` flag), not
// from the tuple's identity: composing with a synthetic identity is not a
// no-op for every tuple (in front of a Page–Hinkley map, the padding map
// turns a B of -0.0 into +0.0 and, where A is 0, K into max(K, B)), and no
// value that is used contains an element past n.
//
// A tuple type is given by a traits struct Tr: `Tr::T` (trivially copyable,
// a whole number of 32-bit words), `Tr::compose(f, g)` (f, then g) and
// `Tr::identity()` (a filler for lanes past the last block; never used).
// Also here, for every zoo kernel's cluster path (K5-eddm's, K5-hddm's,
// K5-kswin's and K5-stepd's too): the segment's vectorised load, the
// per-batch first-change / first-warning marks, which go by shared-memory
// atomics (one a thread and batch) to the CTA that holds the batch's first
// element, and the launch.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_scan.cuh"

namespace ct {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEpt = 8;                   // elements a thread
constexpr int kSeg = kThreads * kEpt;     // 2048 elements a CTA

// has ? acc, then x : x — a fold step that starts from the empty prefix.
template <class Tr>
__device__ __forceinline__ typename Tr::T then(bool has, const typename Tr::T& acc,
                                               const typename Tr::T& x) {
  return has ? Tr::compose(acc, x) : x;
}

// A warp's up-sweep of one value a lane: lev[d], at a lane that is a
// multiple of 2^d, is the tree's value of the block of lanes
// [lane, lane + 2^d) (d = 0..D).
template <class Tr, int D, int N>
__device__ __forceinline__ void up_sweep(typename Tr::T (&lev)[N], const typename Tr::T& v) {
  static_assert(N > D, "");
  lev[0] = v;
#pragma unroll
  for (int d = 1; d <= D; ++d)
    lev[d] = Tr::compose(lev[d - 1], cl::shfl_down(lev[d - 1], 1 << (d - 1)));
}

// acc, then the tree's values of the aligned blocks of m's binary
// expansion (m < 2^(D+1) lanes' worth), most significant first, from an
// up-sweep; m may differ between lanes. Every lane must call it.
template <class Tr, int D, int N>
__device__ __forceinline__ void fold_blocks(typename Tr::T& acc, bool& has,
                                            const typename Tr::T (&lev)[N], int m) {
  static_assert(N > D, "");
#pragma unroll
  for (int b = D; b >= 0; --b) {
    const typename Tr::T val = cl::shfl_idx(lev[b], (m >> (b + 1)) << (b + 1));
    if ((m >> b) & 1) {
      acc = then<Tr>(has, acc, val);
      has = true;
    }
  }
}

// Per CTA: the tree's block value and the prefixes at warp granularity.
template <class T>
struct TreeShared {
  T tile;                 // the CTA's 2048-element block, published
  T wU[kWarps];           // each warp's 256-element block
  T wE[kWarps + 1];       // the prefix at each warp's start, and at the end
  int wEhas[kWarps + 1];  // 0: the empty prefix (element 0 of the row)
};

// The inclusive scan of the row's elements under Tr::compose on
// lax.associative_scan's tree: out[q] = the prefix of the first a+q+1
// elements (a = this thread's first element, q < 8 and a+q < n), given the
// thread's element tuples g[q] (anything past n: out[q] for an element
// below n never reads a later one). m = a+q+1 splits into the blocks of the
// CTA's start (CTAs of lower rank: the cluster's top of the tree), of the
// warp's start within the CTA, of the thread's start within the warp and
// of q+1 within the thread, except q = 7, whose prefix is the next
// thread's start. At each of the three upper scales one warp's up-sweep and
// fold by shuffles; within the thread, registers. One cluster barrier.
// Every thread of the cluster calls it.
template <class Tr>
__device__ __forceinline__ void tree_prefixes(cg::cluster_group& cluster,
                                              const typename Tr::T (&g)[kEpt], int n, int cs,
                                              TreeShared<typename Tr::T>& ts,
                                              typename Tr::T (&out)[kEpt]) {
  using T = typename Tr::T;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());

  // the thread's levels 1-3, then the warp's levels 3-8 over its lanes
  T u1[4], u2[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) u1[k] = Tr::compose(g[2 * k], g[2 * k + 1]);
  u2[0] = Tr::compose(u1[0], u1[1]);
  u2[1] = Tr::compose(u1[2], u1[3]);
  T ulev[6];
  up_sweep<Tr, 5>(ulev, Tr::compose(u2[0], u2[1]));
  if (lane == 0) ts.wU[warp] = ulev[5];
  __syncthreads();
  // warp 0: the CTA's levels 8-11 over its warps, the CTA's value
  // published; then the cluster's levels 11-14 over its CTAs, the prefixes
  // at this CTA's start and end and at each warp's start
  T wlev[4];
  if (warp == 0) {
    up_sweep<Tr, 3>(wlev, lane < kWarps ? ts.wU[lane] : Tr::identity());
    if (lane == 0) ts.tile = wlev[3];
  }
  cluster.sync();
  if (warp == 0) {
    const int full = min(cs, n / kSeg);  // complete CTA blocks: they have a value
    T tlev[4];
    up_sweep<Tr, 3>(tlev, lane < full ? cluster.map_shared_rank(&ts, lane)->tile
                                      : Tr::identity());
    T e_cta = Tr::identity(), e_next = Tr::identity();
    bool has = false, has_next = false;
    fold_blocks<Tr, 3>(e_cta, has, tlev, rank);
    fold_blocks<Tr, 3>(e_next, has_next, tlev, rank + 1);  // used only if rank < full
    fold_blocks<Tr, 3>(e_cta, has, wlev, lane);
    if (lane < kWarps) {
      ts.wE[lane] = e_cta;
      ts.wEhas[lane] = has;
    } else if (lane == kWarps) {
      ts.wE[kWarps] = e_next;
      ts.wEhas[kWarps] = has_next;
    }
  }
  __syncthreads();
  // the prefix at the thread's start: the warp's, then the lane blocks
  T acc = ts.wE[warp];
  bool has = ts.wEhas[warp] != 0;
  fold_blocks<Tr, 4>(acc, has, ulev, lane);
  T next = cl::shfl_down(acc, 1);
  if (lane == 31) next = ts.wE[warp + 1];
  out[0] = then<Tr>(has, acc, g[0]);
  out[1] = then<Tr>(has, acc, u1[0]);
  out[2] = Tr::compose(out[1], g[2]);
  out[3] = then<Tr>(has, acc, u2[0]);
  out[4] = Tr::compose(out[3], g[4]);
  out[5] = Tr::compose(out[3], u1[2]);
  out[6] = Tr::compose(out[5], g[6]);
  out[7] = next;
}

// A thread's elements [a, a + 8) of a row of n: the errors (0 past n) and
// a bit per live element. Two float4 and one uint2 loads where the 8 are
// there and aligned. Keep that choice the plain compare a + 8 <= n: written
// as max(0, min(8, n − a)) == 8, nvcc 12.9 compiled it in K5-kswin's
// cluster kernel to a VIMNMX whose predicate sent a thread holding 1–7
// elements down the 8-element load, which then counted the next row's
// leading elements.
__device__ __forceinline__ unsigned load_elements(const float* e, const uint8_t* lv, int a,
                                                  int n, float (&x)[kEpt]) {
  unsigned ok = 0;
  if (a + kEpt <= n && (reinterpret_cast<uintptr_t>(e + a) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(lv + a) & 7) == 0) {
    const float4 x0 = __ldg(reinterpret_cast<const float4*>(e + a));
    const float4 x1 = __ldg(reinterpret_cast<const float4*>(e + a) + 1);
    const uint2 l = __ldg(reinterpret_cast<const uint2*>(lv + a));
    x[0] = x0.x; x[1] = x0.y; x[2] = x0.z; x[3] = x0.w;
    x[4] = x1.x; x[5] = x1.y; x[6] = x1.z; x[7] = x1.w;
#pragma unroll
    for (int q = 0; q < kEpt; ++q)
      if ((((q < 4 ? l.x : l.y) >> (8 * (q & 3))) & 0xffu) != 0) ok |= 1u << q;
  } else {
#pragma unroll
    for (int q = 0; q < kEpt; ++q) {
      const bool in = a + q < n;
      x[q] = in ? e[a + q] : 0.0f;
      if (in && lv[a + q] != 0) ok |= 1u << q;
    }
  }
  return ok;
}

// Batches overlapping CTA r's segment: its first-change and first-warning
// marks in shared memory, for batches floor(2048·r / b) on.
__device__ __forceinline__ int marks_per_cta(int r, int n, int b) {
  const int lo = r * kSeg;
  return (min(lo + kSeg, n) - 1) / b - lo / b + 1;
}

// Shared memory the marks take: two ints for each batch a segment can
// overlap.
inline size_t marks_bytes(int b) { return 2 * static_cast<size_t>(kSeg / b + 2) * sizeof(int); }

// The CTA's marks, [change: nbl][warning: nbl], set to "none" (b). Before
// the first cluster barrier, so remote marks find them initialised.
__device__ __forceinline__ void init_marks(int* marks, int rank, int n, int b) {
  const int nbl = marks_per_cta(rank, n, b);
  for (int k = threadIdx.x; k < 2 * nbl; k += blockDim.x) marks[k] = b;
}

// A thread's first change and first warning in the batch its current
// element is in (b: none). A thread's elements run in order, so the first
// it flags in a batch is its least, and only that goes, by one atomicMin,
// into the marks of the CTA holding the batch's first element (remote for
// a batch that starts in an earlier segment): the minimum over the batch
// is the same as with an atomic an element.
struct ThreadMarks {
  int k, fc, fw;

  __device__ __forceinline__ ThreadMarks(int a, int b) : k(a / b), fc(b), fw(b) {}

  // Element j (at or after the last one noted) flagged warning/change.
  __device__ __forceinline__ void note(cg::cluster_group& cluster, int* marks, int rank, int j,
                                       int n, int b, bool warning, bool change) {
    if (!change && !warning) return;
    if (j / b != k) {
      flush(cluster, marks, rank, n, b);
      *this = ThreadMarks(j, b);
    }
    if (change && fc == b) fc = j % b;
    if (warning && fw == b) fw = j % b;
  }

  // The current batch's marks into the shared ones; every thread calls it
  // once after its last note, before the last cluster barrier.
  __device__ __forceinline__ void flush(cg::cluster_group& cluster, int* marks, int rank, int n,
                                        int b) const {
    if (fc == b && fw == b) return;
    const int owner = k * b / kSeg;
    const int olo = owner * kSeg / b;
    int* m = owner == rank ? marks : cluster.map_shared_rank(marks, owner);
    if (fc < b) atomicMin(&m[k - olo], fc);
    if (fw < b) atomicMin(&m[marks_per_cta(owner, n, b) + k - olo], fw);
  }
};

// Per batch, from the CTA holding its first element, once every CTA's marks
// are in (the caller's last cluster barrier): the first change, and the
// first warning if it is at or before it; -1 = none. No CTA touches
// another's shared memory after that barrier.
__device__ __forceinline__ void store_marks(const int* marks, int rank, int n, int b,
                                            int* first_warning, int* first_change) {
  const int seg0 = rank * kSeg;
  const int k_lo = seg0 / b;
  const int nbl = marks_per_cta(rank, n, b);
  for (int i = threadIdx.x; i < nbl; i += blockDim.x) {
    const int k = k_lo + i;
    if (k * b < seg0) continue;  // its first element is in an earlier CTA
    const int fc = marks[i];
    const int fw = marks[nbl + i];
    first_change[k] = fc < b ? fc : -1;
    first_warning[k] = (fw < b && (fc >= b || fw <= fc)) ? fw : -1;
  }
}

// Launches `kernel` as one cluster of `ctas` CTAs for each of `p` rows, with
// `smem` bytes of dynamic shared memory (raising the kernel's limit past
// 48 KiB). Returns the CUDA error code: a refused cluster launch is
// returned, never worked around.
template <class Kernel, class... Args>
inline int launch_clusters_smem(Kernel kernel, int p, int ctas, size_t smem, void* stream,
                                Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p) * ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// launch_clusters_smem with the marks' shared memory alone.
template <class Kernel, class... Args>
inline int launch_clusters(Kernel kernel, int p, int ctas, int b, void* stream, Args... args) {
  return launch_clusters_smem(kernel, p, ctas, marks_bytes(b), stream, args...);
}

}  // namespace ct
