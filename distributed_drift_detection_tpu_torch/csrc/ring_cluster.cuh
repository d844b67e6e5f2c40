// The ring-buffer members' cluster path (K5-kswin, K5-stepd): the cluster
// counterpart of ring_compact.cuh's `compact`, on the layout of the other
// zoo kernels' cluster paths — one cluster of ceil(N / 2048) CTAs per
// partition row, CTA r owning the aligned segment [2048·r, 2048·(r+1)),
// each of its 256 threads 8 consecutive elements in registers
// (cluster_tree.cuh's load, marks and launch).
//
// The plain versions' row (ops/detectors.py `_ring_compact`, JAX :944) is
// full = [carried window buf[wr] | the row's valid elements, compacted],
// and ps[k] the sum of its first k values. Nothing here stores that row:
//
// * each CTA writes, in its own shared memory, `loc`: the inclusive error
//   count at each of its valid elements, in compaction order (<= 2048
//   floats), and publishes its (valid count, error sum);
// * every CTA builds the carried window's prefix cp[0..wr] in its shared
//   memory (one block scan, beside the elements' counts);
// * after one cluster barrier, every CTA gathers all CTAs' totals, so it
//   knows each rank's valid base base_n[o] and error base base_c[o], and
//   the row's nv and error total.
//
// Then ps[k] is cp[k] for k <= wr, and above it C + base_c[o] + loc_o[i −
// base_n[o]] for the compacted index i = k − wr − 1, its owner o the last
// rank whose base is at most i (a CTA of padding only has its successor's
// base, so it never owns one), read through distributed shared memory
// where o is another CTA (the look-back). A window reaches at most wr
// values back, so a CTA whose first valid element has compaction index
// base_n reads below that only ps[base_n + 1 .. base_n + wr]: each CTA
// gathers those wr values once, side by side (`ext`: the carried prefix,
// earlier CTAs' `loc` through distributed shared memory), and every
// element then reads its window in its own CTA's shared memory. An
// element's own prefix is in its registers. Windows longer than a
// segment, segments of padding only and windows that reach into the
// carried buffer follow from the same rule.
//
// Exactness: every value summed is a 0/1 indicator, so every prefix is an
// integer below 2^24 and exact in any order — the same bits as the plain
// version's float32 cumsum.
//
// Shared memory: `loc` and the bases statically; dynamically the marks
// (cluster_tree.cuh), cp (wr + 1 floats) and `ext` (wr floats) — which
// bound the window on this path (kWindowCap, ops/detectors.py
// RING_WINDOW_CAP); a longer window takes the one-CTA kernel.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_scan.cuh"
#include "cluster_tree.cuh"

namespace ring {

namespace cg = cooperative_groups;

// The longest window_size on the cluster path: cp and `ext` (128 KiB)
// beside the marks (<= 16 KiB) and `loc` (8 KiB) fit an H100 CTA's 227 KiB.
constexpr int kWindowCap = 16384;

// A thread's share of the block scan: its valid elements, their error sum,
// and the sum of its chunk of the carried window.
struct Share {
  int n;
  float c;
  float w;
};

__device__ __forceinline__ Share then_share(const Share& x, const Share& y) {
  return Share{x.n + y.n, __fadd_rn(x.c, y.c), __fadd_rn(x.w, y.w)};
}

struct ClusterShared {
  float loc[ct::kSeg];                 // inclusive error counts, compaction order
  Share sbuf[ct::kWarps];              // block_exclusive's
  int all_n[cl::kMaxCluster];          // every CTA's valid count and error sum,
  float all_c[cl::kMaxCluster];        // stored here by each CTA before barrier 1
  int base_n[cl::kMaxCluster + 1];     // every rank's bases; [cs] the row's totals
  float base_c[cl::kMaxCluster + 1];
};

// Dynamic shared memory of a launch: the marks, then cp, then `ext`.
inline size_t cluster_smem(int b, int wr) {
  return ct::marks_bytes(b) + (2 * static_cast<size_t>(wr) + 1) * sizeof(float);
}

struct Flags {
  bool warning, change;
};

// The row's totals: valid elements, their error sum.
struct RowTotals {
  int nv;
  float errors;
};

// The cluster path's walk over one row: for each valid element,
// test(q1, own, inc, ps) with q1 its 1-based compaction index, inc the
// row's inclusive error count at it, own = ps[wr + q1] and ps(k) the
// prefix row's value at k (the look-back), returning its Flags; then the
// marks, the next carried window `buf_out`, and the row's marks stored.
// `test` runs on every slot of a thread, side by side, so it must read
// only through ps and change nothing.
// `dyn` is the kernel's dynamic shared memory (cluster_smem). Two cluster
// barriers: after the totals and `loc` are published, and after `ext` is
// gathered and every remote mark made. Every thread of the cluster calls
// it.
template <class Test>
__device__ __forceinline__ RowTotals cluster_row(
    cg::cluster_group& cluster, ClusterShared& sh, int* dyn, const float* __restrict__ e,
    const uint8_t* __restrict__ lv, const float* __restrict__ buf, float* __restrict__ buf_out,
    int n, int b, int wr, int cs, int* __restrict__ first_warning,
    int* __restrict__ first_change, Test test) {
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  int* marks = dyn;
  float* cp = reinterpret_cast<float*>(dyn + 2 * (ct::kSeg / b + 2));
  float* ext = cp + wr + 1;
  const int a = rank * ct::kSeg + tid * ct::kEpt;
  ct::init_marks(marks, rank, n, b);
  float x[ct::kEpt];
  const unsigned ok = ct::load_elements(e, lv, a, n, x);

  // the counts, and the thread's chunk of the carried window
  const int per = (wr + ct::kThreads - 1) / ct::kThreads;
  const int wlo = min(wr, tid * per);
  const int whi = min(wr, wlo + per);
  Share mine{0, 0.0f, 0.0f};
  for (int i = wlo; i < whi; ++i) mine.w = __fadd_rn(mine.w, buf[i]);
#pragma unroll
  for (int q = 0; q < ct::kEpt; ++q)
    if ((ok >> q) & 1u) {
      ++mine.n;
      mine.c = __fadd_rn(mine.c, x[q]);
    }
  Share tot;
  const Share before = cl::block_exclusive(
      mine, Share{0, 0.0f, 0.0f}, [](const Share& p, const Share& q) { return then_share(p, q); },
      sh.sbuf, tot);
  const float carried = tot.w;  // C = ps[wr]
  if (tid == 0) cp[0] = 0.0f;
  float s = before.w;
  for (int i = wlo; i < whi; ++i) {
    s = __fadd_rn(s, buf[i]);
    cp[i + 1] = s;
  }
  {
    int m = before.n;
    float c = before.c;
#pragma unroll
    for (int q = 0; q < ct::kEpt; ++q)
      if ((ok >> q) & 1u) {
        c = __fadd_rn(c, x[q]);
        sh.loc[m++] = c;
      }
  }
  if (tid < cs) {  // the totals into every CTA's shared memory, read there
    ClusterShared* dst = cluster.map_shared_rank(&sh, tid);
    dst->all_n[rank] = tot.n;
    dst->all_c[rank] = tot.c;
  }
  cluster.sync();

  // every rank's bases, from every CTA's totals
  if (tid < 32) {
    int pn = tid < cs ? sh.all_n[tid] : 0;
    float pc = tid < cs ? sh.all_c[tid] : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int un = __shfl_up_sync(cl::kFull, pn, d);
      const float uc = __shfl_up_sync(cl::kFull, pc, d);
      if (tid >= d) {
        pn += un;
        pc = __fadd_rn(uc, pc);
      }
    }
    int en = __shfl_up_sync(cl::kFull, pn, 1);
    float ec = __shfl_up_sync(cl::kFull, pc, 1);
    if (tid == 0) {
      en = 0;
      ec = 0.0f;
    }
    if (tid <= cs) {
      sh.base_n[tid] = en;
      sh.base_c[tid] = ec;
    }
  }
  __syncthreads();
  const int nv = sh.base_n[cs];
  const int my_n = sh.base_n[rank];
  const float my_c = sh.base_c[rank];

  // ext[t] = ps[my_n + 1 + t]: the look-back below this CTA's elements
  for (int t = tid; t < wr; t += ct::kThreads) {
    const int k = my_n + 1 + t;
    float v;
    if (k <= wr) {
      v = cp[k];
    } else {
      const int i = k - wr - 1;  // < my_n: an earlier CTA's
      int o = 0;
#pragma unroll
      for (int r = 1; r < cl::kMaxCluster; ++r) o += (r < cs && sh.base_n[r] <= i) ? 1 : 0;
      const float* src = cluster.map_shared_rank(sh.loc, o);
      v = __fadd_rn(carried, __fadd_rn(sh.base_c[o], src[i - sh.base_n[o]]));
    }
    ext[t] = v;
  }
  __syncthreads();

  // ps[k] for k >= my_n + 1, all a window reads
  auto ps = [&](int k) -> float {
    const int i = k - wr - 1;
    if (i >= my_n) return __fadd_rn(carried, __fadd_rn(my_c, sh.loc[i - my_n]));
    return ext[k - my_n - 1];
  };

  // the thread's tests side by side, with no branch between them: a slot
  // that holds no valid element is tested as the next valid element would
  // be (its reads stay in range) and its flags are dropped below
  Flags f[ct::kEpt];
  int qk[ct::kEpt];
  {
    int q = my_n + before.n;  // the compaction index of the next valid element
    float c = before.c;
#pragma unroll
    for (int k = 0; k < ct::kEpt; ++k) {
      const bool valid = (ok >> k) & 1u;
      c = __fadd_rn(c, valid ? x[k] : 0.0f);
      const float inc = __fadd_rn(my_c, c);
      qk[k] = q;
      f[k] = test(q + 1, __fadd_rn(carried, inc), inc, ps);
      q += valid ? 1 : 0;
    }
  }
  ct::ThreadMarks tm(a, b);
#pragma unroll
  for (int k = 0; k < ct::kEpt; ++k) {
    if (!((ok >> k) & 1u)) continue;
    tm.note(cluster, marks, rank, a + k, n, b, f[k].warning, f[k].change);
    const int at = qk[k] - nv + wr;  // its place in the next window
    if (at >= 0) buf_out[at] = x[k];
  }
  if (rank == 0)
    for (int i = tid; i < wr - nv; i += ct::kThreads) buf_out[i] = buf[nv + i];
  tm.flush(cluster, marks, rank, n, b);

  cluster.sync();
  ct::store_marks(marks, rank, n, b, first_warning, first_change);
  return RowTotals{nv, sh.base_c[cs]};
}

}  // namespace ring
