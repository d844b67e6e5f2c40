// K5-ph — the Page–Hinkley window statistic.
//
// Replaces the JAX package's ops/detectors.py `ph_window` -> `_ph_masks`
// (:251) and `summarise_window` (XLA-lowered there: cumsum, an
// associative_scan of (A, B, K) clamp-affine maps, masked argmax). For each
// row of W·B error indicators it computes the prefix count and input sum
// carried from the state, the running mean, each element's map
// m -> max(K, A·m + B) (A = alpha, B = x - mean - delta, K = 0 when live;
// A = 1, B = 0, K = -1e30 on padding), their inclusive composition,
// m = max(K, A·m0 + B), the warning/change tests, and per batch the first
// change and the first warning at or before it. It writes [W]
// first-warning and first-change indices and the three end-state scalars;
// the masks never leave the row's CTAs.
//
// Bound on an H100: errs (4 B) and live (1 B) per element, 8 B per batch —
// about 1 MB per call at the main path's [16, 12800], 0.3 us at 3.35 TB/s.
// What costs time is the dependence along the row: one combine tree and one
// order-free scan. Two paths, the launcher taking the one the wrapper names:
//
// * the cluster path (rows of at most 2048 CTAs' worth: N <= 2048·cs, cs the
//   cluster size K1 uses, 8 at P = 16): one thread-block cluster of
//   ceil(N / 2048) CTAs per row, 7 at N = 12,800. CTA r owns the aligned
//   segment [2048·r, 2048·(r+1)), each of its 256 threads 8 consecutive
//   elements, whose state (error, count, mean, B, m) stays in registers
//   from load to test. The (count, sum) prefix is a warp-shuffle scan, one
//   shared-memory pass over the warp totals and one exchange of CTA totals
//   through distributed shared memory (cluster_scan.cuh); the tree prefixes
//   are cluster_tree.cuh's `tree_prefixes` (K5-hddm_w's), with one 12-byte
//   map a CTA through distributed shared memory; a batch's marks go by
//   shared-memory atomics, one a thread and batch, to the CTA that holds
//   its first element. Three cluster barriers a launch.
// * the global-scratch path (longer rows, P >= 67 at N = 12,800): one CTA of
//   512 threads per row — a block scan of (count, sum) over thread chunks,
//   then the combine tree level by level with a barrier between levels (27
//   at N = 12,800). The levels above the first (N/2 + N/4 + ... tuples of
//   12 B, 154 KB at N = 12,800) live in shared memory when they fit, else
//   in a global scratch; the first level's elements are generated from the
//   inputs and the per-element scratch (B, count).
//
// Exactness (bit-identical to `ph_window_reference`): counts and input sums
// are integers in f32, so their order is free; the composition runs on
// lax.associative_scan's tree (zoo_scan.cuh's level by level, or
// cluster_tree.cuh's fold of aligned blocks, which starts every fold from
// the empty prefix: composing with the padding map is not a no-op here)
// with the same operations as the plain version — A2·A1, fma(A2, B1, B2),
// max(K2, fma(A2, K1, B2)) and the final fma(A, m0, B), because XLA on the
// CPU fuses those multiply-adds — built with -fmad=false (no other
// contraction) and -ftz=true (XLA on the CPU flushes subnormals, and the
// plain version flushes them as it does: the running product alpha^k
// underflows after some hundreds of elements).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_tree.cuh"
#include "zoo_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using zoo::kThreads;

struct Map {  // m -> max(k, a·m + b)
  float a, b, k;
};

__device__ __forceinline__ Map compose(const Map& f, const Map& g) {  // f, then g
  return Map{__fmul_rn(g.a, f.a), __fmaf_rn(g.a, f.b, g.b),
             fmaxf(g.k, __fmaf_rn(g.a, f.k, g.b))};
}

struct CountSum {
  int c;
  float s;
};

__global__ void __launch_bounds__(kThreads) ph_window_kernel(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ count_in, const float* __restrict__ x_sum_in,
    const float* __restrict__ m_in, int w, int b, int min_num_instances,
    float alpha, float delta, float thr, float wthr, float* __restrict__ scratch,
    long long row_words, int levels_in_smem, int* __restrict__ first_warning,
    int* __restrict__ first_change, int* __restrict__ count_out,
    float* __restrict__ x_sum_out, float* __restrict__ m_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) CountSum scan_buf[2 * kThreads];
  const int row = blockIdx.x;
  const int n = w * b;
  int* fc = reinterpret_cast<int*>(smem);
  int* fw = fc + w;
  const size_t firsts = (2 * static_cast<size_t>(w) * sizeof(int) + 15) & ~size_t(15);
  float* rs = scratch + static_cast<size_t>(row) * row_words;
  float* e_b = rs;                                // [n] B of live elements, 0 on padding
  int* e_cnt = reinterpret_cast<int*>(rs + n);    // [n] running count
  Map* lev = levels_in_smem ? reinterpret_cast<Map*>(smem + firsts)
                            : reinterpret_cast<Map*>(rs + 2 * static_cast<size_t>(n));
  const float* e = errs + static_cast<size_t>(row) * n;
  const uint8_t* v = live + static_cast<size_t>(row) * n;
  zoo::first_init(fc, fw, w, b);

  // 1. prefix count and input sum over thread chunks; per-element B, count
  int lo, hi;
  zoo::chunk_of(n, lo, hi);
  CountSum mine{0, 0.0f};
  for (int j = lo; j < hi; ++j)
    if (v[j]) {
      mine.c += 1;
      mine.s = __fadd_rn(mine.s, e[j]);
    }
  CountSum pre = zoo::block_exclusive_scan(
      mine, CountSum{0, 0.0f},
      [](const CountSum& x, const CountSum& y) { return CountSum{x.c + y.c, __fadd_rn(x.s, y.s)}; },
      scan_buf);
  const int count0 = count_in[row];
  const float x_sum0 = x_sum_in[row];
  for (int j = lo; j < hi; ++j) {
    const bool ok = v[j] != 0;
    if (ok) {
      pre.c += 1;
      pre.s = __fadd_rn(pre.s, e[j]);
    }
    const int cnt = count0 + pre.c;
    const float xsum = __fadd_rn(x_sum0, pre.s);
    const float mean = __fdiv_rn(xsum, static_cast<float>(cnt > 1 ? cnt : 1));
    e_b[j] = ok ? __fsub_rn(__fsub_rn(e[j], mean), delta) : 0.0f;
    e_cnt[j] = cnt;
    if (j == n - 1) {
      count_out[row] = cnt;
      x_sum_out[row] = xsum;
    }
  }
  __syncthreads();

  // 2. the composition, and per element the tests
  const float m0 = m_in[row];
  auto gen = [&](int j) {
    return v[j] ? Map{alpha, e_b[j], 0.0f} : Map{1.0f, 0.0f, -1e30f};
  };
  auto emit = [&](int j, const Map& s) {
    const float m = fmaxf(s.k, __fmaf_rn(s.a, m0, s.b));
    const bool check = v[j] && e_cnt[j] >= min_num_instances;
    const bool change = check && m > thr;
    const bool warning = check && !change && m > wthr;
    zoo::first_mark(fc, fw, j, b, warning, change);
    if (j == n - 1) m_out[row] = m;
  };
  zoo::tree_scan(n, lev, gen, [](const Map& f, const Map& g) { return compose(f, g); }, emit);
  __syncthreads();
  zoo::first_store(fc, fw, w, b, first_warning + static_cast<size_t>(row) * w,
                   first_change + static_cast<size_t>(row) * w);
}

// ---------------------------------------------------------------------------
// The cluster path (cluster_tree.cuh: the tree, the loads, the marks).

using ct::kEpt;
using ct::kSeg;

struct MapTree {
  using T = Map;
  static __device__ __forceinline__ Map compose(const Map& f, const Map& g) {
    return ::compose(f, g);
  }
  static __device__ __forceinline__ Map identity() { return Map{1.0f, 0.0f, -1e30f}; }
};

struct ClusterShared {
  ct::TreeShared<Map> tree;
  CountSum pub, bcast, buf[ct::kWarps];
};

__global__ void __launch_bounds__(ct::kThreads, 1) ph_window_kernel_cluster(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ count_in, const float* __restrict__ x_sum_in,
    const float* __restrict__ m_in, int w, int b, int cs, int min_num_instances,
    float alpha, float delta, float thr, float wthr, int* __restrict__ first_warning,
    int* __restrict__ first_change, int* __restrict__ count_out,
    float* __restrict__ x_sum_out, float* __restrict__ m_out) {
  __shared__ ClusterShared sh;
  extern __shared__ int marks[];  // ct::init_marks
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / cs;
  const int n = w * b;
  const int a = rank * kSeg + static_cast<int>(threadIdx.x) * kEpt;
  const int ne = max(0, min(kEpt, n - a));
  ct::init_marks(marks, rank, n, b);
  float x[kEpt];
  const unsigned ok = ct::load_elements(errs + static_cast<size_t>(row) * n,
                                        live + static_cast<size_t>(row) * n, a, n, x);

  // 1. the count and input sum before the thread's first element (integers
  //    in f32: any order of adds is exact)
  CountSum mine{__popc(ok), 0.0f};
#pragma unroll
  for (int q = 0; q < kEpt; ++q)
    if ((ok >> q) & 1u) mine.s = __fadd_rn(mine.s, x[q]);
  auto add = [](const CountSum& p, const CountSum& q) {
    return CountSum{p.c + q.c, __fadd_rn(p.s, q.s)};
  };
  CountSum tot;
  const CountSum before = cl::block_exclusive(mine, CountSum{0, 0.0f}, add, sh.buf, tot);
  CountSum run = add(cl::cluster_exclusive(cluster, tot, CountSum{0, 0.0f}, add, &sh.pub,
                                           &sh.bcast),
                     before);

  // 2. per element the count, the input sum, the mean and the map
  const int count0 = count_in[row];
  const float x_sum0 = x_sum_in[row];
  int cnt[kEpt];
  Map g[kEpt], pre[kEpt];
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    const bool okq = (ok >> q) & 1u;
    if (okq) run = add(run, CountSum{1, x[q]});
    cnt[q] = count0 + run.c;
    const float xsum = __fadd_rn(x_sum0, run.s);
    const float mean = __fdiv_rn(xsum, static_cast<float>(cnt[q] > 1 ? cnt[q] : 1));
    g[q] = okq ? Map{alpha, __fsub_rn(__fsub_rn(x[q], mean), delta), 0.0f}
               : Map{1.0f, 0.0f, -1e30f};
    if (a + q == n - 1) {
      count_out[row] = cnt[q];
      x_sum_out[row] = xsum;
    }
  }

  // 3. the composition, and per element m and the tests
  ct::tree_prefixes<MapTree>(cluster, g, n, cs, sh.tree, pre);
  const float m0 = m_in[row];
  ct::ThreadMarks tm(a, b);
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    if (q < ne) {
      const int j = a + q;
      const float m = fmaxf(pre[q].k, __fmaf_rn(pre[q].a, m0, pre[q].b));
      const bool check = ((ok >> q) & 1u) && cnt[q] >= min_num_instances;
      const bool change = check && m > thr;
      const bool warning = check && !change && m > wthr;
      tm.note(cluster, marks, rank, j, n, b, warning, change);
      if (j == n - 1) m_out[row] = m;
    }
  }
  tm.flush(cluster, marks, rank, n, b);

  cluster.sync();
  ct::store_marks(marks, rank, n, b, first_warning + static_cast<size_t>(row) * w,
                  first_change + static_cast<size_t>(row) * w);
}

}  // namespace

// `ctas` > 0: the cluster path, one cluster of `ctas` CTAs per partition row
// (ctas = ceil(w·b / 2048) <= 8; `scratch` unused). `ctas` = 0: the
// global-scratch path, one CTA per row, `scratch` holding p rows of
// 2·n + 3·scan_levels(n) floats (n = w·b). Returns a CUDA error code: a
// refused cluster launch is returned, never worked around.
extern "C" int ph_window_launch(
    const float* errs, const uint8_t* live, const int* count_in,
    const float* x_sum_in, const float* m_in, int p, int w, int b, int ctas,
    int min_num_instances, float alpha, float delta, float thr, float wthr,
    float* scratch, int* first_warning, int* first_change, int* count_out,
    float* x_sum_out, float* m_out, void* stream) {
  if (ctas > 0)
    return ct::launch_clusters(ph_window_kernel_cluster, p, ctas, b, stream, errs, live,
                               count_in, x_sum_in, m_in, w, b, ctas, min_num_instances,
                               alpha, delta, thr, wthr, first_warning, first_change,
                               count_out, x_sum_out, m_out);
  const long long n = static_cast<long long>(w) * b;
  const long long levels = zoo::scan_levels(n);
  size_t smem = 0;
  int in_smem = 0;
  cudaError_t e = zoo::dynamic_smem(ph_window_kernel, w, levels * sizeof(Map), smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ph_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, count_in, x_sum_in, m_in, w, b, min_num_instances, alpha,
      delta, thr, wthr, scratch, 2 * n + 3 * levels, in_smem, first_warning,
      first_change, count_out, x_sum_out, m_out);
  return static_cast<int>(cudaGetLastError());
}
