// K5-hddm — the HDDM-A window statistic.
//
// Replaces the JAX package's ops/detectors.py `_hddm_masks` (:548) and
// `summarise_window` (XLA-lowered there: two cumsums, the Hoeffding keys,
// an associative scan of a min with its (n, c) payload, the carried key,
// the two bounds, masked argmins). Per row of N = W·B elements:
//
// 1. the element count n and the error sum c at each element (a scan of
//    sums: counts and 0/1 indicators, exact in any order);
// 2. each element's key mean + ε(n), +inf where padded, and the running
//    minimum of the keys with its (n, c) payload, later ties winning (the
//    plain version's `ops/ddm.py` `_run_min`, an order-free scan);
// 3. the stored cut — the running minimum where it is at or below the
//    carried cut's key, else the carried cut — and the drift and warning
//    tests against it; per batch the first warning and change, and the end
//    state.
//
// Bound on an H100: the inputs are 5 B an element — 1 MB per call at
// [16, 12800] — so bytes bound it (≈ 0.3 µs). What costs time is the
// dependence along the row: two order-free scans. Two paths, the launcher
// taking the one the wrapper names (ops/detectors.py `cluster_ctas`, the
// rule of K5-ph and K5-hddm_w):
//
// * the cluster path (rows of N <= 2048·cs, cs the cluster size K1 uses, 8
//   at P = 16): one thread-block cluster of ceil(N / 2048) CTAs per row, 7
//   at N = 12,800. CTA r owns the aligned segment [2048·r, 2048·(r+1)),
//   each of its 256 threads 8 consecutive elements, loaded coalesced and
//   kept in registers with their (n, c), mean and key, each computed once.
//   Both scans are in-thread, then warp shuffles, one shared-memory pass
//   over the warp totals and one exchange of CTA totals through
//   distributed shared memory (cluster_scan.cuh); the stored cut and the
//   tests run from registers, and a batch's marks go by shared-memory
//   atomics, one a thread and batch, to the CTA that holds its first
//   element (cluster_tree.cuh). Three cluster barriers a launch.
// * the one-CTA path (longer rows, P >= 67 at N = 12,800): one CTA of 512
//   threads per row, each a contiguous chunk — a block scan of the counts,
//   a walk for the chunk's minimum, a block scan of those, and a walk for
//   the cut and the tests.
//
// Exactness: counts are int32; the error sums are sums of 0/1 indicators,
// exact below 2^24 in any order; a min with a payload does not round. The
// keys and bounds are the plain version's float32 expressions, built with
// -fmad=false: IEEE divisions and square roots (`__fdiv_rn`, `__fsqrt_rn`;
// ε is `f32(ln(1/δ))` divided by 2n, the bound's m is (n − n_min) /
// (n_min·n), then ·0.5·f32(ln(2/δ)), left to right; both bounds share m).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_tree.cuh"
#include "zoo_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using zoo::kThreads;

// A running minimum of keys with its payload; `has` false is the empty one.
struct Cut {
  float key;
  int n;
  float c;
  int has;
};

// earlier, then later: the later one wins ties
__device__ inline Cut later_min(Cut a, Cut b) {
  if (!b.has) return a;
  if (!a.has) return b;
  return b.key <= a.key ? b : a;
}

// ε(n, δ) = sqrt(ln(1/δ) / 2n), n as f32(max(n, 1))
__device__ inline float eps_of(float n_f, float log_conf) {
  return __fsqrt_rn(__fdiv_rn(log_conf, __fmul_rn(2.0f, n_f)));
}

// sqrt(max(m, 0) · 0.5 · ln(2/δ)), m = (n − n_min) / (n_min · n)
__device__ inline float bound_of(int n, int n_min, float log2_conf) {
  const float n_f = __int2float_rn(n < 1 ? 1 : n);
  const float nm_f = __int2float_rn(n_min < 1 ? 1 : n_min);
  float m = __fdiv_rn(__fsub_rn(n_f, nm_f), __fmul_rn(nm_f, n_f));
  m = m < 0.0f ? 0.0f : m;
  return __fsqrt_rn(__fmul_rn(__fmul_rn(m, 0.5f), log2_conf));
}

struct Counts {
  int n;
  float c;
};

__global__ void __launch_bounds__(kThreads) hddm_window_kernel(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ count_in, const float* __restrict__ err_sum_in,
    const int* __restrict__ n_min_in, const float* __restrict__ c_min_in, int w, int b,
    float log_drift, float log2_drift, float log2_warning, int* __restrict__ first_warning,
    int* __restrict__ first_change, int* __restrict__ count_out, float* __restrict__ err_sum_out,
    int* __restrict__ n_min_out, float* __restrict__ c_min_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) unsigned char scan_raw[2 * kThreads * sizeof(Cut)];
  const int row = blockIdx.x;
  const int n_el = w * b;
  int* fc = reinterpret_cast<int*>(smem);
  int* fw = fc + w;
  const float* e = errs + static_cast<size_t>(row) * n_el;
  const uint8_t* v = live + static_cast<size_t>(row) * n_el;
  zoo::first_init(fc, fw, w, b);
  int lo, hi;
  zoo::chunk_of(n_el, lo, hi);

  // 1. counts and error sums at the chunk's start
  Counts mine{0, 0.0f};
  for (int j = lo; j < hi; ++j)
    if (v[j]) {
      ++mine.n;
      mine.c = __fadd_rn(mine.c, e[j]);
    }
  const Counts first = zoo::block_exclusive_scan(
      mine, Counts{0, 0.0f},
      [](Counts x, Counts y) { return Counts{x.n + y.n, __fadd_rn(x.c, y.c)}; },
      reinterpret_cast<Counts*>(scan_raw));
  const int count0 = count_in[row];
  const float err0 = err_sum_in[row];

  // each element's (key, n, c), its window prefixes from the chunk's start
  auto walk = [&](auto on) {
    int n = count0 + first.n;
    float pre = first.c;
    for (int j = lo; j < hi; ++j) {
      const bool valid = v[j] != 0;
      if (valid) {
        ++n;
        pre = __fadd_rn(pre, e[j]);
      }
      const float c = __fadd_rn(err0, pre);
      const float n_f = __int2float_rn(n < 1 ? 1 : n);
      const float mean = __fdiv_rn(c, n_f);
      const float key = valid ? __fadd_rn(mean, eps_of(n_f, log_drift)) : INFINITY;
      on(j, valid, Cut{key, n, c, 1}, mean);
    }
  };

  // 2. the chunk's running minimum, then the minimum before it
  Cut run{0.0f, 0, 0.0f, 0};
  walk([&](int, bool, Cut cut, float) { run = later_min(run, cut); });
  run = zoo::block_exclusive_scan(run, Cut{0.0f, 0, 0.0f, 0},
                                  [](Cut x, Cut y) { return later_min(x, y); },
                                  reinterpret_cast<Cut*>(scan_raw));

  // 3. the stored cut and the tests
  const int nm_in = n_min_in[row];
  const float cm_in = c_min_in[row];
  const float nm_f = __int2float_rn(nm_in < 1 ? 1 : nm_in);
  const float carried_key =
      nm_in > 0 ? __fadd_rn(__fdiv_rn(cm_in, nm_f), eps_of(nm_f, log_drift)) : INFINITY;
  walk([&](int j, bool valid, Cut cut, float mean) {
    run = later_min(run, cut);
    const bool use_run = run.key <= carried_key;
    const int n_min = use_run ? run.n : nm_in;
    const float c_min = use_run ? run.c : cm_in;
    if (j == n_el - 1) {
      count_out[row] = cut.n;
      err_sum_out[row] = cut.c;
      n_min_out[row] = n_min;
      c_min_out[row] = c_min;
    }
    if (!(valid && n_min > 0 && n_min < cut.n)) return;
    const float diff =
        __fsub_rn(mean, __fdiv_rn(c_min, __int2float_rn(n_min < 1 ? 1 : n_min)));
    const bool change = diff >= bound_of(cut.n, n_min, log2_drift);
    const bool warning = !change && diff >= bound_of(cut.n, n_min, log2_warning);
    zoo::first_mark(fc, fw, j, b, warning, change);
  });
  __syncthreads();
  zoo::first_store(fc, fw, w, b, first_warning + static_cast<size_t>(row) * w,
                   first_change + static_cast<size_t>(row) * w);
}

// ---------------------------------------------------------------------------
// The cluster path (cluster_scan.cuh: the scans; cluster_tree.cuh: the
// loads and the marks).

using ct::kEpt;
using ct::kSeg;

struct ClusterShared {
  Counts cnt_pub, cnt_b, cbuf[ct::kWarps];
  Cut cut_pub, cut_b, kbuf[ct::kWarps];
};

__global__ void __launch_bounds__(ct::kThreads, 1) hddm_window_kernel_cluster(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ count_in, const float* __restrict__ err_sum_in,
    const int* __restrict__ n_min_in, const float* __restrict__ c_min_in, int w, int b,
    int cs, float log_drift, float log2_drift, float log2_warning,
    int* __restrict__ first_warning, int* __restrict__ first_change,
    int* __restrict__ count_out, float* __restrict__ err_sum_out,
    int* __restrict__ n_min_out, float* __restrict__ c_min_out) {
  __shared__ ClusterShared sh;
  extern __shared__ int marks[];  // ct::init_marks
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / cs;
  const int n_el = w * b;
  const int a = rank * kSeg + static_cast<int>(threadIdx.x) * kEpt;
  const int ne = max(0, min(kEpt, n_el - a));
  ct::init_marks(marks, rank, n_el, b);
  float x[kEpt];
  const unsigned ok = ct::load_elements(errs + static_cast<size_t>(row) * n_el,
                                        live + static_cast<size_t>(row) * n_el, a, n_el, x);

  // 1. the count and error sum before the thread's first element
  auto add = [](const Counts& p, const Counts& q) {
    return Counts{p.n + q.n, __fadd_rn(p.c, q.c)};
  };
  Counts mine{__popc(ok), 0.0f};
#pragma unroll
  for (int q = 0; q < kEpt; ++q)
    if ((ok >> q) & 1u) mine.c = __fadd_rn(mine.c, x[q]);
  Counts tot;
  const Counts before = cl::block_exclusive(mine, Counts{0, 0.0f}, add, sh.cbuf, tot);
  Counts run = add(cl::cluster_exclusive(cluster, tot, Counts{0, 0.0f}, add, &sh.cnt_pub,
                                         &sh.cnt_b),
                   before);

  // 2. each element's (n, c), mean and key, once; the thread's minimum
  const int count0 = count_in[row];
  const float err0 = err_sum_in[row];
  int nn[kEpt];
  float c[kEpt], mean[kEpt], key[kEpt];
  const Cut none{0.0f, 0, 0.0f, 0};
  Cut mine_min = none;
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    const bool okq = (ok >> q) & 1u;
    if (okq) run = add(run, Counts{1, x[q]});
    nn[q] = count0 + run.n;
    c[q] = __fadd_rn(err0, run.c);
    const float n_f = __int2float_rn(nn[q] < 1 ? 1 : nn[q]);
    mean[q] = okq ? __fdiv_rn(c[q], n_f) : 0.0f;
    key[q] = okq ? __fadd_rn(mean[q], eps_of(n_f, log_drift)) : INFINITY;
    if (q < ne) mine_min = later_min(mine_min, Cut{key[q], nn[q], c[q], 1});
  }

  // 3. the running minimum before the thread's first element
  auto lmin = [](const Cut& p, const Cut& q) { return later_min(p, q); };
  Cut ktot;
  const Cut kbefore = cl::block_exclusive(mine_min, none, lmin, sh.kbuf, ktot);
  Cut rmin = later_min(cl::cluster_exclusive(cluster, ktot, none, lmin, &sh.cut_pub,
                                             &sh.cut_b),
                       kbefore);

  // 4. the stored cut and the tests, from registers
  const int nm_in = n_min_in[row];
  const float cm_in = c_min_in[row];
  const float nm_in_f = __int2float_rn(nm_in < 1 ? 1 : nm_in);
  const float carried_key =
      nm_in > 0 ? __fadd_rn(__fdiv_rn(cm_in, nm_in_f), eps_of(nm_in_f, log_drift)) : INFINITY;
  ct::ThreadMarks tm(a, b);
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    if (q < ne) {
      const int j = a + q;
      rmin = later_min(rmin, Cut{key[q], nn[q], c[q], 1});
      const bool use_run = rmin.key <= carried_key;
      const int n_min = use_run ? rmin.n : nm_in;
      const float c_min = use_run ? rmin.c : cm_in;
      if (j == n_el - 1) {
        count_out[row] = nn[q];
        err_sum_out[row] = c[q];
        n_min_out[row] = n_min;
        c_min_out[row] = c_min;
      }
      if (((ok >> q) & 1u) && n_min > 0 && n_min < nn[q]) {
        const float nm_f = __int2float_rn(n_min);
        const float n_f = __int2float_rn(nn[q]);
        const float diff = __fsub_rn(mean[q], __fdiv_rn(c_min, nm_f));
        float m = __fdiv_rn(__fsub_rn(n_f, nm_f), __fmul_rn(nm_f, n_f));
        m = __fmul_rn(m < 0.0f ? 0.0f : m, 0.5f);
        const bool change = diff >= __fsqrt_rn(__fmul_rn(m, log2_drift));
        const bool warning = !change && diff >= __fsqrt_rn(__fmul_rn(m, log2_warning));
        tm.note(cluster, marks, rank, j, n_el, b, warning, change);
      }
    }
  }
  tm.flush(cluster, marks, rank, n_el, b);

  cluster.sync();
  ct::store_marks(marks, rank, n_el, b, first_warning + static_cast<size_t>(row) * w,
                  first_change + static_cast<size_t>(row) * w);
}

__global__ void hddm_window_floor_kernel() {}

}  // namespace

// `ctas` > 0: the cluster path, one cluster of `ctas` CTAs per partition row
// (ctas = ceil(w·b / 2048) <= 8). `ctas` = 0: the one-CTA path, one CTA per
// row. `log_drift` is f32(ln(1/δ)) of the drift confidence, `log2_*`
// f32(ln(2/δ)) of each bound's. Returns a CUDA error code: a refused
// cluster launch is returned, never worked around.
extern "C" int hddm_window_launch(
    const float* errs, const uint8_t* live, const int* count_in, const float* err_sum_in,
    const int* n_min_in, const float* c_min_in, int p, int w, int b, int ctas,
    float log_drift, float log2_drift, float log2_warning, int* first_warning,
    int* first_change, int* count_out, float* err_sum_out, int* n_min_out, float* c_min_out,
    void* stream) {
  if (ctas > 0)
    return ct::launch_clusters(hddm_window_kernel_cluster, p, ctas, b, stream, errs, live,
                               count_in, err_sum_in, n_min_in, c_min_in, w, b, ctas,
                               log_drift, log2_drift, log2_warning, first_warning,
                               first_change, count_out, err_sum_out, n_min_out, c_min_out);
  size_t smem = 0;
  int unused = 0;
  const cudaError_t e = zoo::dynamic_smem(hddm_window_kernel, w, 0, smem, unused);
  if (e != cudaSuccess) return static_cast<int>(e);
  hddm_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, count_in, err_sum_in, n_min_in, c_min_in, w, b, log_drift, log2_drift,
      log2_warning, first_warning, first_change, count_out, err_sum_out, n_min_out, c_min_out);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched as hddm_window_launch launches K5-hddm at this
// shape and path (the same grid, cluster, block and dynamic shared memory):
// the floor under its time.
extern "C" int hddm_window_floor_launch(int p, int w, int b, int ctas, void* stream) {
  if (ctas > 0) return ct::launch_clusters(hddm_window_floor_kernel, p, ctas, b, stream);
  size_t smem = 0;
  int unused = 0;
  const cudaError_t e = zoo::dynamic_smem(hddm_window_kernel, w, 0, smem, unused);
  if (e != cudaSuccess) return static_cast<int>(e);
  return zoo::launch_floor(hddm_window_floor_kernel, p, smem, stream);
}
