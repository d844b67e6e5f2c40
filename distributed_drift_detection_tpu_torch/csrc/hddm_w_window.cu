// K5-hddm_w — the HDDM-W window statistic.
//
// Replaces the JAX package's ops/detectors.py `hddm_w_window` ->
// `_hddm_w_masks` (:736) and `summarise_window` (XLA-lowered there: two
// associative_scans of pairs of affine maps, a cummin, a cummax, cumsums,
// gathers, masked argmax). Per row of W·B error indicators:
//
// 1. the running count n (a scan of valid counts);
// 2. the stream EWMA pair (z, v): each element an affine map y -> A·y + B
//    (absorb (1-λ, λx) and ((1-λ)², λ²); the first element since reset
//    initialises, (0, x) and (0, 1); padding the identity), composed on
//    the combine tree and applied to the carried (z0, v0);
// 3. the cut: key = z + sqrt(v·ln(1/δ)/2) on live elements, a cut where the
//    key is strictly below every earlier key and the carried cut's key (a
//    min-scan), the frozen (z1, v1) at the latest cut, and the monitoring
//    count n2 (a scan of non-cut live counts and a latest-cut record);
// 4. the monitoring EWMA pair (z2, v2): the same maps, reset (0, 0) at every
//    cut and initialised at the first element after it, composed on the tree;
// 5. the tests diff = z2 - z1 >= sqrt((v1+v2)·ln(1/δ)/2) at the drift and
//    warning confidences, and per batch the first change and the first
//    warning at or before it.
//
// It writes [W] first-warning and first-change indices and the eight
// end-state scalars.
//
// Bound on an H100: errs and live, 5 B an element, 8 B per batch — about
// 1 MB per call at [16, 12800], 0.3 us at 3.35 TB/s. What costs time is the
// dependence along the row: two combine trees and the order-free scans.
// Two paths, the launcher taking the one the wrapper names:
//
// * the cluster path (rows of at most 2048 CTAs' worth: N <= 2048·cs, cs the
//   cluster size K1 uses, 8 at P = 16): one thread-block cluster of
//   ceil(N / 2048) CTAs per row, 7 at N = 12,800. CTA r owns the aligned
//   segment [2048·r, 2048·(r+1)), each of its 256 threads 8 consecutive
//   elements, whose state (error, z, v, z1, v1, n2 and the cut flags) stays
//   in registers from load to test — nothing per element goes to memory.
//   The order-free scans are warp shuffles, one shared-memory pass over the
//   warp totals and one exchange of CTA totals through distributed shared
//   memory (cluster_scan.cuh): the count, and the key's running minimum
//   carried with the element that set it — the latest cut, with its count
//   and its (z, v), so the frozen (z1, v1) and n2 come with it and not by
//   a gather or a second scan. The tree prefixes are built the same way
//   (cluster_tree.cuh `tree_prefixes`, shared with K5-ph's cluster path):
//   the tree's levels inside a thread's 8 elements in registers, the next
//   five by shuffles inside a warp, three by one warp's shuffles inside the
//   CTA, and only one 16-byte tuple a CTA goes through distributed shared
//   memory; each CTA computes the tiny top of the tree and sweeps down
//   locally. A batch's first-change and
//   first-warning marks go, by shared-memory atomics (one a thread and
//   batch; remote ones for a batch that straddles two segments), to the CTA
//   that holds its first element. Five cluster barriers a launch.
// * the global-scratch path (longer rows, P >= 67 at N = 12,800): one CTA of
//   512 threads per row, each thread over a contiguous chunk; per element
//   n, z, v, the cut flags, n2 and the latest cut's index in a global
//   scratch (L2-resident: 24 B an element), the tree levels above the
//   first in shared memory when they fit (205 KB at N = 12,800), else in
//   the scratch; Hillis–Steele block scans and zoo_scan.cuh's `tree_scan`.
//
// Exactness (bit-identical to `hddm_w_window_reference`; a one-ulp change
// in z moves a strict cut): both paths evaluate lax.associative_scan's
// combine tree pair for pair — its prefix of the first m elements is the
// left fold, most significant first, of the balanced combines of the
// aligned power-of-two blocks of m's binary expansion, and the cluster
// path builds exactly those blocks at each scale; every multiply-add the
// plain version fuses is __fmaf_rn (A2·B1 + B2 in the compose and A·y0 + B
// at the end, as XLA on the CPU fuses them), built with -fmad=false and
// -ftz=true (XLA on the CPU flushes subnormals: (1-λ)^k underflows after
// some thousands of elements, and the plain version flushes as it does).
// Minima, counts and latest records are order-free.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <utility>

#include "cluster_tree.cuh"
#include "zoo_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using zoo::kThreads;

struct Aff {  // (z, v) -> (az·z + bz, av·v + bv)
  float az, bz, av, bv;
};

__device__ __forceinline__ Aff compose(const Aff& f, const Aff& g) {  // f, then g
  return Aff{__fmul_rn(g.az, f.az), __fmaf_rn(g.az, f.bz, g.bz),
             __fmul_rn(g.av, f.av), __fmaf_rn(g.av, f.bv, g.bv)};
}

struct Consts {
  float lam, one_m, one_m2, lam2;
};

// reset: (0, 0); init: (0, x) and (0, 1); absorb: (1-λ, λx) and ((1-λ)², λ²).
__device__ __forceinline__ Aff element(bool reset, bool init, bool absorb, float x,
                                       const Consts& k) {
  if (reset) return Aff{0.0f, 0.0f, 0.0f, 0.0f};
  if (init) return Aff{0.0f, x, 0.0f, 1.0f};
  if (absorb) return Aff{k.one_m, __fmul_rn(k.lam, x), k.one_m2, k.lam2};
  return Aff{1.0f, 0.0f, 1.0f, 0.0f};
}

__device__ __forceinline__ float eps(float v, float log_conf) {
  return __fsqrt_rn(__fmul_rn(__fmul_rn(v, log_conf), 0.5f));
}

// The latest cut before a point: its element index (-1: none) and the
// running count of non-cut live elements there.
struct Cut {
  int g, ce;
};

union ScanBuf {
  int i[2 * kThreads];
  float f[2 * kThreads];
  Cut c[2 * kThreads];
};

constexpr int kImprove = 1;
constexpr int kE2 = 2;

__global__ void __launch_bounds__(kThreads) hddm_w_window_kernel(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ count_in, const float* __restrict__ z_in,
    const float* __restrict__ v_in, const float* __restrict__ z1_in,
    const float* __restrict__ v1_in, const int* __restrict__ n2_in,
    const float* __restrict__ z2_in, const float* __restrict__ v2_in, int w,
    int b, Consts kc, float log_drift, float log_warning,
    float* __restrict__ scratch, long long row_words, int levels_in_smem,
    int* __restrict__ first_warning, int* __restrict__ first_change,
    int* __restrict__ count_out, float* __restrict__ z_out,
    float* __restrict__ v_out, float* __restrict__ z1_out,
    float* __restrict__ v1_out, int* __restrict__ n2_out,
    float* __restrict__ z2_out, float* __restrict__ v2_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) ScanBuf sb;
  const int row = blockIdx.x;
  const int n = w * b;
  int* fc = reinterpret_cast<int*>(smem);
  int* fw = fc + w;
  const size_t firsts = (2 * static_cast<size_t>(w) * sizeof(int) + 15) & ~size_t(15);
  float* rs = scratch + static_cast<size_t>(row) * row_words;
  int* e_n = reinterpret_cast<int*>(rs);          // running count
  float* e_z = rs + n;                            // stream EWMA
  float* e_v = rs + 2 * static_cast<size_t>(n);   // its bound condition
  int* e_flags = reinterpret_cast<int*>(rs + 3 * static_cast<size_t>(n));
  int* e_n2 = reinterpret_cast<int*>(rs + 4 * static_cast<size_t>(n));
  int* e_g = reinterpret_cast<int*>(rs + 5 * static_cast<size_t>(n));  // latest cut, -1
  Aff* lev = levels_in_smem ? reinterpret_cast<Aff*>(smem + firsts)
                            : reinterpret_cast<Aff*>(rs + 6 * static_cast<size_t>(n));
  const float* e = errs + static_cast<size_t>(row) * n;
  const uint8_t* v = live + static_cast<size_t>(row) * n;
  zoo::first_init(fc, fw, w, b);
  auto comb = [](const Aff& f, const Aff& g) { return compose(f, g); };
  auto add = [](int x, int y) { return x + y; };

  // 1. running count
  int lo, hi;
  zoo::chunk_of(n, lo, hi);
  int mine = 0;
  for (int j = lo; j < hi; ++j) mine += v[j] != 0;
  int cnt = count_in[row] + zoo::block_exclusive_scan(mine, 0, add, sb.i);
  for (int j = lo; j < hi; ++j) {
    cnt += v[j] != 0;
    e_n[j] = cnt;
  }
  __syncthreads();

  // 2. the stream EWMA (z, v)
  const float z0 = z_in[row];
  const float v0 = v_in[row];
  zoo::tree_scan(
      n, lev,
      [&](int j) {
        const bool ok = v[j] != 0;
        const bool init = ok && e_n[j] == 1;
        return element(false, init, ok && !init, e[j], kc);
      },
      comb,
      [&](int j, const Aff& s) {
        e_z[j] = __fmaf_rn(s.az, z0, s.bz);
        e_v[j] = __fmaf_rn(s.av, v0, s.bv);
      });
  __syncthreads();

  // 3. cuts: a strict running minimum of the key, then the latest cut and
  //    the monitoring count
  const float v1_0 = v1_in[row];
  const float z1_0 = z1_in[row];
  const float carried = v1_0 > 0.0f ? __fadd_rn(z1_0, eps(v1_0, log_drift)) : CUDART_INF_F;
  auto key = [&](int j) {
    return v[j] ? __fadd_rn(e_z[j], eps(e_v[j], log_drift)) : CUDART_INF_F;
  };
  float kmin = CUDART_INF_F;
  for (int j = lo; j < hi; ++j) kmin = fminf(kmin, key(j));
  float excl = zoo::block_exclusive_scan(
      kmin, CUDART_INF_F, [](float x, float y) { return fminf(x, y); }, sb.f);
  int ne2 = 0;
  Cut last{-1, 0};  // the chunk's latest cut, ce counted within the chunk
  for (int j = lo; j < hi; ++j) {
    const float kj = key(j);
    const bool improve = v[j] && kj < fminf(excl, carried);
    excl = fminf(excl, kj);
    const bool e2 = v[j] && !improve;
    ne2 += e2;
    if (improve) last = Cut{j, ne2};
    e_flags[j] = (improve ? kImprove : 0) | (e2 ? kE2 : 0);
  }
  const int ce_base = zoo::block_exclusive_scan(ne2, 0, add, sb.i);
  if (last.g >= 0) last.ce += ce_base;
  Cut cut = zoo::block_exclusive_scan(
      last, Cut{-1, 0}, [](const Cut& x, const Cut& y) { return y.g >= 0 ? y : x; }, sb.c);
  const int n2_0 = n2_in[row];
  int ce = ce_base;
  for (int j = lo; j < hi; ++j) {
    const int f = e_flags[j];
    ce += (f & kE2) != 0;
    if (f & kImprove) cut = Cut{j, ce};
    e_n2[j] = cut.g >= 0 ? ce - cut.ce : n2_0 + ce;
    e_g[j] = cut.g;
  }
  __syncthreads();

  // 4–5. the monitoring EWMA (z2, v2) and the tests
  const float z2_0 = z2_in[row];
  const float v2_0 = v2_in[row];
  zoo::tree_scan(
      n, lev,
      [&](int j) {
        const int f = e_flags[j];
        const bool e2 = f & kE2;
        const bool init = e2 && e_n2[j] == 1;
        return element(f & kImprove, init, e2 && !init, e[j], kc);
      },
      comb,
      [&](int j, const Aff& s) {
        const float z2 = __fmaf_rn(s.az, z2_0, s.bz);
        const float v2 = __fmaf_rn(s.av, v2_0, s.bv);
        const int g = e_g[j];
        const float z1 = g >= 0 ? e_z[g] : z1_0;
        const float v1 = g >= 0 ? e_v[g] : v1_0;
        const int n2 = e_n2[j];
        const bool testable = (e_flags[j] & kE2) && n2 >= 1;
        const float diff = __fsub_rn(z2, z1);
        const float vv = __fadd_rn(v1, v2);
        const bool change = testable && diff >= eps(vv, log_drift);
        const bool warning = testable && !change && diff >= eps(vv, log_warning);
        zoo::first_mark(fc, fw, j, b, warning, change);
        if (j == n - 1) {
          count_out[row] = e_n[j];
          z_out[row] = e_z[j];
          v_out[row] = e_v[j];
          z1_out[row] = z1;
          v1_out[row] = v1;
          n2_out[row] = n2;
          z2_out[row] = z2;
          v2_out[row] = v2;
        }
      });
  __syncthreads();
  zoo::first_store(fc, fw, w, b, first_warning + static_cast<size_t>(row) * w,
                   first_change + static_cast<size_t>(row) * w);
}

// ---------------------------------------------------------------------------
// The cluster path (cluster_tree.cuh: the tree, the loads, the marks).

using ct::kEpt;
using ct::kSeg;

struct AffTree {
  using T = Aff;
  static __device__ __forceinline__ Aff compose(const Aff& f, const Aff& g) {
    return ::compose(f, g);
  }
  static __device__ __forceinline__ Aff identity() { return Aff{1.0f, 0.0f, 1.0f, 0.0f}; }
};

// The running minimum of the key with its payload: the element that set
// it (g, -1 for none or the carried cut), the running valid count there
// and its (z, v). The strict `<` keeps the earliest of equal keys, so the
// minimum over a range is the latest cut in it — a cut is an element whose
// key is below every earlier one — and the combine is order-free.
struct KeyMin {
  float key;
  int g, cnt;
  float z, v;
};

__device__ __forceinline__ KeyMin key_min(const KeyMin& a, const KeyMin& b) {
  return b.key < a.key ? b : a;
}

struct ClusterShared {
  ct::TreeShared<Aff> tree[2];
  int cnt_pub, cnt_b, ibuf[ct::kWarps];
  KeyMin key_pub, key_b, kbuf[ct::kWarps];
};

__global__ void __launch_bounds__(ct::kThreads, 1) hddm_w_window_kernel_cluster(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ count_in, const float* __restrict__ z_in,
    const float* __restrict__ v_in, const float* __restrict__ z1_in,
    const float* __restrict__ v1_in, const int* __restrict__ n2_in,
    const float* __restrict__ z2_in, const float* __restrict__ v2_in, int w,
    int b, int cs, Consts kc, float log_drift, float log_warning,
    int* __restrict__ first_warning, int* __restrict__ first_change,
    int* __restrict__ count_out, float* __restrict__ z_out,
    float* __restrict__ v_out, float* __restrict__ z1_out,
    float* __restrict__ v1_out, int* __restrict__ n2_out,
    float* __restrict__ z2_out, float* __restrict__ v2_out) {
  __shared__ ClusterShared sh;
  extern __shared__ int marks[];  // ct::init_marks
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / cs;
  const int n = w * b;
  const int tid = threadIdx.x;
  const int a = rank * kSeg + tid * kEpt;
  const int ne = max(0, min(kEpt, n - a));
  ct::init_marks(marks, rank, n, b);
  float x[kEpt];
  const unsigned ok = ct::load_elements(errs + static_cast<size_t>(row) * n,
                                        live + static_cast<size_t>(row) * n, a, n, x);
  auto add = [](int p, int q) { return p + q; };

  // 1. running count before the thread's first element
  int tot;
  const int xc = cl::block_exclusive(__popc(ok), 0, add, sh.ibuf, tot);
  const int cnt0 = count_in[row] + xc +
                   cl::cluster_exclusive(cluster, tot, 0, add, &sh.cnt_pub, &sh.cnt_b);

  // 2. the stream EWMA (z, v)
  Aff gen[kEpt], pre[kEpt];
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    const bool okq = (ok >> q) & 1u;
    const bool init = okq && cnt0 + __popc(ok & ((2u << q) - 1u)) == 1;
    gen[q] = q < ne ? element(false, init, okq && !init, x[q], kc) : AffTree::identity();
  }
  ct::tree_prefixes<AffTree>(cluster, gen, n, cs, sh.tree[0], pre);
  const float z0 = z_in[row];
  const float v0 = v_in[row];
  float z[kEpt], v[kEpt];
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    z[q] = __fmaf_rn(pre[q].az, z0, pre[q].bz);
    v[q] = __fmaf_rn(pre[q].av, v0, pre[q].bv);
  }

  // 3. cuts: an element is a cut where its key is below every earlier key
  //    and the carried cut's; the latest cut so far (its count and frozen
  //    (z, v)) is the running minimum's payload, and the monitoring count
  //    n2 is the count of live elements after it (a cut is not one)
  const float v1_0 = v1_in[row];
  const float z1_0 = z1_in[row];
  const float carried = v1_0 > 0.0f ? __fadd_rn(z1_0, eps(v1_0, log_drift)) : CUDART_INF_F;
  float key[kEpt];
  int cnt[kEpt];  // the running count at each element
  const KeyMin none{CUDART_INF_F, -1, 0, 0.0f, 0.0f};
  KeyMin mine = none;
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    key[q] = (ok >> q) & 1u ? __fadd_rn(z[q], eps(v[q], log_drift)) : CUDART_INF_F;
    cnt[q] = cnt0 + __popc(ok & ((2u << q) - 1u));
    if (q < ne) mine = key_min(mine, KeyMin{key[q], a + q, cnt[q], z[q], v[q]});
  }
  auto kmin = [](const KeyMin& p, const KeyMin& q) { return key_min(p, q); };
  KeyMin ktot;
  const KeyMin before = cl::block_exclusive(mine, none, kmin, sh.kbuf, ktot);
  KeyMin run = key_min(
      key_min(KeyMin{carried, -1, 0, 0.0f, 0.0f},
              cl::cluster_exclusive(cluster, ktot, none, kmin, &sh.key_pub, &sh.key_b)),
      before);
  const int n2_0 = n2_in[row];
  const int count0 = count_in[row];
  unsigned improve = 0, e2 = 0;
  int n2[kEpt];
  float z1[kEpt], v1[kEpt];
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    if (key[q] < run.key) {  // a live element: padding keys are +inf
      improve |= 1u << q;
      run = KeyMin{key[q], a + q, cnt[q], z[q], v[q]};
    } else if ((ok >> q) & 1u) {
      e2 |= 1u << q;
    }
    n2[q] = run.g >= 0 ? cnt[q] - run.cnt : n2_0 + cnt[q] - count0;
    z1[q] = run.g >= 0 ? run.z : z1_0;
    v1[q] = run.g >= 0 ? run.v : v1_0;
  }

  // 4-5. the monitoring EWMA (z2, v2) and the tests
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    const bool e2q = (e2 >> q) & 1u;
    const bool init = e2q && n2[q] == 1;
    gen[q] = q < ne ? element((improve >> q) & 1u, init, e2q && !init, x[q], kc)
                    : AffTree::identity();
  }
  ct::tree_prefixes<AffTree>(cluster, gen, n, cs, sh.tree[1], pre);
  const float z2_0 = z2_in[row];
  const float v2_0 = v2_in[row];
  ct::ThreadMarks tm(a, b);
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    if (q < ne) {
      const int j = a + q;
      const float z2 = __fmaf_rn(pre[q].az, z2_0, pre[q].bz);
      const float v2 = __fmaf_rn(pre[q].av, v2_0, pre[q].bv);
      const bool testable = ((e2 >> q) & 1u) && n2[q] >= 1;
      const float diff = __fsub_rn(z2, z1[q]);
      const float vv = __fadd_rn(v1[q], v2);
      const bool change = testable && diff >= eps(vv, log_drift);
      const bool warning = testable && !change && diff >= eps(vv, log_warning);
      tm.note(cluster, marks, rank, j, n, b, warning, change);
      if (j == n - 1) {
        count_out[row] = cnt[q];
        z_out[row] = z[q];
        v_out[row] = v[q];
        z1_out[row] = z1[q];
        v1_out[row] = v1[q];
        n2_out[row] = n2[q];
        z2_out[row] = z2;
        v2_out[row] = v2;
      }
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
// 6·n + 4·scan_levels(n) floats (n = w·b). Returns a CUDA error code: a
// refused cluster launch is returned, never worked around.
extern "C" int hddm_w_window_launch(
    const float* errs, const uint8_t* live, const int* count_in,
    const float* z_in, const float* v_in, const float* z1_in,
    const float* v1_in, const int* n2_in, const float* z2_in,
    const float* v2_in, int p, int w, int b, int ctas, float lam, float one_m,
    float one_m2, float lam2, float log_drift, float log_warning,
    float* scratch, int* first_warning, int* first_change, int* count_out,
    float* z_out, float* v_out, float* z1_out, float* v1_out, int* n2_out,
    float* z2_out, float* v2_out, void* stream) {
  const Consts kc{lam, one_m, one_m2, lam2};
  if (ctas > 0)
    return ct::launch_clusters(
        hddm_w_window_kernel_cluster, p, ctas, b, stream, errs, live, count_in, z_in, v_in,
        z1_in, v1_in, n2_in, z2_in, v2_in, w, b, ctas, kc, log_drift, log_warning,
        first_warning, first_change, count_out, z_out, v_out, z1_out, v1_out, n2_out, z2_out,
        v2_out);
  const long long n = static_cast<long long>(w) * b;
  const long long levels = zoo::scan_levels(n);
  size_t smem = 0;
  int in_smem = 0;
  cudaError_t e =
      zoo::dynamic_smem(hddm_w_window_kernel, w, levels * sizeof(Aff), smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  hddm_w_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, count_in, z_in, v_in, z1_in, v1_in, n2_in, z2_in, v2_in, w,
      b, kc, log_drift, log_warning, scratch,
      6 * n + 4 * levels, in_smem, first_warning, first_change, count_out,
      z_out, v_out, z1_out, v1_out, n2_out, z2_out, v2_out);
  return static_cast<int>(cudaGetLastError());
}
