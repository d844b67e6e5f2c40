// K5-eddm — the EDDM window statistic.
//
// Replaces the JAX package's ops/detectors.py `_eddm_masks` (:382) and
// `summarise_window` (XLA-lowered there: two cumsums of counts, two
// cummaxes, two float32 cumsums of the distances between errors and of
// their squares, the moments, the ratio tests, masked argmins). Per row of
// N = W·B elements:
//
// 1. the element index t (a count of valid elements), the count of errors
//    and the index of the latest error before each element (one
//    order-free scan), so each element knows the previous error;
// 2. each error's distance d to the previous one (from the carried
//    `last_err_t` before the row's first), whether it contributes
//    (`paper_exact`: not the first error since a reset), the count k of
//    contributing errors, and the float32 sums of d and d² in XLA's order:
//    `jnp.cumsum` on the CPU chains blocks of 16 elements from their first,
//    scans the blocks' last values the same way (recursively, over blocks
//    of 16 of them) and adds each block's chain to the previous block's
//    scanned value with one rounding (ops/prefix.py `cumsum_f32`);
// 3. at every contributing error, mean + 2·std of the distances; the
//    running max of those over the row's events beside the carried
//    `m2s_max`, each event tested against the max before it;
// 4. per batch the first warning and change, and the end state.
//
// Bound on an H100: the inputs are 5 B an element — 1 MB per call at
// [16, 12800] — and the work a few dozen float operations an element, so
// bytes bound it (≈ 0.3 µs). What costs time is the dependence along the
// row. Two paths, the launcher taking the one the wrapper names
// (ops/detectors.py `cluster_ctas`, the rule of K5-ph and K5-hddm_w):
//
// * the cluster path (rows of N <= 2048·cs, cs the cluster size K1 uses, 8
//   at P = 16): one thread-block cluster of ceil(N / 2048) CTAs per row, 7
//   at N = 12,800. CTA r owns the aligned segment [2048·r, 2048·(r+1)),
//   each of its 256 threads 8 consecutive elements, loaded coalesced and
//   kept in registers from load to test. Step 1 is one scan of a (count,
//   errors, latest error) tuple — in-thread, warp shuffles, one
//   shared-memory pass over the warp totals, one exchange of CTA totals
//   through distributed shared memory (cluster_scan.cuh). The tree of
//   step 2 is cut where it lies: a block of 16 elements is a lane pair
//   (the even lane's chain handed to the odd lane by one shuffle), a block
//   of 16 block values is a warp (its 256 elements, chained from 16
//   shuffles), so a CTA's segment holds 8 whole level-2 values; each CTA
//   stores those in every CTA's shared memory (distributed shared memory,
//   before a cluster barrier), and one warp of every CTA rebuilds the
//   levels above (N/256 values, then N/4096) from all of them with the
//   same adds in the same order. Each contributing
//   error's mean + 2·std is computed once; the running max is an
//   order-free max scan like step 1. A batch's marks go by shared-memory
//   atomics, one a thread and batch, to the CTA that holds its first
//   element (cluster_tree.cuh). Four cluster barriers a launch.
// * the one-CTA path (longer rows, P >= 67 at N = 12,800): one CTA of 512
//   threads per row, each a contiguous chunk of whole blocks of 16; four
//   walks over the chunk with block scans between them, and the levels of
//   the tree above the threads' blocks (N/16 + N/256 + ... values a sum)
//   going up and down a small tree in shared memory, or in a global
//   scratch for very long rows.
//
// Exactness: counts and indices are int32, so order-free. The sums of d
// and d² follow XLA's tree above, with each add rounded on its own
// (`__fadd_rn`); d is `__int2float_rn(t - prev)`, d² `__fmul_rn(d, d)`.
// Every term is at least +0, so adding the +0 of a missing block or of
// padding past N changes no value, and a level of at most 16 values (XLA
// chains it whole) is the same as a first block with nothing before it.
// The moments are the plain version's float32 expressions (ops/detectors.py
// `_eddm_stats`): IEEE divisions and square root (`__fdiv_rn`,
// `__fsqrt_rn`), the variance `__fmaf_rn(-mean, mean, d2/k)` where XLA
// fuses it (`prefix.fma`, which flushes a subnormal result: built with
// -ftz=true), built with -fmad=false so nothing else contracts.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_tree.cuh"
#include "zoo_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using zoo::kThreads;
constexpr int kBase = 16;  // XLA's CPU cumsum: chains over blocks of 16
constexpr int kMaxTree = 16;

// The levels of XLA's cumsum tree over n > 16 values: m[1] = ceil(n/16)
// block values, m[l+1] = ceil(m[l]/16) while m[l] > 16. Returns the depth
// and the total values; off[l] the offset of level l.
__host__ __device__ inline int tree_levels(long long n, long long* m, long long* off,
                                           long long& total) {
  int depth = 0;
  total = 0;
  long long cur = n;
  while (cur > kBase && depth + 1 < kMaxTree) {
    cur = (cur + kBase - 1) / kBase;
    ++depth;
    m[depth] = cur;
    off[depth] = total;
    total += cur;
  }
  return depth;
}

// mean + 2·sqrt(var) of k distances with sums s1, s2 (_eddm_stats).
__device__ inline float m2s_of(float s1, float s2, int k) {
  const float kf = __int2float_rn(k < 1 ? 1 : k);
  const float mean = __fdiv_rn(s1, kf);
  float var = __fmaf_rn(-mean, mean, __fdiv_rn(s2, kf));
  var = var < 0.0f ? 0.0f : var;
  return __fadd_rn(mean, __fmul_rn(2.0f, __fsqrt_rn(var)));
}

// One walk over a chunk of whole blocks [lo, hi) from the element index t,
// the previous error `prev` and the count k before it: each element's
// distance terms and its block's chains s1, s2 of d and d². Calls
// on(j, contributes, k, f1, f2, s1, s2) at every element; with `finals`
// (the tree complete) f1/f2 are the cumsums of d and d² at j in XLA's
// order, else the block chains.
template <class On>
__device__ inline void walk(const float* e, const uint8_t* v, int lo, int hi, int n, int t,
                            int prev, int k, int last_err_in, bool paper_exact,
                            const float* lvl1_d, const float* lvl1_d2, bool finals, On on) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int j = lo; j < hi; ++j) {
    float d1 = 0.0f, d2 = 0.0f;
    bool contrib = false;
    if (v[j]) {
      ++t;
      if (e[j] >= 0.5f) {
        const int prev_t = prev > 0 ? prev : last_err_in;
        contrib = paper_exact ? prev_t > 0 : true;
        if (contrib) {
          ++k;
          d1 = __int2float_rn(t - prev_t);
          d2 = __fmul_rn(d1, d1);
        }
        prev = t;
      }
    }
    const bool first = (j % kBase) == 0;
    s1 = first ? d1 : __fadd_rn(s1, d1);
    s2 = first ? d2 : __fadd_rn(s2, d2);
    float f1 = s1, f2 = s2;
    if (finals && n > kBase) {
      const int blk = j / kBase;
      f1 = __fadd_rn(blk == 0 ? 0.0f : lvl1_d[blk - 1], s1);
      f2 = __fadd_rn(blk == 0 ? 0.0f : lvl1_d2[blk - 1], s2);
    }
    on(j, contrib, k, f1, f2, s1, s2);
  }
}

// Block-wide exclusive scan (zoo::block_exclusive_scan) that also leaves
// the inclusive total of the whole block in *total.
template <class T, class Op>
__device__ T scan_total(T v, T identity, Op op, T* buf, T* total) {
  const T excl = zoo::block_exclusive_scan(v, identity, op, buf);
  if (threadIdx.x == blockDim.x - 1) *total = op(excl, v);
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(kThreads) eddm_window_kernel(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ count_in, const int* __restrict__ num_errors_in,
    const float* __restrict__ d_sum_in, const float* __restrict__ d2_sum_in,
    const int* __restrict__ last_err_in, const float* __restrict__ m2s_max_in, int w, int b,
    int paper_exact, int min_num_errors, float warning_alpha, float change_beta,
    int tree_in_smem, float* __restrict__ scratch, int* __restrict__ first_warning,
    int* __restrict__ first_change, int* __restrict__ count_out, int* __restrict__ num_errors_out,
    float* __restrict__ d_sum_out, float* __restrict__ d2_sum_out, int* __restrict__ last_err_out,
    float* __restrict__ m2s_max_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) unsigned char scan_raw[2 * kThreads * sizeof(float)];
  __shared__ int tot_i;
  __shared__ float tot_f;
  const int row = blockIdx.x;
  const int n = w * b;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int* fc = reinterpret_cast<int*>(smem);
  int* fw = fc + w;
  const size_t firsts = (2 * static_cast<size_t>(w) * sizeof(int) + 15) & ~size_t(15);
  long long m[kMaxTree], off[kMaxTree], tree_total = 0;
  const int depth = tree_levels(n, m, off, tree_total);
  // the tree: level l of d at off[l], of d² at tree_total + off[l]
  float* tree = tree_in_smem ? reinterpret_cast<float*>(smem + firsts)
                             : scratch + static_cast<size_t>(row) * 2 * tree_total;
  float* lvl1_d = tree + (depth > 0 ? off[1] : 0);
  float* lvl1_d2 = tree + tree_total + (depth > 0 ? off[1] : 0);
  const float* e = errs + static_cast<size_t>(row) * n;
  const uint8_t* v = live + static_cast<size_t>(row) * n;
  zoo::first_init(fc, fw, w, b);
  int* ibuf = reinterpret_cast<int*>(scan_raw);
  float* fbuf = reinterpret_cast<float*>(scan_raw);
  auto add = [](int x, int y) { return x + y; };
  auto imax = [](int x, int y) { return x > y ? x : y; };
  auto fmax_ = [](float x, float y) { return x > y ? x : y; };

  // a thread's chunk: whole blocks of 16
  const int per = ((n + nt - 1) / nt + kBase - 1) / kBase * kBase;
  const int lo = min(n, tid * per);
  const int hi = min(n, lo + per);
  const int count0 = count_in[row];
  const int last_in = last_err_in[row];
  const bool exact = paper_exact != 0;

  // 1. element index at the chunk's start; the previous error before it
  int nv = 0, last_local = 0;
  for (int j = lo; j < hi; ++j)
    if (v[j]) {
      ++nv;
      if (e[j] >= 0.5f) last_local = nv;
    }
  const int t_first = count0 + scan_total(nv, 0, add, ibuf, &tot_i);
  const int nv_total = tot_i;
  const int prev_first =
      scan_total(last_local > 0 ? t_first + last_local : -1, -1, imax, ibuf, &tot_i);
  const int last_err_row = tot_i;

  // 2. contributing errors before the chunk; the blocks' chains to the tree
  int kc = 0;
  walk(e, v, lo, hi, n, t_first, prev_first, 0, last_in, exact, lvl1_d, lvl1_d2, false,
       [&](int j, bool contrib, int k, float, float, float s1, float s2) {
         kc = k;
         if (depth > 0 && (j % kBase == kBase - 1 || j == n - 1)) {
           lvl1_d[j / kBase] = s1;
           lvl1_d2[j / kBase] = s2;
         }
       });
  const int k_first = num_errors_in[row] + scan_total(kc, 0, add, ibuf, &tot_i);
  const int k_total = tot_i;
  // up the tree: chain each level's blocks in place, their last values to
  // the level above; the top level (at most 16 values) is chained whole
  for (int l = 1; l <= depth; ++l) {
    const long long ml = m[l];
    const long long blocks = l < depth ? (ml + kBase - 1) / kBase : 1;
    for (long long q = tid; q < 2 * blocks; q += nt) {
      float* lev = tree + (q >= blocks ? tree_total : 0) + off[l];
      const long long blk = q % blocks;
      const long long a = blk * kBase;
      const long long z = l < depth ? min(ml, a + kBase) : ml;
      float s = lev[a];
      for (long long i = a + 1; i < z; ++i) {
        s = __fadd_rn(s, lev[i]);
        lev[i] = s;
      }
      if (l < depth) (tree + (q >= blocks ? tree_total : 0) + off[l + 1])[blk] = s;
    }
    __syncthreads();
  }
  // down the tree: each value of a level below the top plus the scanned
  // value of the block before its own
  for (int l = depth - 1; l >= 1; --l) {
    for (long long q = tid; q < 2 * m[l]; q += nt) {
      const int side = q >= m[l];
      const long long i = q - side * m[l];
      float* lev = tree + side * tree_total + off[l];
      const float* up = tree + side * tree_total + off[l + 1];
      const long long blk = i / kBase;
      lev[i] = __fadd_rn(blk == 0 ? 0.0f : up[blk - 1], lev[i]);
    }
    __syncthreads();
  }

  // 3. the running max of mean + 2·std over the row's events
  const float d_in = d_sum_in[row], d2_in = d2_sum_in[row];
  float ev_max = -INFINITY;
  walk(e, v, lo, hi, n, t_first, prev_first, k_first, last_in, exact, lvl1_d, lvl1_d2, true,
       [&](int j, bool contrib, int k, float f1, float f2, float, float) {
         if (contrib) ev_max = fmax_(ev_max, m2s_of(__fadd_rn(d_in, f1), __fadd_rn(d2_in, f2), k));
         if (j == n - 1) {
           d_sum_out[row] = __fadd_rn(d_in, f1);
           d2_sum_out[row] = __fadd_rn(d2_in, f2);
         }
       });
  const float carried = m2s_max_in[row];
  const float ev_before = scan_total(ev_max, -INFINITY, fmax_, fbuf, &tot_f);
  const float ev_row = tot_f;

  // 4. each event against the max before it; per-batch first flags
  float run = fmax_(ev_before, carried);
  walk(e, v, lo, hi, n, t_first, prev_first, k_first, last_in, exact, lvl1_d, lvl1_d2, true,
       [&](int j, bool contrib, int k, float f1, float f2, float, float) {
         if (!contrib) return;
         const float m2s = m2s_of(__fadd_rn(d_in, f1), __fadd_rn(d2_in, f2), k);
         const float excl = run;
         run = fmax_(run, m2s);
         const bool update = m2s > excl;
         const bool check = !update && k >= min_num_errors;
         const float ratio = __fdiv_rn(m2s, excl < 1e-30f ? 1e-30f : excl);
         const bool change = check && ratio < change_beta;
         const bool warning = check && !change && ratio < warning_alpha;
         zoo::first_mark(fc, fw, j, b, warning, change);
       });
  if (tid == 0) {
    count_out[row] = count0 + nv_total;
    num_errors_out[row] = num_errors_in[row] + k_total;
    last_err_out[row] = last_err_row > 0 ? last_err_row : last_in;
    m2s_max_out[row] = fmax_(ev_row, carried);
  }
  __syncthreads();
  zoo::first_store(fc, fw, w, b, first_warning + static_cast<size_t>(row) * w,
                   first_change + static_cast<size_t>(row) * w);
}

// ---------------------------------------------------------------------------
// The cluster path (cluster_scan.cuh: the scans; cluster_tree.cuh: the
// loads and the marks).

using ct::kEpt;
using ct::kSeg;
constexpr int kTop = ct::kWarps * cl::kMaxCluster;  // level-2 values of a cluster

// A range's valid elements, its errors and the position (1-based among its
// valid elements) of its latest error, 0 for none.
struct Prefix {
  int t, ne, last;
};

// p, then q: an order-free combine of integers
__device__ __forceinline__ Prefix then_(const Prefix& p, const Prefix& q) {
  return Prefix{p.t + q.t, p.ne + q.ne, q.last > 0 ? p.t + q.last : p.last};
}

struct ClusterShared {
  Prefix pre_pub, pre_b, pbuf[ct::kWarps];
  float top[2][kTop];      // every CTA's level-2 values of d and d², pushed
  float s2[2][kTop];       // their scanned values
  float t3[2][kTop / 16];  // the level-3 values
  float ev_pub, ev_b, ebuf[ct::kWarps];
};

__global__ void __launch_bounds__(ct::kThreads, 1) eddm_window_kernel_cluster(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ count_in, const int* __restrict__ num_errors_in,
    const float* __restrict__ d_sum_in, const float* __restrict__ d2_sum_in,
    const int* __restrict__ last_err_in, const float* __restrict__ m2s_max_in, int w, int b,
    int cs, int paper_exact, int min_num_errors, float warning_alpha, float change_beta,
    int* __restrict__ first_warning, int* __restrict__ first_change,
    int* __restrict__ count_out, int* __restrict__ num_errors_out,
    float* __restrict__ d_sum_out, float* __restrict__ d2_sum_out,
    int* __restrict__ last_err_out, float* __restrict__ m2s_max_out) {
  __shared__ ClusterShared sh;
  extern __shared__ int marks[];  // ct::init_marks
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / cs;
  const int n = w * b;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int a = rank * kSeg + static_cast<int>(threadIdx.x) * kEpt;
  const int ne = max(0, min(kEpt, n - a));
  ct::init_marks(marks, rank, n, b);
  float x[kEpt];
  const unsigned ok = ct::load_elements(errs + static_cast<size_t>(row) * n,
                                        live + static_cast<size_t>(row) * n, a, n, x);
  auto fmax_ = [](float p, float q) { return p > q ? p : q; };

  // 1. the valid count, the errors and the latest error before the thread
  Prefix mine{0, 0, 0};
#pragma unroll
  for (int q = 0; q < kEpt; ++q)
    if ((ok >> q) & 1u) {
      ++mine.t;
      if (x[q] >= 0.5f) {
        ++mine.ne;
        mine.last = mine.t;
      }
    }
  auto comb = [](const Prefix& p, const Prefix& q) { return then_(p, q); };
  Prefix tot;
  const Prefix before = cl::block_exclusive(mine, Prefix{0, 0, 0}, comb, sh.pbuf, tot);
  const Prefix pre = then_(
      cl::cluster_exclusive(cluster, tot, Prefix{0, 0, 0}, comb, &sh.pre_pub, &sh.pre_b),
      before);

  // 2. per element t, the previous error, whether it contributes, k, d, d².
  //    An error's t is at least 1 (counts start at 0), so the previous
  //    error is the carried one only before the row's first error, and
  //    under paper_exact only that first error can fail to contribute.
  const int count0 = count_in[row];
  const int last_in = last_err_in[row];
  const bool exact = paper_exact != 0;
  int t = count0 + pre.t;
  int last = pre.last > 0 ? count0 + pre.last : -1;
  int kk = num_errors_in[row] + pre.ne - (exact && last_in <= 0 && pre.ne > 0 ? 1 : 0);
  unsigned contrib = 0;
  int k[kEpt];
  float d[kEpt], dd[kEpt];
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    d[q] = 0.0f;
    dd[q] = 0.0f;
    if ((ok >> q) & 1u) {
      ++t;
      if (x[q] >= 0.5f) {
        const int prev_t = last > 0 ? last : last_in;
        if (!exact || prev_t > 0) {
          contrib |= 1u << q;
          ++kk;
          d[q] = __int2float_rn(t - prev_t);
          dd[q] = __fmul_rn(d[q], d[q]);
        }
        last = t;
      }
    }
    k[q] = kk;
    if (a + q == n - 1) {
      count_out[row] = t;
      num_errors_out[row] = kk;
      last_err_out[row] = last > 0 ? last : last_in;
    }
  }

  // 3. the sums of d and d² on cumsum_f32's tree. Level 0: the chains of
  //    the aligned blocks of 16 elements, a lane pair each.
  float c1[kEpt], c2[kEpt];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    s1 = __fadd_rn(s1, d[q]);
    s2 = __fadd_rn(s2, dd[q]);
    c1[q] = s1;
    c2[q] = s2;
  }
  const float from1 = __shfl_up_sync(cl::kFull, s1, 1);
  const float from2 = __shfl_up_sync(cl::kFull, s2, 1);
  if (lane & 1) {
    s1 = from1;
    s2 = from2;
#pragma unroll
    for (int q = 0; q < kEpt; ++q) {
      s1 = __fadd_rn(s1, d[q]);
      s2 = __fadd_rn(s2, dd[q]);
      c1[q] = s1;
      c2[q] = s2;
    }
  }
  // level 1: the warp's 16 block values (the odd lanes' chains) chained;
  // the chain before the lane pair's block, and the warp's level-2 value
  const int blk = lane >> 1;
  float u1 = 0.0f, u2 = 0.0f, p1 = 0.0f, p2 = 0.0f;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    u1 = __fadd_rn(u1, __shfl_sync(cl::kFull, s1, 2 * r + 1));
    u2 = __fadd_rn(u2, __shfl_sync(cl::kFull, s2, 2 * r + 1));
    if (r == blk - 1) {
      p1 = u1;
      p2 = u2;
    }
  }
  const int g = rank * ct::kWarps + warp;  // the warp's level-2 index
  if (lane < cs) {  // stored in every CTA of the cluster, so read locally
    ClusterShared* dst = cluster.map_shared_rank(&sh, lane);
    dst->top[0][g] = u1;
    dst->top[1][g] = u2;
  }
  cluster.sync();
  // levels 2 and 3 in warp 0 of every CTA, from every CTA's level-2
  // values: chains over aligned blocks of 16 (2 CTAs each), the chain of
  // their last values, each level-2 value's scan (zeros past N add +0)
  const int top_n = ct::kWarps * cs;
  if (warp == 0) {
    const int side = lane >> 2;
    const int h = lane & 3;
    const bool mine_h = lane < 8 && 16 * h < top_n;
    float ch[16];
    if (mine_h) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int v = 16 * h + r;
        s = __fadd_rn(s, v < top_n ? sh.top[side][v] : 0.0f);
        ch[r] = s;
      }
      sh.t3[side][h] = s;
    }
    __syncwarp();
    if (mine_h) {
      float e3 = 0.0f;
      for (int r = 0; r < h; ++r) e3 = __fadd_rn(e3, sh.t3[side][r]);
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (16 * h + r < top_n) sh.s2[side][16 * h + r] = __fadd_rn(e3, ch[r]);
    }
  }
  __syncthreads();
  // the scanned value before the lane pair's block, then each element's
  float base1 = 0.0f, base2 = 0.0f;
  if (blk > 0) {
    base1 = __fadd_rn(g > 0 ? sh.s2[0][g - 1] : 0.0f, p1);
    base2 = __fadd_rn(g > 0 ? sh.s2[1][g - 1] : 0.0f, p2);
  } else if (g > 0) {
    base1 = __fadd_rn(g > 1 ? sh.s2[0][g - 2] : 0.0f, sh.top[0][g - 1]);
    base2 = __fadd_rn(g > 1 ? sh.s2[1][g - 2] : 0.0f, sh.top[1][g - 1]);
  }
  const float d_in = d_sum_in[row], d2_in = d2_sum_in[row];
  float f1[kEpt], f2[kEpt];
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    f1[q] = __fadd_rn(d_in, __fadd_rn(base1, c1[q]));
    f2[q] = __fadd_rn(d2_in, __fadd_rn(base2, c2[q]));
  }

  // 4. mean + 2·std at each contributing error, once; the running max
  //    before the thread's first element
  float m2s[kEpt];
  float emax = -INFINITY;
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    m2s[q] = (contrib >> q) & 1u ? m2s_of(f1[q], f2[q], k[q]) : -INFINITY;
    emax = fmax_(emax, m2s[q]);
  }
  float etot;
  const float ebefore = cl::block_exclusive(emax, -INFINITY, fmax_, sh.ebuf, etot);
  float run = fmax_(
      fmax_(cl::cluster_exclusive(cluster, etot, -INFINITY, fmax_, &sh.ev_pub, &sh.ev_b),
            ebefore),
      m2s_max_in[row]);

  // 5. each event against the max before it; per-batch marks; the end
  ct::ThreadMarks tm(a, b);
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    if (q < ne) {
      const int j = a + q;
      if ((contrib >> q) & 1u) {
        const float excl = run;
        run = fmax_(run, m2s[q]);
        const bool update = m2s[q] > excl;
        const bool check = !update && k[q] >= min_num_errors;
        const float ratio = __fdiv_rn(m2s[q], excl < 1e-30f ? 1e-30f : excl);
        const bool change = check && ratio < change_beta;
        const bool warning = check && !change && ratio < warning_alpha;
        tm.note(cluster, marks, rank, j, n, b, warning, change);
      }
      if (j == n - 1) {
        d_sum_out[row] = f1[q];
        d2_sum_out[row] = f2[q];
        m2s_max_out[row] = run;
      }
    }
  }
  tm.flush(cluster, marks, rank, n, b);

  cluster.sync();
  ct::store_marks(marks, rank, n, b, first_warning + static_cast<size_t>(row) * w,
                  first_change + static_cast<size_t>(row) * w);
}

__global__ void eddm_window_floor_kernel() {}

}  // namespace

// The floats of a row's global scratch: the cumsum tree's levels for d and
// d² (used where they do not fit in shared memory).
extern "C" long long eddm_tree_words(int n) {
  long long m[kMaxTree], off[kMaxTree], total = 0;
  tree_levels(n, m, off, total);
  return 2 * total;
}

// The shared memory of the one-CTA path at w batches of b: the bytes to
// request, and whether the sums' tree sits there (else in the scratch).
inline cudaError_t one_cta_smem(int w, int b, size_t& smem, int& in_smem) {
  const long long tree_bytes = eddm_tree_words(w * b) * static_cast<long long>(sizeof(float));
  return zoo::dynamic_smem(eddm_window_kernel, w, tree_bytes, smem, in_smem);
}

// Whether the one-CTA path's sums' tree sits in shared memory at w batches
// of b on the current device (*in_smem 1), or in the scratch (0). Returns a
// CUDA error code.
extern "C" int eddm_window_tree_in_smem(int w, int b, int* in_smem) {
  size_t smem = 0;
  const cudaError_t e = one_cta_smem(w, b, smem, *in_smem);
  return static_cast<int>(e);
}

// `ctas` > 0: the cluster path, one cluster of `ctas` CTAs per partition row
// (ctas = ceil(w·b / 2048) <= 8; `scratch` unused). `ctas` = 0: the one-CTA
// path, one CTA per row, `scratch` holding p rows of eddm_tree_words(w·b)
// floats (null where the tree sits in shared memory). Returns a
// CUDA error code: a refused cluster launch is returned, never worked
// around.
extern "C" int eddm_window_launch(
    const float* errs, const uint8_t* live, const int* count_in, const int* num_errors_in,
    const float* d_sum_in, const float* d2_sum_in, const int* last_err_in,
    const float* m2s_max_in, int p, int w, int b, int ctas, int paper_exact,
    int min_num_errors, float warning_alpha, float change_beta, float* scratch,
    int* first_warning, int* first_change, int* count_out, int* num_errors_out,
    float* d_sum_out, float* d2_sum_out, int* last_err_out, float* m2s_max_out,
    void* stream) {
  if (ctas > 0)
    return ct::launch_clusters(eddm_window_kernel_cluster, p, ctas, b, stream, errs, live,
                               count_in, num_errors_in, d_sum_in, d2_sum_in, last_err_in,
                               m2s_max_in, w, b, ctas, paper_exact, min_num_errors,
                               warning_alpha, change_beta, first_warning, first_change,
                               count_out, num_errors_out, d_sum_out, d2_sum_out,
                               last_err_out, m2s_max_out);
  size_t smem = 0;
  int in_smem = 0;
  const cudaError_t e = one_cta_smem(w, b, smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  eddm_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, count_in, num_errors_in, d_sum_in, d2_sum_in, last_err_in, m2s_max_in, w, b,
      paper_exact, min_num_errors, warning_alpha, change_beta, in_smem, scratch, first_warning,
      first_change, count_out, num_errors_out, d_sum_out, d2_sum_out, last_err_out,
      m2s_max_out);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched as eddm_window_launch launches K5-eddm at this
// shape and path (the same grid, cluster, block and dynamic shared memory):
// the floor under its time.
extern "C" int eddm_window_floor_launch(int p, int w, int b, int ctas, void* stream) {
  if (ctas > 0) return ct::launch_clusters(eddm_window_floor_kernel, p, ctas, b, stream);
  size_t smem = 0;
  int in_smem = 0;
  const cudaError_t e = one_cta_smem(w, b, smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return zoo::launch_floor(eddm_window_floor_kernel, p, smem, stream);
}
