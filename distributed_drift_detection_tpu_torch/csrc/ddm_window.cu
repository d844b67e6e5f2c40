// K1 — the DDM window statistic, one partition row per thread-block cluster.
//
// Replaces the JAX package's ops/ddm.py `ddm_window` -> `_prefix_masks`,
// `_run_min` and `summarise_window` (XLA-lowered there: cumsum +
// associative_scan + masked argmax). For each partition row of W·B error
// indicators it computes the prefix count and error sum carried from the
// detector state, p = esum/cnt, s = sqrt(p(1-p)/cnt), the running minimum
// of p+s with its (p, s) payload (a later tie wins, merged with the carried
// minima by the same rule), the warning/change tests, and per batch the
// first change and the first warning at or before it. The per-element
// masks live only in registers; the kernel writes [W] first-warning and
// first-change indices and the five end-state scalars per row.
//
// Bound on an H100: it reads errs (4 B) and live (1 B) per element and
// writes 8 B per batch, about 1 MB per level at the main path's
// [16, 12800] — 0.3 us at 3.35 TB/s, under one launch's latency. What
// costs time is the serial dependence along the row, so the design spreads
// a row over a cluster of `cs` CTAs (the wrapper picks cs = min(8,
// max(1, SMs / P)): 16 x 8 = 128 CTAs at P = 16) and keeps each CTA's
// work short:
//
// * CTA k of a cluster owns whole batches [floor(k·W/cs),
//   floor((k+1)·W/cs)), so each batch's first warning and first change
//   stay CTA-local (shared-memory atomicMin). When W < cs some CTAs own
//   nothing and contribute neutral records.
// * The CTA stages its errs/live slice in shared memory with coalesced
//   16-byte (errs) and 4-byte (live) loads, in tiles of 2048 elements;
//   each thread owns 8 consecutive elements of a tile.
// * Prefix exchange through distributed shared memory: each CTA publishes
//   its (count, error sum) total, cluster.sync(), and reads the totals of
//   the CTAs before it (map_shared_rank); then the same for its
//   running-minimum aggregate, whose exclusive prefix starts with the
//   carried state as the first record.
// * The statistic is computed once per element and kept in registers
//   between the aggregate pass and the test pass. A CTA slice longer than
//   one tile (rows of more than cs·2048 elements) re-stages and recomputes
//   each tile in the test pass instead.
//
// Exactness (the kernel is bit-identical to `ddm_window_reference`):
// counts and error sums are integers held in f32 (exact below 2^24), so
// the split across threads, tiles and CTAs cannot change them. The
// min-record combine "the later record wins on <=" is associative (a fold
// yields the latest record holding the minimum), so combining CTA
// aggregates in rank order gives the same ps_min/p_min/s_min as one serial
// scan — the +inf ties of unchecked elements that carry a finite payload
// included. Built with -fmad=false and IEEE division/sqrt; the two
// threshold expressions `p_min + level * s_band` are explicit fused
// multiply-adds, because XLA on the CPU contracts them into one FMA and the
// JAX package is the reference. The plain PyTorch version reproduces the
// FMA exactly in float64.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEpt = 8;  // elements per thread per tile
// Two CTAs an SM (launch bounds) cap registers at 128 a thread, so the 16
// clusters of 8 CTAs at P = 16 are all placed at once, not in two waves.
constexpr int kMinBlocks = 2;
constexpr int kTile = kThreads * kEpt;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 8;  // CTAs of a cluster (the portable limit)

// A running-minimum record: (p+s masked to +inf where unchecked, p, s).
// `has` marks a non-empty record so empty ranges stay neutral.
struct __align__(16) MinRec {
  float ps, p, s;
  int has;
};

// `a` precedes `b`; the later record wins ties (`<=`), as in _run_min.
__device__ __forceinline__ MinRec combine(const MinRec& a, const MinRec& b) {
  if (!b.has) return a;
  if (!a.has) return b;
  return (b.ps <= a.ps) ? b : a;
}

__device__ __forceinline__ MinRec shfl_up(const MinRec& v, int d) {
  MinRec o;
  o.ps = __shfl_up_sync(kFull, v.ps, d);
  o.p = __shfl_up_sync(kFull, v.p, d);
  o.s = __shfl_up_sync(kFull, v.s, d);
  o.has = __shfl_up_sync(kFull, v.has, d);
  return o;
}

// The neutral (empty) record.
__device__ __forceinline__ MinRec none() {
  return MinRec{CUDART_INF_F, 0.0f, 0.0f, 0};
}

// Shared scratch of the block scans.
struct Scratch {
  int cnt[kWarps];
  float err[kWarps];
  MinRec rec[kWarps];
};

// Block-wide exclusive scan of (count, error sum) in thread order: `xc`,
// `xe` get the thread's exclusive prefix, `tc`, `te` the block total.
__device__ void scan_counts(int c, float e, int& xc, float& xe, int& tc,
                            float& te, Scratch& sc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int ic = c;
  float ie = e;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int oc = __shfl_up_sync(kFull, ic, d);
    const float oe = __shfl_up_sync(kFull, ie, d);
    if (lane >= d) {
      ic += oc;
      ie = __fadd_rn(ie, oe);
    }
  }
  if (lane == 31) {
    sc.cnt[warp] = ic;
    sc.err[warp] = ie;
  }
  __syncthreads();
  if (warp == 0) {
    int wc = lane < kWarps ? sc.cnt[lane] : 0;
    float we = lane < kWarps ? sc.err[lane] : 0.0f;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int oc = __shfl_up_sync(kFull, wc, d);
      const float oe = __shfl_up_sync(kFull, we, d);
      if (lane >= d) {
        wc += oc;
        we = __fadd_rn(we, oe);
      }
    }
    if (lane < kWarps) {
      sc.cnt[lane] = wc;
      sc.err[lane] = we;
    }
  }
  __syncthreads();
  xc = ic - c;
  xe = __fsub_rn(ie, e);
  if (warp > 0) {
    xc += sc.cnt[warp - 1];
    xe = __fadd_rn(xe, sc.err[warp - 1]);
  }
  tc = sc.cnt[kWarps - 1];
  te = sc.err[kWarps - 1];
  __syncthreads();
}

// Block-wide exclusive scan of min records in thread order: `x` gets the
// thread's exclusive prefix (neutral for thread 0), `tot` the block's.
__device__ void scan_mins(const MinRec& a, MinRec& x, MinRec& tot,
                          Scratch& sc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  MinRec im = a;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const MinRec o = shfl_up(im, d);
    if (lane >= d) im = combine(o, im);
  }
  x = shfl_up(im, 1);
  if (lane == 0) x = none();
  if (lane == 31) sc.rec[warp] = im;
  __syncthreads();
  if (warp == 0) {
    MinRec wm = lane < kWarps ? sc.rec[lane] : none();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const MinRec o = shfl_up(wm, d);
      if (lane >= d) wm = combine(o, wm);
    }
    if (lane < kWarps) sc.rec[lane] = wm;
  }
  __syncthreads();
  if (warp > 0) x = combine(sc.rec[warp - 1], x);
  tot = sc.rec[kWarps - 1];
  __syncthreads();
}

// Copy `tm` elements of errs/live into shared memory: 16-byte loads of
// errs and 4-byte loads of live where both are aligned, else 4 B / 1 B.
__device__ void stage(const float* __restrict__ e,
                      const uint8_t* __restrict__ v, int tm, float* e_s,
                      uint8_t* v_s) {
  __syncthreads();  // the previous tile's readers are done
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(e) & 15) |
       (reinterpret_cast<uintptr_t>(v) & 3)) == 0) {
    const int nq = tm >> 2;
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      reinterpret_cast<float4*>(e_s)[q] =
          __ldg(reinterpret_cast<const float4*>(e) + q);
      reinterpret_cast<unsigned*>(v_s)[q] =
          __ldg(reinterpret_cast<const unsigned*>(v) + q);
    }
    done = nq << 2;
  }
  for (int i = done + threadIdx.x; i < tm; i += kThreads) {
    e_s[i] = e[i];
    v_s[i] = v[i];
  }
  __syncthreads();
}

// The thread's elements of the staged tile: error sums and validity.
struct Chunk {
  float e[kEpt];
  unsigned valid;  // bit j: element j is live
  int ne;          // elements of this thread in the tile (0..kEpt)
};

__device__ __forceinline__ Chunk read_chunk(const float* e_s,
                                            const uint8_t* v_s, int tm) {
  Chunk ch;
  ch.ne = min(kEpt, max(0, tm - static_cast<int>(threadIdx.x) * kEpt));
  ch.valid = 0;
#pragma unroll
  for (int q = 0; q < kEpt / 4; ++q) {
    const int at = threadIdx.x * (kEpt / 4) + q;
    const float4 a = reinterpret_cast<const float4*>(e_s)[at];
    const unsigned vv = reinterpret_cast<const unsigned*>(v_s)[at];
    ch.e[4 * q] = a.x;
    ch.e[4 * q + 1] = a.y;
    ch.e[4 * q + 2] = a.z;
    ch.e[4 * q + 3] = a.w;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * q + u;
      if (j < ch.ne && ((vv >> (8 * u)) & 0xffu) != 0) ch.valid |= 1u << j;
    }
  }
  return ch;
}

// Stage tile t of the CTA's `m` elements and scan its (count, error sum):
// returns the thread's chunk; `xc`, `xe` get the thread's exclusive prefix
// within the tile and `tc`, `te` the tile's totals.
__device__ Chunk count_tile(const float* __restrict__ e,
                            const uint8_t* __restrict__ v, int t, int m,
                            float* e_s, uint8_t* v_s, Scratch& sc, int& xc,
                            float& xe, int& tc, float& te) {
  const int tm = min(kTile, m - t * kTile);
  stage(e + t * kTile, v + t * kTile, tm, e_s, v_s);
  const Chunk ch = read_chunk(e_s, v_s, tm);
  int c = 0;
  float es = 0.0f;
#pragma unroll
  for (int j = 0; j < kEpt; ++j) {
    if ((ch.valid >> j) & 1u) {
      c += 1;
      es = __fadd_rn(es, ch.e[j]);
    }
  }
  scan_counts(c, es, xc, xe, tc, te, sc);
  return ch;
}

// Per-element statistic of the thread's elements, kept in registers.
struct Stats {
  float p[kEpt], s[kEpt], ps[kEpt], esum[kEpt];
  int cnt[kEpt];
  unsigned check;  // bit j: the min/warning/change section runs
};

// The statistic from the thread's exclusive prefix (`cnt`: count including
// the carried count; `cums`: error sum excluding the carried err_sum), and
// the thread's min-record aggregate.
__device__ __forceinline__ MinRec element_stats(const Chunk& ch, int cnt,
                                                float cums, float err_sum0,
                                                int min_num_instances,
                                                Stats& st) {
  MinRec agg = none();
  st.check = 0;
#pragma unroll
  for (int j = 0; j < kEpt; ++j) {
    if (j < ch.ne) {
      const bool ok = (ch.valid >> j) & 1u;
      if (ok) {
        cnt += 1;
        cums = __fadd_rn(cums, ch.e[j]);
      }
      const float esum = __fadd_rn(err_sum0, cums);
      const float cnt_f = static_cast<float>(cnt > 1 ? cnt : 1);
      // +0 / x and sqrt(+0) are +0: testing for zero (an error-free or
      // empty prefix) keeps it off the division's and square root's slow
      // paths, and the results are the same bits.
      const float p = esum > 0.0f ? __fdiv_rn(esum, cnt_f) : 0.0f;
      const float q = __fmul_rn(p, __fsub_rn(1.0f, p));
      const float s = q > 0.0f ? __fsqrt_rn(__fdiv_rn(q, cnt_f)) : 0.0f;
      const float ps = __fadd_rn(p, s);
      const bool check = ok && (cnt + 1 >= min_num_instances);
      st.p[j] = p;
      st.s[j] = s;
      st.ps[j] = ps;
      st.esum[j] = esum;
      st.cnt[j] = cnt;
      if (check) st.check |= 1u << j;
      agg = combine(agg, MinRec{check ? ps : CUDART_INF_F, p, s, 1});
    }
  }
  return agg;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) ddm_window_kernel(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ count_in, const float* __restrict__ err_sum_in,
    const float* __restrict__ ps_min_in, const float* __restrict__ p_min_in,
    const float* __restrict__ s_min_in, int n, int w, int b, int cs,
    int min_num_instances, float warning_level, float out_control_level,
    float band_floor, int use_floor, int* __restrict__ first_warning,
    int* __restrict__ first_change, int* __restrict__ count_out,
    float* __restrict__ err_sum_out, float* __restrict__ ps_min_out,
    float* __restrict__ p_min_out, float* __restrict__ s_min_out) {
  __shared__ __align__(16) float e_s[kTile];
  __shared__ __align__(16) uint8_t v_s[kTile];
  __shared__ Scratch sc;
  // Published to the cluster: this CTA's totals and min aggregate.
  __shared__ int cta_count;
  __shared__ float cta_err;
  __shared__ MinRec cta_min;
  // Broadcast within the CTA: the exclusive prefix over earlier CTAs.
  __shared__ int pre_count;
  __shared__ float pre_err;
  __shared__ MinRec pre_min;
  extern __shared__ int first_s[];  // [2·nb]: first change, first warning

  cg::cluster_group cluster = cg::this_cluster();  // cs CTAs along x
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  const int b_lo = static_cast<int>(static_cast<long long>(rank) * w / cs);
  const int b_hi =
      static_cast<int>(static_cast<long long>(rank + 1) * w / cs);
  const int nb = b_hi - b_lo;
  const int m = nb * b;  // this CTA's elements
  const int ntiles = (m + kTile - 1) / kTile;
  const int start = b_lo * b;  // first element within the row
  const float* e = errs + static_cast<size_t>(row) * n + start;
  const uint8_t* v = live + static_cast<size_t>(row) * n + start;
  int* fc_s = first_s;
  int* fw_s = first_s + nb;
  for (int k = tid; k < nb; k += kThreads) {
    fc_s[k] = b;
    fw_s[k] = b;
  }
  const int count0 = count_in[row];
  const float err_sum0 = err_sum_in[row];
  const MinRec carried = {ps_min_in[row], p_min_in[row], s_min_in[row], 1};

  // 1. The CTA's (count, error sum) total; with one tile, the thread's
  //    exclusive prefix and its chunk stay for pass 2.
  Chunk ch;
  ch.ne = 0;
  ch.valid = 0;
  int xc = 0;
  float xe = 0.0f;
  int tot_c = 0;
  float tot_e = 0.0f;
  for (int t = 0; t < ntiles; ++t) {
    int tc;
    float te;
    ch = count_tile(e, v, t, m, e_s, v_s, sc, xc, xe, tc, te);
    tot_c += tc;
    tot_e = __fadd_rn(tot_e, te);
  }

  // Exchange 1: the counts and error sums of the CTAs before this one.
  if (tid == 0) {
    cta_count = tot_c;
    cta_err = tot_e;
  }
  cluster.sync();
  if (tid < 32) {
    int c = 0;
    float es = 0.0f;
    if (lane < rank) {
      c = *cluster.map_shared_rank(&cta_count, lane);
      es = *cluster.map_shared_rank(&cta_err, lane);
    }
#pragma unroll
    for (int d = kMaxCluster / 2; d > 0; d >>= 1) {  // over lanes 0..7
      c += __shfl_xor_sync(kFull, c, d);
      es = __fadd_rn(es, __shfl_xor_sync(kFull, es, d));
    }
    if (lane == 0) {
      pre_count = c;
      pre_err = es;
    }
  }
  __syncthreads();
  const int pc = count0 + pre_count;  // carried count + earlier CTAs
  const float pe = pre_err;

  // 2. The statistic and the CTA's min aggregate.
  Stats st;
  MinRec xm = none();  // the thread's exclusive min prefix within its tile
  MinRec agg = none();
  {
    int tb_c = 0;
    float tb_e = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
      int tc;
      float te;
      if (ntiles > 1)
        ch = count_tile(e, v, t, m, e_s, v_s, sc, xc, xe, tc, te);
      const MinRec a = element_stats(ch, pc + tb_c + xc,
                                     __fadd_rn(pe, __fadd_rn(tb_e, xe)),
                                     err_sum0, min_num_instances, st);
      MinRec tile_min;
      scan_mins(a, xm, tile_min, sc);
      agg = combine(agg, tile_min);
      if (ntiles > 1) {
        tb_c += tc;
        tb_e = __fadd_rn(tb_e, te);
      }
    }
  }

  // Exchange 2: the min aggregates of the CTAs before this one, in rank
  // order, after the carried minima (the first record of CTA 0).
  if (tid == 0) cta_min = agg;
  cluster.sync();
  if (tid < 32) {
    MinRec r = none();
    if (lane < rank) r = *cluster.map_shared_rank(&cta_min, lane);
#pragma unroll
    for (int d = 1; d < kMaxCluster; d <<= 1) {  // over lanes 0..7
      const MinRec o = shfl_up(r, d);
      if (lane >= d) r = combine(o, r);
    }
    if (lane == kMaxCluster - 1) pre_min = combine(carried, r);
  }
  __syncthreads();
  // This CTA has read the cluster's shared memory for the last time; the
  // wait before exit keeps its own alive until every CTA has done so.
  cg::cluster_group::arrival_token done = cluster.barrier_arrive();

  // 3. Per element: running minimum, band, warning/change; per-batch first
  //    indices through shared-memory atomicMin.
  {
    MinRec tile_base = pre_min;
    int tb_c = 0;
    float tb_e = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
      MinRec tile_min = none();
      if (ntiles > 1) {
        int tc;
        float te;
        ch = count_tile(e, v, t, m, e_s, v_s, sc, xc, xe, tc, te);
        const MinRec a = element_stats(ch, pc + tb_c + xc,
                                       __fadd_rn(pe, __fadd_rn(tb_e, xe)),
                                       err_sum0, min_num_instances, st);
        scan_mins(a, xm, tile_min, sc);
        tb_c += tc;
        tb_e = __fadd_rn(tb_e, te);
      }
      MinRec run = combine(tile_base, xm);
      const int i0 = start + t * kTile + tid * kEpt;  // element within row
      int wi = i0 / b;  // its batch, and its index there
      int jb = i0 - wi * b;
      int last_c = -1;
      int last_w = -1;
#pragma unroll
      for (int j = 0; j < kEpt; ++j) {
        if (j > 0 && ++jb == b) {
          jb = 0;
          ++wi;
        }
        if (j < ch.ne) {
          const bool check = (st.check >> j) & 1u;
          run = combine(run, MinRec{check ? st.ps[j] : CUDART_INF_F, st.p[j],
                                    st.s[j], 1});
          const float s_band =
              use_floor ? (run.s > band_floor ? run.s : band_floor) : run.s;
          const bool change =
              check && st.ps[j] > __fmaf_rn(out_control_level, s_band, run.p);
          const bool warning =
              check && !change &&
              st.ps[j] > __fmaf_rn(warning_level, s_band, run.p);
          if (change && wi != last_c) {
            atomicMin(&fc_s[wi - b_lo], jb);
            last_c = wi;
          }
          if (warning && wi != last_w) {
            atomicMin(&fw_s[wi - b_lo], jb);
            last_w = wi;
          }
          if (i0 + j == n - 1) {
            count_out[row] = st.cnt[j];
            err_sum_out[row] = st.esum[j];
            ps_min_out[row] = run.ps;
            p_min_out[row] = run.p;
            s_min_out[row] = run.s;
          }
        }
      }
      if (ntiles > 1) tile_base = combine(tile_base, tile_min);
    }
  }
  __syncthreads();

  // 4. A warning counts only at or before the batch's first change.
  for (int k = tid; k < nb; k += kThreads) {
    const int fc = fc_s[k];
    const int fw = fw_s[k];
    const size_t at = static_cast<size_t>(row) * w + b_lo + k;
    first_change[at] = fc < b ? fc : -1;
    first_warning[at] = (fw < b && (fc >= b || fw <= fc)) ? fw : -1;
  }
  cluster.barrier_wait(std::move(done));
}

}  // namespace

// One cluster of `cs` CTAs per partition row (1 <= cs <= 8). Returns a CUDA
// error code: a refused cluster launch is returned, never worked around.
extern "C" int ddm_window_launch(
    const float* errs, const uint8_t* live, const int* count_in,
    const float* err_sum_in, const float* ps_min_in, const float* p_min_in,
    const float* s_min_in, int p, int n, int w, int b, int cs,
    int min_num_instances, float warning_level, float out_control_level,
    float band_floor, int use_floor, int* first_warning, int* first_change,
    int* count_out, float* err_sum_out, float* ps_min_out, float* p_min_out,
    float* s_min_out, void* stream) {
  const int nb_max = (w + cs - 1) / cs;
  const size_t smem = 2 * static_cast<size_t>(nb_max) * sizeof(int);
  if (smem > 32 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ddm_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p) * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, ddm_window_kernel, errs, live, count_in, err_sum_in, ps_min_in,
      p_min_in, s_min_in, n, w, b, cs, min_num_instances, warning_level,
      out_control_level, band_floor, use_floor, first_warning, first_change,
      count_out, err_sum_out, ps_min_out, p_min_out, s_min_out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
