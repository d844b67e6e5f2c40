// K1 — the DDM window statistic, one block per partition row.
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
// [16, 12800] — 0.3 us at 3.35 TB/s, well under one launch's latency, so
// the kernel is launch-latency bound at P = 16. Its design keeps it to one
// launch per level: one block per row, a thread-serial pass over each
// thread's contiguous chunk, a warp-shuffle + shared-memory block scan for
// the prefix sums, a second block scan for the running minimum, and
// shared-memory atomicMin for the per-batch first indices.
//
// Exactness: counts and error sums are integers held in f32 (exact below
// 2^24), so the scan order cannot change them. Built with -fmad=false and
// IEEE division/sqrt; the two threshold expressions `p_min + level *
// s_band` are explicit fused multiply-adds, because XLA on the CPU
// contracts them into one FMA and the JAX package is the reference. The
// plain PyTorch version reproduces the FMA exactly in float64.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// A running-minimum record: (p+s masked to +inf where unchecked, p, s).
// `has` marks a non-empty record so empty thread chunks stay neutral.
struct MinRec {
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

struct Elem {
  float p, s, ps, esum;
  int cnt;
  bool check;
};

// The per-element statistic at prefix count `cnt` and prefix error sum
// `cums` (exclusive of the carried err_sum).
__device__ __forceinline__ Elem element(int cnt, float cums, float err_sum0,
                                        bool valid, int min_num_instances) {
  Elem r;
  r.cnt = cnt;
  r.esum = __fadd_rn(err_sum0, cums);
  const float cnt_f = static_cast<float>(cnt > 1 ? cnt : 1);
  r.p = __fdiv_rn(r.esum, cnt_f);
  float q = __fmul_rn(r.p, __fsub_rn(1.0f, r.p));
  q = q > 0.0f ? q : 0.0f;
  r.s = __fsqrt_rn(__fdiv_rn(q, cnt_f));
  r.ps = __fadd_rn(r.p, r.s);
  r.check = valid && (cnt + 1 >= min_num_instances);
  return r;
}

__global__ void __launch_bounds__(kThreads) ddm_window_kernel(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ count_in, const float* __restrict__ err_sum_in,
    const float* __restrict__ ps_min_in, const float* __restrict__ p_min_in,
    const float* __restrict__ s_min_in, int n, int w, int b,
    int min_num_instances, float warning_level, float out_control_level,
    float band_floor, int use_floor, int* __restrict__ first_warning,
    int* __restrict__ first_change, int* __restrict__ count_out,
    float* __restrict__ err_sum_out, float* __restrict__ ps_min_out,
    float* __restrict__ p_min_out, float* __restrict__ s_min_out) {
  extern __shared__ int first_s[];  // [2W]: first change, first warning
  __shared__ int warp_cnt[kWarps];
  __shared__ float warp_err[kWarps];
  __shared__ MinRec warp_min[kWarps];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* e = errs + static_cast<size_t>(row) * n;
  const uint8_t* v = live + static_cast<size_t>(row) * n;
  int* fc_s = first_s;
  int* fw_s = first_s + w;
  for (int k = tid; k < w; k += kThreads) {
    fc_s[k] = b;
    fw_s[k] = b;
  }

  const int chunk = (n + kThreads - 1) / kThreads;
  const int lo = min(tid * chunk, n);
  const int hi = min(lo + chunk, n);

  // 1. Thread-serial totals of the chunk.
  int c = 0;
  float es = 0.0f;
  for (int i = lo; i < hi; ++i) {
    if (v[i]) {
      c += 1;
      es = __fadd_rn(es, e[i]);
    }
  }

  // 2. Block exclusive scan of (count, error sum).
  int ic = c;
  float ie = es;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int oc = __shfl_up_sync(kFull, ic, d);
    const float oe = __shfl_up_sync(kFull, ie, d);
    if (lane >= d) {
      ic += oc;
      ie = __fadd_rn(ie, oe);
    }
  }
  int xc = __shfl_up_sync(kFull, ic, 1);
  float xe = __shfl_up_sync(kFull, ie, 1);
  if (lane == 0) {
    xc = 0;
    xe = 0.0f;
  }
  if (lane == 31) {
    warp_cnt[warp] = ic;
    warp_err[warp] = ie;
  }
  __syncthreads();
  if (warp == 0) {
    int wc = warp_cnt[lane];
    float we = warp_err[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int oc = __shfl_up_sync(kFull, wc, d);
      const float oe = __shfl_up_sync(kFull, we, d);
      if (lane >= d) {
        wc += oc;
        we = __fadd_rn(we, oe);
      }
    }
    warp_cnt[lane] = wc;
    warp_err[lane] = we;
  }
  __syncthreads();
  if (warp > 0) {
    xc += warp_cnt[warp - 1];
    xe = __fadd_rn(xe, warp_err[warp - 1]);
  }

  const int count0 = count_in[row];
  const float err_sum0 = err_sum_in[row];

  // 3. Chunk aggregate of the running minimum, then its block scan.
  MinRec agg = {CUDART_INF_F, 0.0f, 0.0f, 0};
  {
    int cnt = count0 + xc;
    float cums = xe;
    for (int i = lo; i < hi; ++i) {
      const bool ok = v[i] != 0;
      if (ok) {
        cnt += 1;
        cums = __fadd_rn(cums, e[i]);
      }
      const Elem x = element(cnt, cums, err_sum0, ok, min_num_instances);
      agg = combine(agg, MinRec{x.check ? x.ps : CUDART_INF_F, x.p, x.s, 1});
    }
  }
  MinRec im = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const MinRec o = shfl_up(im, d);
    if (lane >= d) im = combine(o, im);
  }
  MinRec xm = shfl_up(im, 1);
  if (lane == 0) xm.has = 0;
  if (lane == 31) warp_min[warp] = im;
  __syncthreads();
  if (warp == 0) {
    MinRec wm = warp_min[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const MinRec o = shfl_up(wm, d);
      if (lane >= d) wm = combine(o, wm);
    }
    warp_min[lane] = wm;
  }
  __syncthreads();
  if (warp > 0) xm = combine(warp_min[warp - 1], xm);
  // The carried minima precede every element of the window.
  MinRec run = combine(
      MinRec{ps_min_in[row], p_min_in[row], s_min_in[row], 1}, xm);

  // 4. Per element: running minimum, band, warning/change; per-batch
  //    first indices through shared-memory atomicMin.
  int cnt = count0 + xc;
  float cums = xe;
  int last_c = -1;
  int last_w = -1;
  for (int i = lo; i < hi; ++i) {
    const bool ok = v[i] != 0;
    if (ok) {
      cnt += 1;
      cums = __fadd_rn(cums, e[i]);
    }
    const Elem x = element(cnt, cums, err_sum0, ok, min_num_instances);
    run = combine(run, MinRec{x.check ? x.ps : CUDART_INF_F, x.p, x.s, 1});
    const float s_band =
        use_floor ? (run.s > band_floor ? run.s : band_floor) : run.s;
    const bool change =
        x.check && x.ps > __fmaf_rn(out_control_level, s_band, run.p);
    const bool warning = x.check && !change &&
                         x.ps > __fmaf_rn(warning_level, s_band, run.p);
    const int wi = i / b;
    const int j = i - wi * b;
    if (change && wi != last_c) {
      atomicMin(&fc_s[wi], j);
      last_c = wi;
    }
    if (warning && wi != last_w) {
      atomicMin(&fw_s[wi], j);
      last_w = wi;
    }
    if (i == n - 1) {
      count_out[row] = x.cnt;
      err_sum_out[row] = x.esum;
      ps_min_out[row] = run.ps;
      p_min_out[row] = run.p;
      s_min_out[row] = run.s;
    }
  }
  __syncthreads();

  // 5. A warning counts only at or before the batch's first change.
  for (int k = tid; k < w; k += kThreads) {
    const int fc = fc_s[k];
    const int fw = fw_s[k];
    first_change[static_cast<size_t>(row) * w + k] = fc < b ? fc : -1;
    first_warning[static_cast<size_t>(row) * w + k] =
        (fw < b && (fc >= b || fw <= fc)) ? fw : -1;
  }
}

}  // namespace

extern "C" int ddm_window_launch(
    const float* errs, const uint8_t* live, const int* count_in,
    const float* err_sum_in, const float* ps_min_in, const float* p_min_in,
    const float* s_min_in, int p, int n, int w, int b, int min_num_instances,
    float warning_level, float out_control_level, float band_floor,
    int use_floor, int* first_warning, int* first_change, int* count_out,
    float* err_sum_out, float* ps_min_out, float* p_min_out,
    float* s_min_out, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(w) * sizeof(int);
  ddm_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, count_in, err_sum_in, ps_min_in, p_min_in, s_min_in, n, w,
      b, min_num_instances, warning_level, out_control_level, band_floor,
      use_floor, first_warning, first_change, count_out, err_sum_out,
      ps_min_out, p_min_out, s_min_out);
  return static_cast<int>(cudaGetLastError());
}
