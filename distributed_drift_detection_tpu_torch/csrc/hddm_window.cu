// K5-hddm — the HDDM-A window statistic, one partition row per CTA.
//
// Replaces the JAX package's ops/detectors.py `_hddm_masks` (:548) and
// `summarise_window` (XLA-lowered there: two cumsums, the Hoeffding keys,
// an associative scan of a min with its (n, c) payload, the carried key,
// the two bounds, masked argmins). Per row of N = W·B elements, each thread
// a contiguous chunk:
//
// 1. the element count n and the error sum c at each chunk's start (a block
//    scan of sums: counts and 0/1 indicators, exact in any order);
// 2. each element's key mean + ε(n), +inf where padded, and the running
//    minimum of the keys with its (n, c) payload, later ties winning (the
//    plain version's `ops/ddm.py` `_run_min`: a block scan of each chunk's
//    minimum, then a walk);
// 3. the stored cut — the running minimum where it is at or below the
//    carried cut's key, else the carried cut — and the drift and warning
//    tests against it; per batch the first warning and change, and the end
//    state.
//
// Bound on an H100: the inputs are 5 B an element — 1 MB per call at
// [16, 12800] — so bytes bound it (≈ 0.3 µs); a launch is three passes over
// the row's chunk and two block scans, latency rather than throughput.
//
// Exactness: counts are int32; the error sums are sums of 0/1 indicators,
// exact below 2^24 in any order; a min with a payload does not round. The
// keys and bounds are the plain version's float32 expressions, built with
// -fmad=false: IEEE divisions and square roots (`__fdiv_rn`, `__fsqrt_rn`;
// ε is `f32(ln(1/δ))` divided by 2n, the bound's m is (n − n_min) /
// (n_min·n), then ·0.5·f32(ln(2/δ)), left to right).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "zoo_scan.cuh"

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

}  // namespace

// One CTA per partition row of w·b elements; `log_drift` is f32(ln(1/δ))
// of the drift confidence, `log2_*` f32(ln(2/δ)) of each bound's. Returns
// a CUDA error code.
extern "C" int hddm_window_launch(
    const float* errs, const uint8_t* live, const int* count_in, const float* err_sum_in,
    const int* n_min_in, const float* c_min_in, int p, int w, int b, float log_drift,
    float log2_drift, float log2_warning, int* first_warning, int* first_change,
    int* count_out, float* err_sum_out, int* n_min_out, float* c_min_out, void* stream) {
  size_t smem = 0;
  int unused = 0;
  const cudaError_t e = zoo::dynamic_smem(hddm_window_kernel, w, 0, smem, unused);
  if (e != cudaSuccess) return static_cast<int>(e);
  hddm_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, count_in, err_sum_in, n_min_in, c_min_in, w, b, log_drift, log2_drift,
      log2_warning, first_warning, first_change, count_out, err_sum_out, n_min_out, c_min_out);
  return static_cast<int>(cudaGetLastError());
}
