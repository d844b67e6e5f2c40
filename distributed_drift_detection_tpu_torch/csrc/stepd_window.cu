// K5-stepd — the STEPD window statistic, one partition row per CTA.
//
// Replaces the JAX package's ops/detectors.py `_stepd_masks` (:1135) with
// `_stepd_signal` (:1088), `_ring_compact` (:944) and `summarise_window`
// (XLA-lowered there: KSWIN's compaction and prefix row, a cumsum of the
// errors, the pooled two-proportion test, masked argmins). Per row of
// N = W·B elements:
//
// 1. the valid elements compacted behind the carried window of the last
//    `window_size` stream elements, and the zero-led prefix sums of that
//    row (csrc/ring_compact.cuh);
// 2. at each valid element, the error sum of its last `window_size` stream
//    elements (a difference of the prefix row) against the older rest: the
//    pooled z statistic with continuity correction, gated on t ≥ 2·w and a
//    recent rate above the older one, against the drift and warning
//    critical values;
// 3. per batch the first warning and change, and the end state: the
//    count, the error total and the last `window_size` stream elements.
//
// Bound on an H100: the inputs are 5 B an element — 1 MB per call at
// [16, 12800] — so bytes bound it (≈ 0.3 µs); the prefix row lives in
// shared memory (or a global scratch), a launch is two passes over the
// row's chunk and one block scan.
//
// Exactness: counts are int32 and the sums 0/1 indicators, exact in any
// order. The test is the plain version's float32 expression (ops/detectors.py
// `_stepd_signal`), built with -fmad=false: IEEE divisions and square root,
// the multiplication by f32(1/w) where XLA divides by the constant w, the
// clamp of the variance term at f32(1e-30); the critical values come from
// the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ring_compact.cuh"
#include "zoo_scan.cuh"

namespace {

using zoo::kThreads;

struct Test {
  bool warning, change;
};

// _stepd_signal at element count t, error total `total` and the recent
// window's error sum `recent`
__device__ inline Test stepd_test(int t, float total, float recent, int wr, float inv_w,
                                  float z_drift, float z_warning) {
  float n_of = __int2float_rn(t - wr);
  n_of = n_of < 1.0f ? 1.0f : n_of;
  const float p_r = __fmul_rn(recent, inv_w);
  const float p_o = __fdiv_rn(__fsub_rn(total, recent), n_of);
  const float p_hat = __fdiv_rn(total, __int2float_rn(t < 1 ? 1 : t));
  const float inv = __fadd_rn(__fdiv_rn(1.0f, n_of), inv_w);
  const float num = __fsub_rn(fabsf(__fsub_rn(p_o, p_r)), __fmul_rn(0.5f, inv));
  float var = __fmul_rn(__fmul_rn(p_hat, __fsub_rn(1.0f, p_hat)), inv);
  var = var < 1e-30f ? 1e-30f : var;
  const float z = __fdiv_rn(num, __fsqrt_rn(var));
  const bool gate = t >= 2 * wr && p_r > p_o;
  const bool change = gate && z > z_drift;
  return Test{gate && !change && z > z_warning, change};
}

__global__ void __launch_bounds__(kThreads) stepd_window_kernel(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ t_in, const float* __restrict__ total_in,
    const float* __restrict__ buf_in, int w, int b, int wr, float inv_w, float z_drift,
    float z_warning, int pre_in_smem, float* __restrict__ scratch,
    int* __restrict__ first_warning, int* __restrict__ first_change, int* __restrict__ t_out,
    float* __restrict__ total_out, float* __restrict__ buf_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) ring::Counts scan[2 * kThreads];
  __shared__ ring::Counts row_s;
  const int row = blockIdx.x;
  const int n = w * b;
  int* fc = reinterpret_cast<int*>(smem);
  int* fw = fc + w;
  const size_t firsts = (2 * static_cast<size_t>(w) * sizeof(int) + 15) & ~size_t(15);
  float* pre = pre_in_smem ? reinterpret_cast<float*>(smem + firsts)
                           : scratch + static_cast<size_t>(row) * (wr + n + 1);
  const float* e = errs + static_cast<size_t>(row) * n;
  const uint8_t* v = live + static_cast<size_t>(row) * n;
  zoo::first_init(fc, fw, w, b);
  int lo, hi;
  zoo::chunk_of(n, lo, hi);
  const ring::Counts first =
      ring::compact(e, v, lo, hi, buf_in + static_cast<size_t>(row) * wr,
                    buf_out + static_cast<size_t>(row) * wr, wr, pre, scan, &row_s);
  const int t0 = t_in[row];
  const float total0 = total_in[row];
  int q = first.n;
  float inc = first.c;
  for (int j = lo; j < hi; ++j) {
    if (!v[j]) continue;
    inc = __fadd_rn(inc, e[j]);
    const float recent = __fsub_rn(pre[wr + q + 1], pre[q + 1]);
    ++q;
    const Test s = stepd_test(t0 + q, __fadd_rn(total0, inc), recent, wr, inv_w, z_drift,
                              z_warning);
    zoo::first_mark(fc, fw, j, b, s.warning, s.change);
  }
  if (threadIdx.x == 0) {
    t_out[row] = t0 + row_s.n;
    total_out[row] = __fadd_rn(total0, row_s.c);
  }
  __syncthreads();
  zoo::first_store(fc, fw, w, b, first_warning + static_cast<size_t>(row) * w,
                   first_change + static_cast<size_t>(row) * w);
}

__global__ void stepd_window_floor_kernel() {}

}  // namespace

// One CTA per partition row of w·b elements; `wr` the window_size, inv_w =
// f32(1/wr), `z_*` the f32 critical values. `scratch` holds p rows of
// wr + w·b + 1 floats, used where they do not fit in shared memory. Returns
// a CUDA error code.
extern "C" int stepd_window_launch(
    const float* errs, const uint8_t* live, const int* t_in, const float* total_in,
    const float* buf_in, int p, int w, int b, int wr, float inv_w, float z_drift,
    float z_warning, float* scratch, int* first_warning, int* first_change, int* t_out,
    float* total_out, float* buf_out, void* stream) {
  size_t smem = 0;
  int in_smem = 0;
  const cudaError_t e =
      ring::ring_smem(stepd_window_kernel, w, wr, static_cast<long long>(w) * b, smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  stepd_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, t_in, total_in, buf_in, w, b, wr, inv_w, z_drift, z_warning, in_smem, scratch,
      first_warning, first_change, t_out, total_out, buf_out);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched as stepd_window_launch launches K5-stepd at this
// shape (the same grid, block and dynamic shared memory): the floor under
// its time.
extern "C" int stepd_window_floor_launch(int p, int w, int b, int wr, void* stream) {
  size_t smem = 0;
  int in_smem = 0;
  const cudaError_t e =
      ring::ring_smem(stepd_window_kernel, w, wr, static_cast<long long>(w) * b, smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return zoo::launch_floor(stepd_window_floor_kernel, p, smem, stream);
}
