// K5-stepd — the STEPD window statistic.
//
// Replaces the JAX package's ops/detectors.py `_stepd_masks` (:1135) with
// `_stepd_signal` (:1088), `_ring_compact` (:944) and `summarise_window`
// (XLA-lowered there: KSWIN's compaction and prefix row, a cumsum of the
// errors, the pooled two-proportion test, masked argmins). Per row of
// N = W·B elements:
//
// 1. the valid elements compacted behind the carried window of the last
//    `window_size` stream elements, and the zero-led prefix sums of that
//    row;
// 2. at each valid element, the error sum of its last `window_size` stream
//    elements (a difference of the prefix row) against the older rest: the
//    pooled z statistic with continuity correction, gated on t ≥ 2·w and a
//    recent rate above the older one, against the drift and warning
//    critical values;
// 3. per batch the first warning and change, and the end state: the
//    count, the error total and the last `window_size` stream elements.
//
// Bound on an H100: the inputs are 5 B an element — 1 MB per call at
// [16, 12800] — so bytes bound it (≈ 0.3 µs). Two paths, as K5-kswin's
// (csrc/kswin_window.cu; ops/detectors.py `ring_ctas`): the cluster path,
// ceil(N / 2048) CTAs a row of 256 threads with 8 elements each in
// registers, the test's divisions and root spread over the cluster's SMs
// (a thread's 8 tests side by side) and its one look-back a read of the
// CTA's shared memory (csrc/ring_cluster.cuh); and the one-CTA path for
// longer rows or windows (csrc/ring_compact.cuh), the prefix row in shared
// memory or a global scratch.
//
// Exactness: counts are int32 and the sums 0/1 indicators, exact in any
// order. The test is the plain version's float32 expression (ops/detectors.py
// `_stepd_signal`), built with -fmad=false: IEEE divisions and square root,
// the multiplication by f32(1/w) where XLA divides by the constant w, the
// clamp of the variance term at f32(1e-30); the critical values come from
// the host.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ring_cluster.cuh"
#include "ring_compact.cuh"
#include "zoo_scan.cuh"

namespace cg = cooperative_groups;

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

__global__ void __launch_bounds__(ct::kThreads, 1) stepd_window_kernel_cluster(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ t_in, const float* __restrict__ total_in,
    const float* __restrict__ buf_in, int w, int b, int cs, int wr, float inv_w, float z_drift,
    float z_warning, int* __restrict__ first_warning, int* __restrict__ first_change,
    int* __restrict__ t_out, float* __restrict__ total_out, float* __restrict__ buf_out) {
  __shared__ ring::ClusterShared sh;
  extern __shared__ __align__(16) int dyn[];  // ring::cluster_smem
  cg::cluster_group cluster = cg::this_cluster();
  const int row = blockIdx.x / cs;
  const int n = w * b;
  const int t0 = t_in[row];
  const float total0 = total_in[row];
  const ring::RowTotals tot = ring::cluster_row(
      cluster, sh, dyn, errs + static_cast<size_t>(row) * n, live + static_cast<size_t>(row) * n,
      buf_in + static_cast<size_t>(row) * wr, buf_out + static_cast<size_t>(row) * wr, n, b,
      wr, cs, first_warning + static_cast<size_t>(row) * w,
      first_change + static_cast<size_t>(row) * w,
      [&](int q1, float own, float inc, auto& ps) {
        const Test s = stepd_test(t0 + q1, __fadd_rn(total0, inc), __fsub_rn(own, ps(q1)), wr,
                                  inv_w, z_drift, z_warning);
        return ring::Flags{s.warning, s.change};
      });
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    t_out[row] = t0 + tot.nv;
    total_out[row] = __fadd_rn(total0, tot.errors);
  }
}

__global__ void stepd_window_floor_kernel() {}

// The one-CTA path's shared memory at w batches of b and window wr: the
// bytes to request, and whether the prefix row sits there.
inline cudaError_t one_cta_smem(int w, int b, int wr, size_t& smem, int& in_smem) {
  return ring::ring_smem(stepd_window_kernel, w, wr, static_cast<long long>(w) * b, smem,
                         in_smem);
}

}  // namespace

// Whether the one-CTA path's prefix row sits in shared memory at w batches
// of b and window wr on the current device (*in_smem 1), or in the
// scratch (0). Returns a CUDA error code.
extern "C" int stepd_window_pre_in_smem(int w, int b, int wr, int* in_smem) {
  size_t smem = 0;
  return static_cast<int>(one_cta_smem(w, b, wr, smem, *in_smem));
}

// `ctas` > 0: the cluster path, one cluster of `ctas` CTAs per partition row
// (ctas = ceil(w·b / 2048) <= 8, wr <= ring::kWindowCap; `scratch` unused).
// `ctas` = 0: the one-CTA path, `scratch` holding p rows of wr + w·b + 1
// floats (null where they fit in shared memory). `wr` the window_size,
// inv_w = f32(1/wr), `z_*` the f32 critical values. Returns a CUDA error
// code: a refused cluster launch is returned, never worked around.
extern "C" int stepd_window_launch(
    const float* errs, const uint8_t* live, const int* t_in, const float* total_in,
    const float* buf_in, int p, int w, int b, int ctas, int wr, float inv_w, float z_drift,
    float z_warning, float* scratch, int* first_warning, int* first_change, int* t_out,
    float* total_out, float* buf_out, void* stream) {
  if (ctas > 0) {
    if (wr > ring::kWindowCap) return static_cast<int>(cudaErrorInvalidValue);
    return ct::launch_clusters_smem(stepd_window_kernel_cluster, p, ctas,
                                    ring::cluster_smem(b, wr), stream, errs, live, t_in,
                                    total_in, buf_in, w, b, ctas, wr, inv_w, z_drift, z_warning,
                                    first_warning, first_change, t_out, total_out, buf_out);
  }
  size_t smem = 0;
  int in_smem = 0;
  const cudaError_t e = one_cta_smem(w, b, wr, smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  stepd_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, t_in, total_in, buf_in, w, b, wr, inv_w, z_drift, z_warning, in_smem, scratch,
      first_warning, first_change, t_out, total_out, buf_out);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched as stepd_window_launch launches K5-stepd at this
// shape and path (the same grid, cluster, block and dynamic shared memory):
// the floor under its time.
extern "C" int stepd_window_floor_launch(int p, int w, int b, int wr, int ctas, void* stream) {
  if (ctas > 0)
    return ct::launch_clusters_smem(stepd_window_floor_kernel, p, ctas,
                                    ring::cluster_smem(b, wr), stream);
  size_t smem = 0;
  int in_smem = 0;
  const cudaError_t e = one_cta_smem(w, b, wr, smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return zoo::launch_floor(stepd_window_floor_kernel, p, smem, stream);
}
