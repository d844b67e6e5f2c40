// K5-kswin — the KSWIN window statistic, one partition row per CTA.
//
// Replaces the JAX package's ops/detectors.py `_kswin_masks` (:973) with
// `_ring_compact` (:944) and `summarise_window` (XLA-lowered there: a
// cumsum, a scatter, a concatenation, a float32 cumsum, three gathers, a
// dynamic slice, masked argmins). Per row of N = W·B elements:
//
// 1. the valid elements compacted behind the carried window of the last
//    `window_size` stream elements, and the zero-led prefix sums of that
//    row (csrc/ring_compact.cuh: a block scan of valid counts and error
//    sums, then each thread writes its elements' prefixes);
// 2. at each valid element, the mean of its last `stat_size` stream
//    elements against the mean of the `window_size − stat_size` before
//    them, two differences of the prefix row; a change where the gap
//    exceeds the two-sample KS critical value once `window_size` elements
//    have been seen (no warnings);
// 3. per batch the first change, and the end state: the count and the
//    last `window_size` stream elements.
//
// Bound on an H100: the inputs are 5 B an element — 1 MB per call at
// [16, 12800] — so bytes bound it (≈ 0.3 µs). The prefix row (N + 101
// floats a row) lives in shared memory, or in a global scratch for a row
// too long for it; a launch is two passes over the row's chunk and one
// block scan.
//
// Exactness: the prefix sums are sums of 0/1 indicators, exact in any
// order; the means are the plain version's multiplications by f32(1/r)
// and f32(1/(w − r)) (XLA's constant divisions), each difference and
// product rounded on its own (-fmad=false).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ring_compact.cuh"
#include "zoo_scan.cuh"

namespace {

using zoo::kThreads;

__global__ void __launch_bounds__(kThreads) kswin_window_kernel(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ t_in, const float* __restrict__ buf_in, int w, int b, int wr,
    int r, float inv_r, float inv_m, float crit, int pre_in_smem, float* __restrict__ scratch,
    int* __restrict__ first_warning, int* __restrict__ first_change, int* __restrict__ t_out,
    float* __restrict__ buf_out) {
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
  int q = first.n;
  for (int j = lo; j < hi; ++j) {
    if (!v[j]) continue;
    const float hi_s = pre[wr + q + 1];
    const float mid = pre[wr + q + 1 - r];
    const float lo_s = pre[q + 1];
    ++q;
    const float gap = fabsf(__fsub_rn(__fmul_rn(__fsub_rn(hi_s, mid), inv_r),
                                      __fmul_rn(__fsub_rn(mid, lo_s), inv_m)));
    zoo::first_mark(fc, fw, j, b, false, t0 + q >= wr && gap > crit);
  }
  if (threadIdx.x == 0) t_out[row] = t0 + row_s.n;
  __syncthreads();
  zoo::first_store(fc, fw, w, b, first_warning + static_cast<size_t>(row) * w,
                   first_change + static_cast<size_t>(row) * w);
}

__global__ void kswin_window_floor_kernel() {}

}  // namespace

// One CTA per partition row of w·b elements; `wr` the window_size, `r` the
// stat_size, inv_r = f32(1/r), inv_m = f32(1/(wr − r)), `crit` the f32
// critical value. `scratch` holds p rows of wr + w·b + 1 floats, used where
// they do not fit in shared memory. Returns a CUDA error code.
extern "C" int kswin_window_launch(
    const float* errs, const uint8_t* live, const int* t_in, const float* buf_in, int p, int w,
    int b, int wr, int r, float inv_r, float inv_m, float crit, float* scratch,
    int* first_warning, int* first_change, int* t_out, float* buf_out, void* stream) {
  size_t smem = 0;
  int in_smem = 0;
  const cudaError_t e =
      ring::ring_smem(kswin_window_kernel, w, wr, static_cast<long long>(w) * b, smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kswin_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, t_in, buf_in, w, b, wr, r, inv_r, inv_m, crit, in_smem, scratch,
      first_warning, first_change, t_out, buf_out);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched as kswin_window_launch launches K5-kswin at this
// shape (the same grid, block and dynamic shared memory): the floor under
// its time.
extern "C" int kswin_window_floor_launch(int p, int w, int b, int wr, void* stream) {
  size_t smem = 0;
  int in_smem = 0;
  const cudaError_t e =
      ring::ring_smem(kswin_window_kernel, w, wr, static_cast<long long>(w) * b, smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return zoo::launch_floor(kswin_window_floor_kernel, p, smem, stream);
}
