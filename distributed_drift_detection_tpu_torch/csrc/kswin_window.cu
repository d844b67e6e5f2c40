// K5-kswin — the KSWIN window statistic.
//
// Replaces the JAX package's ops/detectors.py `_kswin_masks` (:973) with
// `_ring_compact` (:944) and `summarise_window` (XLA-lowered there: a
// cumsum, a scatter, a concatenation, a float32 cumsum, three gathers, a
// dynamic slice, masked argmins). Per row of N = W·B elements:
//
// 1. the valid elements compacted behind the carried window of the last
//    `window_size` stream elements, and the zero-led prefix sums of that
//    row;
// 2. at each valid element, the mean of its last `stat_size` stream
//    elements against the mean of the `window_size − stat_size` before
//    them, two differences of the prefix row; a change where the gap
//    exceeds the two-sample KS critical value once `window_size` elements
//    have been seen (no warnings);
// 3. per batch the first change, and the end state: the count and the
//    last `window_size` stream elements.
//
// Bound on an H100: the inputs are 5 B an element — 1 MB per call at
// [16, 12800] — so bytes bound it (≈ 0.3 µs). Two paths, the launcher
// taking the one the wrapper names (ops/detectors.py `ring_ctas`: K5-ph's
// shape rule, `cluster_ctas`, for windows up to RING_WINDOW_CAP):
//
// * the cluster path: one thread-block cluster of ceil(N / 2048) CTAs per
//   row, 7 at N = 12,800, each of 256 threads 8 elements in registers
//   (csrc/ring_cluster.cuh: one block scan of the counts, error sums and
//   the carried window; each CTA's compacted prefixes in its shared
//   memory, and beside them the window_size prefix values below its first
//   element, gathered once from the carried window and earlier CTAs
//   through distributed shared memory; every element's two look-backs
//   then read its own CTA's shared memory, the tests of a thread's 8
//   elements side by side; two cluster barriers);
// * the one-CTA path (longer rows, P >= 67 at N = 12,800, or longer
//   windows): one CTA of 512 threads per row, each a contiguous chunk
//   (csrc/ring_compact.cuh: a block scan of valid counts and error sums,
//   then each thread writes its elements' prefixes), the prefix row (N +
//   window_size + 1 floats) in shared memory or, for a row too long for
//   it, in a global scratch.
//
// Exactness: the prefix sums are sums of 0/1 indicators, exact in any
// order; the means are the plain version's multiplications by f32(1/r)
// and f32(1/(w − r)) (XLA's constant divisions), each difference and
// product rounded on its own (-fmad=false).

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

// |(hi − mid)·f32(1/r) − (mid − lo)·f32(1/(w − r))|
__device__ inline float kswin_gap(float hi, float mid, float lo, float inv_r, float inv_m) {
  return fabsf(
      __fsub_rn(__fmul_rn(__fsub_rn(hi, mid), inv_r), __fmul_rn(__fsub_rn(mid, lo), inv_m)));
}

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
    zoo::first_mark(fc, fw, j, b, false,
                    t0 + q >= wr && kswin_gap(hi_s, mid, lo_s, inv_r, inv_m) > crit);
  }
  if (threadIdx.x == 0) t_out[row] = t0 + row_s.n;
  __syncthreads();
  zoo::first_store(fc, fw, w, b, first_warning + static_cast<size_t>(row) * w,
                   first_change + static_cast<size_t>(row) * w);
}

__global__ void __launch_bounds__(ct::kThreads, 1) kswin_window_kernel_cluster(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ t_in, const float* __restrict__ buf_in, int w, int b, int cs,
    int wr, int r, float inv_r, float inv_m, float crit, int* __restrict__ first_warning,
    int* __restrict__ first_change, int* __restrict__ t_out, float* __restrict__ buf_out) {
  __shared__ ring::ClusterShared sh;
  extern __shared__ __align__(16) int dyn[];  // ring::cluster_smem
  cg::cluster_group cluster = cg::this_cluster();
  const int row = blockIdx.x / cs;
  const int n = w * b;
  const int t0 = t_in[row];
  const ring::RowTotals tot = ring::cluster_row(
      cluster, sh, dyn, errs + static_cast<size_t>(row) * n, live + static_cast<size_t>(row) * n,
      buf_in + static_cast<size_t>(row) * wr, buf_out + static_cast<size_t>(row) * wr, n, b,
      wr, cs, first_warning + static_cast<size_t>(row) * w,
      first_change + static_cast<size_t>(row) * w,
      [&](int q1, float hi, float, auto& ps) {
        const float gap = kswin_gap(hi, ps(wr + q1 - r), ps(q1), inv_r, inv_m);
        const bool open = t0 + q1 >= wr;
        return ring::Flags{false, open && gap > crit};
      });
  if (cluster.block_rank() == 0 && threadIdx.x == 0) t_out[row] = t0 + tot.nv;
}

__global__ void kswin_window_floor_kernel() {}

// The one-CTA path's shared memory at w batches of b and window wr: the
// bytes to request, and whether the prefix row sits there.
inline cudaError_t one_cta_smem(int w, int b, int wr, size_t& smem, int& in_smem) {
  return ring::ring_smem(kswin_window_kernel, w, wr, static_cast<long long>(w) * b, smem,
                         in_smem);
}

}  // namespace

// Whether the one-CTA path's prefix row sits in shared memory at w batches
// of b and window wr on the current device (*in_smem 1), or in the
// scratch (0). Returns a CUDA error code.
extern "C" int kswin_window_pre_in_smem(int w, int b, int wr, int* in_smem) {
  size_t smem = 0;
  return static_cast<int>(one_cta_smem(w, b, wr, smem, *in_smem));
}

// `ctas` > 0: the cluster path, one cluster of `ctas` CTAs per partition row
// (ctas = ceil(w·b / 2048) <= 8, wr <= ring::kWindowCap; `scratch` unused).
// `ctas` = 0: the one-CTA path, `scratch` holding p rows of wr + w·b + 1
// floats (null where they fit in shared memory). `wr` the window_size, `r`
// the stat_size, inv_r = f32(1/r), inv_m = f32(1/(wr − r)), `crit` the f32
// critical value. Returns a CUDA error code: a refused cluster launch is
// returned, never worked around.
extern "C" int kswin_window_launch(
    const float* errs, const uint8_t* live, const int* t_in, const float* buf_in, int p, int w,
    int b, int ctas, int wr, int r, float inv_r, float inv_m, float crit, float* scratch,
    int* first_warning, int* first_change, int* t_out, float* buf_out, void* stream) {
  if (ctas > 0) {
    if (wr > ring::kWindowCap) return static_cast<int>(cudaErrorInvalidValue);
    return ct::launch_clusters_smem(kswin_window_kernel_cluster, p, ctas,
                                    ring::cluster_smem(b, wr), stream, errs, live, t_in, buf_in,
                                    w, b, ctas, wr, r, inv_r, inv_m, crit, first_warning,
                                    first_change, t_out, buf_out);
  }
  size_t smem = 0;
  int in_smem = 0;
  const cudaError_t e = one_cta_smem(w, b, wr, smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kswin_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, t_in, buf_in, w, b, wr, r, inv_r, inv_m, crit, in_smem, scratch,
      first_warning, first_change, t_out, buf_out);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched as kswin_window_launch launches K5-kswin at this
// shape and path (the same grid, cluster, block and dynamic shared memory):
// the floor under its time.
extern "C" int kswin_window_floor_launch(int p, int w, int b, int wr, int ctas, void* stream) {
  if (ctas > 0)
    return ct::launch_clusters_smem(kswin_window_floor_kernel, p, ctas,
                                    ring::cluster_smem(b, wr), stream);
  size_t smem = 0;
  int in_smem = 0;
  const cudaError_t e = one_cta_smem(w, b, wr, smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return zoo::launch_floor(kswin_window_floor_kernel, p, smem, stream);
}
