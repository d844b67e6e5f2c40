// K5-adwin — the ADWIN window statistic, one partition row per CTA.
//
// Replaces the JAX package's ops/adwin.py `adwin_window` -> `_adwin_masks`
// (:348) with its chunk scan over `_flush_chunk` (:210), and
// `summarise_window` (XLA-lowered there: cumsum, segment_sum, a lax.scan of
// N/clock + 1 closed-form cascades with a flattened cut test each, a
// gather, masked argmax). Per row of W·B 0/1 error indicators:
//
// 1. each element's absorb counter t (a block scan of valid counts over
//    thread chunks) and the chunk sums (atomics of the errors
//    into the chunk each valid element feeds, the carried pending sum in
//    the first);
// 2. the sequential scan of the n_flush completed chunks, by warp 0 alone:
//    lane k owns histogram level k (L <= 30 lanes), its C slots a row of the
//    [L, C] int histogram in shared memory. A flush is the closed-form
//    cascade — lane k receives a bucket iff every level below it is full
//    (a ballot), a full receiving level drops its two oldest slots (the top
//    level one), and appends the chunk (level 0) or the merged pair of the
//    level below (a shuffle) — then the cut test at every bucket boundary,
//    oldest to newest (a reversed-lane prefix of the per-level sizes and
//    sums, then each lane over its slots), reduced with __any_sync;
// 3. each chunk-completing element's verdict, and per batch the first
//    change (no warnings: first_warning is -1).
//
// It writes [W] first-change (and first-warning) indices and the end state:
// t, pending sum, n, total, the [L, C] histogram and [L] counts, all int32.
//
// Bound on an H100: the inputs are 5 B an element — 1 MB per call at
// [16, 12800] — but the flush scan is a dependent chain of
// N/clock + 1 = 401 steps (clock 32), each a few shuffles, shared-memory
// reads and a handful of float divisions and square roots per bucket: the
// bound is that chain's latency, about 401 x 0.3 us on one warp, not the
// bytes. The JAX package runs all N/clock + 1 steps (dead ones are the
// identity); the kernel stops at the last completed chunk.
//
// Exactness: the histogram, counts and totals are int32, so the end state
// and the flags equal `adwin_window_reference` exactly where the cut tests
// do. The cut bound is the plain version's float32 expression, built with
// -fmad=false, the one fused multiply-add XLA forms there as __fmaf_rn, and
// ln n taken as the float32 rounding of the double-precision log of
// f32(max(n, 1)) — on the CPU the plain version does the same with
// torch.log on float64 — so both agree with the correctly rounded value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "zoo_scan.cuh"

namespace {

using zoo::kThreads;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) adwin_window_kernel(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ t_in, const int* __restrict__ pend_in,
    const int* __restrict__ n_in, const int* __restrict__ total_in,
    const int* __restrict__ sums_in, const int* __restrict__ counts_in, int w,
    int b, int clock, int max_buckets, int levels, int min_window,
    int min_side, float log_2_delta, int* __restrict__ scratch,
    int* __restrict__ first_warning, int* __restrict__ first_change,
    int* __restrict__ t_out, int* __restrict__ pend_out,
    int* __restrict__ n_out, int* __restrict__ total_out,
    int* __restrict__ sums_out, int* __restrict__ counts_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scan_buf[2 * kThreads];
  __shared__ int flushed_s;
  const int row = blockIdx.x;
  const int n_el = w * b;
  const int C = max_buckets + 1;
  const int L = levels;
  const int nc = n_el / clock + 1;
  int* fc = reinterpret_cast<int*>(smem);
  int* fw = fc + w;
  const size_t firsts = (2 * static_cast<size_t>(w) * sizeof(int) + 15) & ~size_t(15);
  int* hist = reinterpret_cast<int*>(smem + firsts);  // [L, C]
  int* rs = scratch + static_cast<size_t>(row) * (n_el + 2 * static_cast<size_t>(nc));
  int* e_t = rs;                  // [n_el] absorb counter
  int* csum = rs + n_el;          // [nc] chunk sums
  int* fired = csum + nc;         // [nc] chunk verdicts
  const float* e = errs + static_cast<size_t>(row) * n_el;
  const uint8_t* v = live + static_cast<size_t>(row) * n_el;
  zoo::first_init(fc, fw, w, b);
  const int t0 = t_in[row];
  const int base = t0 / clock;
  for (int j = threadIdx.x; j < nc; j += blockDim.x) {
    csum[j] = 0;
    fired[j] = 0;
  }
  for (int i = threadIdx.x; i < L * C; i += blockDim.x)
    hist[i] = sums_in[static_cast<size_t>(row) * L * C + i];
  __syncthreads();

  // 1. absorb counters and chunk sums
  int lo, hi;
  zoo::chunk_of(n_el, lo, hi);
  int mine = 0;
  for (int j = lo; j < hi; ++j) mine += v[j] != 0;
  int t = t0 + zoo::block_exclusive_scan(
                   mine, 0, [](int x, int y) { return x + y; }, scan_buf);
  for (int j = lo; j < hi; ++j) {
    if (v[j]) {
      ++t;
      const int ev = static_cast<int>(e[j]);  // truncation, as astype(int32)
      const int sid = (t - 1) / clock - base;  // nc: a chunk no flush reaches
      if (ev != 0 && sid < nc) atomicAdd(&csum[sid], ev);
    }
    e_t[j] = t;
  }
  const int pend0 = pend_in[row];
  if (threadIdx.x == 0) atomicAdd(&csum[0], pend0);
  __syncthreads();
  const int t_end = e_t[n_el - 1];
  const int n_flush = (t0 % clock + (t_end - t0)) / clock;

  // 2. the flush scan, warp 0 (lane k: level k)
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const bool mine_lvl = lane < L;
    int cnt = mine_lvl ? counts_in[static_cast<size_t>(row) * L + lane] : 0;
    int n = n_in[row];
    int total = total_in[row];
    const int size_k = mine_lvl ? (clock << lane) : 0;
    const unsigned below = (1u << lane) - 1u;  // lanes < this one (lane < 32)
    int flushed = 0;
    for (int j = 0; j < n_flush; ++j) {
      const int chunk = csum[j];
      flushed += chunk;
      int* my = hist + lane * C;
      // cascade
      const bool full = mine_lvl && cnt == max_buckets;
      const unsigned fb = __ballot_sync(kFull, full);
      const bool received = mine_lvl && (fb & below) == below;
      const bool ovf = received && full;
      const int shift = ovf ? (lane == L - 1 ? 1 : 2) : 0;
      const int merged = mine_lvl ? my[0] + my[1] : 0;
      const int up = __shfl_up_sync(kFull, merged, 1);
      const int val = lane == 0 ? chunk : up;
      const int top_ovf = __shfl_sync(kFull, ovf ? 1 : 0, L - 1);
      const int top0 = __shfl_sync(kFull, mine_lvl ? my[0] : 0, L - 1);
      __syncwarp();
      if (mine_lvl) {
        const int app = cnt - shift;
        for (int c = 0; c < C; ++c) {  // in place: reads slot c + shift >= c
          const int src = c + shift;
          const int keep = src < C ? my[src] : 0;
          my[c] = (received && c == app) ? val : keep;
        }
        cnt += (received ? 1 : 0) - shift;
      }
      n += clock - top_ovf * (clock << (L - 1));
      total += chunk - top_ovf * top0;
      __syncwarp();

      // cut test at every boundary, oldest (level L-1, slot 0) first
      int pre_n = mine_lvl ? cnt * size_k : 0;
      int pre_s = 0;
      if (mine_lvl)
        for (int c = 0; c < cnt; ++c) pre_s += my[c];
      for (int d = 1; d < 32; d <<= 1) {  // suffix sums over higher lanes
        const int on = __shfl_down_sync(kFull, pre_n, d);
        const int os = __shfl_down_sync(kFull, pre_s, d);
        if (lane + d < 32) {
          pre_n += on;
          pre_s += os;
        }
      }
      int n0 = pre_n - (mine_lvl ? cnt * size_k : 0);  // before this level
      int s0 = pre_s;
      if (mine_lvl)
        for (int c = 0; c < cnt; ++c) s0 -= my[c];
      const float nf = static_cast<float>(n > 1 ? n : 1);
      const float p = __fdiv_rn(static_cast<float>(total), nf);
      const float var_w = __fmul_rn(p, __fsub_rn(1.0f, p));
      const float lg = __fadd_rn(log_2_delta, __double2float_rn(log(static_cast<double>(nf))));
      bool viol = false;
      if (mine_lvl)
        for (int c = 0; c < cnt; ++c) {
          n0 += size_k;
          s0 += my[c];
          const int n1 = n - n0;
          const int s1 = total - s0;
          const float n0f = static_cast<float>(n0 > 1 ? n0 : 1);
          const float n1f = static_cast<float>(n1 > 1 ? n1 : 1);
          const float mu0 = __fdiv_rn(static_cast<float>(s0), n0f);
          const float mu1 = __fdiv_rn(static_cast<float>(s1), n1f);
          const float inv_m = __fadd_rn(__fdiv_rn(1.0f, n0f), __fdiv_rn(1.0f, n1f));
          const float root = __fsqrt_rn(
              __fmul_rn(__fmul_rn(__fmul_rn(2.0f, inv_m), var_w), lg));
          const float eps_cut = __fmaf_rn(__fmul_rn(2.0f / 3.0f, inv_m), lg, root);
          viol |= n0 >= min_side && n1 >= min_side &&
                  fabsf(__fsub_rn(mu0, mu1)) >= eps_cut;
        }
      const bool any = __any_sync(kFull, viol);
      if (lane == 0) fired[j] = (n >= min_window && any) ? 1 : 0;
      __syncwarp();
    }
    if (mine_lvl) counts_out[static_cast<size_t>(row) * L + lane] = cnt;
    if (lane == 0) {
      n_out[row] = n;
      total_out[row] = total;
      flushed_s = flushed;
    }
  }
  __syncthreads();

  // 3. verdicts at chunk-completing elements; the end state
  int pend_sum = 0;
  for (int j = lo; j < hi; ++j) {
    const int tj = e_t[j];
    if (v[j]) pend_sum += static_cast<int>(e[j]);
    if (v[j] && tj % clock == 0) {
      int cid = tj / clock - base - 1;
      cid = cid < 0 ? 0 : (cid > nc - 1 ? nc - 1 : cid);
      zoo::first_mark(fc, fw, j, b, false, fired[cid] != 0);
    }
  }
  const int err_sum = zoo::block_exclusive_scan(
      pend_sum, 0, [](int x, int y) { return x + y; }, scan_buf);
  if (threadIdx.x == blockDim.x - 1) {  // its exclusive sum plus its own
    t_out[row] = t_end;
    pend_out[row] = pend0 + err_sum + pend_sum - (n_flush > 0 ? flushed_s : 0);
  }
  for (int i = threadIdx.x; i < L * C; i += blockDim.x)
    sums_out[static_cast<size_t>(row) * L * C + i] = hist[i];
  __syncthreads();
  zoo::first_store(fc, fw, w, b, first_warning + static_cast<size_t>(row) * w,
                   first_change + static_cast<size_t>(row) * w);
}

}  // namespace

// One CTA per partition row (levels <= 30, checked by the wrapper).
// `scratch` holds p rows of n + 2·(n/clock + 1) ints (n = w·b). Returns a
// CUDA error code.
extern "C" int adwin_window_launch(
    const float* errs, const uint8_t* live, const int* t_in,
    const int* pend_in, const int* n_in, const int* total_in,
    const int* sums_in, const int* counts_in, int p, int w, int b, int clock,
    int max_buckets, int levels, int min_window, int min_side,
    float log_2_delta, int* scratch, int* first_warning, int* first_change,
    int* t_out, int* pend_out, int* n_out, int* total_out, int* sums_out,
    int* counts_out, void* stream) {
  size_t smem = 0;
  int unused = 0;
  const long long hist_bytes =
      static_cast<long long>(levels) * (max_buckets + 1) * sizeof(int);
  cudaError_t e = zoo::dynamic_smem(adwin_window_kernel, w, hist_bytes, smem, unused);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!unused) return static_cast<int>(cudaErrorInvalidValue);  // histogram too large
  adwin_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, t_in, pend_in, n_in, total_in, sums_in, counts_in, w, b,
      clock, max_buckets, levels, min_window, min_side, log_2_delta, scratch,
      first_warning, first_change, t_out, pend_out, n_out, total_out, sums_out,
      counts_out);
  return static_cast<int>(cudaGetLastError());
}
