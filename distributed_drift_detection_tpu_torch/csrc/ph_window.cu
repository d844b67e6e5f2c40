// K5-ph — the Page–Hinkley window statistic, one partition row per CTA.
//
// Replaces the JAX package's ops/detectors.py `ph_window` -> `_ph_masks`
// (:251) and `summarise_window` (XLA-lowered there: cumsum, an
// associative_scan of (A, B, K) clamp-affine maps, masked argmax). For each
// row of W·B error indicators it computes the prefix count and input sum
// carried from the state, the running mean, each element's map
// m -> max(K, A·m + B) (A = alpha, B = x - mean - delta, K = 0 when live;
// the identity A = 1, B = 0, K = -1e30 on padding), their inclusive
// composition, m = max(K, A·m0 + B), the warning/change tests, and per batch
// the first change and the first warning at or before it. It writes [W]
// first-warning and first-change indices and the three end-state scalars;
// the masks never leave the CTA.
//
// Bound on an H100: errs (4 B) and live (1 B) per element, 8 B per batch —
// about 1 MB per call at the main path's [16, 12800], 0.3 us at 3.35 TB/s.
// What costs time is the dependence along the row: the design is the simple
// one, one CTA of 512 threads per row — a block scan of (count, sum) over
// thread chunks, then the combine tree level by level with a barrier
// between levels (27 at N = 12,800). The levels above the first (N/2 + N/4
// + ... tuples of 12 B, 154 KB at N = 12,800) live in shared memory when
// they fit, else in a global scratch; the first level's elements are
// generated from the inputs and the per-element scratch (B, count).
//
// Exactness (bit-identical to `ph_window_reference`): counts and input sums
// are integers in f32, so their order is free; the composition runs on
// lax.associative_scan's tree (zoo_scan.cuh) with the same operations as
// the plain version — A2·A1, fma(A2, B1, B2), max(K2, fma(A2, K1, B2)) and
// the final fma(A, m0, B), because XLA on the CPU fuses those multiply-adds
// — built with -fmad=false (no other contraction) and -ftz=true (XLA on the
// CPU flushes subnormals, and the plain version flushes them as it does:
// the running product alpha^k underflows after some hundreds of elements).

#include <cuda_runtime.h>
#include <stdint.h>

#include "zoo_scan.cuh"

namespace {

using zoo::kThreads;

struct Map {  // m -> max(k, a·m + b)
  float a, b, k;
};

__device__ __forceinline__ Map compose(const Map& f, const Map& g) {  // f, then g
  return Map{__fmul_rn(g.a, f.a), __fmaf_rn(g.a, f.b, g.b),
             fmaxf(g.k, __fmaf_rn(g.a, f.k, g.b))};
}

struct CountSum {
  int c;
  float s;
};

__global__ void __launch_bounds__(kThreads) ph_window_kernel(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ count_in, const float* __restrict__ x_sum_in,
    const float* __restrict__ m_in, int w, int b, int min_num_instances,
    float alpha, float delta, float thr, float wthr, float* __restrict__ scratch,
    long long row_words, int levels_in_smem, int* __restrict__ first_warning,
    int* __restrict__ first_change, int* __restrict__ count_out,
    float* __restrict__ x_sum_out, float* __restrict__ m_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) CountSum scan_buf[2 * kThreads];
  const int row = blockIdx.x;
  const int n = w * b;
  int* fc = reinterpret_cast<int*>(smem);
  int* fw = fc + w;
  const size_t firsts = (2 * static_cast<size_t>(w) * sizeof(int) + 15) & ~size_t(15);
  float* rs = scratch + static_cast<size_t>(row) * row_words;
  float* e_b = rs;                                // [n] B of live elements, 0 on padding
  int* e_cnt = reinterpret_cast<int*>(rs + n);    // [n] running count
  Map* lev = levels_in_smem ? reinterpret_cast<Map*>(smem + firsts)
                            : reinterpret_cast<Map*>(rs + 2 * static_cast<size_t>(n));
  const float* e = errs + static_cast<size_t>(row) * n;
  const uint8_t* v = live + static_cast<size_t>(row) * n;
  zoo::first_init(fc, fw, w, b);

  // 1. prefix count and input sum over thread chunks; per-element B, count
  int lo, hi;
  zoo::chunk_of(n, lo, hi);
  CountSum mine{0, 0.0f};
  for (int j = lo; j < hi; ++j)
    if (v[j]) {
      mine.c += 1;
      mine.s = __fadd_rn(mine.s, e[j]);
    }
  CountSum pre = zoo::block_exclusive_scan(
      mine, CountSum{0, 0.0f},
      [](const CountSum& x, const CountSum& y) { return CountSum{x.c + y.c, __fadd_rn(x.s, y.s)}; },
      scan_buf);
  const int count0 = count_in[row];
  const float x_sum0 = x_sum_in[row];
  for (int j = lo; j < hi; ++j) {
    const bool ok = v[j] != 0;
    if (ok) {
      pre.c += 1;
      pre.s = __fadd_rn(pre.s, e[j]);
    }
    const int cnt = count0 + pre.c;
    const float xsum = __fadd_rn(x_sum0, pre.s);
    const float mean = __fdiv_rn(xsum, static_cast<float>(cnt > 1 ? cnt : 1));
    e_b[j] = ok ? __fsub_rn(__fsub_rn(e[j], mean), delta) : 0.0f;
    e_cnt[j] = cnt;
    if (j == n - 1) {
      count_out[row] = cnt;
      x_sum_out[row] = xsum;
    }
  }
  __syncthreads();

  // 2. the composition, and per element the tests
  const float m0 = m_in[row];
  auto gen = [&](int j) {
    return v[j] ? Map{alpha, e_b[j], 0.0f} : Map{1.0f, 0.0f, -1e30f};
  };
  auto emit = [&](int j, const Map& s) {
    const float m = fmaxf(s.k, __fmaf_rn(s.a, m0, s.b));
    const bool check = v[j] && e_cnt[j] >= min_num_instances;
    const bool change = check && m > thr;
    const bool warning = check && !change && m > wthr;
    zoo::first_mark(fc, fw, j, b, warning, change);
    if (j == n - 1) m_out[row] = m;
  };
  zoo::tree_scan(n, lev, gen, [](const Map& f, const Map& g) { return compose(f, g); }, emit);
  __syncthreads();
  zoo::first_store(fc, fw, w, b, first_warning + static_cast<size_t>(row) * w,
                   first_change + static_cast<size_t>(row) * w);
}

}  // namespace

// One CTA per partition row. `scratch` holds p rows of
// 2·n + 3·scan_levels(n) floats (n = w·b). Returns a CUDA error code.
extern "C" int ph_window_launch(
    const float* errs, const uint8_t* live, const int* count_in,
    const float* x_sum_in, const float* m_in, int p, int w, int b,
    int min_num_instances, float alpha, float delta, float thr, float wthr,
    float* scratch, int* first_warning, int* first_change, int* count_out,
    float* x_sum_out, float* m_out, void* stream) {
  const long long n = static_cast<long long>(w) * b;
  const long long levels = zoo::scan_levels(n);
  size_t smem = 0;
  int in_smem = 0;
  cudaError_t e = zoo::dynamic_smem(ph_window_kernel, w, levels * sizeof(Map), smem, in_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ph_window_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      errs, live, count_in, x_sum_in, m_in, w, b, min_num_instances, alpha,
      delta, thr, wthr, scratch, 2 * n + 3 * levels, in_smem, first_warning,
      first_change, count_out, x_sum_out, m_out);
  return static_cast<int>(cudaGetLastError());
}
