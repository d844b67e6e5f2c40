// K12 — the oblique forest's predict fused with the error indicator.
//
// Replaces the JAX package's models/classifiers.py `make_forest.predict`
// (:431-436) with engine/window.py's gather `base_X[idx]` and `(preds !=
// y)` — XLA-lowered there as a gather, a [W·B, F] x [F, T·n] dot of every
// node, `depth` rounds of gathers and compares, a one-hot tally of the T
// leaf votes and an argmax. For each row it gathers the features from the
// row table through its index, walks each tree computing only the
// projections of the nodes it visits (the chain of csrc/forest.cuh), takes
// the modal leaf vote (ties to the lowest class, as jnp.argmax of the
// tally) and writes err = (pred != label) as f32. Neither the [P·W·B,
// T·n] projections nor the votes reach device memory (unless T is too
// large for a block's shared memory, below).
//
// Bound on an H100 at the main path's shapes (P = 16 partitions, W·B =
// 12,800 rows each, F = 21, T = 32, depth 3): 96 visited nodes a row × 21
// products and adds, and a tally of the 32 votes, 0.832 G operations a
// launch, 12.4 us at 67 TFLOP/s f32 — against 0.4 MB of int16 indices read
// and 0.8 MB of errors written (0.4 us at 3.35 TB/s): bound by the f32
// operations. This simple design is held back further by the shared and
// L1 loads that feed them (two a product) and by its O(T²) mode count
// (1,024 compares a row, more than the function needs). The design: a
// thread a row; the partition's projections node-major, its
// thresholds and leaf classes in shared memory when they fit (19.6 KB at
// the main path's shapes), else read from device memory in place; a
// thread's row, read once from the table, and its T votes in shared memory
// at a stride of the block, so their loads and the O(T²) mode count are
// free of bank conflicts (10.8 KB and 16 KB a block at those shapes; rows
// too wide for shared memory are read from the table at each visit). The
// row is staged because reading it from the table at every visited node
// puts an L2 round trip on each product: 2.47 ms a call on an H100 at the
// main path's shapes, against 0.34 ms staged (PERF.md §6).
//
// The plain version is models/forest.py `forest_predict_err_reference`;
// the two are equal bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "forest.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on an H100
constexpr int kMaxDevices = 64;

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    forest_predict_err_kernel(const float* __restrict__ table, int ldt,
                              const int* __restrict__ labels, const Idx* __restrict__ idx,
                              const float* __restrict__ proj, const float* __restrict__ thresh,
                              const int* __restrict__ leaf_class, int n_rows, int f, int trees,
                              int depth, int rows_staged, int staged, int* __restrict__ gvotes,
                              float* __restrict__ err, int* __restrict__ pred) {
  extern __shared__ float smem[];
  const int n = (1 << depth) - 1, leaves = n + 1, tn = trees * n;
  const int tid = threadIdx.x;
  const int part = blockIdx.y;
  const float* pp = proj + static_cast<size_t>(part) * f * tn;
  const float* tp = thresh + static_cast<size_t>(part) * tn;
  const int* lp = leaf_class + static_cast<size_t>(part) * trees * leaves;
  // the votes: [T][kThreads] in shared memory, else [T][P·N] in gvotes;
  // then the block's rows [F][kThreads], when staged
  int* votes = reinterpret_cast<int*>(smem);
  float* xs = smem + (gvotes == nullptr ? static_cast<size_t>(trees) * kThreads : 0);
  const float* P = pp;
  int sm = 1, sj = tn;  // element (j, m) of the projections at P[m·sm + j·sj]
  float* rest = xs + (rows_staged ? static_cast<size_t>(f) * kThreads : 0);
  if (staged) {  // node-major projections, thresholds, leaf classes
    float* ps = rest;
    float* ts = ps + static_cast<size_t>(tn) * f;
    int* ls = reinterpret_cast<int*>(ts + tn);
    for (int i = tid; i < f * tn; i += kThreads) {
      const int j = i / tn, m = i - j * tn;
      ps[static_cast<size_t>(m) * f + j] = pp[i];
    }
    for (int i = tid; i < tn; i += kThreads) ts[i] = tp[i];
    for (int i = tid; i < trees * leaves; i += kThreads) ls[i] = lp[i];
    __syncthreads();
    P = ps;
    sm = f;
    sj = 1;
    tp = ts;
    lp = ls;
  }
  const int row = blockIdx.x * kThreads + tid;
  if (row >= n_rows) return;
  const size_t at = static_cast<size_t>(part) * n_rows + row;
  int* vt = gvotes == nullptr ? votes + tid : gvotes + at;
  const size_t vs = gvotes == nullptr ? kThreads : static_cast<size_t>(gridDim.y) * n_rows;
  const int ri = static_cast<int>(idx[at]);
  const float* x = table + static_cast<size_t>(ri) * ldt;
  int sx = 1;
  if (rows_staged) {  // the row once from the table, then from shared memory
    for (int j = 0; j < f; ++j) xs[j * kThreads + tid] = x[j];
    x = xs + tid;
    sx = kThreads;
  }

  for (int t = 0; t < trees; ++t) {
    int node = 0;
    for (int d = 0; d < depth; ++d) {
      const int m = t * n + node;
      node = 2 * node + 1 + (forest::gt(forest::project(x, sx, P, f, m, sm, sj), tp[m]) ? 1 : 0);
    }
    vt[t * vs] = lp[t * leaves + node - n];
  }
  // the modal vote, ties to the lowest class
  int best = 0, best_n = 0;
  for (int t = 0; t < trees; ++t) {
    const int v = vt[t * vs];
    int cnt = 0;
    for (int u = 0; u < trees; ++u) cnt += vt[u * vs] == v;
    if (cnt > best_n || (cnt == best_n && v < best)) {
      best = v;
      best_n = cnt;
    }
  }
  err[at] = best != labels[ri] ? 1.0f : 0.0f;
  if (pred != nullptr) pred[at] = best;
}

struct Config {
  size_t smem;
  int rows_staged;
  int staged;
  bool global_votes;
};

// The launch's shared memory: the votes of a block's threads when they
// fit, then the block's rows when they fit beside them, then the
// partition's node-major projections, thresholds and leaf classes when
// they fit beside those.
Config configure(int f, int trees, int depth) {
  const size_t n = (static_cast<size_t>(1) << depth) - 1, tn = trees * n;
  Config cfg{0, 0, 0, false};
  const size_t votes = 4 * static_cast<size_t>(trees) * kThreads;
  cfg.global_votes = votes > kMaxSmem;
  cfg.smem = cfg.global_votes ? 0 : votes;
  const size_t rows = 4 * static_cast<size_t>(f) * kThreads;
  if (cfg.smem + rows <= kMaxSmem) {
    cfg.rows_staged = 1;
    cfg.smem += rows;
  }
  const size_t params = 4 * (tn * f + tn + trees * (n + 1));
  if (cfg.smem + params <= kMaxSmem) {
    cfg.staged = 1;
    cfg.smem += params;
  }
  return cfg;
}

template <typename Idx>
int launch(const float* table, int ldt, const int* labels, const void* idx, const float* proj,
           const float* thresh, const int* leaf_class, int p, int n_rows, int f, int trees,
           int depth, int* gvotes, float* err, int* pred, cudaStream_t stream) {
  const Config cfg = configure(f, trees, depth);
  if (cfg.global_votes != (gvotes != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = forest_predict_err_kernel<Idx>;
  // the largest shared memory this instantiation's limit was raised to,
  // per device: raised once per (device, size) above the 48 KB default
  static std::atomic<int> raised[kMaxDevices];
  if (cfg.smem > kDefaultSmem) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (static_cast<int>(cfg.smem) > raised[dev].load(std::memory_order_relaxed)) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cfg.smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      raised[dev].store(static_cast<int>(cfg.smem), std::memory_order_relaxed);
    }
  }
  const dim3 grid((n_rows + kThreads - 1) / kThreads, p);
  kernel<<<grid, kThreads, cfg.smem, stream>>>(table, ldt, labels, static_cast<const Idx*>(idx),
                                               proj, thresh, leaf_class, n_rows, f, trees, depth,
                                               cfg.rows_staged, cfg.staged, gvotes, err, pred);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched with K12's grid, block and shared memory: the
// floor under K12's time.
__global__ void forest_predict_err_floor_kernel() {}

}  // namespace

// K12 at a shape: the i32 words each row's votes take in a global
// workspace, or 0 when a block's votes fit shared memory, into *out
// (models/forest.py `k12_votes` sizes `gvotes` from it).
extern "C" int forest_predict_err_votes_words(int f, int trees, int depth, long long* out) {
  if (depth < 1 || depth > 16 || trees < 1) return static_cast<int>(cudaErrorInvalidValue);
  *out = configure(f, trees, depth).global_votes ? trees : 0;
  return 0;
}

// `table` is [R, ldt] f32; `idx_bytes` is 2 (int16) or 4 (int32);
// `gvotes` is null when a block's votes fit shared memory, else a [T][P·N]
// i32 workspace (`forest_predict_err_votes_words`). Returns a CUDA error
// code (0 on a clean launch).
extern "C" int forest_predict_err_launch(const float* table, int ldt, const int* labels,
                                         const void* idx, int idx_bytes, const float* proj,
                                         const float* thresh, const int* leaf_class, int p,
                                         int n_rows, int f, int trees, int depth, int* gvotes,
                                         float* err, int* pred, void* stream) {
  if (p == 0 || n_rows == 0) return 0;
  if (depth < 1 || depth > 16 || trees < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 2)
    return launch<int16_t>(table, ldt, labels, idx, proj, thresh, leaf_class, p, n_rows, f,
                           trees, depth, gvotes, err, pred, s);
  return launch<int32_t>(table, ldt, labels, idx, proj, thresh, leaf_class, p, n_rows, f, trees,
                         depth, gvotes, err, pred, s);
}

extern "C" int forest_predict_err_floor_launch(int p, int n_rows, int f, int trees, int depth,
                                               void* stream) {
  if (p == 0 || n_rows == 0) return 0;
  const Config cfg = configure(f, trees, depth);
  if (cfg.smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(forest_predict_err_floor_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(cfg.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_rows + kThreads - 1) / kThreads, p);
  forest_predict_err_floor_kernel<<<grid, kThreads, cfg.smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
