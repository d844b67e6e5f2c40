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
// T·n] projections nor the votes reach device memory.
//
// Bound on an H100 at the main path's shapes (P = 16 partitions, W·B =
// 12,800 rows each, F = 21, T = 32, depth 3): 96 visited nodes a row × 21
// products and adds, and a tally of the 32 votes, 0.832 G operations a
// launch, 12.4 us at 67 TFLOP/s f32 — against 0.4 MB of int16 indices read
// and 0.8 MB of errors written (0.4 us at 3.35 TB/s): bound by the f32
// operations. The chain that keeps K11, K12 and the plain version equal
// bit for bit rounds each product and each add on its own (no FMA), so
// each is an instruction: ≈ 25 us is the least this arithmetic takes. The
// design spends as little as it can beside those instructions:
//
// * The row in registers. For F <= 64 the kernel is templated on F's
//   float4 count NV and the real features of the last one (TAIL); each
//   thread keeps its row in NV float4 registers, so a product costs a
//   quarter of a shared load — the node's projection column, node-major,
//   read as float4. Columns sit 4·(NV | 1) floats apart, so the (at most
//   8) nodes a level of a tree offers the lanes of a warp fall in
//   distinct banks.
// * Two trees walked together: their independent chains (21 dependent
//   adds each at F = 21) fill each other's latency; the levels of one
//   tree stay in order. Two, so that a thread of a row of up to 32
//   features keeps to 64 registers and 8 CTAs fit an SM
//   (chip_forest_probe.py times one, two and four trees).
// * Persistent CTAs. About one wave of CTAs, split among the partitions,
//   each staging its partition's node-major projections, thresholds and
//   leaf classes once (a 2-D loop, no division an element) and then
//   walking row tiles of kThreads rows, as many tiles each.
// * An O(T) tally. Each thread counts its votes in private counters,
//   [⌈C / k⌉][kThreads] 32-bit words of k counters of 8, 16 or 32 bits
//   (by T), so a warp's counters never share a bank. The mode is kept as
//   the votes come: a class whose count passes the best, or equals it
//   with a lower class, takes its place — which leaves the first class of
//   largest count, jnp.argmax's rule. The counters are then cleared: all
//   ⌈C / k⌉ words, or, when that is more than T, the words of the votes,
//   which the thread then keeps ([T][kThreads] words). Votes outside
//   [0, C) are not counted, as jax.nn.one_hot drops them; K11 and JAX's
//   fit give none (the wrapper's contract).
//
// What holds it above the arithmetic: below the root the lanes of a warp
// read the columns of different nodes, and such a read costs the warp a
// shared-memory wavefront a float where a read at one address costs a
// quarter of one (chip_forest_probe.py times the walk with every read at
// the root's address).
//
// Shapes past these layouts: rows wider than 64 features, or parameters
// too large for shared memory beside the tally, take the generic kernel —
// the row staged in shared memory at a stride of the block (else read
// from the table at each visit), the parameters node-major in shared
// memory when they fit (else read from device memory in place) — with the
// same two-tree walk and tally. A tally too large for shared memory goes
// to a global workspace of kThreads slots a CTA (the wrapper allocates it
// from `forest_predict_err_plan`). `force` puts each layout within a
// test's reach at small shapes.
//
// The plain version is models/forest.py `forest_predict_err_reference`;
// the two are equal bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "forest.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 2;   // trees walked together
constexpr int kMaxVec = 16;  // rows of up to 64 features in registers
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on an H100
constexpr int kMaxDevices = 64;
constexpr int kKernels = 1 + 4 * kMaxVec;  // the generic kernel, then (NV, TAIL)

// `force` bits (tests): the generic kernel; rows read from the table;
// parameters read from device memory; the tally in the global workspace;
// the votes kept (counters cleared through them).
constexpr int kForceGeneric = 1, kForceTable = 2, kForceParamsGlobal = 4, kForceTallyGlobal = 8,
              kForceKeepVotes = 16;

struct Args {
  const float* table;
  int ldt;
  const int* labels;
  const void* idx;
  int idx_bytes;
  const float* proj;
  const float* thresh;
  const int* leaf_class;
  int n_rows, f, trees, depth, classes;
  uint32_t* gtally;  // the global tally, or null
  float* err;
  int* pred;
};

// A launch's layout (`forest_predict_err_plan`).
struct Plan {
  int regs;           // the row in registers (F <= 64, parameters staged)
  int rows_staged;    // generic kernel: rows [F][kThreads] in shared memory
  int params_staged;  // node-major projections, thresholds, leaf classes in shared
  int tally_global;   // counters (and votes) in the global workspace
  int keep_votes;     // counters cleared through the kept votes
  int bits;           // a counter's width: 8, 16 or 32
  int words;          // a thread's counter words: ⌈C / (32 / bits)⌉
  int stride;         // floats between staged columns
  int ctas;           // CTAs a partition
  int smem;           // bytes of dynamic shared memory
  long long tally_words;  // 32-bit words of one CTA's tally
};

__device__ __forceinline__ int load_idx(const void* idx, int idx_bytes, size_t at) {
  return idx_bytes == 2 ? static_cast<int>(static_cast<const int16_t*>(idx)[at])
                        : static_cast<const int32_t*>(idx)[at];
}

// A thread's private counters and running mode (see the header).
struct Tally {
  uint32_t* cnt;  // word w at cnt[w · kThreads]
  int* votes;     // tree t's vote at votes[t · kThreads], or null
  int classes, words, lg_cpw, lg_bits;
  uint32_t mask;
  int best, best_n;

  __device__ __forceinline__ void add(int v, int t) {
    if (votes != nullptr) votes[static_cast<size_t>(t) * kThreads] = v;
    if (static_cast<unsigned>(v) >= static_cast<unsigned>(classes)) return;
    uint32_t* wp = cnt + static_cast<size_t>(v >> lg_cpw) * kThreads;
    const int sh = (v & ((1 << lg_cpw) - 1)) << lg_bits;
    const uint32_t word = *wp + (1u << sh);
    *wp = word;
    const int k = static_cast<int>((word >> sh) & mask);
    if (k > best_n || (k == best_n && v < best)) {
      best = v;
      best_n = k;
    }
  }

  __device__ __forceinline__ void clear(int trees) {
    if (votes != nullptr) {
      for (int t = 0; t < trees; ++t) {
        const int v = votes[static_cast<size_t>(t) * kThreads];
        if (static_cast<unsigned>(v) < static_cast<unsigned>(classes))
          cnt[static_cast<size_t>(v >> lg_cpw) * kThreads] = 0;
      }
    } else {
      for (int w = 0; w < words; ++w) cnt[static_cast<size_t>(w) * kThreads] = 0;
    }
  }
};

// Trees t0 .. t0 + G - 1 of a row held in registers: each level's G
// chains interleaved, each over the F = 4·(NV − 1) + TAIL features in
// order from +0 (forest.cuh `project`'s chain); then the G votes.
template <int NV, int TAIL, int G>
__device__ __forceinline__ void walk_regs(const float4 (&x)[NV], const float4* ps4,
                                          const float* ts, const int* ls, int t0, int n,
                                          int depth, Tally& tally) {
  constexpr int kS4 = NV | 1;
  int node[G];
#pragma unroll
  for (int g = 0; g < G; ++g) node[g] = 0;
  for (int d = 0; d < depth; ++d) {
    float acc[G];
    const float4* col[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g] = 0.0f;
      col[g] = ps4 + ((t0 + g) * n + node[g]) * kS4;
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int real = v < NV - 1 ? 4 : TAIL;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 p = col[g][v];
        acc[g] = forest::add_rn(acc[g], forest::mul_rn(x[v].x, p.x));
        if (real > 1) acc[g] = forest::add_rn(acc[g], forest::mul_rn(x[v].y, p.y));
        if (real > 2) acc[g] = forest::add_rn(acc[g], forest::mul_rn(x[v].z, p.z));
        if (real > 3) acc[g] = forest::add_rn(acc[g], forest::mul_rn(x[v].w, p.w));
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int m = (t0 + g) * n + node[g];
      node[g] = 2 * node[g] + 1 + (forest::gt(acc[g], ts[m]) ? 1 : 0);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) tally.add(ls[(t0 + g) * (n + 1) + node[g] - n], t0 + g);
}

// The same walk for a row x (feature j at x[j·sx]) and projections whose
// element (j, m) lies at P[m·sm + j·sj].
template <int G>
__device__ __forceinline__ void walk_any(const float* x, int sx, const float* P, int sm, int sj,
                                         int f, const float* ts, const int* ls, int t0, int n,
                                         int depth, Tally& tally) {
  int node[G];
#pragma unroll
  for (int g = 0; g < G; ++g) node[g] = 0;
  for (int d = 0; d < depth; ++d) {
    float acc[G];
    const float* col[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g] = 0.0f;
      col[g] = P + static_cast<size_t>((t0 + g) * n + node[g]) * sm;
    }
#pragma unroll 4
    for (int j = 0; j < f; ++j) {
      const float xj = x[static_cast<size_t>(j) * sx];
#pragma unroll
      for (int g = 0; g < G; ++g)
        acc[g] = forest::add_rn(acc[g], forest::mul_rn(xj, col[g][static_cast<size_t>(j) * sj]));
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int m = (t0 + g) * n + node[g];
      node[g] = 2 * node[g] + 1 + (forest::gt(acc[g], ts[m]) ? 1 : 0);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    tally.add(ls[static_cast<size_t>(t0 + g) * (n + 1) + node[g] - n], t0 + g);
}

// NV > 0: the register kernel for F = 4·(NV − 1) + TAIL; NV = 0: the
// generic kernel. A grid of (plan.ctas, P).
template <int NV, int TAIL>
__global__ void __launch_bounds__(kThreads, NV <= 8 ? 8 : 4)
    forest_predict_err_kernel(const Args a, const Plan plan) {
  extern __shared__ float4 smem4[];
  const int n = (1 << a.depth) - 1, leaves = n + 1, tn = a.trees * n, f = a.f;
  const int tid = threadIdx.x;
  const int part = blockIdx.y;
  const float* pp = a.proj + static_cast<size_t>(part) * f * tn;
  const float* tp = a.thresh + static_cast<size_t>(part) * tn;
  const int* lp = a.leaf_class + static_cast<size_t>(part) * a.trees * leaves;
  float* rest = reinterpret_cast<float*>(smem4);
  const float* P = pp;
  int sm = 1, sj = tn;  // element (j, m) of the projections at P[m·sm + j·sj]
  if (plan.params_staged) {  // node-major, zero past F; a column loop a thread
    float* ps = rest;
    float* ts = ps + static_cast<size_t>(tn) * plan.stride;
    int* ls = reinterpret_cast<int*>(ts + tn);
    for (int m = tid; m < tn; m += kThreads) {
      float* dst = ps + static_cast<size_t>(m) * plan.stride;
      for (int j = 0; j < f; ++j) dst[j] = pp[static_cast<size_t>(j) * tn + m];
      for (int j = f; j < plan.stride; ++j) dst[j] = 0.0f;
    }
    for (int i = tid; i < tn; i += kThreads) ts[i] = tp[i];
    for (int i = tid; i < a.trees * leaves; i += kThreads) ls[i] = lp[i];
    P = ps;
    sm = plan.stride;
    sj = 1;
    tp = ts;
    lp = ls;
    rest = reinterpret_cast<float*>(ls + a.trees * leaves);
  }
  uint32_t* tal = reinterpret_cast<uint32_t*>(rest);
  if (plan.tally_global) {
    tal = a.gtally + (static_cast<size_t>(part) * gridDim.x + blockIdx.x) * plan.tally_words;
  } else {
    rest += plan.tally_words;
  }
  const int lg_bits = plan.bits == 8 ? 3 : plan.bits == 16 ? 4 : 5;
  Tally tally{tal + tid,
              plan.keep_votes ? reinterpret_cast<int*>(tal) +
                                    static_cast<size_t>(plan.words) * kThreads + tid
                              : nullptr,
              a.classes, plan.words, 5 - lg_bits, lg_bits,
              plan.bits == 32 ? 0xFFFFFFFFu : (1u << plan.bits) - 1u, 0, 0};
  for (int w = 0; w < plan.words; ++w) tally.cnt[static_cast<size_t>(w) * kThreads] = 0;
  float* xs = rest;  // the generic kernel's rows [F][kThreads], when staged
  __syncthreads();

  const int tiles = (a.n_rows + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row = tile * kThreads + tid;
    if (row >= a.n_rows) break;
    const size_t at = static_cast<size_t>(part) * a.n_rows + row;
    const int ri = load_idx(a.idx, a.idx_bytes, at);
    const float* src = a.table + static_cast<size_t>(ri) * a.ldt;
    tally.best = 0;
    tally.best_n = 0;
    if constexpr (NV > 0) {
      float4 x[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int real = v < NV - 1 ? 4 : TAIL;
        x[v].x = src[4 * v];
        x[v].y = real > 1 ? src[4 * v + 1] : 0.0f;
        x[v].z = real > 2 ? src[4 * v + 2] : 0.0f;
        x[v].w = real > 3 ? src[4 * v + 3] : 0.0f;
      }
      const float4* ps4 = reinterpret_cast<const float4*>(P);
      int t = 0;
      for (; t + kGroup <= a.trees; t += kGroup)
        walk_regs<NV, TAIL, kGroup>(x, ps4, tp, lp, t, n, a.depth, tally);
      for (; t < a.trees; ++t) walk_regs<NV, TAIL, 1>(x, ps4, tp, lp, t, n, a.depth, tally);
    } else {
      const float* x = src;
      int sx = 1;
      if (plan.rows_staged) {  // the row once from the table
        for (int j = 0; j < f; ++j) xs[j * kThreads + tid] = src[j];
        x = xs + tid;
        sx = kThreads;
      }
      int t = 0;
      for (; t + kGroup <= a.trees; t += kGroup)
        walk_any<kGroup>(x, sx, P, sm, sj, f, tp, lp, t, n, a.depth, tally);
      for (; t < a.trees; ++t) walk_any<1>(x, sx, P, sm, sj, f, tp, lp, t, n, a.depth, tally);
    }
    a.err[at] = tally.best != a.labels[ri] ? 1.0f : 0.0f;
    if (a.pred != nullptr) a.pred[at] = tally.best;
    tally.clear(a.trees);
  }
}

// An empty kernel launched with K12's grid, block and shared memory: the
// floor under K12's time.
__global__ void forest_predict_err_floor_kernel() {}

using Kernel = void (*)(Args, Plan);

template <int NV>
Kernel with_tail(int tail) {
  switch (tail) {
    case 1: return forest_predict_err_kernel<NV, 1>;
    case 2: return forest_predict_err_kernel<NV, 2>;
    case 3: return forest_predict_err_kernel<NV, 3>;
    default: return forest_predict_err_kernel<NV, 4>;
  }
}

// The kernel of a layout and its slot in the raised-limit table.
Kernel kernel_of(const Plan& plan, int f, int& slot) {
  if (!plan.regs) {
    slot = 0;
    return forest_predict_err_kernel<0, 0>;
  }
  const int nv = (f + 3) / 4, tail = f - 4 * (nv - 1);
  slot = 1 + 4 * (nv - 1) + (tail - 1);
  switch (nv) {
    case 1: return with_tail<1>(tail);
    case 2: return with_tail<2>(tail);
    case 3: return with_tail<3>(tail);
    case 4: return with_tail<4>(tail);
    case 5: return with_tail<5>(tail);
    case 6: return with_tail<6>(tail);
    case 7: return with_tail<7>(tail);
    case 8: return with_tail<8>(tail);
    case 9: return with_tail<9>(tail);
    case 10: return with_tail<10>(tail);
    case 11: return with_tail<11>(tail);
    case 12: return with_tail<12>(tail);
    case 13: return with_tail<13>(tail);
    case 14: return with_tail<14>(tail);
    case 15: return with_tail<15>(tail);
    default: return with_tail<16>(tail);
  }
}

// The layout at a shape, the CTAs aside. Register kernel: the parameters
// node-major in shared memory (they must fit), the tally beside them when
// it fits. Generic kernel: the tally, then the rows, then the parameters,
// each in shared memory when it fits beside the ones before.
bool layout(int f, int trees, int depth, int classes, int force, Plan& plan) {
  if (f < 1 || trees < 1 || depth < 1 || depth > 16 || classes < 1) return false;
  const long long n = (1LL << depth) - 1, tn = trees * n, leaves = n + 1;
  if (tn * f > INT32_MAX || tn * (f + 3) > INT32_MAX || trees * leaves > INT32_MAX) return false;
  plan = Plan{};
  plan.bits = trees < 256 ? 8 : trees < 65536 ? 16 : 32;
  const int cpw = 32 / plan.bits;
  plan.words = (classes + cpw - 1) / cpw;
  plan.keep_votes = (force & kForceKeepVotes) || plan.words > trees;
  plan.tally_words = static_cast<long long>(plan.words + (plan.keep_votes ? trees : 0)) * kThreads;
  const long long tally = 4 * plan.tally_words;
  const int nv = (f + 3) / 4;
  const long long reg_params = 4 * (tn * 4 * (nv | 1) + tn + trees * leaves);
  long long smem = 0;
  if (!(force & (kForceGeneric | kForceParamsGlobal | kForceTable)) && nv <= kMaxVec &&
      reg_params <= static_cast<long long>(kMaxSmem)) {
    plan.regs = 1;
    plan.params_staged = 1;
    plan.stride = 4 * (nv | 1);
    smem = reg_params;
    plan.tally_global = (force & kForceTallyGlobal) || smem + tally > static_cast<long long>(kMaxSmem);
    if (!plan.tally_global) smem += tally;
  } else {
    plan.tally_global = (force & kForceTallyGlobal) || tally > static_cast<long long>(kMaxSmem);
    if (!plan.tally_global) smem += tally;
    const long long rows = 4LL * f * kThreads;
    plan.rows_staged = !(force & kForceTable) && smem + rows <= static_cast<long long>(kMaxSmem);
    if (plan.rows_staged) smem += rows;
    const long long params = 4 * (tn * f + tn + trees * leaves);
    plan.params_staged =
        !(force & kForceParamsGlobal) && smem + params <= static_cast<long long>(kMaxSmem);
    if (plan.params_staged) smem += params;
    plan.stride = f;
  }
  plan.smem = static_cast<int>(smem);
  return true;
}

std::atomic<int> g_sms[kMaxDevices];
std::atomic<int> g_raised[kKernels + 1][kMaxDevices];  // the kernels, then the floor

// Raise a kernel's shared-memory limit to `smem` bytes once per (device,
// size), above the 48 KB default.
cudaError_t allow_shared(const void* kernel, int slot, int smem, int dev) {
  if (static_cast<size_t>(smem) <= kDefaultSmem) return cudaSuccess;
  std::atomic<int>& raised = g_raised[slot][dev];
  if (smem > raised.load(std::memory_order_relaxed)) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    raised.store(smem, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// The whole plan on the current device: the layout, then the CTAs a
// partition — the CTAs the card holds at once (the kernel's occupancy
// times the SMs) shared out over the partitions, then evened out so that
// every CTA walks as many row tiles. Raises the kernel's shared-memory
// limit.
cudaError_t full_plan(int p, int n, int f, int trees, int depth, int classes, int force,
                      Plan& plan, Kernel& kernel, int& slot) {
  if (!layout(f, trees, depth, classes, force, plan)) return cudaErrorInvalidValue;
  kernel = kernel_of(plan, f, slot);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  e = allow_shared(reinterpret_cast<const void*>(kernel), slot, plan.smem, dev);
  if (e != cudaSuccess) return e;
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, plan.smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  long long share = static_cast<long long>(per_sm) * sms / (p > 0 ? p : 1);
  if (share < 1) share = 1;
  const long long rounds = (tiles + share - 1) / share;
  plan.ctas = static_cast<int>(rounds > 0 ? (tiles + rounds - 1) / rounds : 1);
  if (plan.ctas < 1) plan.ctas = 1;
  return cudaSuccess;
}

}  // namespace

// K12's plan at [p, n] on the current device, into out[0..10]: the
// register kernel, rows staged, parameters staged, tally global, votes
// kept, counter bits, CTAs a partition, threads, shared bytes, the 32-bit
// words of the global workspace (p · CTAs · a CTA's tally when the tally
// is global, else 0), and the counter words a thread (models/forest.py
// `k12_plan`). Returns a CUDA error code.
extern "C" int forest_predict_err_plan(int p, int n, int f, int trees, int depth, int classes,
                                       int force, long long* out) {
  Plan plan;
  Kernel kernel;
  int slot = 0;
  const cudaError_t e =
      full_plan(p, n > 0 ? n : 1, f, trees, depth, classes, force, plan, kernel, slot);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long vals[11] = {plan.regs,
                              plan.rows_staged,
                              plan.params_staged,
                              plan.tally_global,
                              plan.keep_votes,
                              plan.bits,
                              plan.ctas,
                              kThreads,
                              plan.smem,
                              plan.tally_global ? static_cast<long long>(p) * plan.ctas *
                                                      plan.tally_words
                                                : 0,
                              plan.words};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return 0;
}

// `table` is [R, ldt] f32; `idx_bytes` is 2 (int16) or 4 (int32);
// `classes` the forest's C (leaf classes lie in [0, C)); `gtally` null
// unless the plan's tally is global, else its words
// (`forest_predict_err_plan`). Returns a CUDA error code (0 on a clean
// launch).
extern "C" int forest_predict_err_launch(const float* table, int ldt, const int* labels,
                                         const void* idx, int idx_bytes, const float* proj,
                                         const float* thresh, const int* leaf_class, int p,
                                         int n_rows, int f, int trees, int depth, int classes,
                                         int force, void* gtally, float* err, int* pred,
                                         void* stream) {
  if (p == 0 || n_rows == 0) return 0;
  Plan plan;
  Kernel kernel;
  int slot = 0;
  const cudaError_t e =
      full_plan(p, n_rows, f, trees, depth, classes, force, plan, kernel, slot);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (plan.tally_global != (gtally != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const Args args{table, ldt, labels, idx, idx_bytes, proj, thresh, leaf_class, n_rows, f, trees,
                  depth, classes, static_cast<uint32_t*>(gtally), err, pred};
  kernel<<<dim3(plan.ctas, p), kThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(args,
                                                                                       plan);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int forest_predict_err_floor_launch(int p, int n_rows, int f, int trees, int depth,
                                               int classes, void* stream) {
  if (p == 0 || n_rows == 0) return 0;
  Plan plan;
  Kernel kernel;
  int slot = 0, dev = 0;
  cudaError_t e = full_plan(p, n_rows, f, trees, depth, classes, 0, plan, kernel, slot);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_shared(reinterpret_cast<const void*>(forest_predict_err_floor_kernel), kKernels,
                   plan.smem, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  forest_predict_err_floor_kernel<<<dim3(plan.ctas, p), kThreads, plan.smem,
                                    static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
