// K11 — the oblique forest's fit from its key, one CTA a (partition, tree).
//
// Replaces the JAX package's models/classifiers.py `make_forest.fit`
// (:391-429), XLA-lowered there as threefry hashes and erf_inv for the
// normals and uniforms, a [B, F] x [F, T·n] dot, a sort along the rows, a
// gather, `depth` rounds of gathers and compares, a scatter-add of the
// leaf counts and two argmaxes, vmapped over partitions. Per partition p,
// from its fit key keys[p], rows X [B, F] f32, labels y [B] i32 and {0, 1}
// weights w [B] f32, it writes proj [F, T·n] f32, thresh [T·n] f32 and
// leaf_class [T, 2^d] i32 (n = 2^d − 1 nodes a tree):
// 1. kp, kt = split(key); proj[j][m] = normal(kp, j·T·n + m) with XLA's
//    folded factor f32(f32(√2)·f32(1/√F)) (csrc/threefry.cuh); idx[m] =
//    clip(int(uniform(kt, m, 0.1, 0.9) · nv), 0, B − 1), nv = max(Σw, 1);
// 2. z[r][m], each row's projection onto each node (csrc/forest.cuh);
// 3. thresh[m] = the idx[m]-th of column m of z in a stable sort of
//    jnp.sort's keys, the invalid rows (w = 0) as +inf;
// 4. each row walks each tree to its leaf;
// 5. a leaf's class is the first class of largest weight among its rows,
//    a leaf of no weight the batch's majority class (the first class of
//    largest weight).
// The plain version is models/forest.py `forest_fit_reference`; the two
// are equal bit for bit (the projections by the chain of forest.cuh, the
// draws by threefry.cuh; built with -fmad=false -ftz=true for erf_inv).
//
// Bound on an H100 at the main path's shapes (P = 16, B = 100, F = 21,
// C = 40, T = 32, depth 3: T·n = 224 nodes): bytes — X, y, w in (0.15 MB),
// proj, thresh, leaf_class out (0.32 MB), 0.14 us at 3.35 TB/s; the
// operations the function needs a partition, whatever its algorithm —
// 4,704 normals (≈ 40 f32 operations each in erf_inv, the integer hash
// aside), 940,800 products and adds of z, a selection of ⌈log2 B⌉ = 7
// compares a (row, node), and 16,000 for the routing, the leaf counts and
// the batch's class counts — 20.8 M over 16 partitions: 0.31 us at 67
// TFLOP/s. What bounds a launch this small is latency: each step is a
// dependent chain (the hash's 20 rounds, erf_inv, a projection's 21 adds)
// and the steps wait on each other. The design cuts the chain a CTA runs
// and runs as many CTAs as the card holds:
//
// * A CTA a (partition, tree): P·T CTAs (512 at the main path's
//   shapes). A tree's normals are proj[j][m] for its own columns m:
//   counter j·T·n + m, drawn alone; its uniforms, its z, thresholds,
//   routing and leaf counts touch no other tree. Only nv and the batch's majority class
//   are shared across a partition; every CTA computes them itself, the
//   same bits in each: the weights are {0, 1} (the wrapper's contract),
//   so every sum is an integer below 2^24, exact in any order.
// * The thresholds by selection: a warp a column finds the idx-th (key,
//   row) of its B rows by a radix select on the keys, a ballot over each
//   lane's keys a bit, from the highest bit the keys differ in until one
//   candidate is left (≈ log2 B passes), then the rank among equal keys
//   in row order — jnp.sort's stable order. Each key is read once into
//   registers when B <= 128. The row found writes its projection,
//   recomputed (the same chain, the same bits), or +inf when it is
//   invalid.
// * Leaf counts as counters: [2^d][C] and the batch's [C] integer counts
//   in shared memory; each row of weight 1 adds one to its (leaf, label)
//   cell — a warp's rows of one cell at once, by a shared atomic from
//   their lowest lane (labels outside [0, C) dropped, as JAX's scatter
//   drops them) — the same numbers as the weights' f32 sums, whose
//   integer values are exact in any order; a warp a leaf then takes the
//   first class of largest count. Where the counters do not fit
//   (deep trees, many classes), the row rule: each row's weight of its
//   label in its leaf (O(B²) a tree), and the row of largest (count,
//   −label, −row) in a leaf writes its class.
// * z a chunk of columns at a time: z of as many of the tree's columns as
//   fit sits in shared memory, [chunk][B]; the keys are worked out from it
//   as the selection reads it. When one chunk holds all the tree's columns
//   (all 7 at the main path's shapes) the routing reads z there, else it
//   recomputes each visited projection (deep trees). The tree's columns,
//   the rows and the thresholds sit in shared memory when they fit, else
//   are read from device memory (the columns and thresholds from the
//   outputs this CTA wrote); z of rows too many for one column in shared
//   memory, and the row rule's ids and counts, take a global workspace
//   (`forest_fit_plan`). `force` puts the row rule and the global layout
//   within a test's reach at small shapes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "forest.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;  // keys a lane holds in registers: B <= 128
constexpr int kCols = 8;   // columns a thread projects a row onto at once
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on an H100
constexpr int kMaxDevices = 64;
// The static shared memory beside the dynamic, kept free of it.
constexpr size_t kStaticSmem = 1024;

// `force` bits (tests): the row rule; nothing staged (the rows, columns
// and thresholds read from device memory; z, the ids and counts in the
// global workspace).
constexpr int kForceRowRule = 1, kForceGlobal = 2;

struct Args {
  const uint32_t* keys;
  const float* X;
  const int* y;
  const float* w;
  int b, f, c, trees, depth;
  float factor;
  float* proj;
  float* thresh;
  int* leaf_class;
  float* gwork;
};

// A launch's layout (`forest_fit_plan`).
struct Plan {
  int counters;     // leaf and batch counters in shared memory (else the row rule)
  int ids_global;   // the row rule's leaf ids and counts [2][B] in the global workspace
  int th_staged;    // the tree's thresholds [n] in shared memory
  int cols_staged;  // the tree's columns node-major [n][F] in shared memory
  int x_staged;     // the rows [B][F] in shared memory
  int z_global;     // z of a chunk of columns in the global workspace
  int chunk;        // columns a round of the thresholds
  int smem;         // bytes of dynamic shared memory
  long long work_words;  // floats of one CTA's global workspace
};

__device__ __forceinline__ uint32_t ukey(int key) {
  return static_cast<uint32_t>(key) ^ 0x80000000u;  // the signed order, unsigned
}

// Row r's key in a column whose projections are zs: jnp.sort's order of
// its value, +inf for an invalid row.
__device__ __forceinline__ uint32_t row_key(const float* zs, const float* w, int r) {
  return ukey(forest::sort_key(w[r] > 0.0f ? zs[r] : CUDART_INF_F));
}

// The row at rank k (from 0) in the stable ascending order of the keys of
// the column zs[0 .. b): the radix select above, for a whole warp (every
// lane gets it), from the highest bit the keys differ in down to the bit
// where one candidate is left (≈ log2 B passes for keys of distinct
// values). S > 0: the keys held in S registers a lane (b <= 32·S).
template <int S>
__device__ int select_row(const float* zs, const float* w, int b, int k, int lane) {
  const int slots = S > 0 ? S : (b + 31) >> 5;
  uint32_t reg[S > 0 ? S : 1];
  uint32_t all = 0xFFFFFFFFu, any = 0u;
#pragma unroll
  for (int s = 0; s < slots; ++s) {
    const int r = (s << 5) + lane;
    const uint32_t v = r < b ? row_key(zs, w, r) : 0u;
    if (S > 0) reg[S > 0 ? s : 0] = v;
    if (r < b) {
      all &= v;
      any |= v;
    }
  }
  all = __reduce_and_sync(0xFFFFFFFFu, all);
  any = __reduce_or_sync(0xFFFFFFFFu, any);
  // `key` holds the bits decided so far (those of `ge`); the candidates
  // are the keys that match it there, `total` of them, and k is the rank
  // sought among them
  uint32_t key = all, ge = 0xFFFFFFFFu;
  if (all != any) {
    const int hb = 31 - __clz(all ^ any);  // the highest bit the keys differ in
    ge = ~(0xFFFFFFFFu >> (31 - hb));
    key &= ge;
    int total = b;
    for (int bit = hb; bit >= 0 && total > 1; --bit) {
      const uint32_t gb = ge | (1u << bit);
      int below = 0;  // candidates with a 0 at `bit`
#pragma unroll
      for (int s = 0; s < slots; ++s) {
        const int r = (s << 5) + lane;
        const uint32_t v = S > 0 ? reg[S > 0 ? s : 0] : (r < b ? row_key(zs, w, r) : 0u);
        below += __popc(__ballot_sync(0xFFFFFFFFu, r < b && (v & gb) == key));
      }
      if (k >= below) {
        k -= below;
        key |= 1u << bit;
        total -= below;
      } else {
        total = below;
      }
      ge = gb;
    }
  }
  // the k-th candidate in row order: one left, or the keys equal to `key`
#pragma unroll
  for (int s = 0; s < slots; ++s) {
    const int r = (s << 5) + lane;
    const uint32_t v = S > 0 ? reg[S > 0 ? s : 0] : (r < b ? row_key(zs, w, r) : 0u);
    const bool eq = r < b && (v & ge) == key;
    const unsigned m = __ballot_sync(0xFFFFFFFFu, eq);
    const int cnt = __popc(m);
    if (k < cnt) {
      const unsigned hit =
          __ballot_sync(0xFFFFFFFFu, eq && __popc(m & ((1u << lane) - 1u)) == k);
      return (s << 5) + __ffs(hit) - 1;
    }
    k -= cnt;
  }
  return 0;  // not reached: k < b
}

// (s, k) beats (best, at): a larger value, or the same at a lower index.
__device__ __forceinline__ bool beats(float s, int k, float best, int at) {
  return s > best || (s == best && k < at);
}

// The first index of the largest of the counts v[0 .. c), for a whole
// warp (every lane gets both).
__device__ __forceinline__ void warp_argmax(const int* v, int c, int lane, int& best, int& at) {
  best = -1;
  at = c;
  for (int k = lane; k < c; k += 32)
    if (v[k] > best) {
      best = v[k];
      at = k;
    }
  for (int o = 16; o > 0; o >>= 1) {
    const int ob = __shfl_xor_sync(0xFFFFFFFFu, best, o);
    const int oa = __shfl_xor_sync(0xFFFFFFFFu, at, o);
    if (ob > best || (ob == best && oa < at)) {
      best = ob;
      at = oa;
    }
  }
}

__global__ void __launch_bounds__(kThreads) forest_fit_kernel(const Args a, const Plan pl) {
  extern __shared__ float4 smem4[];
  __shared__ float s_part[kWarps];
  __shared__ int s_cls[kWarps];
  __shared__ int s_major;
  __shared__ uint32_t s_key[4];  // kp, kt
  const int b = a.b, f = a.f, c = a.c;
  const int n = (1 << a.depth) - 1, leaves = n + 1, tn = a.trees * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = blockIdx.x / a.trees, tree = blockIdx.x - part * a.trees;
  const int m0 = tree * n;
  const float* X = a.X + static_cast<size_t>(part) * b * f;
  const int* y = a.y + static_cast<size_t>(part) * b;
  const float* w = a.w + static_cast<size_t>(part) * b;
  float* pp = a.proj + static_cast<size_t>(part) * f * tn;
  float* tp = a.thresh + static_cast<size_t>(part) * tn + m0;  // this tree's thresholds
  int* lp = a.leaf_class + static_cast<size_t>(blockIdx.x) * leaves;
  float* gw = a.gwork != nullptr ? a.gwork + static_cast<size_t>(blockIdx.x) * pl.work_words
                                 : nullptr;

  float* sp = reinterpret_cast<float*>(smem4);
  int* cnt = nullptr;  // [leaves][C] then the batch's [C]
  int* ids = nullptr;    // the row rule: leaf ids [B], then counts [B]
  float* rc = nullptr;
  if (pl.counters) {
    cnt = reinterpret_cast<int*>(sp);
    sp += static_cast<size_t>(leaves + 1) * c;
  } else {
    float* base = pl.ids_global ? gw : sp;
    ids = reinterpret_cast<int*>(base);
    rc = base + b;
    if (pl.ids_global) gw += 2 * static_cast<size_t>(b); else sp += 2 * static_cast<size_t>(b);
  }
  float* ths = tp;
  if (pl.th_staged) {
    ths = sp;
    sp += n;
  }
  float* cs = nullptr;
  if (pl.cols_staged) {
    cs = sp;
    sp += static_cast<size_t>(n) * f;
  }
  float* xs = nullptr;
  if (pl.x_staged) {
    xs = sp;
    sp += static_cast<size_t>(b) * f;
  }
  float* zb = pl.z_global ? gw : sp;  // z of a chunk of columns [cn][B]

  // the fit key's two halves, split once by warp 0 (every lane of a warp
  // issues a split as one instruction stream, so the other warps would
  // only repeat it)
  if (warp == 0) {
    const threefry::Pair half = threefry::split({a.keys[2 * part], a.keys[2 * part + 1]},
                                                static_cast<uint32_t>(lane & 1));
    if (lane < 2) {
      s_key[2 * lane] = half.a;
      s_key[2 * lane + 1] = half.b;
    }
  }

  // 1. zero the counters, stage the rows, sum the weights, draw the
  // tree's columns of proj
  if (pl.counters)
    for (int i = tid; i < (leaves + 1) * c; i += kThreads) cnt[i] = 0;
  if (pl.x_staged)
    for (int i = tid; i < b * f; i += kThreads) xs[i] = X[i];
  float s = 0.0f;
  for (int r = tid; r < b; r += kThreads) s += w[r];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
  if (lane == 0) s_part[warp] = s;
  __syncthreads();
  const threefry::Pair kp{s_key[0], s_key[1]}, kt{s_key[2], s_key[3]};
  for (int i = tid; i < n * f; i += kThreads) {
    const int j = i / n, mm = i - j * n;
    const size_t at = static_cast<size_t>(j) * tn + m0 + mm;
    const float v = threefry::normal(kp, at, a.factor);
    pp[at] = v;
    if (cs != nullptr) cs[mm * f + j] = v;
  }
  __syncthreads();
  if (xs != nullptr) X = xs;
  // column mm of this tree: element j at cols[mm·sm + j·sj]
  const float* cols = cs != nullptr ? cs : pp + m0;
  const int sm = cs != nullptr ? f : 1, sj = cs != nullptr ? 1 : tn;
  float total = 0.0f;
  for (int k = 0; k < kWarps; ++k) total += s_part[k];
  const float nv = fmaxf(total, 1.0f);

  // 2-3. the thresholds, a chunk of columns a round: z of the chunk's
  // columns [cn][B] — a thread projects a row onto up to kCols columns at
  // once, each chain forest.cuh's, so a feature read serves kCols
  // products — then a warp a column
  for (int c0 = 0; c0 < n; c0 += pl.chunk) {
    const int cn = min(pl.chunk, n - c0);
    const int groups = (cn + kCols - 1) / kCols;
    for (int i = tid; i < groups * b; i += kThreads) {
      const int g = i / b, r = i - g * b;
      const int m1 = c0 + g * kCols, mc = min(kCols, c0 + cn - m1);
      const float* xr = X + static_cast<size_t>(r) * f;
      float acc[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
      for (int j = 0; j < f; ++j) {
        const float xj = xr[j];
        const float* cj = cols + static_cast<size_t>(m1) * sm + static_cast<size_t>(j) * sj;
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          if (q < mc)
            acc[q] = forest::add_rn(acc[q], forest::mul_rn(xj, cj[static_cast<size_t>(q) * sm]));
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        if (q < mc) zb[static_cast<size_t>(m1 - c0 + q) * b + r] = acc[q];
    }
    __syncthreads();
    for (int mm = warp; mm < cn; mm += kWarps) {
      const int m = c0 + mm;
      const float u = threefry::uniform(kt, m0 + m, 0.1f, 0.9f);
      const int k = min(max(__float2int_rz(forest::mul_rn(u, nv)), 0), b - 1);
      const float* zs = zb + static_cast<size_t>(mm) * b;
      const int r = b <= 32 * kSlots ? select_row<kSlots>(zs, w, b, k, lane)
                                     : select_row<0>(zs, w, b, k, lane);
      if (lane == 0) {
        const float th = w[r] > 0.0f ? zs[r] : CUDART_INF_F;
        tp[m] = th;
        if (pl.th_staged) ths[m] = th;
      }
    }
    __syncthreads();
  }

  // 4. every row to its leaf; its weight to its (leaf, label) and label
  // counters — the rows of a warp with one (leaf, label) added at once by
  // their lowest lane (a batch of one class would otherwise serialise on
  // one counter) — or its leaf id for the row rule
  for (int r0 = warp * 32; r0 < b; r0 += kThreads) {
    const int r = r0 + lane;
    int leaf = 0;
    if (r < b) {
      const float* xr = X + static_cast<size_t>(r) * f;
      int node = 0;
      for (int d = 0; d < a.depth; ++d) {
        const float z = pl.chunk == n ? zb[static_cast<size_t>(node) * b + r]
                                      : forest::project(xr, 1, cols, f, node, sm, sj);
        node = 2 * node + 1 + (forest::gt(z, ths[node]) ? 1 : 0);
      }
      leaf = node - n;
    }
    if (pl.counters) {
      const int cls = r < b ? y[r] : -1;
      const bool ok = r < b && cls >= 0 && cls < c && w[r] != 0.0f;
      const unsigned same_leaf = __match_any_sync(0xFFFFFFFFu, ok ? leaf * c + cls : -1);
      const unsigned same_cls = __match_any_sync(0xFFFFFFFFu, ok ? cls : -1);
      if (ok && lane == __ffs(same_leaf) - 1)
        atomicAdd(cnt + static_cast<size_t>(leaf) * c + cls, __popc(same_leaf));
      if (ok && lane == __ffs(same_cls) - 1)
        atomicAdd(cnt + static_cast<size_t>(leaves) * c + cls, __popc(same_cls));
    } else if (r < b) {
      ids[r] = leaf;
    }
  }
  __syncthreads();

  // 5. the leaf classes
  if (pl.counters) {
    int best, major;
    warp_argmax(cnt + static_cast<size_t>(leaves) * c, c, lane, best, major);
    for (int l = warp; l < leaves; l += kWarps) {
      int at;
      warp_argmax(cnt + static_cast<size_t>(l) * c, c, lane, best, at);
      if (lane == 0) lp[l] = best > 0 ? at : major;
    }
    return;
  }
  // the row rule: per row, the weight of its label in its leaf (-1 for a
  // label of no class) and in the batch; the batch's majority
  float best = -2.0f;
  int best_c = 0x7FFFFFFF;
  for (int r = tid; r < b; r += kThreads) {
    const int lf = ids[r], cls = y[r];
    float sl = -1.0f, sb = -1.0f;
    if (cls >= 0 && cls < c) {
      sl = sb = 0.0f;
      for (int q = 0; q < b; ++q)
        if (y[q] == cls) {
          sb += w[q];
          if (ids[q] == lf) sl += w[q];
        }
    }
    rc[r] = sl;
    if (beats(sb, cls, best, best_c)) {
      best = sb;
      best_c = cls;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xFFFFFFFFu, best, o);
    const int oc = __shfl_xor_sync(0xFFFFFFFFu, best_c, o);
    if (beats(ob, oc, best, best_c)) {
      best = ob;
      best_c = oc;
    }
  }
  if (lane == 0) {
    s_part[warp] = best;
    s_cls[warp] = best_c;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kWarps; ++k)
      if (beats(s_part[k], s_cls[k], best, best_c)) {
        best = s_part[k];
        best_c = s_cls[k];
      }
    s_major = best > 0.0f ? best_c : 0;  // no weight: jnp.argmax of zeros
  }
  __syncthreads();
  for (int l = tid; l < leaves; l += kThreads) lp[l] = s_major;
  __syncthreads();
  // the row of largest (count, −label, −row) in each leaf writes its class
  for (int r = tid; r < b; r += kThreads) {
    const float sr = rc[r];
    if (!(sr > 0.0f)) continue;
    const int lf = ids[r], cls = y[r];
    bool top = true;
    for (int q = 0; q < b && top; ++q) {
      if (q == r || ids[q] != lf) continue;
      const float sq = rc[q];
      const int cq = y[q];
      top = !(sq > sr || (sq == sr && (cq < cls || (cq == cls && q < r))));
    }
    if (top) lp[lf] = cls;
  }
}

// An empty kernel: launched with K11's grid, block and shared memory, its
// time is the floor under K11's.
__global__ void forest_fit_floor_kernel() {}

// The layout at a shape: in shared memory, in this order and each where
// it fits beside the ones before — the counters (else the row rule's ids
// and counts), the thresholds, the tree's columns, the rows, then the
// z of as many columns as fit (at least one, else a chunk of kWarps
// columns in the global workspace).
bool layout(int b, int f, int c, int trees, int depth, int force, Plan& pl) {
  if (b < 1 || f < 1 || c < 1 || trees < 1 || depth < 1 || depth > 16) return false;
  const long long n = (1LL << depth) - 1, leaves = n + 1, tn = trees * n;
  if (tn * f > INT32_MAX || tn * b > INT32_MAX || static_cast<long long>(b) * f > INT32_MAX ||
      (leaves + 1) * c > INT32_MAX)
    return false;
  pl = Plan{};
  const long long budget = static_cast<long long>(kMaxSmem - kStaticSmem);
  const bool global = force & kForceGlobal;
  long long smem = 0;
  auto fits = [&](long long bytes) { return !global && smem + bytes <= budget; };
  const long long counters = 4 * (leaves + 1) * c;
  pl.counters = !(force & kForceRowRule) && smem + counters <= budget;
  if (pl.counters) {
    smem += counters;
  } else {
    pl.ids_global = !fits(8LL * b);
    if (!pl.ids_global) smem += 8LL * b;
  }
  if ((pl.th_staged = fits(4 * n))) smem += 4 * n;
  if ((pl.cols_staged = fits(4 * n * f))) smem += 4 * n * f;
  if ((pl.x_staged = fits(4LL * b * f))) smem += 4LL * b * f;
  const long long chunk = global ? 0 : (budget - smem) / (4LL * b);
  pl.z_global = chunk < 1;
  pl.chunk = static_cast<int>(pl.z_global ? (n < kWarps ? n : kWarps) : (chunk < n ? chunk : n));
  if (!pl.z_global) smem += 4LL * pl.chunk * b;
  pl.smem = static_cast<int>(smem);
  pl.work_words = (pl.ids_global ? 2LL * b : 0) + (pl.z_global ? static_cast<long long>(pl.chunk) * b : 0);
  return true;
}

std::atomic<int> g_raised[kMaxDevices];
std::atomic<int> g_floor_raised[kMaxDevices];

// Above 48 KB, raise `kernel`'s limit once per (device, size).
cudaError_t allow_shared(int smem, const void* kernel, std::atomic<int>* raised) {
  if (static_cast<size_t>(smem) <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > raised[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    raised[dev].store(smem, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

}  // namespace

// K11's layout at a shape, into out[0..8]: counters, ids global,
// thresholds staged, columns staged, rows staged, z global, columns a
// chunk, shared bytes, and the floats of a partition's global workspace
// (trees × a CTA's; 0 when none) — models/forest.py `k11_plan`.
extern "C" int forest_fit_plan(int b, int f, int c, int trees, int depth, int force,
                               long long* out) {
  Plan pl;
  if (!layout(b, f, c, trees, depth, force, pl)) return static_cast<int>(cudaErrorInvalidValue);
  const long long vals[9] = {pl.counters,  pl.ids_global, pl.th_staged,
                             pl.cols_staged, pl.x_staged,  pl.z_global,
                             pl.chunk,     pl.smem,       pl.work_words * trees};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// `gwork` is null when the plan has no global workspace, else P × its
// floats a partition (`forest_fit_plan`). Returns a CUDA error code (0 on
// a clean launch).
extern "C" int forest_fit_launch(const int* keys, const float* X, const int* y, const float* w,
                                 int p, int b, int f, int c, int trees, int depth, float factor,
                                 int force, float* proj, float* thresh, int* leaf_class,
                                 float* gwork, void* stream) {
  if (p == 0) return 0;
  Plan pl;
  if (!layout(b, f, c, trees, depth, force, pl) ||
      static_cast<long long>(p) * trees > INT32_MAX || (pl.work_words > 0) != (gwork != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      allow_shared(pl.smem, reinterpret_cast<const void*>(forest_fit_kernel), g_raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args args{reinterpret_cast<const uint32_t*>(keys), X, y, w, b, f, c, trees, depth,
                  factor, proj, thresh, leaf_class, gwork};
  forest_fit_kernel<<<p * trees, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(args, pl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int forest_fit_floor_launch(int p, int b, int f, int c, int trees, int depth,
                                       void* stream) {
  if (p == 0) return 0;
  Plan pl;
  if (!layout(b, f, c, trees, depth, 0, pl)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      allow_shared(pl.smem, reinterpret_cast<const void*>(forest_fit_floor_kernel), g_floor_raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  forest_fit_floor_kernel<<<p * trees, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
