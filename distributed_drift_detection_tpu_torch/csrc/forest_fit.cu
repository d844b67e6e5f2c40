// K11 — the oblique forest's fit from its key, one CTA a partition.
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
//    jnp.sort's keys, the invalid rows (w = 0) as +inf — by a rank count:
//    a thread per (row, node) counts the rows before it in that order,
//    and the row whose rank is idx[m] writes its value;
// 4. each row walks each tree to its leaf;
// 5. per (tree, row), the weight of the rows of its label in its leaf,
//    summed in row order; the row whose (count, −label, −row) is largest
//    in its leaf writes the leaf's class when its count is positive; every
//    other leaf keeps the batch's majority class (the first class of
//    largest weight, summed in row order).
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
// compares a (row, node) (156,800: what a sort of each column takes), and
// 16,000 for the routing, the leaf counts and the batch's class counts —
// 1.30 M, 20.8 M over 16 partitions: 0.31 us at 67 TFLOP/s. This design
// does more than that: its rank count compares B² keys a node (2.22 M a
// partition) and its leaf counts B² rows a tree (0.64 M), for the sake of
// flat loops. What bounds it is latency: one CTA a partition
// on 16 of 132 SMs, each phase a chain of dependent shared loads. The
// design keeps each phase a flat loop over independent items for 512
// threads, the partition's z, its sort keys, leaf ids, idx, w and y in
// shared memory (193 KB at the main path's shapes), or in a global
// workspace when they do not fit (`work_words`): the kernel's code reads
// them through one pointer either way.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "forest.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on an H100
constexpr int kMaxDevices = 64;

// The static shared memory beside the workspace, kept free of it.
constexpr size_t kStaticSmem = 1024;

// Words of a partition's workspace: z [B][T·n] f32, the sort keys of z
// [B][T·n] i32 (then the per-(row, tree) counts), leaf ids [B][T] i32,
// idx [T·n] i32, w [B] f32, y [B] i32.
__host__ __device__ inline size_t work_words(int b, int trees, int n) {
  const size_t tn = static_cast<size_t>(trees) * n;
  return 2 * static_cast<size_t>(b) * tn + static_cast<size_t>(b) * trees + tn + 2 * b;
}

__global__ void __launch_bounds__(kThreads)
    forest_fit_kernel(const uint32_t* __restrict__ keys, const float* __restrict__ X,
                      const int* __restrict__ y, const float* __restrict__ w, int b, int f,
                      int c, int trees, int depth, float factor, float* proj, float* thresh,
                      int* __restrict__ leaf_class, float* gwork) {
  extern __shared__ float smem[];
  __shared__ float s_nv;
  __shared__ float s_best[kWarps];
  __shared__ int s_cls[kWarps];
  const int n = (1 << depth) - 1, leaves = n + 1, tn = trees * n;
  const int tid = threadIdx.x;
  const size_t part = blockIdx.x;
  float* z = gwork != nullptr ? gwork + part * work_words(b, trees, n) : smem;
  int* zkey = reinterpret_cast<int*>(z + static_cast<size_t>(b) * tn);
  int* leaf = zkey + static_cast<size_t>(b) * tn;
  int* idx = leaf + static_cast<size_t>(b) * trees;
  float* wv = reinterpret_cast<float*>(idx + tn);
  int* yv = reinterpret_cast<int*>(wv + b);
  const float* Xp = X + part * b * f;
  float* pp = proj + part * f * tn;
  float* tp = thresh + part * tn;
  int* lp = leaf_class + part * trees * leaves;

  const threefry::Pair key{keys[2 * part], keys[2 * part + 1]};
  const threefry::Pair kp = threefry::split(key, 0u), kt = threefry::split(key, 1u);

  // 1. the normals, the rows' weights and labels, nv
  for (int i = tid; i < f * tn; i += kThreads) pp[i] = threefry::normal(kp, i, factor);
  for (int r = tid; r < b; r += kThreads) {
    wv[r] = w[part * b + r];
    yv[r] = y[part * b + r];
  }
  if (tid == 0) {
    float s = 0.0f;
    for (int r = 0; r < b; ++r) s = forest::add_rn(s, w[part * b + r]);
    s_nv = fmaxf(s, 1.0f);
  }
  __syncthreads();
  // the order statistic each threshold takes, and z
  for (int m = tid; m < tn; m += kThreads) {
    const float u = threefry::uniform(kt, m, 0.1f, 0.9f);
    idx[m] = min(max(__float2int_rz(forest::mul_rn(u, s_nv)), 0), b - 1);
  }
  const int inf_key = forest::sort_key(CUDART_INF_F);
  for (int i = tid; i < b * tn; i += kThreads) {
    const int r = i / tn;
    const float v = forest::project(Xp + static_cast<size_t>(r) * f, 1, pp, f, i - r * tn, 1, tn);
    z[i] = v;
    zkey[i] = wv[r] > 0.0f ? forest::sort_key(v) : inf_key;  // invalid rows as +inf
  }
  __syncthreads();

  // 3. the thresholds: thread (r, m) ranks row r in column m — the rows
  // before it in the stable order: those above r with a smaller key, and
  // those below r with a key no larger
  for (int i = tid; i < b * tn; i += kThreads) {
    const int r = i / tn, m = i - r * tn;
    const int k = zkey[i];
    int rank = 0;
    for (int q = 0; q < r; ++q) rank += zkey[q * tn + m] <= k;
    for (int q = r + 1; q < b; ++q) rank += zkey[q * tn + m] < k;
    if (rank == idx[m]) tp[m] = wv[r] > 0.0f ? z[i] : CUDART_INF_F;
  }
  __syncthreads();

  // 4. every row to its leaf in every tree; the batch's majority class
  for (int i = tid; i < b * trees; i += kThreads) {
    const int r = i / trees, t = i - r * trees;
    const float* zr = z + static_cast<size_t>(r) * tn + t * n;
    const float* th = tp + t * n;
    int node = 0;
    for (int d = 0; d < depth; ++d) node = 2 * node + 1 + (forest::gt(zr[node], th[node]) ? 1 : 0);
    leaf[i] = node - n;
  }
  float best = -1.0f;
  int best_c = 0;
  for (int k = tid; k < c; k += kThreads) {  // classes in order: the first max stays
    float s = 0.0f;
    for (int r = 0; r < b; ++r)
      if (yv[r] == k) s = forest::add_rn(s, wv[r]);
    if (s > best) {
      best = s;
      best_c = k;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, o);
    const int oc = __shfl_down_sync(0xffffffffu, best_c, o);
    if (ob > best || (ob == best && oc < best_c)) {
      best = ob;
      best_c = oc;
    }
  }
  if ((tid & 31) == 0) {
    s_best[tid >> 5] = best;
    s_cls[tid >> 5] = best_c;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kWarps; ++k)
      if (s_best[k] > best || (s_best[k] == best && s_cls[k] < best_c)) {
        best = s_best[k];
        best_c = s_cls[k];
      }
    s_cls[0] = best_c;
  }
  __syncthreads();

  // 5. every leaf the batch majority; per (row, tree) the weight of its
  // label in its leaf (-1 for a label of no class), in the keys' place
  float* cnt = reinterpret_cast<float*>(zkey);
  for (int i = tid; i < trees * leaves; i += kThreads) lp[i] = s_cls[0];
  for (int i = tid; i < b * trees; i += kThreads) {
    const int r = i / trees, t = i - r * trees;
    const int lf = leaf[i], cls = yv[r];
    float s = -1.0f;
    if (cls >= 0 && cls < c) {
      s = 0.0f;
      for (int q = 0; q < b; ++q)
        if (leaf[q * trees + t] == lf && yv[q] == cls) s = forest::add_rn(s, wv[q]);
    }
    cnt[i] = s;
  }
  __syncthreads();
  // the row of largest (count, −label, −row) in each leaf writes its class
  for (int i = tid; i < b * trees; i += kThreads) {
    const int r = i / trees, t = i - r * trees;
    const float s = cnt[i];
    if (!(s > 0.0f)) continue;
    const int lf = leaf[i], cls = yv[r];
    bool top = true;
    for (int q = 0; q < b && top; ++q) {
      if (q == r || leaf[q * trees + t] != lf) continue;
      const float sq = cnt[q * trees + t];
      const int cq = yv[q];
      top = !(sq > s || (sq == s && (cq < cls || (cq == cls && q < r))));
    }
    if (top) lp[t * leaves + lf] = cls;
  }
}

// An empty kernel: launched with K11's grid, block and shared memory, its
// time is the floor under K11's.
__global__ void forest_fit_floor_kernel() {}

std::atomic<int> g_raised[kMaxDevices];
std::atomic<int> g_floor_raised[kMaxDevices];

// Shared memory of a launch: the workspace when it fits (gwork null), else
// none; above 48 KB `kernel`'s limit is raised once per (device, size).
cudaError_t shared_bytes(int b, int trees, int n, bool global, const void* kernel,
                         std::atomic<int>* raised, size_t& smem) {
  smem = global ? 0 : 4 * work_words(b, trees, n);
  if (smem > kMaxSmem - kStaticSmem) return cudaErrorInvalidValue;
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (static_cast<int>(smem) > raised[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    raised[dev].store(static_cast<int>(smem), std::memory_order_relaxed);
  }
  return cudaSuccess;
}

}  // namespace

// K11 at a shape: the floats of a partition's global workspace, or 0 when
// the workspace fits the shared memory left beside the static (231,424 B),
// into *out (models/forest.py `forest_fit_scratch` sizes `gwork` from it).
extern "C" int forest_fit_workspace_words(int b, int trees, int depth, long long* out) {
  if (b < 1 || trees < 1 || depth < 1 || depth > 16) return static_cast<int>(cudaErrorInvalidValue);
  const size_t words = work_words(b, trees, (1 << depth) - 1);
  *out = 4 * words <= kMaxSmem - kStaticSmem ? 0 : static_cast<long long>(words);
  return 0;
}

// `gwork` is null when the workspace fits shared memory, else P ×
// work_words floats (`forest_fit_workspace_words`). Returns a CUDA error
// code (0 on a clean launch).
extern "C" int forest_fit_launch(const int* keys, const float* X, const int* y, const float* w,
                                 int p, int b, int f, int c, int trees, int depth, float factor,
                                 float* proj, float* thresh, int* leaf_class, float* gwork,
                                 void* stream) {
  if (p == 0) return 0;
  const long long tn = static_cast<long long>(trees) * ((1 << depth) - 1);
  if (b < 1 || f < 1 || trees < 1 || depth < 1 || depth > 16 || tn * b > INT32_MAX ||
      tn * f > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const cudaError_t e = shared_bytes(b, trees, (1 << depth) - 1, gwork != nullptr,
                                     reinterpret_cast<const void*>(forest_fit_kernel), g_raised,
                                     smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  forest_fit_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(keys), X, y, w, b, f, c, trees, depth, factor, proj,
      thresh, leaf_class, gwork);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int forest_fit_floor_launch(int p, int b, int trees, int depth, int global,
                                       void* stream) {
  if (p == 0) return 0;
  size_t smem = 0;
  const cudaError_t e = shared_bytes(b, trees, (1 << depth) - 1, global != 0,
                                     reinterpret_cast<const void*>(forest_fit_floor_kernel),
                                     g_floor_raised, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  forest_fit_floor_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
