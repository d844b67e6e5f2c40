// K7 — the nearest-centroid fit, bit for bit as XLA computes it on the CPU.
//
// Replaces the JAX package's models/classifiers.py `make_centroid.fit`
// (:92-98): onehot = one_hot(y)·w, counts = Σ onehot, sums = onehotᵀ @ X,
// cent = sums / max(counts, 1), bias = -0.5·Σ_f cent² (−inf for absent
// classes) — XLA-lowered there as an XLA dot plus a reduce, vmapped over
// partitions. Per partition, from its training batch X [B, F] f32, labels
// y [B] i32 and {0, 1} weights w [B] f32, it writes cent [C, F] and
// bias [C].
//
// Numerics (measured against XLA's CPU fit of jax 0.9.0 at B <= 384):
// XLA's `onehotᵀ @ X` is a float32 sum over the B rows in row order,
// starting from 0; each product onehot·w·x is exact (0 or x), so the kernel
// adds w·x for the rows of class c in row order with __fadd_rn and skips
// the others (adding a zero product to a sum that started at +0 never
// changes it). The counts are the same sum over an implicit column of
// ones. At B = 1 XLA's dot is the product itself, onehot·w·x with no +0
// start (a zero product keeps its sign), and so is this kernel's.
// `Σ_f cent²` is one fused multiply-add chain over the features in feature
// order from 0 (acc = fma(c_f, c_f, acc)), then × -0.5. Built with
// -fmad=false and -ftz=true, as the zoo kernels, so no other contraction
// happens and subnormal results flush as XLA's do; the plain version is
// models/classifiers.py `centroid_fit_reference`, step for step. cuBLAS's
// batched f32 GEMM and torch.cumsum do not sum in row order, which is why
// this is a kernel at all.
//
// Bound on an H100 at the main path's shapes (P = 16, B = 100, F = 21,
// C = 40): bytes — [P, B, F] f32 and two [P, B] vectors in (0.15 MB),
// [P, C, F] and [P, C] f32 out (0.06 MB), 0.06 us at 3.35 TB/s; the
// operations are fewer still. What really bounds it is latency: the
// launch, the load, the dependent chain of adds per (class, feature) sum
// — on the main path each partition's training batch is one class, so
// that chain is B adds long — and the F fused multiply-adds per bias.
// The design:
// * one CTA a partition; its [rows, F] block goes to shared memory
//   feature-major, with the weights, by 4-byte cp.async — issued first,
//   so the copies fly while the labels are sorted;
// * a stable class-sorted row list, kept as row bitmaps: for each class
//   and 32-row chunk, one word whose bit i marks row 32·chunk + i of the
//   class (a warp per class, a ballot of the label per chunk, one block
//   barrier). Read chunk by chunk, low bit first, a class's words list
//   its rows in row order;
// * a thread per (class, feature or count) pair walks only its class's
//   rows, eight at a time: two 16-byte loads of their weights and two of
//   its feature's row (the count pair's "feature" is a row of 1.0f), then
//   each add under its row's bit, so the add chain waits on no branch,
//   bit scan or address arithmetic. The class's count chain runs beside
//   the sum (the same adds in the same order as the count pair's), so the
//   thread divides at once; the accumulators stay in registers across row
//   tiles when the pairs fit one block, else in shared memory;
// * then one thread per class runs the bias chain from shared memory.
// Rows beyond one tile (kMaxTileRows) run tile by tile, each class chain
// carried over in row order. Classes whose sums do not fit shared memory
// even at the smallest tile (above 2,490 at F = 21) run in chunks of `cc`,
// in class order, each chunk over all the rows; with one chunk the path is
// the one-pass kernel's. The launcher asks the card nothing at the
// main path's shapes: the opt-in shared-memory limit is read once per
// device, and the kernel's limit raised once per (device, size), only for
// a launch above the 48 KB default. Measured on an H100 80GB HBM3 against
// this design (PERF.md §6, K7): an explicit row list with C + 1 offsets
// written by a second ballot pass, one warp ranking the rows by
// __match_any_sync, a bulk copy on an mbarrier, and walking a class's
// rows bit by bit with __ffs were all slower or no faster.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxTileRows = 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round32(int n) { return (n + 31) & ~31; }

// The stride of the feature-major row block: the tile's rows padded to
// whole 32-row chunks, + 4 words so that eight lanes' 16-byte loads of
// eight features' rows fall in distinct banks.
__host__ __device__ constexpr int xstride(int tile) { return round32(tile) + 4; }

// Shared memory, in 4-byte words: the row block feature-major, F + 1 rows
// of xstride(tile) (row F holds 1.0f, the count pair's "feature"), the
// tile's weights (padded to whole chunks), the per-pair sums and counts
// [C, F + 1] (column F holds the count), and per class its row bitmaps,
// a word for each 32-row chunk. The padding lets a chain read whole
// chunks unconditionally.
__host__ __device__ constexpr size_t smem_words(int f, int c, int tile) {
  return static_cast<size_t>(f + 1) * xstride(tile) + round32(tile) +
         static_cast<size_t>(c) * (f + 1) + static_cast<size_t>(c) * ((tile + 31) / 32);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// The tile's rows [rows, F] from src into xt feature-major (xt[j·ld + r]),
// and its weights to ws, by 4-byte cp.async (coalesced on the global
// side). Every thread waits for its own copies.
__device__ __forceinline__ void async_load(float* xt, int ld, const float* src, int rows,
                                           int f, const float* wsrc, float* ws) {
  for (int i = threadIdx.x; i < rows * f; i += blockDim.x) {
    const int r = i / f;
    cp_async4(xt + (i - r * f) * ld + r, src + i);
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) cp_async4(ws + i, wsrc + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The tile's stable class-sorted row list, as row bitmaps: bit i of
// rows_of[k·chunks + ch] marks row 32·ch + i as one of class k0 + k's, for
// the cn classes from k0. A warp per class, a ballot of the label per
// chunk; labels outside [0, C) enter no class.
__device__ __forceinline__ void class_rows(const int* __restrict__ yt, int rows, int k0, int cn,
                                           unsigned* __restrict__ rows_of) {
  const int lane = threadIdx.x & 31;
  const int chunks = (rows + 31) >> 5;
  for (int k = threadIdx.x >> 5; k < cn; k += blockDim.x >> 5) {
#pragma unroll 4
    for (int ch = 0; ch < chunks; ++ch) {
      const int r = 32 * ch + lane;
      const unsigned m = __ballot_sync(kFull, r < rows && yt[r] == k0 + k);
      if (lane == 0) rows_of[k * chunks + ch] = m;
    }
  }
}

// Pair (k, j) over this tile's rows: adds w·x of class k0 + k's rows in
// row order into `a` and their weights into `n`, where x is row j of the
// feature-major block xt — feature j, or for the count pair j == F the
// row of 1.0f (w·1 = w exactly), so both kinds of pair run the same code.
// At B = 1, XLA's product instead (module note).
__device__ __forceinline__ void chain(int k, int k0, const float* xj, int b, int rows,
                                      const float* ws, const int* yt,
                                      const unsigned* rows_of, float& a, float& n) {
  if (b == 1) {
    const float oh = __fmul_rn(yt[0] == k0 + k ? 1.0f : 0.0f, ws[0]);
    a = __fmul_rn(oh, xj[0]);
    n = oh;
    return;
  }
  const int chunks = (rows + 31) >> 5;
  for (int ch = 0; ch < chunks; ++ch) {
    const unsigned m = rows_of[k * chunks + ch];
    // the chunk's rows in order, eight at a time: four 16-byte loads first,
    // unconditionally (the padding keeps them in bounds), then each add
    // under its row's bit, so the add chain waits on no branch, bit scan
    // or address arithmetic
    for (int i0 = 0; i0 < 32; i0 += 8) {
      const unsigned byte = (m >> i0) & 0xffu;
      if (byte == 0) continue;
      const float4* w4 = reinterpret_cast<const float4*>(ws + 32 * ch + i0);
      const float4* x4 = reinterpret_cast<const float4*>(xj + 32 * ch + i0);
      const float4 wa = w4[0], wb = w4[1], xa = x4[0], xb = x4[1];
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if ((byte >> i) & 1u) {
          a = __fadd_rn(a, __fmul_rn(wv[i], xv[i]));
          n = __fadd_rn(n, wv[i]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    centroid_fit_kernel(const float* __restrict__ X, const int* __restrict__ y,
                        const float* __restrict__ w, int b, int f, int c, int tile, int cc,
                        float* __restrict__ cent, float* __restrict__ bias) {
  extern __shared__ __align__(16) float xt[];
  const int ld = xstride(tile);
  float* ws = xt + (f + 1) * ld;
  float* acc = ws + round32(tile);
  unsigned* rows_of = reinterpret_cast<unsigned*>(acc + cc * (f + 1));

  const int tid = threadIdx.x;
  const int f1 = f + 1;
  const size_t part = blockIdx.x;
  const float* Xp = X + part * b * f;
  const int* yp = y + part * b;
  const float* wp = w + part * b;

  for (int r = tid; r < ld; r += blockDim.x) xt[f * ld + r] = 1.0f;
  for (int k0 = 0; k0 < c; k0 += cc) {  // a chunk of classes at a time
    const int cn = min(cc, c - k0);
    const int pairs = cn * f1;
    const bool in_regs = pairs <= static_cast<int>(blockDim.x);
    if (!in_regs)
      for (int i = tid; i < pairs; i += blockDim.x) acc[i] = 0.0f;
    float a = 0.0f, n = 0.0f;  // pair tid's sum and count, when in_regs

    for (int t0 = 0; t0 < b; t0 += tile) {
      const int rows = min(tile, b - t0);
      async_load(xt, ld, Xp + static_cast<size_t>(t0) * f, rows, f, wp + t0, ws);
      const int* yt = yp + t0;
      class_rows(yt, rows, k0, cn, rows_of);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (in_regs) {
        if (tid < pairs)
          chain(tid / f1, k0, xt + (tid % f1) * ld, b, rows, ws, yt, rows_of, a, n);
      } else {
        for (int i = tid; i < pairs; i += blockDim.x) {
          float ai = acc[i], ni = 0.0f;
          chain(i / f1, k0, xt + (i % f1) * ld, b, rows, ws, yt, rows_of, ai, ni);
          acc[i] = ai;
        }
      }
      // the next tile overwrites the rows; the division below reads the counts
      if (t0 + tile < b || !in_regs) __syncthreads();
    }

    // cent = sums / max(counts, 1), kept in acc for the bias (counts stay
    // in column F)
    for (int i = tid; i < pairs; i += blockDim.x) {
      const int k = i / f1;
      const int j = i - k * f1;
      const float s = in_regs ? a : acc[i];
      if (j < f) {
        const float v = __fdiv_rn(s, fmaxf(in_regs ? n : acc[k * f1 + f], 1.0f));
        acc[i] = v;
        cent[(part * c + k0 + k) * f + j] = v;
      } else if (in_regs) {
        acc[i] = s;
      }
    }
    __syncthreads();

    for (int k = tid; k < cn; k += blockDim.x) {
      const float* row = acc + k * f1;
      float s = 0.0f;
      for (int j = 0; j < f; ++j) s = __fmaf_rn(row[j], row[j], s);
      bias[part * c + k0 + k] = row[f] > 0.0f ? __fmul_rn(-0.5f, s) : -CUDART_INF_F;
    }
    if (k0 + cc < c) __syncthreads();  // the next chunk rewrites the rows and sums
  }
}

// An empty kernel: launched with K7's grid, block and shared memory, its
// time is the floor under K7's.
__global__ void centroid_fit_floor_kernel() {}

struct Config {
  int tile;
  int cc;  // classes a chunk
  int threads;
  size_t smem;
};

std::atomic<int> g_optin[kMaxDevices];  // 0: not read yet

// A thread per (class, feature or count) pair of a chunk, at most 1024.
void set_threads(int f, Config& cfg) {
  const int pairs = cfg.cc * (f + 1);
  cfg.threads = pairs < 32 ? 32 : (pairs > kMaxThreads ? kMaxThreads : (pairs + 31) / 32 * 32);
}

// K7's launch for P partitions of B rows: the largest row tile (at most
// kMaxTileRows) whose shared memory fits the card with every class; else
// classes in chunks — the largest chunk that fits beside the largest tile
// that holds one class — and a thread per pair of a chunk (at most a
// block's 1024); above 48 KB, `kernel`'s limit is raised once per (device,
// size) (`raised` holds the largest size set per device).
cudaError_t configure(int b, int f, int c, const void* kernel, std::atomic<int>* raised,
                      Config& cfg) {
  cfg.cc = c;
  cfg.tile = b < 1 ? 1 : (b > kMaxTileRows ? kMaxTileRows : b);
  cfg.smem = 4 * smem_words(f, c, cfg.tile);
  if (cfg.smem <= kDefaultSmem) {
    set_threads(f, cfg);
    return cudaSuccess;
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int optin = g_optin[dev].load(std::memory_order_relaxed);
  if (optin == 0) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    g_optin[dev].store(optin, std::memory_order_relaxed);
  }
  while (cfg.tile > 1 && 4 * smem_words(f, c, cfg.tile) > static_cast<size_t>(optin))
    cfg.tile /= 2;
  if (4 * smem_words(f, c, cfg.tile) > static_cast<size_t>(optin)) {
    // classes in chunks: each class costs F + 1 sums and a bitmap word a
    // 32-row chunk beside the tile's rows and weights
    cfg.tile = b < 1 ? 1 : (b > kMaxTileRows ? kMaxTileRows : b);
    for (;;) {
      const size_t fixed = smem_words(f, 0, cfg.tile);
      const size_t per_class = smem_words(f, 1, cfg.tile) - fixed;
      if (4 * (fixed + per_class) <= static_cast<size_t>(optin)) {
        const size_t fit = (static_cast<size_t>(optin) / 4 - fixed) / per_class;
        cfg.cc = fit < static_cast<size_t>(c) ? static_cast<int>(fit) : c;
        break;
      }
      if (cfg.tile == 1) return cudaErrorInvalidValue;
      cfg.tile /= 2;
    }
  }
  set_threads(f, cfg);
  cfg.smem = 4 * smem_words(f, cfg.cc, cfg.tile);
  if (cfg.smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  if (cfg.smem > kDefaultSmem &&
      static_cast<int>(cfg.smem) > raised[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(cfg.smem));
    if (e != cudaSuccess) return e;
    raised[dev].store(static_cast<int>(cfg.smem), std::memory_order_relaxed);
  }
  return cudaSuccess;
}

std::atomic<int> g_raised[kMaxDevices];
std::atomic<int> g_floor_raised[kMaxDevices];

}  // namespace

extern "C" int centroid_fit_launch(const float* X, const int* y, const float* w, int p,
                                   int b, int f, int c, float* cent, float* bias,
                                   void* stream) {
  if (p == 0) return 0;
  Config cfg;
  const cudaError_t e = configure(b, f, c, reinterpret_cast<const void*>(centroid_fit_kernel),
                                  g_raised, cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  centroid_fit_kernel<<<p, cfg.threads, cfg.smem, static_cast<cudaStream_t>(stream)>>>(
      X, y, w, b, f, c, cfg.tile, cfg.cc, cent, bias);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int centroid_fit_floor_launch(int p, int b, int f, int c, void* stream) {
  if (p == 0) return 0;
  Config cfg;
  const cudaError_t e = configure(
      b, f, c, reinterpret_cast<const void*>(centroid_fit_floor_kernel), g_floor_raised, cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  centroid_fit_floor_kernel<<<p, cfg.threads, cfg.smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
