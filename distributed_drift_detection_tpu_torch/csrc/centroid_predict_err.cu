// K2 — nearest-centroid predict fused with the error indicator.
//
// Replaces the JAX package's models/classifiers.py `make_centroid.predict`
// (scores = X @ centroids.T + bias, argmax) together with engine/window.py's
// gather `base_X[idx]` and `(preds != y)` — XLA-lowered there as a gather,
// a [W·B, F] x [F, C] matmul, an argmax and a compare. For each row it
// gathers the features from the row table through its index, takes C dot
// products against its partition's centroids, keeps the first maximum
// (strict `>` in class order, so a row whose scores are all -inf — the bias
// of absent classes — predicts class 0, like jnp.argmax), and writes
// err = (pred != label) as f32. Neither the gathered [P·W·B, F] rows nor the
// [P·W·B, C] score plane ever reach device memory.
//
// Bound on an H100 at the main path's shapes (P=16 partitions, W·B=12800
// rows each, F=21, C=40): 2·F·C = 1680 f32 operations per row, 0.34 GFLOP
// per level — about 5 us at the 67 TFLOP/s f32 rate outside the tensor
// cores — against 0.4 MB of int16 indices read and 0.8 MB of errors
// written (0.4 us at 3.35 TB/s). So it is bound by f32 FMAs; the gathered
// rows themselves, 96 B each, are about 20 MB of L2 traffic a launch
// (each table row is used ~50 times), some 4 us of L2 bandwidth. The
// design keeps the FMA units fed and the gather coalesced:
//
// * a register-tiled gather-GEMV: each thread holds the features of kRows
//   rows in registers (the kernel is templated on F: its float4 count up
//   to 8, i.e. F <= 32, and the real features of the last one — beyond
//   that a generic loop takes the row from L1), and the partition's [C, F]
//   centroids sit in shared memory, padded to a multiple of 4, read as
//   float4 broadcast loads (every lane the same address): one shared load
//   feeds 4·kRows FMAs, where a thread that kept one row in shared memory
//   spent two loads per FMA; two classes are in flight at once, so a
//   thread has 2·kRows independent FMA chains;
// * rows are gathered with 16-byte cp.async copies from a copy of the row
//   table whose row stride is F rounded up to 4, zero-filled (built once
//   per run by `models.base.pad_row_table`), neighbouring threads on one
//   row, into shared memory and from there into registers;
// * each block covers kRows·kThreads rows of one partition and stages the
//   centroids once for them. (The broadcast shared loads cost one
//   wavefront a value for the warp, so kRows rows a thread is what keeps
//   them below the FMA rate.) Classes beyond what fits shared memory
//   beside the rows (2,058 at F = 21) are staged in chunks of `cc`, in
//   class order, each row's best score and class carried across chunks
//   in registers; with all classes in one chunk the path is the one-pass
//   kernel's.
//
// Numerics: per (row, class) `acc = 0`, then `acc = fmaf(x[j], c[k][j],
// acc)` for j = 0..F-1 in order (the padded lanes never enter the chain),
// then `score = acc + bias[k]` — the same chain as the one-row-per-thread
// kernel it replaces, so predictions are equal. No tensor cores: TF32 or
// 3xTF32 would round the products differently and FP64 DMMA would round
// the sum once where the f32 chain rounds F times; either can flip a near
// tie, and the port's flags are compared field by field.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kRows = 4;  // rows per thread, held in registers
constexpr int kBlockRows = kThreads * kRows;
constexpr int kGenericThreads = 128;  // the F > 32 kernel's block
constexpr size_t kMaxSmem = 232448;    // a block's shared memory on an H100

__host__ __device__ constexpr int round4(int f) { return (f + 3) & ~3; }

// Asynchronous global -> shared copies (cp.async): issued without a
// register round trip, so all of a block's copies are in flight at once.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` committed groups are still in flight.
template <int Pending>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Start copying classes [k0, k0 + cn) of `part`'s C centroids into
// shared memory at stride round4(F), zero-padded, and their bias after
// them.
__device__ __forceinline__ void stage_centroids(
    const float* __restrict__ centroids, const float* __restrict__ bias,
    int part, int c, int k0, int cn, int f, float* cs, float* bs) {
  const int fp = round4(f);
  const float* cp = centroids + (static_cast<size_t>(part) * c + k0) * f;
  for (int k = threadIdx.x; k < cn * f; k += blockDim.x) {
    const int cls = k / f;
    copy4(cs + cls * fp + k - cls * f, cp + k);
  }
  for (int k = threadIdx.x; k < cn * (fp - f); k += blockDim.x) {
    const int cls = k / (fp - f);
    cs[cls * fp + f + k - cls * (fp - f)] = 0.0f;
  }
  for (int k = threadIdx.x; k < cn; k += blockDim.x)
    copy4(bs + k, bias + static_cast<size_t>(part) * c + k0 + k);
}

// One row's score chain against one class: fmaf over the F = 4·(NV-1) +
// TAIL real features in order, from zero.
template <int NV, int TAIL>
__device__ __forceinline__ float dot(const float4 (&x)[NV],
                                     const float4* ck) {
  float acc = 0.0f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 cv = ck[v];  // broadcast: one address for the warp
    const int real = v < NV - 1 ? 4 : TAIL;
    acc = fmaf(x[v].x, cv.x, acc);
    if (real > 1) acc = fmaf(x[v].y, cv.y, acc);
    if (real > 2) acc = fmaf(x[v].z, cv.z, acc);
    if (real > 3) acc = fmaf(x[v].w, cv.w, acc);
  }
  return acc;
}

// Class k0 + k's score (k in the staged chunk) for each row; the first
// maximum wins (strict `>`).
template <int NV, int TAIL>
__device__ __forceinline__ void take(const float4 (&x)[kRows][NV],
                                     const float4* cs4, const float* bs,
                                     int k, int k0, float (&best)[kRows],
                                     int (&arg)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float score = dot<NV, TAIL>(x[r], cs4 + k * NV) + bs[k];
    if (score > best[r]) {
      best[r] = score;
      arg[r] = k0 + k;
    }
  }
}

template <typename Idx, int NV, int TAIL>
__global__ void __launch_bounds__(kThreads) centroid_predict_err_kernel(
    const float* __restrict__ table, int ldt, const int* __restrict__ labels,
    const Idx* __restrict__ idx, const float* __restrict__ centroids,
    const float* __restrict__ bias, int n, int c, int f, int cc,
    float* __restrict__ err, int* __restrict__ pred) {
  extern __shared__ float4 sm4[];
  float4* xs = sm4;  // [kBlockRows, NV] the block's rows
  float4* cs4 = xs + kBlockRows * NV;       // [cc, NV] a chunk's centroids
  float* bs = reinterpret_cast<float*>(cs4 + cc * NV);  // [cc] bias
  int* is = reinterpret_cast<int*>(bs + cc);  // [kBlockRows] table rows
  int* ls = is + kBlockRows;                 // [kBlockRows] their labels
  const int tid = threadIdx.x;
  const int part = blockIdx.y;
  const int base = blockIdx.x * kBlockRows;
  const int m = min(kBlockRows, n - base);
  const Idx* ip = idx + static_cast<size_t>(part) * n + base;

  // 1. The block's indices (coalesced), while the first chunk's centroids
  //    are copied.
  stage_centroids(centroids, bias, part, c, 0, min(cc, c), f,
                  reinterpret_cast<float*>(cs4), bs);
  for (int i = tid; i < m; i += kThreads) is[i] = static_cast<int>(ip[i]);
  __syncthreads();
  // 2. The rows, NV 16-byte copies each with neighbouring threads on one
  //    row, so a warp's copies touch a few rows instead of 32; the labels.
  for (int q = tid; q < m * NV; q += kThreads) {
    const int row = q / NV;
    copy16(xs + q, table + static_cast<size_t>(is[row]) * ldt +
                       4 * (q - row * NV));
  }
  for (int i = tid; i < m; i += kThreads) copy4(ls + i, labels + is[i]);
  copies_commit();
  copies_wait<0>();
  __syncthreads();

  // 3. This thread's rows r·kThreads + tid into registers, then every
  //    class, two at a time, a chunk of classes at a time.
  float4 x[kRows][NV];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = min(r * kThreads + tid, m - 1);
#pragma unroll
    for (int v = 0; v < NV; ++v) x[r][v] = xs[i * NV + v];
  }
  float best[kRows];
  int arg[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    best[r] = -CUDART_INF_F;
    arg[r] = 0;
  }
  for (int k0 = 0; k0 < c; k0 += cc) {
    if (k0 > 0) {  // every thread is past the last chunk: stage the next
      __syncthreads();
      stage_centroids(centroids, bias, part, c, k0, min(cc, c - k0), f,
                      reinterpret_cast<float*>(cs4), bs);
      copies_commit();
      copies_wait<0>();
      __syncthreads();
    }
    const int cn = min(cc, c - k0);
    int k = 0;
    for (; k + 1 < cn; k += 2) {
      take<NV, TAIL>(x, cs4, bs, k, k0, best, arg);
      take<NV, TAIL>(x, cs4, bs, k + 1, k0, best, arg);
    }
    if (k < cn) take<NV, TAIL>(x, cs4, bs, k, k0, best, arg);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = r * kThreads + tid;
    if (i < m) {
      const size_t at = static_cast<size_t>(part) * n + base + i;
      err[at] = arg[r] != ls[i] ? 1.0f : 0.0f;
      if (pred != nullptr) pred[at] = arg[r];
    }
  }
}

// F above 32: one row per thread, its features read from L1/L2 in the dot
// loop; the same FMA chain.
template <typename Idx>
__global__ void __launch_bounds__(kGenericThreads) centroid_predict_err_generic(
    const float* __restrict__ table, int ldt, const int* __restrict__ labels,
    const Idx* __restrict__ idx, const float* __restrict__ centroids,
    const float* __restrict__ bias, int n, int c, int f, int cc,
    float* __restrict__ err, int* __restrict__ pred) {
  extern __shared__ float4 sm4[];
  const int fp = round4(f);
  float* cs = reinterpret_cast<float*>(sm4);
  float* bs = cs + cc * fp;
  const int part = blockIdx.y;
  const int i = blockIdx.x * kGenericThreads + threadIdx.x;
  const bool live = i < n;
  const size_t at = static_cast<size_t>(part) * n + (live ? i : 0);
  const int ri = live ? static_cast<int>(idx[at]) : 0;
  const float* x = table + static_cast<size_t>(ri) * ldt;
  float best = -CUDART_INF_F;
  int arg = 0;
  for (int k0 = 0; k0 < c; k0 += cc) {  // a chunk of classes at a time
    const int cn = min(cc, c - k0);
    if (k0 > 0) __syncthreads();  // every thread is past the last chunk
    stage_centroids(centroids, bias, part, c, k0, cn, f, cs, bs);
    copies_commit();
    copies_wait<0>();
    __syncthreads();
    for (int k = 0; live && k < cn; ++k) {
      const float* ck = cs + k * fp;
      float acc = 0.0f;
      for (int j = 0; j < f; ++j) acc = fmaf(__ldg(x + j), ck[j], acc);
      const float score = acc + bs[k];
      if (score > best) {
        best = score;
        arg = k0 + k;
      }
    }
  }
  if (!live) return;
  err[at] = arg != labels[ri] ? 1.0f : 0.0f;
  if (pred != nullptr) pred[at] = arg;
}

template <typename Idx>
using KernelFn = void (*)(const float*, int, const int*, const Idx*,
                          const float*, const float*, int, int, int, int,
                          float*, int*);

// Launch one instantiation; above 48 KB of shared memory it first raises
// the kernel's dynamic shared-memory limit (the wrapper caps the request
// at the card's 227 KB).
template <typename Idx>
int run(KernelFn<Idx> kernel, dim3 grid, int threads, size_t smem,
        cudaStream_t stream, const float* table, int ldt, const int* labels,
        const Idx* idx, const float* centroids, const float* bias, int n,
        int c, int f, int cc, float* err, int* pred) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(table, ldt, labels, idx, centroids,
                                          bias, n, c, f, cc, err, pred);
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx>
int launch(const float* table, int ldt, const int* labels, const void* idx_v,
           const float* centroids, const float* bias, int p, int n, int c,
           int f, float* err, int* pred, cudaStream_t stream) {
  const Idx* idx = static_cast<const Idx*>(idx_v);
  const int fp = round4(f);
  // a class's centroid and bias; the register path adds the block's rows,
  // indices and labels; the classes staged at once (all that fit)
  const size_t per_class = (static_cast<size_t>(fp) + 1) * sizeof(float);
  const size_t rows_smem = static_cast<size_t>(kBlockRows) * (fp + 2) * sizeof(float);
  const size_t fixed = f <= 32 ? rows_smem : 0;
  const size_t fit = kMaxSmem < fixed + per_class ? 1 : (kMaxSmem - fixed) / per_class;
  const int cc = fit < static_cast<size_t>(c) ? static_cast<int>(fit) : c;
  const size_t smem = cc * per_class;
  const size_t reg_smem = smem + rows_smem;
  const dim3 reg_grid((n + kBlockRows - 1) / kBlockRows, p);
#define K2_CASE(NV_, TAIL_)                                                   \
  case 4 * (NV_ - 1) + TAIL_:                                                 \
    return run<Idx>(centroid_predict_err_kernel<Idx, NV_, TAIL_>, reg_grid,   \
                    kThreads, reg_smem, stream, table, ldt, labels, idx,      \
                    centroids, bias, n, c, f, cc, err, pred);
#define K2_CASES(NV_) \
  K2_CASE(NV_, 1) K2_CASE(NV_, 2) K2_CASE(NV_, 3) K2_CASE(NV_, 4)
  switch (f) {
    K2_CASES(1)
    K2_CASES(2)
    K2_CASES(3)
    K2_CASES(4)
    K2_CASES(5)
    K2_CASES(6)
    K2_CASES(7)
    K2_CASES(8)
    default:
      break;
  }
#undef K2_CASES
#undef K2_CASE
  const dim3 grid((n + kGenericThreads - 1) / kGenericThreads, p);
  return run<Idx>(centroid_predict_err_generic<Idx>, grid, kGenericThreads,
                  smem, stream, table, ldt, labels, idx, centroids, bias, n,
                  c, f, cc, err, pred);
}

}  // namespace

// `table` is [R, ldt] f32 with ldt = F rounded up to a multiple of 4 and a
// 16-byte aligned base; `idx_bytes` is 2 (int16, the packed stream's index
// plane) or 4 (int32, the dense stream's flat index). Returns a CUDA error
// code (0 on a clean launch).
extern "C" int centroid_predict_err_launch(
    const float* table, int ldt, const int* labels, const void* idx,
    int idx_bytes, const float* centroids, const float* bias, int p, int n,
    int c, int f, float* err, int* pred, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 2)
    return launch<int16_t>(table, ldt, labels, idx, centroids, bias, p, n, c,
                           f, err, pred, s);
  return launch<int32_t>(table, ldt, labels, idx, centroids, bias, p, n, c, f,
                         err, pred, s);
}
