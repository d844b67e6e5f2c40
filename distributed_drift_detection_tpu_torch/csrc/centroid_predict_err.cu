// K2 — nearest-centroid predict fused with the error indicator.
//
// Replaces the JAX package's models/classifiers.py `make_centroid.predict`
// (scores = X @ centroids.T + bias, argmax) together with engine/window.py's
// gather `base_X[idx]` and `(preds != y)` — XLA-lowered there as a gather,
// a [W·B, F] x [F, C] matmul, an argmax and a compare. Here one thread
// owns one row: it gathers the row from the table through its index, takes
// C dot products against its partition's centroids, keeps the first
// maximum (strict `>` in class order, so a row whose scores are all -inf —
// the bias of absent classes — predicts class 0, like jnp.argmax), and
// writes err = (pred != label) as f32. Neither the gathered [P·W·B, F]
// rows nor the [P·W·B, C] score plane ever reach device memory.
//
// Bound on an H100 at the main path's shapes (P=16 partitions, W·B=12800
// rows each, F=21, C=40): 2·F·C = 1680 f32 operations per row, 0.34 GFLOP
// per level — about 5 us at the 67 TFLOP/s f32 rate outside the tensor
// cores — against 0.4 MB of int16 indices read and 0.8 MB of errors
// written (0.4 us at 3.35 TB/s; the 336 KB row table stays in L2). So it
// is bound by operations, and at these sizes by launch latency. The
// design: the partition's centroids and bias sit in shared memory
// (broadcast reads), each thread's row is staged into shared memory
// transposed so the inner dot loop reads it without bank conflicts, and
// the dot is an f32 FMA chain in feature order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename Idx>
__global__ void __launch_bounds__(kThreads) centroid_predict_err_kernel(
    const float* __restrict__ table, const int* __restrict__ labels,
    const Idx* __restrict__ idx, const float* __restrict__ centroids,
    const float* __restrict__ bias, int n, int c, int f,
    float* __restrict__ err, int* __restrict__ pred) {
  extern __shared__ float sm[];
  float* cs = sm;             // [C, F] this partition's centroids
  float* bs = cs + c * f;     // [C]    its bias
  float* xs = bs + c;         // [F, kThreads] the block's rows, transposed
  const int part = blockIdx.y;
  const int tid = threadIdx.x;
  const float* cp = centroids + static_cast<size_t>(part) * c * f;
  const float* bp = bias + static_cast<size_t>(part) * c;
  for (int k = tid; k < c * f; k += kThreads) cs[k] = cp[k];
  for (int k = tid; k < c; k += kThreads) bs[k] = bp[k];

  const int i = blockIdx.x * kThreads + tid;
  const size_t at = static_cast<size_t>(part) * n + i;
  int r = 0;
  if (i < n) {
    r = static_cast<int>(idx[at]);
    const float* x = table + static_cast<size_t>(r) * f;
    for (int j = 0; j < f; ++j) xs[j * kThreads + tid] = x[j];
  }
  __syncthreads();
  if (i >= n) return;

  float best = -CUDART_INF_F;
  int arg = 0;
  for (int k = 0; k < c; ++k) {
    const float* ck = cs + k * f;
    float acc = 0.0f;
    for (int j = 0; j < f; ++j) acc = fmaf(xs[j * kThreads + tid], ck[j], acc);
    const float score = acc + bs[k];
    if (score > best) {
      best = score;
      arg = k;
    }
  }
  err[at] = arg != labels[r] ? 1.0f : 0.0f;
  if (pred != nullptr) pred[at] = arg;
}

template <typename Idx>
int launch(const float* table, const int* labels, const void* idx,
           const float* centroids, const float* bias, int p, int n, int c,
           int f, float* err, int* pred, void* stream) {
  const size_t smem =
      (static_cast<size_t>(c) * f + c + static_cast<size_t>(f) * kThreads) *
      sizeof(float);
  const dim3 grid((n + kThreads - 1) / kThreads, p);
  centroid_predict_err_kernel<Idx>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          table, labels, static_cast<const Idx*>(idx), centroids, bias, n, c,
          f, err, pred);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `idx_bytes` is 2 (int16, the packed stream's index plane) or 4 (int32,
// the dense stream's flat index).
extern "C" int centroid_predict_err_launch(
    const float* table, const int* labels, const void* idx, int idx_bytes,
    const float* centroids, const float* bias, int p, int n, int c, int f,
    float* err, int* pred, void* stream) {
  if (idx_bytes == 2)
    return launch<int16_t>(table, labels, idx, centroids, bias, p, n, c, f,
                           err, pred, stream);
  return launch<int32_t>(table, labels, idx, centroids, bias, p, n, c, f, err,
                         pred, stream);
}
