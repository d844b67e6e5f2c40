// K10 — the MLP's predict fused with the error indicator.
//
// Replaces the JAX package's models/classifiers.py `make_mlp.predict`
// (:302-303: argmax of the forward pass) together with engine/window.py's
// gather `base_X[idx]` and `(preds != y)` — XLA-lowered there as a gather,
// the layers' matmuls, an argmax and a compare. For each row it gathers the
// features from the row table through its index, runs the partition's
// layers (ReLU on the hidden ones), keeps the first maximum of the logits
// (strict `>` in class order, as jnp.argmax) and writes err = (pred !=
// label) as f32 (and pred, when asked). Neither the gathered rows nor any
// activation reaches device memory.
//
// Numerics: per (row, unit) `acc = 0`, then `acc = fmaf(in[i], w[i][j],
// acc)` for i in order, then `acc + b[j]`; the plain version
// (models/mlp.py `mlp_predict_err_reference`, torch.bmm) and XLA sum in
// other orders, so predictions agree except on rows whose two best logits
// lie within rounding of each other (tests/test_torch_kernels.py states
// the bound).
//
// Bound on an H100 at the main path's shapes (P = 16 partitions, W·B =
// 12,800 rows each, F = 21, hidden (128, 64), C = 40): 2·13,440 f32
// operations a row, 5.5 GFLOP a launch, ≈ 82 us at the 67 TFLOP/s f32 rate
// outside the tensor cores; the bytes (int16 indices in, f32 errors out,
// the row table and the weights) are some 1 MB. So the multiply-adds bound
// it. The design is the simple one: a block of kThreads threads takes
// kRows rows of one partition, stages the partition's weights (54.7 KB at
// the main path's shapes, above the 48 KB default, so the launcher raises
// the kernel's limit once per device and size) and the rows in shared
// memory, and runs each layer as a loop of its threads over (row, unit)
// outputs into one of two activation tiles, one barrier a layer. No tensor
// cores: TF32 would round every product.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kRows = 64;  // rows a block (models/mlp.py K10_ROWS)
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr size_t kDefaultSmem = 48 * 1024;

struct Net {
  int layers;
  int dims[kMaxLayers + 1];
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
};

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }

// Shared words (models/mlp.py `_k10_shared_bytes`): each layer's w [din *
// dout] and b [dout], rounded up to 4; two activation tiles [kRows][the
// widest layer]; the rows [kRows][F rounded up to 4].
__host__ __device__ inline int smem_words(const Net& net) {
  int words = 0, widest = 0;
  for (int l = 0; l < net.layers; ++l) {
    words += r4(net.dims[l] * net.dims[l + 1]) + r4(net.dims[l + 1]);
    widest = net.dims[l + 1] > widest ? net.dims[l + 1] : widest;
  }
  return words + 2 * kRows * widest + kRows * r4(net.dims[0]);
}

__global__ void __launch_bounds__(kThreads)
    mlp_predict_err_kernel(const float* T, int ld_t, const int* Ty, const void* idx,
                           int idx_bytes, int n, Net net, float* err, int* pred) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int part = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_layers = net.layers;

  // the partition's weights and biases
  float* wl[kMaxLayers];
  float* bl[kMaxLayers];
  int off = 0, widest = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    wl[l] = sm + off;
    off += r4(din * dout);
    bl[l] = sm + off;
    off += r4(dout);
    widest = dout > widest ? dout : widest;
    const float* src = net.w[l] + static_cast<size_t>(part) * din * dout;
    for (int e = tid; e < din * dout; e += nt) wl[l][e] = src[e];
    for (int j = tid; j < dout; j += nt) bl[l][j] = net.b[l][static_cast<size_t>(part) * dout + j];
  }
  float* tile[2] = {sm + off, sm + off + kRows * widest};
  float* xs = sm + off + 2 * kRows * widest;

  // the block's rows, gathered through idx (the table's columns past F are
  // zero padding and never enter a product)
  const int fp = r4(net.dims[0]);
  const size_t base = static_cast<size_t>(part) * n + row0;
  for (int e = tid; e < rows * fp; e += nt) {
    const int r = e / fp, k = e - r * fp;
    const int g = idx_bytes == 2 ? static_cast<const int16_t*>(idx)[base + r]
                                 : static_cast<const int32_t*>(idx)[base + r];
    xs[e] = T[static_cast<size_t>(g) * ld_t + k];
  }
  __syncthreads();

  const float* in = xs;
  int ld_in = fp;
  for (int l = 0; l < n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    float* out = tile[l & 1];
    const bool hidden = l < n_layers - 1;
    for (int e = tid; e < rows * dout; e += nt) {
      const int r = e / dout, j = e - r * dout;
      const float* a = in + r * ld_in;
      float acc = 0.0f;
      for (int i = 0; i < din; ++i) acc = fmaf(a[i], wl[l][i * dout + j], acc);
      acc += bl[l][j];
      out[r * dout + j] = hidden ? fmaxf(acc, 0.0f) : acc;
    }
    __syncthreads();
    in = out;
    ld_in = dout;
  }

  const int c = net.dims[n_layers];
  for (int r = tid; r < rows; r += nt) {
    const float* lg = in + r * c;
    float best = lg[0];
    int k = 0;
    for (int q = 1; q < c; ++q)
      if (lg[q] > best) {
        best = lg[q];
        k = q;
      }
    const int g = idx_bytes == 2 ? static_cast<const int16_t*>(idx)[base + r]
                                 : static_cast<const int32_t*>(idx)[base + r];
    err[base + r] = k != Ty[g] ? 1.0f : 0.0f;
    if (pred != nullptr) pred[base + r] = k;
  }
}

// An empty kernel: launched with K10's grid, block and shared memory, its
// time is the floor under K10's.
__global__ void mlp_predict_err_floor_kernel() {}

std::atomic<int> g_optin[kMaxDevices];  // 0: not read yet
std::atomic<int> g_raised[kMaxDevices];
std::atomic<int> g_floor_raised[kMaxDevices];

cudaError_t shared_bytes(const Net& net, const void* kernel, std::atomic<int>* raised,
                         size_t& smem) {
  smem = 4 * static_cast<size_t>(smem_words(net));
  if (smem <= kDefaultSmem) return cudaSuccess;
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
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  if (static_cast<int>(smem) > raised[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    raised[dev].store(static_cast<int>(smem), std::memory_order_relaxed);
  }
  return cudaSuccess;
}

bool make_net(int layers, const int* dims, void* const* w, void* const* b, Net& net) {
  if (layers < 1 || layers > kMaxLayers) return false;
  net = Net{};
  net.layers = layers;
  for (int l = 0; l <= layers; ++l) net.dims[l] = dims[l];
  for (int l = 0; l < layers; ++l) {
    net.w[l] = w != nullptr ? static_cast<const float*>(w[l]) : nullptr;
    net.b[l] = b != nullptr ? static_cast<const float*>(b[l]) : nullptr;
  }
  return true;
}

}  // namespace

// `dims` (layers + 1), `w` and `b` (layers each) are host arrays.
extern "C" int mlp_predict_err_launch(const float* T, int ld_t, const int* Ty, const void* idx,
                                      int idx_bytes, int p, int n, int layers, const int* dims,
                                      void* const* w, void* const* b, float* err, int* pred,
                                      void* stream) {
  if (p == 0 || n == 0) return 0;
  Net net;
  if (!make_net(layers, dims, w, b, net)) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const cudaError_t e = shared_bytes(
      net, reinterpret_cast<const void*>(mlp_predict_err_kernel), g_raised, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kRows - 1) / kRows, p);
  mlp_predict_err_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      T, ld_t, Ty, idx, idx_bytes, n, net, err, pred);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mlp_predict_err_floor_launch(int p, int n, int layers, const int* dims,
                                            void* stream) {
  if (p == 0 || n == 0) return 0;
  Net net;
  if (!make_net(layers, dims, nullptr, nullptr, net))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const cudaError_t e = shared_bytes(
      net, reinterpret_cast<const void*>(mlp_predict_err_floor_kernel), g_floor_raised, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kRows - 1) / kRows, p);
  mlp_predict_err_floor_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
