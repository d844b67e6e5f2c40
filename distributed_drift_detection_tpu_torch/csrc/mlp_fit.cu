// K9 — the MLP fit: init from the fit key, then every SGD + momentum step.
//
// Replaces the JAX package's models/classifiers.py `make_mlp.fit`
// (:286-300): params0 = init(key) (split(key, layers), then per layer
// sqrt(2/din) * normal(k, (din, dout)), zero biases), zero velocities, then
// `fit_steps` steps of vel = m·vel − lr·∇, p = p + vel on the loss
// −Σ_b wn_b·Σ_c onehot_bc·log_softmax(logits)_bc, wn = w / max(Σw, 1) —
// XLA-lowered there as a scan of matmuls, vmapped over partitions. Per
// partition, from its fit key, training batch X [B, F] f32, labels y [B]
// i32 and {0, 1} weights w [B] f32, it writes each layer's w [din, dout]
// and b [dout].
//
// Numerics. The init is JAX's bit for bit (csrc/threefry.cuh, times the
// factor XLA's jitted init folds, models/mlp.py `init_scales`); the file
// builds with -fmad=false -ftz=true for that. The steps follow JAX's VJP
// as the plain version models/mlp.py `mlp_fit_reference` writes it out:
// log_softmax's backward g + e·(−Σg / Σe) with the max shift held
// constant, ReLU's gradient where the activation is positive, each
// gradient from the old parameters (a layer's weights move only after the
// gradient below it is taken). Each dot product is one fused multiply-add
// chain in index order from 0; XLA's order and the plain version's are
// other ones, so the fitted parameters agree to a tolerance
// (tests/test_torch_kernels.py), not to the bit.
//
// Bound on an H100 at the main path's shapes (P = 16, B = 100, F = 21,
// hidden (128, 64), C = 40, 32 steps): a step is ≈ 3.75 M multiply-adds a
// partition (the forward pass, the weight gradients and the two backward
// products), 3.85 GFLOP a launch, ≈ 57 us at the 67 TFLOP/s f32 rate; the
// bytes (the batch in, 13,672 parameters a partition out) are far less.
// The design is the simple one: one CTA a partition, so 16 of the card's
// 132 SMs work and the launch takes at least ≈ 475 us; its parameters,
// velocities, activations, rows, labels and weights sit in the CTA's
// shared memory when they fit (≈ 215 KB at the main path's shapes), else
// in a global workspace the wrapper allocates — the same code through
// generic pointers. Every phase (a layer's forward product, the softmax
// gradient, a layer's weight gradient, its backward product, its update)
// is a loop of the block's threads over the phase's outputs, one barrier
// apart; weight rows are padded by one float so the backward product's
// column reads (row stride dout + 1) meet no bank conflicts. No tensor
// cores: TF32 would round every product. A cluster per partition, which
// would spread a fit over several SMs, is a later PR's work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "threefry.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr size_t kDefaultSmem = 48 * 1024;

struct Net {
  int layers;
  int dims[kMaxLayers + 1];
  float factor[kMaxLayers];
  float* w[kMaxLayers];
  float* b[kMaxLayers];
};

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }

// A partition's workspace, in floats (models/mlp.py `_k9_words`): each
// layer's w [din][dout + 1] and b [dout], the velocities laid out the same,
// each layer's output [B][dout] (the hidden activations, then the logits;
// in the backward pass the gradients that replace them), the rows [B][F],
// the labels and the normalised weights; every region rounded up to 4.
struct Layout {
  int w[kMaxLayers], b[kMaxLayers], vw[kMaxLayers], vb[kMaxLayers], act[kMaxLayers];
  int x, y, wn, total;
};

__host__ __device__ inline Layout layout(const Net& net, int rows) {
  Layout lay{};
  int off = 0;
  for (int v = 0; v < 2; ++v)
    for (int l = 0; l < net.layers; ++l) {
      (v ? lay.vw : lay.w)[l] = off;
      off += r4(net.dims[l] * (net.dims[l + 1] + 1));
      (v ? lay.vb : lay.b)[l] = off;
      off += r4(net.dims[l + 1]);
    }
  for (int l = 0; l < net.layers; ++l) {
    lay.act[l] = off;
    off += r4(rows * net.dims[l + 1]);
  }
  lay.x = off;
  off += r4(rows * net.dims[0]);
  lay.y = off;
  off += r4(rows);
  lay.wn = off;
  off += r4(rows);
  lay.total = off;
  return lay;
}

__global__ void __launch_bounds__(kThreads)
    mlp_fit_kernel(const uint32_t* keys, const float* X, const int* y, const float* w,
                   int rows, Net net, int steps, float lr, float mom, float* scratch) {
  extern __shared__ float4 smem4[];
  const Layout lay = layout(net, rows);
  const int part = blockIdx.x;
  float* ws = scratch != nullptr ? scratch + static_cast<size_t>(part) * lay.total
                                 : reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nt = blockDim.x, n_layers = net.layers;
  const int f = net.dims[0];
  float* xs = ws + lay.x;
  int* ys = reinterpret_cast<int*>(ws + lay.y);
  float* wn = ws + lay.wn;

  // The batch, and wn = w / max(Σw, 1) (a sum of {0, 1}: exact in any order).
  const float* Xp = X + static_cast<size_t>(part) * rows * f;
  for (int e = tid; e < rows * f; e += nt) xs[e] = Xp[e];
  for (int r = tid; r < rows; r += nt) {
    ys[r] = y[part * rows + r];
    wn[r] = w[part * rows + r];
  }
  __syncthreads();
  float wsum = 0.0f;
  for (int r = 0; r < rows; ++r) wsum = __fadd_rn(wsum, wn[r]);
  wsum = fmaxf(wsum, 1.0f);
  __syncthreads();
  for (int r = tid; r < rows; r += nt) wn[r] = __fdiv_rn(wn[r], wsum);

  // init(key): layer l's weights from split(key, layers)[l], zero biases
  // and velocities.
  const threefry::Pair key{keys[2 * part], keys[2 * part + 1]};
  for (int l = 0; l < n_layers; ++l) {
    const threefry::Pair kl = threefry::split(key, static_cast<uint32_t>(l));
    const int din = net.dims[l], dout = net.dims[l + 1], ld = dout + 1;
    for (int e = tid; e < din * dout; e += nt) {
      const int i = e / dout, j = e - i * dout;
      ws[lay.w[l] + i * ld + j] = threefry::normal(kl, static_cast<uint64_t>(e), net.factor[l]);
      ws[lay.vw[l] + i * ld + j] = 0.0f;
    }
    for (int j = tid; j < dout; j += nt) {
      ws[lay.b[l] + j] = 0.0f;
      ws[lay.vb[l] + j] = 0.0f;
    }
  }
  __syncthreads();

  const int c = net.dims[n_layers];
  for (int step = 0; step < steps; ++step) {
    // Forward: out = in·W + b, ReLU on the hidden layers.
    for (int l = 0; l < n_layers; ++l) {
      const int din = net.dims[l], dout = net.dims[l + 1], ld = dout + 1;
      const float* in = l == 0 ? xs : ws + lay.act[l - 1];
      const float* W = ws + lay.w[l];
      const float* bias = ws + lay.b[l];
      float* out = ws + lay.act[l];
      const bool hidden = l < n_layers - 1;
      for (int e = tid; e < rows * dout; e += nt) {
        const int r = e / dout, j = e - r * dout;
        const float* a = in + r * din;
        float acc = 0.0f;
        for (int i = 0; i < din; ++i) acc = __fmaf_rn(a[i], W[i * ld + j], acc);
        acc = __fadd_rn(acc, bias[j]);
        out[e] = hidden ? fmaxf(acc, 0.0f) : acc;
      }
      __syncthreads();
    }

    // The logits' gradient, in place: d = g + e·(−Σg / Σe), g = −wn·onehot,
    // e = exp(logits − max).
    float* logits = ws + lay.act[n_layers - 1];
    for (int r = tid; r < rows; r += nt) {
      float* lg = logits + r * c;
      float m = lg[0];
      for (int k = 1; k < c; ++k) m = fmaxf(m, lg[k]);
      float s = 0.0f;
      for (int k = 0; k < c; ++k) {
        const float ex = expf(__fsub_rn(lg[k], m));
        lg[k] = ex;
        s = __fadd_rn(s, ex);
      }
      const int yr = ys[r];
      const float g_y = -wn[r];
      const float g_sum = (yr >= 0 && yr < c) ? g_y : 0.0f;
      const float coef = __fdiv_rn(-g_sum, s);
      for (int k = 0; k < c; ++k)
        lg[k] = __fadd_rn(k == yr ? g_y : -0.0f, __fmul_rn(lg[k], coef));
    }
    __syncthreads();

    // Backward, from the last layer down.
    for (int l = n_layers - 1; l >= 0; --l) {
      const int din = net.dims[l], dout = net.dims[l + 1], ld = dout + 1;
      const float* in = l == 0 ? xs : ws + lay.act[l - 1];
      const float* d = ws + lay.act[l];
      float* W = ws + lay.w[l];
      float* bias = ws + lay.b[l];
      float* vW = ws + lay.vw[l];
      float* vb = ws + lay.vb[l];
      // the gradient into the velocity: vel = m·vel − lr·inᵀd (W unchanged)
      for (int e = tid; e < din * dout; e += nt) {
        const int i = e / dout, j = e - i * dout;
        float g = 0.0f;
        for (int r = 0; r < rows; ++r) g = __fmaf_rn(in[r * din + i], d[r * dout + j], g);
        float* v = vW + i * ld + j;
        *v = __fsub_rn(__fmul_rn(mom, *v), __fmul_rn(lr, g));
      }
      for (int j = tid; j < dout; j += nt) {
        float g = 0.0f;
        for (int r = 0; r < rows; ++r) g = __fadd_rn(g, d[r * dout + j]);
        vb[j] = __fsub_rn(__fmul_rn(mom, vb[j]), __fmul_rn(lr, g));
      }
      __syncthreads();
      // the layer below's gradient, from the old W, over its activations
      if (l > 0) {
        float* h = ws + lay.act[l - 1];
        for (int e = tid; e < rows * din; e += nt) {
          const int r = e / din, i = e - r * din;
          float acc = 0.0f;
          if (h[e] > 0.0f) {
            const float* dr = d + r * dout;
            const float* wr = W + i * ld;
            for (int j = 0; j < dout; ++j) acc = __fmaf_rn(dr[j], wr[j], acc);
          }
          h[e] = acc;
        }
        __syncthreads();
      }
      // p = p + vel (the next layer's gradient phase touches other memory)
      for (int e = tid; e < din * dout; e += nt) {
        const int i = e / dout, j = e - i * dout;
        W[i * ld + j] = __fadd_rn(W[i * ld + j], vW[i * ld + j]);
      }
      for (int j = tid; j < dout; j += nt) bias[j] = __fadd_rn(bias[j], vb[j]);
    }
    __syncthreads();
  }

  for (int l = 0; l < n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1], ld = dout + 1;
    float* wo = net.w[l] + static_cast<size_t>(part) * din * dout;
    for (int e = tid; e < din * dout; e += nt) {
      const int i = e / dout, j = e - i * dout;
      wo[e] = ws[lay.w[l] + i * ld + j];
    }
    for (int j = tid; j < dout; j += nt)
      net.b[l][static_cast<size_t>(part) * dout + j] = ws[lay.b[l] + j];
  }
}

// An empty kernel: launched with K9's grid, block and shared memory, its
// time is the floor under K9's.
__global__ void mlp_fit_floor_kernel() {}

std::atomic<int> g_optin[kMaxDevices];  // 0: not read yet
std::atomic<int> g_raised[kMaxDevices];
std::atomic<int> g_floor_raised[kMaxDevices];

// Shared memory for a launch whose workspace is not global: the layout's
// bytes, with `kernel`'s limit raised once per (device, size) above 48 KB.
cudaError_t shared_bytes(const Net& net, int rows, const void* kernel, std::atomic<int>* raised,
                         size_t& smem) {
  smem = 4 * static_cast<size_t>(layout(net, rows).total);
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

bool make_net(int layers, const int* dims, const float* factors, void* const* w_out,
              void* const* b_out, Net& net) {
  if (layers < 1 || layers > kMaxLayers) return false;
  net = Net{};
  net.layers = layers;
  for (int l = 0; l <= layers; ++l) net.dims[l] = dims[l];
  for (int l = 0; l < layers; ++l) {
    net.factor[l] = factors != nullptr ? factors[l] : 0.0f;
    net.w[l] = w_out != nullptr ? static_cast<float*>(w_out[l]) : nullptr;
    net.b[l] = b_out != nullptr ? static_cast<float*>(b_out[l]) : nullptr;
  }
  return true;
}

}  // namespace

// `dims`, `factors`, `w_out` and `b_out` are host arrays (layers + 1,
// layers, layers, layers); `scratch` is a global workspace of [p, words]
// floats, or null to keep the workspace in shared memory.
extern "C" int mlp_fit_launch(const int* keys, const float* X, const int* y, const float* w,
                              int p, int rows, int layers, const int* dims, const float* factors,
                              int steps, float lr, float mom, void* const* w_out,
                              void* const* b_out, float* scratch, void* stream) {
  if (p == 0) return 0;
  Net net;
  if (!make_net(layers, dims, factors, w_out, b_out, net))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (scratch == nullptr) {
    const cudaError_t e = shared_bytes(net, rows, reinterpret_cast<const void*>(mlp_fit_kernel),
                                       g_raised, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mlp_fit_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(keys), X, y, w, rows, net, steps, lr, mom, scratch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mlp_fit_floor_launch(int p, int rows, int layers, const int* dims, void* stream) {
  if (p == 0) return 0;
  Net net;
  if (!make_net(layers, dims, nullptr, nullptr, nullptr, net))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (4 * static_cast<size_t>(layout(net, rows).total) <= 232448) {
    const cudaError_t e = shared_bytes(
        net, rows, reinterpret_cast<const void*>(mlp_fit_floor_kernel), g_floor_raised, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mlp_fit_floor_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
