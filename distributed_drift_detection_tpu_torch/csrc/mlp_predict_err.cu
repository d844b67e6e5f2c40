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
// activation reaches device memory (unless a layer is too wide for shared
// memory, below).
//
// Numerics: per (row, unit) `acc = +0`, then `acc = fma(in[i], w[i][j],
// acc)` for i = 0 .. din-1 in order, then `acc + b[j]`, then max(·, 0) on
// the hidden layers — one chain an output, never split, reordered or
// summed in parts, so the outputs are bit for bit those of the one-output-
// a-thread kernel this design replaced (pinned by digest in chip_smoke.py
// and tests/test_torch_kernels.py) whatever the tile, the rows a CTA or the
// weight path. The plain version (models/mlp.py
// `mlp_predict_err_reference`, torch.bmm) and XLA sum in other orders, so
// predictions agree except on rows whose two best logits lie within
// rounding of each other (tests/test_torch_kernels.py states the bound).
// No tensor cores: TF32 would round every product.
//
// Bound on an H100 at the main path's shapes (P = 16 partitions, W·B =
// 12,800 rows each, F = 21, hidden (128, 64), C = 40): 2·13,440 f32
// operations a row, 5.5 GFLOP a launch, ≈ 82 us at the 67 TFLOP/s f32 rate
// outside the tensor cores; the bytes (int16 indices in, f32 errors out,
// the row table and the weights) are some 1 MB. So the multiply-adds bound
// it. The design (a `Plan`, from the shapes alone but for the CTAs a
// partition, `mlp_predict_err_plan`; models/mlp.py `k10_plan` mirrors it):
//
// * Register tiles. A CTA takes a tile of `rows` rows of one partition
//   (128 at the main path's shapes). Each thread owns 8 rows × 4 units of a
//   layer's outputs: 32 accumulators in registers. Activations sit in
//   shared memory transposed, [unit][rows + 4], and weights as [i][dout
//   rounded up to 4], so one step of i takes two float4 loads of 4 rows
//   each and one float4 of 4 units for 32 fused multiply-adds (the kernel
//   this replaced took 2 shared loads for 1). A thread's rows are 4·tm + p
//   and rows/2 + 4·tm + p, so the lanes of a warp read whole float4 runs.
//   Tiles are indexed by counters; ragged rows, units and inputs are
//   computed and never stored, or skipped.
// * Persistent CTAs. `ctas` CTAs a partition (what the card holds at
//   once, spread over the partitions) each stage the partition's weights
//   once and loop over its row tiles; the next tile's rows are gathered by
//   cp.async while the current one computes.
// * Weights staged in tiles. When the weights and the activation tiles do
//   not fit shared memory together, each layer's W streams through a ring
//   of two [kc × units-a-pass] chunks, in i order, the accumulators staying
//   in registers across chunks (each output's chain is unchanged). The
//   plan takes the largest row tile whose activations fit beside the
//   resident weights, else beside the ring; a layer too wide even for 8
//   rows puts the activations (and the gathered rows) in a global
//   workspace the wrapper allocates (`global_words` floats a CTA), through
//   the same code.
// * Layers come in a __grid_constant__ struct of up to kInlineLayers (64)
//   widths and w / b pointers (a kernel's parameters are limited to 4 KB),
//   past that in a device array the launcher fills; the code reads either
//   through one view.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <vector>

namespace {

constexpr int kInlineLayers = 64;  // models/mlp.py INLINE_LAYERS
constexpr int kMaxThreads = 256;
constexpr int kThreadRows = 8;  // a thread's rows; a tile is a multiple of it
constexpr int kRingWords = 4096;  // floats a buffer of the streamed weights' ring
constexpr int kMaxDevices = 64;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxSmemWords = 232448 / 4;  // models/classifiers.py MAX_SHARED_BYTES
// Row tiles the plan tries, resident weights first (the first two), then
// streamed (all); the default threads a CTA.
constexpr int kRowChoices[] = {128, 64, 32, 16, 8};
constexpr int kResidentChoices = 2;
constexpr int kThreads = 256;

// The net as the code reads it: its widths and parameter pointers, viewed
// where they lie — on the host, the launcher's arrays; in the kernel, a
// __grid_constant__ NetArgs for up to kInlineLayers layers, else a device
// array the launcher fills (`net_desc_bytes`; the wrapper allocates it).
struct Net {
  int layers;
  const int* dims;         // [layers + 1]
  const float* const* w;   // [layers]
  const float* const* b;   // [layers]
};

struct NetArgs {
  int dims[kInlineLayers + 1];
  const float* w[kInlineLayers];
  const float* b[kInlineLayers];
};

// The device array past kInlineLayers: w [L] and b [L] pointers, then dims
// [L + 1] ints.
__host__ __device__ inline size_t net_desc_bytes(int layers) {
  return 2 * sizeof(float*) * layers + sizeof(int) * (layers + 1);
}

__device__ __forceinline__ Net device_net(int layers, const NetArgs& args, const void* desc) {
  if (desc == nullptr) return Net{layers, args.dims, args.w, args.b};
  const float* const* w = static_cast<const float* const*>(desc);
  return Net{layers, reinterpret_cast<const int*>(w + 2 * layers), w, w + layers};
}

// A launch's plan (`mlp_predict_err_plan`; models/mlp.py `k10_plan`).
struct Plan {
  int rows;          // rows a tile, a multiple of kThreadRows
  int threads;       // a CTA
  int ctas;          // CTAs a partition
  int stream;        // 1: weights through the ring; 0: resident
  int global;        // 1: activations and rows in the global workspace
  int kc;            // inputs a streamed chunk: kRingWords / units a pass
  int ldr;           // row stride of an activation: rows + 4
  int wa, wb;        // widths of the two activation buffers (even, odd layers)
  int shared_words;  // floats of shared memory a CTA
  int global_words;  // floats of global workspace a CTA (0: none)
};

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
// Units a pass of a layer: one 8 × 4 tile a thread.
__host__ __device__ inline int units_a_pass(int rows, int threads) {
  return 4 * (threads / (rows / kThreadRows));
}

int weight_words(const Net& net) {
  int words = 0;
  for (int l = 0; l < net.layers; ++l) words += net.dims[l] * r4(net.dims[l + 1]);
  return words;
}

// The plan's sizes for its row tile, threads and placements: fills ldr,
// wa, wb and the word counts. Shared memory holds the tile's indices (two
// buffers), then, unless global, the gathered rows [2][F][ldr] and the
// activations [wa + wb][ldr], then the resident weights or the ring
// [2][kc][units a pass].
void size_plan(const Net& net, Plan& plan) {
  plan.ldr = plan.rows + 4;
  plan.kc = kRingWords / units_a_pass(plan.rows, plan.threads);
  plan.wa = plan.wb = 0;
  for (int l = 0; l < net.layers; ++l) {
    int& w = (l & 1) ? plan.wb : plan.wa;
    w = net.dims[l + 1] > w ? net.dims[l + 1] : w;
  }
  const int acts = (2 * net.dims[0] + plan.wa + plan.wb) * plan.ldr;
  const int weights = plan.stream ? 2 * kRingWords : weight_words(net);
  plan.shared_words = 2 * r4(plan.rows) + weights + (plan.global ? 0 : acts);
  plan.global_words = plan.global ? acts : 0;
}

// Whether the plan with these rows, weight path and activation placement
// fits shared memory (sizing it).
bool fits(const Net& net, Plan& plan, int rows, int stream, int global) {
  plan.rows = rows;
  plan.stream = stream;
  plan.global = global;
  if (rows < kThreadRows || rows % kThreadRows || rows / kThreadRows > plan.threads) return false;
  size_plan(net, plan);
  return plan.shared_words <= kMaxSmemWords;
}

// The plan for a net, from the shapes alone (the CTAs a partition are
// full_plan's): resident weights at the first of kRowChoices[0 ..
// kResidentChoices) that fits, else streamed weights at the first of
// kRowChoices that fits, else activations in global memory at the largest
// tile, the weights resident if they fit. A forced field — `rows` or
// `threads` > 0, `stream` >= 0 — is kept; false if no plan fits.
bool choose_plan(const Net& net, int rows, int threads, int stream, Plan& plan) {
  plan = Plan{};
  plan.threads = threads > 0 ? threads : kThreads;
  if (plan.threads > kMaxThreads || plan.threads % 32) return false;
  const int n_rows = rows > 0 ? 1 : 5;
  const int n_resident = rows > 0 || stream == 0 ? n_rows : kResidentChoices;
  auto rows_at = [&](int k) { return rows > 0 ? rows : kRowChoices[k]; };
  if (stream != 1)
    for (int k = 0; k < n_resident; ++k)
      if (fits(net, plan, rows_at(k), 0, 0)) return true;
  if (stream != 0)
    for (int k = 0; k < n_rows; ++k)
      if (fits(net, plan, rows_at(k), 1, 0)) return true;
  for (int s = 0; s < 2; ++s)
    if (stream < 0 || stream == s)
      if (fits(net, plan, rows_at(0), s, 1)) return true;
  return false;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
__device__ __forceinline__ float& ref4(float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// A 4-byte copy global -> shared by cp.async, or by a load and a store
// when the destination is the global workspace.
template <bool kGlobal>
__device__ __forceinline__ void copy1(float* dst, const float* src) {
  if (kGlobal) {
    *dst = __ldg(src);
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// acc[p][q] (q < 4 units at w, 8 rows: 4·tm + p and half + 4·tm + p − 4)
// += in[i][row] · w[i][unit] for i = 0 .. cnt-1 in order, one fused
// multiply-add chain an accumulator.
__device__ __forceinline__ void accumulate(float (&acc)[8][4], const float* a0, const float* a1,
                                           int lda, const float* w, int ldw, int cnt) {
#pragma unroll 4
  for (int i = 0; i < cnt; ++i) {
    const float4 x0 = load4(a0 + i * lda), x1 = load4(a1 + i * lda), wv = load4(w + i * ldw);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[p][q] = __fmaf_rn(lane4(x0, p), lane4(wv, q), acc[p][q]);
        acc[4 + p][q] = __fmaf_rn(lane4(x1, p), lane4(wv, q), acc[4 + p][q]);
      }
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads)
    mlp_predict_err_kernel(const float* T, int ld_t, const int* Ty, const void* idx,
                           int idx_bytes, int n, int layers, const __grid_constant__ NetArgs args,
                           const void* desc, const __grid_constant__ Plan plan, float* scratch,
                           float* err, int* pred) {
  extern __shared__ float4 smem4[];
  const Net net = device_net(layers, args, desc);
  float* sm = reinterpret_cast<float*>(smem4);
  const int part = blockIdx.y, g = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rows = plan.rows, ldr = plan.ldr, half = rows / 2, gm = rows / kThreadRows;
  const int f = net.dims[0], n_layers = net.layers, c = net.dims[n_layers];
  const int upp = units_a_pass(rows, nt);
  const int tiles = cdiv(n, rows);

  // Buffers by offset from their base (no arrays of pointers, so the
  // compiler keeps shared-memory accesses shared): the tile's indices
  // ids + s·r4(rows); the gathered rows acts + s·F·ldr and the layers'
  // outputs acts + (2F + (l & 1)·wa)·ldr, in shared memory or in the CTA's
  // global workspace; the resident weights or the ring at wsm.
  int* ids = reinterpret_cast<int*>(sm);
  float* acts = kGlobal ? scratch + (static_cast<size_t>(part) * gridDim.x + g) * plan.global_words
                        : sm + 2 * r4(rows);
  float* wsm = sm + 2 * r4(rows) + (kGlobal ? 0 : (2 * f + plan.wa + plan.wb) * ldr);

  // The partition's weights, once: layer l's w [din][r4(dout)].
  if (!plan.stream) {
    int off = 0;
    for (int l = 0; l < n_layers; ++l) {
      const int din = net.dims[l], dout = net.dims[l + 1], ld = r4(dout);
      const float* src = net.w[l] + static_cast<size_t>(part) * din * dout;
      for (int e = tid; e < din * dout; e += nt) {
        const int i = e / dout;
        copy1<false>(wsm + off + i * ld + (e - i * dout), src + e);
      }
      off += din * ld;
    }
    commit();
  }

  // Tile t's indices and rows into buffer s: the rows transposed,
  // acts[(s·F + k)·ldr + r] = T[idx[r]][k] (the table's columns past F are never
  // read); rows past n are left as they are, and never stored from.
  auto gather = [&](int t, int s) {
    const int row0 = t * rows, m = min(rows, n - row0);
    const size_t base = static_cast<size_t>(part) * n + row0;
    for (int e = tid; e < m * f; e += nt) {
      const int r = e / f, k = e - r * f;
      const int gi = idx_bytes == 2 ? static_cast<const int16_t*>(idx)[base + r]
                                    : static_cast<const int32_t*>(idx)[base + r];
      if (k == 0) ids[s * r4(rows) + r] = gi;
      copy1<kGlobal>(acts + (s * f + k) * ldr + r, T + static_cast<size_t>(gi) * ld_t + k);
    }
    commit();
  };

  int s = 0;
  if (g < tiles) gather(g, 0);
  for (int t = g; t < tiles; t += gridDim.x, s ^= 1) {
    wait_copies<0>();
    __syncthreads();  // this tile's rows, and the weights, are in; the last tile is done
    if (t + gridDim.x < tiles) gather(t + gridDim.x, s ^ 1);

    const float* in = acts + s * f * ldr;
    int woff = 0;
    for (int l = 0; l < n_layers; ++l) {
      const int din = net.dims[l], dout = net.dims[l + 1], ldw = r4(dout);
      const float* wl = net.w[l] + static_cast<size_t>(part) * din * dout;
      const float* bl = net.b[l] + static_cast<size_t>(part) * dout;
      float* out = acts + (2 * f + (l & 1) * plan.wa) * ldr;
      const bool hidden = l < n_layers - 1;
      for (int n0 = 0; n0 < dout; n0 += upp) {
        const int n1 = min(dout, n0 + upp), gn = cdiv(n1 - n0, 4);
        const int tm = tid / gn, tn = tid - tm * gn;
        const bool active = tm < gm;
        const float* a0 = in + 4 * tm;
        const float* a1 = in + half + 4 * tm;
        float acc[8][4] = {};
        if (!plan.stream) {
          if (active) accumulate(acc, a0, a1, ldr, wsm + woff + n0 + 4 * tn, ldw, din);
        } else {
          // the ring: chunk k of kc inputs × the pass's units, in i order
          const int kc = plan.kc, nw = n1 - n0, ldc = r4(nw), chunks = cdiv(din, kc);
          auto issue = [&](int k) {
            const int i0 = k * kc, cnt = min(kc, din - i0);
            const float* src = wl + static_cast<size_t>(i0) * dout + n0;
            for (int e = tid; e < cnt * nw; e += nt) {
              const int i = e / nw;
              copy1<false>(wsm + (k & 1) * kRingWords + i * ldc + (e - i * nw),
                           src + i * dout + (e - i * nw));
            }
            commit();
          };
          issue(0);
          for (int k = 0; k < chunks; ++k) {
            if (k + 1 < chunks) {
              issue(k + 1);
              wait_copies<1>();
            } else {
              wait_copies<0>();
            }
            __syncthreads();  // chunk k is in
            const int i0 = k * kc;
            if (active)
              accumulate(acc, a0 + i0 * ldr, a1 + i0 * ldr, ldr,
                         wsm + (k & 1) * kRingWords + 4 * tn, ldc, min(kc, din - i0));
            __syncthreads();  // no thread reads chunk k's buffer again
          }
        }
        if (active) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = n0 + 4 * tn + q;
            if (j < n1) {
              const float bj = __ldg(bl + j);
              float4 v0, v1;
#pragma unroll
              for (int p = 0; p < 4; ++p) {
                const float z0 = __fadd_rn(acc[p][q], bj), z1 = __fadd_rn(acc[4 + p][q], bj);
                ref4(v0, p) = hidden ? fmaxf(z0, 0.0f) : z0;
                ref4(v1, p) = hidden ? fmaxf(z1, 0.0f) : z1;
              }
              store4(out + j * ldr + 4 * tm, v0);
              store4(out + j * ldr + half + 4 * tm, v1);
            }
          }
        }
      }
      __syncthreads();  // the layer's outputs are complete
      in = out;
      woff += din * ldw;
    }

    // the first maximum of each row's logits, in class order
    const int row0 = t * rows, m = min(rows, n - row0);
    for (int r = tid; r < m; r += nt) {
      float best = in[r];
      int k = 0;
      for (int q = 1; q < c; ++q) {
        const float v = in[q * ldr + r];
        if (v > best) {
          best = v;
          k = q;
        }
      }
      const size_t at = static_cast<size_t>(part) * n + row0 + r;
      err[at] = k != Ty[ids[s * r4(rows) + r]] ? 1.0f : 0.0f;
      if (pred != nullptr) pred[at] = k;
    }
  }
}

// An empty kernel: launched with K10's grid, block and shared memory, its
// time is the floor under K10's.
__global__ void mlp_predict_err_floor_kernel() {}

std::atomic<int> g_optin[kMaxDevices];  // 0: not read yet
std::atomic<int> g_sms[kMaxDevices];
std::atomic<int> g_raised[3][kMaxDevices];  // kernel<false>, kernel<true>, floor

const void* kernel_of(int which) {
  return which == 0   ? reinterpret_cast<const void*>(mlp_predict_err_kernel<false>)
         : which == 1 ? reinterpret_cast<const void*>(mlp_predict_err_kernel<true>)
                      : reinterpret_cast<const void*>(mlp_predict_err_floor_kernel);
}

// Raise kernel `which`'s shared-memory limit to `smem` bytes once per
// (device, size), above the 48 KB default; the card's opt-in limit is read
// once per device.
cudaError_t allow_shared(int which, size_t smem, int& dev) {
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= kDefaultSmem) return cudaSuccess;
  int optin = g_optin[dev].load(std::memory_order_relaxed);
  if (optin == 0) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    g_optin[dev].store(optin, std::memory_order_relaxed);
  }
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  std::atomic<int>& raised = g_raised[which][dev];
  if (static_cast<int>(smem) > raised.load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(kernel_of(which), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    raised.store(static_cast<int>(smem), std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// A view of the launcher's host arrays (w and b may be null where only the
// widths are read).
bool make_net(int layers, const int* dims, void* const* w, void* const* b, Net& net) {
  if (layers < 1) return false;
  for (int l = 0; l <= layers; ++l)
    if (dims[l] < 1) return false;
  net = Net{layers, dims, reinterpret_cast<const float* const*>(w),
            reinterpret_cast<const float* const*>(b)};
  return true;
}

// The kernel's copy of `net`: the NetArgs for up to kInlineLayers layers;
// past that the same fields written to the device array `desc` (on the
// launch's stream; a pageable copy, so `net`'s arrays may go once this
// returns). Returns a CUDA error code.
cudaError_t device_args(const Net& net, void* desc, cudaStream_t stream, NetArgs& args) {
  args = NetArgs{};
  const int L = net.layers;
  if (L <= kInlineLayers) {
    for (int l = 0; l <= L; ++l) args.dims[l] = net.dims[l];
    for (int l = 0; l < L; ++l) {
      args.w[l] = net.w[l];
      args.b[l] = net.b[l];
    }
    return cudaSuccess;
  }
  if (desc == nullptr) return cudaErrorInvalidValue;
  std::vector<unsigned char> host(net_desc_bytes(L));
  const float** w = reinterpret_cast<const float**>(host.data());
  int* dims = reinterpret_cast<int*>(w + 2 * L);
  for (int l = 0; l < L; ++l) {
    w[l] = net.w[l];
    w[L + l] = net.b[l];
  }
  for (int l = 0; l <= L; ++l) dims[l] = net.dims[l];
  return cudaMemcpyAsync(desc, host.data(), host.size(), cudaMemcpyHostToDevice, stream);
}

// The full plan of a launch at [p, n] on the current device: the shapes'
// plan (choose_plan, with the forced fields), then the CTAs a partition —
// `ctas` if forced, else the CTAs the card holds at once (`per_sm`, the
// kernel's occupancy at the plan's threads and shared memory, times the
// `sms`) shared out over the p partitions, at least one and at most the
// partition's tiles. Also raises the kernel's shared-memory limit. The
// wrapper passes a whole plan, so a launch asks the card nothing.
cudaError_t full_plan(const Net& net, int p, int n, int rows, int threads, int ctas, int stream,
                      Plan& plan, int& per_sm, int& sms) {
  if (!choose_plan(net, rows, threads, stream, plan)) return cudaErrorInvalidValue;
  int dev = 0;
  const int which = plan.global ? 1 : 0;
  const size_t smem = 4 * static_cast<size_t>(plan.shared_words);
  cudaError_t e = allow_shared(which, smem, dev);
  if (e != cudaSuccess) return e;
  const int tiles = cdiv(n, plan.rows);
  per_sm = sms = 0;
  if (ctas > 0) {
    plan.ctas = ctas < tiles ? ctas : tiles;
    return cudaSuccess;
  }
  sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(which), plan.threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  const int share = per_sm * sms / (p > 0 ? p : 1);
  plan.ctas = share < 1 ? 1 : (share < tiles ? share : tiles);
  return cudaSuccess;
}

}  // namespace

// `dims` (layers + 1), `w` and `b` (layers each) are host arrays; `desc` a
// device array of net_desc_bytes(layers) when layers > kInlineLayers, else
// null; `scratch` the global workspace, [p · ctas · global_words] floats,
// or null when the plan has none. `rows`, `threads` and `ctas` (0: the plan's) and `stream`
// (-1: the plan's, 0: resident weights, 1: streamed) force a plan's fields;
// a forced plan that does not fit returns cudaErrorInvalidValue.
extern "C" int mlp_predict_err_launch(const float* T, int ld_t, const int* Ty, const void* idx,
                                      int idx_bytes, int p, int n, int layers, const int* dims,
                                      void* const* w, void* const* b, void* desc, float* scratch,
                                      int rows, int threads, int ctas, int stream, float* err,
                                      int* pred, void* stream_handle) {
  if (p == 0 || n == 0) return 0;
  Net net;
  if (!make_net(layers, dims, w, b, net)) return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  int per_sm, sms;
  const cudaError_t e = full_plan(net, p, n, rows, threads, ctas, stream, plan, per_sm, sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (plan.global && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(plan.ctas, p);
  const size_t smem = 4 * static_cast<size_t>(plan.shared_words);
  const cudaStream_t s = static_cast<cudaStream_t>(stream_handle);
  NetArgs args;
  const cudaError_t ea = device_args(net, desc, s, args);
  if (ea != cudaSuccess) return static_cast<int>(ea);
  const void* kdesc = layers > kInlineLayers ? desc : nullptr;
  if (plan.global)
    mlp_predict_err_kernel<true><<<grid, plan.threads, smem, s>>>(
        T, ld_t, Ty, idx, idx_bytes, n, layers, args, kdesc, plan, scratch, err, pred);
  else
    mlp_predict_err_kernel<false><<<grid, plan.threads, smem, s>>>(
        T, ld_t, Ty, idx, idx_bytes, n, layers, args, kdesc, plan, scratch, err, pred);
  return static_cast<int>(cudaGetLastError());
}

// The plan of a launch at [p, n] × dims with the forced fields, into
// out[0..10]: rows, threads, ctas, stream, global, wa, wb, shared bytes,
// global workspace floats a CTA; then the card's numbers the CTAs a
// partition came from, the kernel's CTAs an SM and the SMs (0 when `ctas`
// is forced).
extern "C" int mlp_predict_err_plan(int p, int n, int layers, const int* dims, int rows,
                                    int threads, int ctas, int stream, int* out) {
  Net net;
  if (!make_net(layers, dims, nullptr, nullptr, net)) return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  int per_sm, sms;
  const cudaError_t e =
      full_plan(net, p, n > 0 ? n : 1, rows, threads, ctas, stream, plan, per_sm, sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vals[11] = {plan.rows, plan.threads, plan.ctas, plan.stream, plan.global, plan.wa,
                        plan.wb, 4 * plan.shared_words, plan.global_words, per_sm, sms};
  for (int k = 0; k < 11; ++k) out[k] = vals[k];
  return 0;
}

extern "C" int mlp_predict_err_floor_launch(int p, int n, int layers, const int* dims, int rows,
                                            int threads, int ctas, int stream,
                                            void* stream_handle) {
  if (p == 0 || n == 0) return 0;
  Net net;
  if (!make_net(layers, dims, nullptr, nullptr, net))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  int per_sm, sms;
  cudaError_t e = full_plan(net, p, n, rows, threads, ctas, stream, plan, per_sm, sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  const size_t smem = 4 * static_cast<size_t>(plan.shared_words);
  e = allow_shared(2, smem, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  mlp_predict_err_floor_kernel<<<dim3(plan.ctas, p), plan.threads, smem,
                                 static_cast<cudaStream_t>(stream_handle)>>>();
  return static_cast<int>(cudaGetLastError());
}
