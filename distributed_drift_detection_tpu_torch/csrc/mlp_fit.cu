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
// gradient below it is taken). XLA's summation order and the plain
// version's are other ones, so the fitted parameters agree with them to a
// tolerance (tests/test_torch_kernels.py), not to the bit. Every output
// has one fixed chain, which no design choice below may reorder or split:
// a forward output is one __fmaf_rn chain over its inputs in index order
// from +0, then + bias, then ReLU; a weight-gradient element one chain over
// the rows in order; a bias gradient one __fadd_rn chain over the rows; a
// backward-product element one chain over the layer's outputs in order
// (+0 where the activation is not positive); the softmax sum one chain over
// the classes; Σw one chain over the rows. So the fitted parameters do not
// depend on the cluster size or the tile shape: they are bit for bit those
// of the one-CTA kernel this design replaced (pinned by digest in
// chip_smoke.py and tests/test_torch_kernels.py).
//
// Bound on an H100 at the main path's shapes (P = 16, B = 100, F = 21,
// hidden (128, 64), C = 40, 32 steps): a step is ≈ 3.76 M multiply-adds a
// partition (the forward pass, the weight gradients and the two backward
// products), 3.85 GFLOP a launch, ≈ 57 us at the 67 TFLOP/s f32 rate; the
// bytes (the batch in, 13,672 parameters a partition out) are far less.
// The design:
//
// * A thread-block cluster of `cs` CTAs a partition (1, 2, 4 or 8; the
//   wrapper picks it, models/mlp.py `k9_launch_plan`: 4 at the main
//   path's shapes on an H100). CTA k owns a slice of every layer's output units
//   (`cut`: whole groups of 4): it computes those columns of the layer's
//   forward output, of its weight gradient and of its update, and keeps
//   their velocities; in the backward product of layer l it computes its
//   own slice of layer l − 1's units (rows of W_l). Every CTA holds a
//   replica of the parameters, the layer inputs and the activations; once
//   its block has computed a slice another CTA reads, it stores the slice
//   into that CTA's replica through distributed shared memory as float4s
//   (a remote store does not wait, a remote load would): each hidden
//   activation and the logits (the softmax then runs in every CTA), each
//   backward product's output that a lower backward product reads, and
//   once a step the rows of the updated weights that the other CTAs'
//   backward products read. Five cluster barriers a step at (128, 64) (see
//   the kernel); the last backward product's output and the first layer's
//   weights are never sent.
// * Register tiles of 4 × 4 outputs a thread in the three product loops,
//   every operand read as a float4 (row strides of 4 × an odd number of
//   floats, so 8 rows' float4s fall in 8 different bank quads): one shared
//   load for 8 fused multiply-adds, against the one-CTA kernel's 2 loads
//   for 1. Each accumulator is one output's chain.
// * The softmax by the whole block: a thread a row for the max and the
//   sum (each one ordered chain), all threads across float4s for the
//   exponentials and the outputs.
// * The workspace in shared memory (≈ 223 KB at the main path's shapes and
//   cs = 1, ≈ 210 KB at cs = 4, where the velocities are sliced), else —
//   a batch too large for any cluster size — in a global workspace the
//   wrapper allocates, with cs = 1 and the same code through generic
//   pointers.
// Measured (PERF.md §6): ≈ 0.98 ms a launch at the main path's shapes with
// 4 CTAs a partition, against 5.86 ms for the one-CTA kernel it replaced;
// the product loops still run latency-bound, with 1–8 warps a phase.
// No tensor cores: TF32 would round every product.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <vector>

#include "threefry.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kInlineLayers = 64;  // models/mlp.py INLINE_LAYERS
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxDevices = 64;
constexpr size_t kDefaultSmem = 48 * 1024;
// The product loops' steps unrolled this many times (4 ran faster than 1
// and 2 at every cluster size on an H100, PERF.md §6).
constexpr int kUnroll = 4;

// The net as the code reads it: its layers' widths, init factors and
// output pointers, viewed where they lie — on the host, the launcher's
// arrays; in the kernel, a __grid_constant__ NetArgs for up to
// kInlineLayers layers (a kernel's parameters are limited to 4 KB), else a
// device array the launcher fills (`net_desc_bytes`; the wrapper
// allocates it). The arithmetic does not depend on which.
struct Net {
  int layers;
  const int* dims;      // [layers + 1]
  const float* factor;  // [layers]
  float* const* w;      // [layers]
  float* const* b;      // [layers]
};

struct NetArgs {
  int dims[kInlineLayers + 1];
  float factor[kInlineLayers];
  float* w[kInlineLayers];
  float* b[kInlineLayers];
};

// The device array past kInlineLayers: w [L], b [L] pointers, then dims
// [L + 1] ints and factor [L] floats.
__host__ __device__ inline size_t net_desc_bytes(int layers) {
  return 2 * sizeof(float*) * layers + sizeof(int) * (layers + 1) + sizeof(float) * layers;
}

// kDesc: the layers in `desc`, else in `args` — a view the compiler
// resolves to the parameter space, so ≤ kInlineLayers layers are read as
// the __grid_constant__ struct's fields.
template <bool kDesc>
__device__ __forceinline__ Net device_net(int layers, const NetArgs& args, const void* desc) {
  if (!kDesc) return Net{layers, args.dims, args.factor, args.w, args.b};
  float* const* w = static_cast<float* const*>(desc);
  const int* dims = reinterpret_cast<const int*>(w + 2 * layers);
  return Net{layers, dims, reinterpret_cast<const float*>(dims + layers + 1), w, w + layers};
}

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
// A row stride for n floats: at least r4(n), and 4 times an odd number, so
// float4 reads of 8 rows fall in 8 different bank quads.
__host__ __device__ inline int pad4(int n) { return ((r4(n) / 4) | 1) * 4; }
// CTA k's units of a layer of n: [cut(n, k, cs), cut(n, k + 1, cs)), whole
// groups of 4 (the last may be short), so a slice starts on a float4.
__host__ __device__ inline int cut(int n, int k, int cs) {
  return min(n, 4 * (k * cdiv(n, 4) / cs));
}
// The CTA whose slice of n holds unit c.
__host__ __device__ inline int owner(int c, int n, int cs) {
  return ((c / 4 + 1) * cs - 1) / cdiv(n, 4);
}

// A CTA's workspace, in floats (`mlp_fit_words`): its header (9 ints a
// layer and 6, rounded up to 4: sized by the net's own layers, read by
// layer index from the workspace without local memory), each
// layer's w [din][pad4(dout)] and b [dout], the velocities of the CTA's
// columns (vw [din][v], vb [v], v the widest slice), each layer's output
// [B][pad4(dout)] (the hidden activations, then the logits), with cs > 1
// a gradient buffer [B][pad4(dout)] for each hidden layer but the
// first (their gradients are exchanged while the activations are still
// read; with cs = 1, and for the first hidden layer, a gradient replaces
// its activations in place), a float a row (each row's max, then its
// softmax coefficient), the rows [B][pad4(F)], the labels and the
// normalised weights; every region rounded up to 4.
// The header: 9 arrays of an int a layer, then 6 ints.
enum Field { kLdw, kW, kB, kLdv, kVw, kVb, kLdh, kAct, kGrad, kArrays };
enum Scalar { kRow, kLdx, kX, kY, kWn, kTotal, kScalars };

__host__ __device__ inline int header_words(int layers) { return r4(kArrays * layers + kScalars); }

// A view of a header of `layers` layers.
struct Layout {
  const int* h;
  int layers;
  __host__ __device__ int at(Field f, int l) const { return h[f * layers + l]; }
  __host__ __device__ int at(Scalar s) const { return h[kArrays * layers + s]; }
  __host__ __device__ int ldw(int l) const { return at(kLdw, l); }
  __host__ __device__ int w(int l) const { return at(kW, l); }
  __host__ __device__ int b(int l) const { return at(kB, l); }
  __host__ __device__ int ldv(int l) const { return at(kLdv, l); }
  __host__ __device__ int vw(int l) const { return at(kVw, l); }
  __host__ __device__ int vb(int l) const { return at(kVb, l); }
  __host__ __device__ int ldh(int l) const { return at(kLdh, l); }
  __host__ __device__ int act(int l) const { return at(kAct, l); }
  __host__ __device__ int grad(int l) const { return at(kGrad, l); }
  __host__ __device__ int row() const { return at(kRow); }
  __host__ __device__ int ldx() const { return at(kLdx); }
  __host__ __device__ int x() const { return at(kX); }
  __host__ __device__ int y() const { return at(kY); }
  __host__ __device__ int wn() const { return at(kWn); }
};

// Writes the header into h (when not null); returns the total.
__host__ __device__ inline int layout(const Net& net, int rows, int cs, int* h) {
  const int L = net.layers;
  auto put = [&](int at, int v) {
    if (h != nullptr) h[at] = v;
  };
  int off = header_words(L);
  for (int l = 0; l < L; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1], ldw = pad4(dout);
    put(kLdw * L + l, ldw);
    put(kW * L + l, off);
    off += r4(din * ldw);
    put(kB * L + l, off);
    off += r4(dout);
  }
  for (int l = 0; l < L; ++l) {
    const int din = net.dims[l], ldv = 4 * cdiv(cdiv(net.dims[l + 1], 4), cs);
    put(kLdv * L + l, ldv);
    put(kVw * L + l, off);
    off += r4(din * ldv);
    put(kVb * L + l, off);
    off += r4(ldv);
  }
  for (int l = 0; l < L; ++l) {
    const int ldh = pad4(net.dims[l + 1]);
    put(kLdh * L + l, ldh);
    put(kAct * L + l, off);
    put(kGrad * L + l, off);
    off += r4(rows * ldh);
  }
  for (int l = 1; l < L - 1 && cs > 1; ++l) {
    put(kGrad * L + l, off);
    off += r4(rows * pad4(net.dims[l + 1]));
  }
  const int ldx = pad4(net.dims[0]);
  put(kArrays * L + kRow, off);
  off += r4(rows);
  put(kArrays * L + kLdx, ldx);
  put(kArrays * L + kX, off);
  off += r4(rows * ldx);
  put(kArrays * L + kY, off);
  off += r4(rows);
  put(kArrays * L + kWn, off);
  off += r4(rows);
  put(kArrays * L + kTotal, off);
  return off;
}

// The three product loops. Every output is one fused multiply-add chain
// over t in order from +0, handed to epi(m, n, value); a thread computes a
// tile of 4 × 4 outputs, reading each operand as a float4 (16-byte aligned:
// row strides and slice starts are multiples of 4 floats), so a loop takes
// one shared load for 8 multiply-adds. Out-of-range rows read the last
// valid one, out-of-range columns a row's padding; neither is handed on.

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

// out(m, n) = Σ_t A[m·lda + t]·B[t·ldb + n], m < M, n0 <= n < n1 (the
// forward product: A the layer input, B its weights). Tile (tm, tn) of a
// gm × gn grid: rows tm + gm·p, columns n0 + 4·tn + q; A read four steps
// at a time.
template <class Epi>
__device__ __forceinline__ void forward_tiles(int M, int n0, int n1, int T, const float* A,
                                              int lda, const float* B, int ldb, Epi epi) {
  if (n1 <= n0 || M <= 0) return;
  const int gn = cdiv(n1 - n0, 4), gm = cdiv(M, 4), t4 = T & ~3;
  for (int tile = threadIdx.x; tile < gm * gn; tile += kThreads) {
    const int tm = tile / gn, tn = tile - tm * gn;
    const float* a[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) a[p] = A + min(tm + gm * p, M - 1) * lda;
    const float* b = B + n0 + 4 * tn;
    float acc[4][4] = {};
    int t = 0;
#pragma unroll kUnroll
    for (; t < t4; t += 4) {
      float4 av[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) av[p] = load4(a[p] + t);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 bv = load4(b + (t + u) * ldb);
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[p][q] = __fmaf_rn(lane4(av[p], u), lane4(bv, q), acc[p][q]);
      }
    }
    for (; t < T; ++t) {
      const float4 bv = load4(b + t * ldb);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = __fmaf_rn(a[p][t], lane4(bv, q), acc[p][q]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = tm + gm * p, n = n0 + 4 * tn + q;
        if (m < M && n < n1) epi(m, n, acc[p][q]);
      }
  }
}

// out(m, n) = Σ_t A[t·lda + m]·B[t·ldb + n], m < M, n0 <= n < n1 (a weight
// gradient: t the batch rows, A the layer input, B its output's gradient).
// Tile (tm, tn): rows 4·tm + p, columns n0 + 4·tn + q; a float4 of each
// operand a step.
template <class Epi>
__device__ __forceinline__ void gradient_tiles(int M, int n0, int n1, int T, const float* A,
                                               int lda, const float* B, int ldb, Epi epi) {
  if (n1 <= n0 || M <= 0) return;
  const int gn = cdiv(n1 - n0, 4), gm = cdiv(M, 4);
  for (int tile = threadIdx.x; tile < gm * gn; tile += kThreads) {
    const int tm = tile / gn, tn = tile - tm * gn;
    const float* a = A + 4 * tm;
    const float* b = B + n0 + 4 * tn;
    float acc[4][4] = {};
#pragma unroll kUnroll
    for (int t = 0; t < T; ++t) {
      const float4 av = load4(a + t * lda), bv = load4(b + t * ldb);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[p][q] = __fmaf_rn(lane4(av, p), lane4(bv, q), acc[p][q]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = 4 * tm + p, n = n0 + 4 * tn + q;
        if (m < M && n < n1) epi(m, n, acc[p][q]);
      }
  }
}

// out(m, n) = Σ_t A[m·lda + t]·B[n·ldb + t], m < M, n0 <= n < n1 (a
// backward product: A the layer output's gradient, B the layer's weights,
// n a unit of the layer below). Tile (tm, tn): rows tm + gm·p, columns
// n0 + tn + gn·q; both read four steps at a time.
template <class Epi>
__device__ __forceinline__ void backward_tiles(int M, int n0, int n1, int T, const float* A,
                                               int lda, const float* B, int ldb, Epi epi) {
  if (n1 <= n0 || M <= 0) return;
  const int gn = cdiv(n1 - n0, 4), gm = cdiv(M, 4), t4 = T & ~3;
  for (int tile = threadIdx.x; tile < gm * gn; tile += kThreads) {
    const int tm = tile / gn, tn = tile - tm * gn;
    const float* a[4];
    const float* b[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) a[p] = A + min(tm + gm * p, M - 1) * lda;
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = B + min(n0 + tn + gn * q, n1 - 1) * ldb;
    float acc[4][4] = {};
    int t = 0;
#pragma unroll kUnroll
    for (; t < t4; t += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) av[p] = load4(a[p] + t);
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = load4(b[q] + t);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[p][q] = __fmaf_rn(lane4(av[p], u), lane4(bv[q], u), acc[p][q]);
    }
    for (; t < T; ++t)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = __fmaf_rn(a[p][t], b[q][t], acc[p][q]);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = tm + gm * p, n = n0 + tn + gn * q;
        if (m < M && n < n1) epi(m, n, acc[p][q]);
      }
  }
}

// This CTA's columns [c0, c1) of rows [0, rows) of buf (row stride ld),
// copied into the same place in the other cs − 1 CTAs' workspaces as
// float4s (c0 and ld are multiples of 4; a last short group carries the
// row's padding along).
__device__ __forceinline__ void send_slice(cg::cluster_group& cluster, int cs, int rank,
                                           float* buf, int ld, int rows, int c0, int c1) {
  const int groups = cdiv(c1 - c0, 4), n = rows * groups;
  for (int k = 1; k < cs; ++k) {
    float* dst = cluster.map_shared_rank(buf, (rank + k) & (cs - 1));
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e / groups, at = r * ld + c0 + 4 * (e - r * groups);
      *reinterpret_cast<float4*>(dst + at) = load4(buf + at);
    }
  }
}

// This CTA's columns of W [din][ldw] (a layer of dout units), row i sent
// to the CTA that owns unit i of the layer below, whose backward product
// reads that row; as float4s, like send_slice.
__device__ __forceinline__ void push_rows(cg::cluster_group& cluster, int cs, int rank, float* W,
                                          int ldw, int din, int dout) {
  const int j0 = cut(dout, rank, cs), groups = cdiv(cut(dout, rank + 1, cs) - j0, 4);
  for (int e = threadIdx.x; e < din * groups; e += kThreads) {
    const int i = e / groups, to = owner(i, din, cs);
    if (to == rank) continue;
    float* src = W + i * ldw + j0 + 4 * (e - i * groups);
    *reinterpret_cast<float4*>(cluster.map_shared_rank(src, to)) = load4(src);
  }
}

// The logits' gradient of rows [0, rows) (row stride ld, a multiple of 4),
// in place: d = g + e·(−Σg / Σe), g = −wn·onehot, e = exp(logits − max). A
// thread a row for the max and for the sum (each in class order, as one
// chain; `rowv` holds a row's max, then its coefficient), the block's
// threads across the rows' float4s for the exponentials and the outputs (a
// row's padding is carried along and never read).
__device__ __forceinline__ void softmax_grad(float* lg, int ld, int rows, int c, const int* ys,
                                             const float* wn, float* rowv) {
  const int tid = threadIdx.x, groups = cdiv(c, 4);
  for (int r = tid; r < rows; r += kThreads) {
    const float* row = lg + r * ld;
    float m = row[0];
    for (int g = 0; g < groups; ++g) {
      const float4 v = load4(row + 4 * g);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * g + u < c) m = fmaxf(m, lane4(v, u));
    }
    rowv[r] = m;
  }
  __syncthreads();
  for (int e = tid; e < rows * groups; e += kThreads) {
    const int r = e / groups;
    float* at = lg + r * ld + 4 * (e - r * groups);
    float4 v = load4(at);
    const float m = rowv[r];
#pragma unroll
    for (int u = 0; u < 4; ++u) ref4(v, u) = expf(__fsub_rn(ref4(v, u), m));
    store4(at, v);
  }
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads) {
    const float* row = lg + r * ld;
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) {
      const float4 v = load4(row + 4 * g);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * g + u < c) s = __fadd_rn(s, lane4(v, u));
    }
    const int yr = ys[r];
    const float g_sum = (yr >= 0 && yr < c) ? -wn[r] : 0.0f;
    rowv[r] = __fdiv_rn(-g_sum, s);
  }
  __syncthreads();
  for (int e = tid; e < rows * groups; e += kThreads) {
    const int r = e / groups, k0 = 4 * (e - r * groups);
    float* at = lg + r * ld + k0;
    float4 v = load4(at);
    const float coef = rowv[r], g_y = -wn[r];
    const int yr = ys[r];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      ref4(v, u) = __fadd_rn(k0 + u == yr ? g_y : -0.0f, __fmul_rn(ref4(v, u), coef));
    store4(at, v);
  }
}

// A barrier of the partition's CTAs: after it, what each wrote or sent
// before it is visible to all.
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster, int cs) {
  if (cs > 1)
    cluster.sync();
  else
    __syncthreads();
}

// kShared: the workspace in shared memory (so the compiler emits shared
// loads), else in `scratch` with cs = 1. kDesc: past kInlineLayers, the
// layers in the device array `desc` (`device_net`).
//
// The exchange: a CTA sends each output another CTA reads into that CTA's
// workspace once its block has written it (`send_slice`, `push_rows`),
// and a cluster barrier later the receiver reads it. Per step: barrier C
// (every CTA is past the previous step, so no replica is still being
// read; then the weight rows of layer 1, and at step 0 of every layer, go
// out), a barrier after each layer's forward output, and one after the
// backward product of each layer l >= 2 (its output, the gradient of a
// hidden layer, is complete; then layer l's updated weight rows go out). A
// value is sent only after the barrier behind its receiver's last read of
// the value it replaces (tests/test_torch_mlp.py
// `test_k9_cluster_dataflow_model` checks this schedule).
template <bool kShared, bool kDesc>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_fit_kernel(const uint32_t* keys, const float* X, const int* y, const float* w,
                   int rows, int layers, const __grid_constant__ NetArgs args,
                   const void* desc, int steps, float lr, float mom, float* scratch,
                   int cluster_ctas) {
  extern __shared__ float4 smem4[];
  const Net net = device_net<kDesc>(layers, args, desc);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = kShared ? cluster_ctas : 1;
  const int rank = cs > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int part = blockIdx.x / cs;
  float* ws = kShared ? reinterpret_cast<float*>(smem4)
                      : scratch + static_cast<size_t>(part) * layout(net, rows, 1, nullptr);
  if (threadIdx.x == 0) layout(net, rows, cs, reinterpret_cast<int*>(ws));
  __syncthreads();
  const Layout lay{reinterpret_cast<const int*>(ws), net.layers};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, n_layers = net.layers;
  const int f = net.dims[0], c = net.dims[n_layers];
  float* xs = ws + lay.x();
  int* ys = reinterpret_cast<int*>(ws + lay.y());
  float* wn = ws + lay.wn();
  float* lg = ws + lay.act(n_layers - 1);

  // The batch, and wn = w / max(Σw, 1) (a sum of {0, 1}: exact in any order).
  const float* Xp = X + static_cast<size_t>(part) * rows * f;
  for (int r = warp; r < rows; r += kWarps)
    for (int i = lane; i < f; i += 32) xs[r * lay.ldx() + i] = Xp[r * f + i];
  for (int r = tid; r < rows; r += kThreads) {
    ys[r] = y[part * rows + r];
    wn[r] = w[part * rows + r];
  }
  __syncthreads();
  float wsum = 0.0f;
  for (int r = 0; r < rows; ++r) wsum = __fadd_rn(wsum, wn[r]);
  wsum = fmaxf(wsum, 1.0f);
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads) wn[r] = __fdiv_rn(wn[r], wsum);

  // init(key) of the CTA's columns: layer l's weights from
  // split(key, layers)[l] (element (i, j) is normal number i·dout + j),
  // zero biases and velocities.
  const threefry::Pair key{keys[2 * part], keys[2 * part + 1]};
  for (int l = 0; l < n_layers; ++l) {
    const threefry::Pair kl = threefry::split(key, static_cast<uint32_t>(l));
    const int din = net.dims[l], dout = net.dims[l + 1];
    const int j0 = cut(dout, rank, cs), ns = cut(dout, rank + 1, cs) - j0;
    float* W = ws + lay.w(l);
    float* vW = ws + lay.vw(l);
    for (int i = warp; i < din; i += kWarps)
      for (int jj = lane; jj < ns; jj += 32) {
        const int j = j0 + jj;
        W[i * lay.ldw(l) + j] = threefry::normal(kl, static_cast<uint64_t>(i) * dout + j,
                                                 net.factor[l]);
        vW[i * lay.ldv(l) + jj] = 0.0f;
      }
    for (int jj = tid; jj < ns; jj += kThreads) {
      ws[lay.b(l) + j0 + jj] = 0.0f;
      ws[lay.vb(l) + jj] = 0.0f;
    }
  }
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    // C: every CTA is past the previous step
    cluster_barrier(cluster, cs);
    if (cs > 1) {
      for (int l = 1; l < n_layers; ++l)
        if (l == 1 || step == 0)
          push_rows(cluster, cs, rank, ws + lay.w(l), lay.ldw(l), net.dims[l], net.dims[l + 1]);
    }

    // Forward: out = in·W + b, ReLU on the hidden layers; each CTA its
    // columns, then sent to every CTA.
    for (int l = 0; l < n_layers; ++l) {
      const int din = net.dims[l], dout = net.dims[l + 1];
      const int j0 = cut(dout, rank, cs), j1 = cut(dout, rank + 1, cs);
      const float* in = l == 0 ? xs : ws + lay.act(l - 1);
      const int ldi = l == 0 ? lay.ldx() : lay.ldh(l - 1);
      const float* W = ws + lay.w(l);
      const float* bias = ws + lay.b(l);
      float* out = ws + lay.act(l);
      const int ldo = lay.ldh(l);
      const bool hidden = l < n_layers - 1;
      forward_tiles(rows, j0, j1, din, in, ldi, W, lay.ldw(l), [&](int m, int n, float v) {
        const float z = __fadd_rn(v, bias[n]);
        out[m * ldo + n] = hidden ? fmaxf(z, 0.0f) : z;
      });
      if (cs > 1) {
        __syncthreads();
        send_slice(cluster, cs, rank, out, ldo, rows, j0, j1);
      }
      cluster_barrier(cluster, cs);
    }

    softmax_grad(lg, lay.ldh(n_layers - 1), rows, c, ys, wn, ws + lay.row());
    __syncthreads();

    // Backward, from the last layer down.
    for (int l = n_layers - 1; l >= 0; --l) {
      const int din = net.dims[l], dout = net.dims[l + 1];
      const int j0 = cut(dout, rank, cs), j1 = cut(dout, rank + 1, cs), ns = j1 - j0;
      const float* in = l == 0 ? xs : ws + lay.act(l - 1);
      const int ldi = l == 0 ? lay.ldx() : lay.ldh(l - 1);
      const float* d = ws + lay.grad(l);
      const int ldd = lay.ldh(l), ldw = lay.ldw(l), ldv = lay.ldv(l);
      float* W = ws + lay.w(l);
      float* bias = ws + lay.b(l);
      float* vW = ws + lay.vw(l);
      float* vb = ws + lay.vb(l);
      // the gradient of the CTA's columns into their velocity:
      // vel = m·vel − lr·inᵀd (W unchanged); the bias gradients on the
      // block's last threads
      gradient_tiles(din, j0, j1, rows, in, ldi, d, ldd, [&](int m, int n, float g) {
        float* v = vW + m * ldv + (n - j0);
        *v = __fsub_rn(__fmul_rn(mom, *v), __fmul_rn(lr, g));
      });
      for (int jj = kThreads - 1 - tid; jj < ns; jj += kThreads) {
        float g = 0.0f;
        for (int r = 0; r < rows; ++r) g = __fadd_rn(g, d[r * ldd + j0 + jj]);
        vb[jj] = __fsub_rn(__fmul_rn(mom, vb[jj]), __fmul_rn(lr, g));
      }
      __syncthreads();
      // the CTA's units of the layer below: their gradient, from the old W,
      // over their activations; sent to every CTA where a lower backward
      // product reads it whole
      if (l > 0) {
        const int below = net.dims[l];
        const float* h = ws + lay.act(l - 1);
        float* g_out = ws + lay.grad(l - 1);
        const int ldh = lay.ldh(l - 1), i0 = cut(below, rank, cs), i1 = cut(below, rank + 1, cs);
        backward_tiles(rows, i0, i1, dout, d, ldd, W, ldw, [&](int m, int n, float g) {
          g_out[m * ldh + n] = h[m * ldh + n] > 0.0f ? g : 0.0f;
        });
        __syncthreads();
        if (cs > 1 && l >= 2) send_slice(cluster, cs, rank, g_out, ldh, rows, i0, i1);
      }
      // p = p + vel on the CTA's columns (the next phase touches other
      // memory), a float4 of a row at a time
      const int groups = cdiv(ns, 4);
      for (int e = tid; e < din * groups; e += kThreads) {
        const int i = e / groups, g = e - i * groups;
        float4 wv = load4(W + i * ldw + j0 + 4 * g);
        const float4 vv = load4(vW + i * ldv + 4 * g);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * g + u < ns) ref4(wv, u) = __fadd_rn(ref4(wv, u), lane4(vv, u));
        store4(W + i * ldw + j0 + 4 * g, wv);
      }
      for (int jj = tid; jj < ns; jj += kThreads)
        bias[j0 + jj] = __fadd_rn(bias[j0 + jj], vb[jj]);
      if (cs > 1 && l >= 2) {
        // the gradient sent above is complete everywhere, and no CTA reads
        // layer l's weight rows again this step
        cluster.sync();
        push_rows(cluster, cs, rank, W, ldw, din, dout);
      }
    }
  }
  __syncthreads();

  for (int l = 0; l < n_layers; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const int j0 = cut(dout, rank, cs), ns = cut(dout, rank + 1, cs) - j0;
    float* wo = net.w[l] + static_cast<size_t>(part) * din * dout;
    for (int i = warp; i < din; i += kWarps)
      for (int jj = lane; jj < ns; jj += 32)
        wo[i * dout + j0 + jj] = ws[lay.w(l) + i * lay.ldw(l) + j0 + jj];
    for (int jj = tid; jj < ns; jj += kThreads)
      net.b[l][static_cast<size_t>(part) * dout + j0 + jj] = ws[lay.b(l) + j0 + jj];
  }
  // no CTA leaves while another may still send into its shared memory
  if (cs > 1) cluster.sync();
}

// An empty kernel: launched with K9's grid, cluster, block and shared
// memory, its time is the floor under K9's.
__global__ void mlp_fit_floor_kernel() {}

std::atomic<int> g_optin[kMaxDevices];  // 0: not read yet
std::atomic<int> g_raised[2][kMaxDevices];  // mlp_fit_kernel<true, kDesc>: [kDesc]
std::atomic<int> g_floor_raised[kMaxDevices];

// Shared memory for a launch whose workspace is not global: the layout's
// bytes, with `kernel`'s limit raised once per (device, size) above 48 KB.
cudaError_t shared_bytes(const Net& net, int rows, int cs, const void* kernel,
                         std::atomic<int>* raised, size_t& smem) {
  smem = 4 * static_cast<size_t>(layout(net, rows, cs, nullptr));
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

// A view of the launcher's host arrays (factors, w_out and b_out may be
// null where only the widths are read).
bool make_net(int layers, const int* dims, const float* factors, void* const* w_out,
              void* const* b_out, Net& net) {
  if (layers < 1) return false;
  net = Net{layers, dims, factors, reinterpret_cast<float* const*>(w_out),
            reinterpret_cast<float* const*>(b_out)};
  return true;
}

// The kernel's copy of `net`: the NetArgs for up to kInlineLayers layers;
// past that the same fields written to the device array `desc` (on the
// launch's stream; a pageable copy, so `net`'s arrays may go once this
// returns). Returns a CUDA error code.
cudaError_t device_args(const Net& net, void* desc, void* stream, NetArgs& args) {
  args = NetArgs{};
  const int L = net.layers;
  if (L <= kInlineLayers) {
    for (int l = 0; l <= L; ++l) args.dims[l] = net.dims[l];
    for (int l = 0; l < L; ++l) {
      args.factor[l] = net.factor[l];
      args.w[l] = net.w[l];
      args.b[l] = net.b[l];
    }
    return cudaSuccess;
  }
  if (desc == nullptr) return cudaErrorInvalidValue;
  std::vector<unsigned char> host(net_desc_bytes(L));
  float** w = reinterpret_cast<float**>(host.data());
  int* dims = reinterpret_cast<int*>(w + 2 * L);
  float* factor = reinterpret_cast<float*>(dims + L + 1);
  for (int l = 0; l < L; ++l) {
    w[l] = net.w[l];
    w[L + l] = net.b[l];
    factor[l] = net.factor[l];
  }
  for (int l = 0; l <= L; ++l) dims[l] = net.dims[l];
  return cudaMemcpyAsync(desc, host.data(), host.size(), cudaMemcpyHostToDevice,
                         static_cast<cudaStream_t>(stream));
}

bool valid_cs(int cs) { return cs == 1 || cs == 2 || cs == 4 || cs == kMaxCluster; }

cudaLaunchConfig_t launch_config(int p, int cs, size_t smem, void* stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p) * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// `dims`, `factors`, `w_out` and `b_out` are host arrays (layers + 1,
// layers, layers, layers); `desc` a device array of net_desc_bytes(layers)
// when layers > kInlineLayers, else null; `scratch` is a global workspace
// of [p, words] floats (cs must be 1), or null to keep the workspace in
// shared memory; `cs` CTAs a partition, one cluster each (1, 2, 4 or 8).
// Returns a CUDA error code: a refused cluster launch is returned, never
// worked around.
extern "C" int mlp_fit_launch(const int* keys, const float* X, const int* y, const float* w,
                              int p, int rows, int layers, const int* dims, const float* factors,
                              int steps, float lr, float mom, void* const* w_out,
                              void* const* b_out, void* desc, float* scratch, int cs,
                              void* stream) {
  if (p == 0) return 0;
  Net net;
  if (!make_net(layers, dims, factors, w_out, b_out, net) || !valid_cs(cs) ||
      (scratch != nullptr && cs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  NetArgs args;
  const cudaError_t ea = device_args(net, desc, stream, args);
  if (ea != cudaSuccess) return static_cast<int>(ea);
  const bool deep = layers > kInlineLayers;
  const auto kernel = scratch == nullptr
                          ? (deep ? mlp_fit_kernel<true, true> : mlp_fit_kernel<true, false>)
                          : (deep ? mlp_fit_kernel<false, true> : mlp_fit_kernel<false, false>);
  size_t smem = 0;
  if (scratch == nullptr) {
    const cudaError_t e = shared_bytes(net, rows, cs, reinterpret_cast<const void*>(kernel),
                                       g_raised[deep], smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(p, cs, smem, stream, attr);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, reinterpret_cast<const uint32_t*>(keys), X, y, w, rows,
                         layers, args, deep ? desc : nullptr, steps, lr, mom, scratch, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The floats of one CTA's workspace with `cs` CTAs a partition of [rows]
// × dims (the layout's total), into *out: the size of the shared memory a
// launch takes and, at cs = 1, of a partition's global workspace.
extern "C" int mlp_fit_words(int rows, int layers, const int* dims, int cs, int* out) {
  Net net;
  if (!make_net(layers, dims, nullptr, nullptr, nullptr, net) || !valid_cs(cs))
    return static_cast<int>(cudaErrorInvalidValue);
  *out = layout(net, rows, cs, nullptr);
  return 0;
}

// The most clusters of `cs` CTAs with the shared-memory workspace of
// [rows] × dims that the current device holds at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int mlp_fit_max_clusters(int rows, int layers, const int* dims, int cs, int* out) {
  Net net;
  if (!make_net(layers, dims, nullptr, nullptr, nullptr, net) || !valid_cs(cs))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const bool deep = layers > kInlineLayers;
  const auto kernel = deep ? mlp_fit_kernel<true, true> : mlp_fit_kernel<true, false>;
  cudaError_t e = shared_bytes(net, rows, cs, reinterpret_cast<const void*>(kernel),
                               g_raised[deep], smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(cs, cs, smem, nullptr, attr);
  e = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  return static_cast<int>(e);
}

extern "C" int mlp_fit_floor_launch(int p, int rows, int layers, const int* dims, int cs,
                                    void* stream) {
  if (p == 0) return 0;
  Net net;
  if (!make_net(layers, dims, nullptr, nullptr, nullptr, net) || !valid_cs(cs))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (4 * static_cast<size_t>(layout(net, rows, cs, nullptr)) <= 232448) {
    const cudaError_t e = shared_bytes(net, rows, cs,
                                       reinterpret_cast<const void*>(mlp_fit_floor_kernel),
                                       g_floor_raised, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(p, cs, smem, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mlp_fit_floor_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
