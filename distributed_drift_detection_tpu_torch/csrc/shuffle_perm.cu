// K13 — the in-loop shuffle: jax.random.permutation of every batch of a
// span, applied to the batch's planes in the same launch, bit for bit.
//
// Replaces the XLA-lowered permutation of the JAX package's engines under
// shuffle=True: engine/loop.py:289-297 (`perm = permutation(k_shuf, B)`,
// then b_X, b_y, b_rows, b_valid gathered through it) and
// engine/window.py:211-223 (`permutation(split(k_shuf, W)[i], B)` for window
// row i, then the window slice's planes gathered through it). jax 0.9.0's
// permutation of n places (`_shuffle` of arange(n)) runs
// ceil(3·ln(n)/ln(2^32 − 1)) rounds (0 at n = 1, 1 up to n = 1625, 2 from
// 1626) of `key, sub = split(key)`, 32 random bits of `sub` for each place
// and a stable sort of the places by their bits (lax.sort_key_val is
// stable). The plain version is ops/shuffle.py `shuffle_planes_reference`
// on utils/threefry.py `permutation` (torch.sort(stable=True)).
//
// For the CTA of (partition p, batch i < W): the batch's key is
// split(keys[p], W)[i] (derive: the window engine hands one k_shuf a
// partition) or keys[p, i] (the loop engine's k_shuf of each step); thread
// 0 runs the key chain of the rounds into shared memory. Each round sorts
// the 64-bit composites (bits << 32) | position with a bitonic network over
// B rounded up to a power of two, sentinels (all ones) in the padding:
// ordering by the position breaks every tie as a stable sort does, and the
// composites are distinct, so the network's lack of stability never shows.
// The round's order then composes with the permutation so far (kept beside
// the composites). Last, the CTA gathers the batch's planes through the
// permutation: the index plane (int16 or int32, written as int32), rows
// (int32) and valid (bytes), reading batch start[p] + i of the source
// planes [P, src_batches, B] — the window engine's slice at each lane's
// pointer, so the slice's gather costs nothing more.
//
// What bounds it. At the main path's shapes (B = 100, 16 partitions, one
// window of 128 batches a launch) a batch is 100 hashes (~69 integer
// operations each) and a 128-wide network of 28 stages of 64
// compare-exchanges, and moves 1.8 KB: microseconds of work spread over
// 2,048 CTAs, below an empty launch. So the design is one launch a span and
// one CTA a batch, all in shared memory up to kSharedItems composites
// (128 KB of them, plus the permutation: 192 KB); a larger B sorts the same
// way in a global scratch the wrapper allocates (`force` 1 takes that path
// at any B), so every per_batch RunConfig admits runs, without a refusal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kMaxRounds = 4;          // n < 2^32 needs at most 4
constexpr int kSharedItems = 16384;    // ops/shuffle.py K13_SHARED_ITEMS
constexpr int kMaxThreads = 1024;
constexpr unsigned long long kSentinel = ~0ull;

struct Args {
  const uint32_t* keys;  // [P, 2] (derive) or [P, W, 2]
  int derive;
  int width;  // W: batches a partition
  const void* idx;
  int idx_bytes;  // 2 or 4
  const int* rows;
  const uint8_t* valid;
  const long long* start;  // [P]: the span's first source batch (null: 0)
  int src_batches;         // batches a partition in the source planes
  int b;
  int npow2;
  int rounds;
  uint32_t tie_mask;
  int* out_idx;  // [P, W, B]
  int* out_rows;
  uint8_t* out_valid;
  unsigned long long* scratch;  // the global path: [P·W, npow2] composites
  int* scratch_perm;            // and [P·W, B] permutations
};

// Sort s[0 .. n2) ascending (n2 a power of two); ends with a barrier.
__device__ __forceinline__ void bitonic(unsigned long long* s, int n2) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n2 >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));  // t with a zero inserted at bit j
        const int l = i + j;
        const unsigned long long x = s[i], y = s[l];
        if ((x > y) == ((i & k) == 0)) {
          s[i] = y;
          s[l] = x;
        }
      }
      __syncthreads();
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads) shuffle_perm_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned long long smem[];
  __shared__ threefry::Pair subkeys[kMaxRounds];
  const int i = blockIdx.x, p = blockIdx.y;
  const long long batch = static_cast<long long>(p) * a.width + i;
  const int n = a.b;
  unsigned long long* comp;
  int* perm;
  if (kShared) {
    comp = smem;
    perm = reinterpret_cast<int*>(smem + a.npow2);
  } else {
    comp = a.scratch + batch * a.npow2;
    perm = a.scratch_perm + batch * n;
  }
  if (threadIdx.x == 0) {
    threefry::Pair k = a.derive
        ? threefry::split({a.keys[2 * p], a.keys[2 * p + 1]}, static_cast<uint32_t>(i))
        : threefry::Pair{a.keys[2 * batch], a.keys[2 * batch + 1]};
    for (int r = 0; r < a.rounds; ++r) {
      subkeys[r] = threefry::split(k, 1u);
      k = threefry::split(k, 0u);
    }
  }
  for (int m = threadIdx.x; m < n; m += blockDim.x) perm[m] = m;
  __syncthreads();
  for (int r = 0; r < a.rounds; ++r) {
    const threefry::Pair sub = subkeys[r];
    for (int m = threadIdx.x; m < a.npow2; m += blockDim.x) {
      comp[m] = m < n ? (static_cast<unsigned long long>(threefry::bits(sub, m) & a.tie_mask) << 32) |
                            static_cast<unsigned>(m)
                      : kSentinel;
    }
    __syncthreads();
    bitonic(comp, a.npow2);
    // place m of the new order holds the item at place low(comp[m]) of the old
    for (int m = threadIdx.x; m < n; m += blockDim.x) {
      const unsigned from = static_cast<unsigned>(comp[m]);
      comp[m] = static_cast<unsigned>(perm[from]);
    }
    __syncthreads();
    for (int m = threadIdx.x; m < n; m += blockDim.x) perm[m] = static_cast<int>(comp[m]);
    __syncthreads();
  }
  const long long s0 = a.start ? a.start[p] : 0;
  const long long src = (static_cast<long long>(p) * a.src_batches + s0 + i) * n;
  const long long dst = batch * n;
  for (int m = threadIdx.x; m < n; m += blockDim.x) {
    const long long from = src + perm[m];
    a.out_idx[dst + m] = a.idx_bytes == 2
                             ? static_cast<int>(static_cast<const int16_t*>(a.idx)[from])
                             : static_cast<const int*>(a.idx)[from];
    a.out_rows[dst + m] = a.rows[from];
    a.out_valid[dst + m] = a.valid[from];
  }
}

// An empty kernel: launched with K13's grid, block and shared memory, its
// time is the floor under K13's.
__global__ void shuffle_perm_floor_kernel() {}

struct Layout {
  bool shared;
  int npow2, threads;
  size_t shared_bytes;
};

bool layout(int p, int width, int b, int force, Layout* l) {
  if (p <= 0 || p > 65535 || width < 0 || b <= 0) return false;
  int n2 = 1;
  while (n2 < b) {
    if (n2 > (1 << 29)) return false;
    n2 <<= 1;
  }
  l->npow2 = n2;
  l->shared = force == 0 && n2 <= kSharedItems;
  l->threads = n2 / 2 < 32 ? 32 : (n2 / 2 > kMaxThreads ? kMaxThreads : n2 / 2);
  l->shared_bytes = l->shared ? static_cast<size_t>(n2) * 8 + static_cast<size_t>(b) * 4 : 0;
  return true;
}

}  // namespace

// keys: int32 words of [P, 2] (derive) or [P, W, 2]; idx [P, src_batches, B]
// of idx_bytes 2 or 4, rows int32 and valid bytes of the same shape; start
// [P] int64 or null; out_* [P, W, B]; scratch: null on the shared path,
// else P·W·(8·npow2 + 4·B) bytes.
extern "C" int shuffle_perm_launch(const int* keys, int derive, int p, int width,
                                   const void* idx, int idx_bytes, const int* rows,
                                   const unsigned char* valid, const long long* start,
                                   int src_batches, int b, int rounds, unsigned tie_mask,
                                   int force, int* out_idx, int* out_rows,
                                   unsigned char* out_valid, void* scratch, void* stream) {
  Layout l;
  if (!layout(p, width, b, force, &l) || (idx_bytes != 2 && idx_bytes != 4) || rounds < 0 ||
      rounds > kMaxRounds)
    return static_cast<int>(cudaErrorInvalidValue);
  if (width == 0) return 0;
  if (!l.shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.keys = reinterpret_cast<const uint32_t*>(keys);
  a.derive = derive;
  a.width = width;
  a.idx = idx;
  a.idx_bytes = idx_bytes;
  a.rows = rows;
  a.valid = valid;
  a.start = start;
  a.src_batches = src_batches;
  a.b = b;
  a.npow2 = l.npow2;
  a.rounds = rounds;
  a.tie_mask = tie_mask;
  a.out_idx = out_idx;
  a.out_rows = out_rows;
  a.out_valid = out_valid;
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.scratch_perm = l.shared ? nullptr
                            : reinterpret_cast<int*>(a.scratch + static_cast<long long>(p) *
                                                                     width * l.npow2);
  const dim3 grid(static_cast<unsigned>(width), static_cast<unsigned>(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l.shared) {
    if (l.shared_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          shuffle_perm_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(l.shared_bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    shuffle_perm_kernel<true><<<grid, l.threads, l.shared_bytes, s>>>(a);
  } else {
    shuffle_perm_kernel<false><<<grid, l.threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shuffle_perm_floor_launch(int p, int width, int b, int force, void* stream) {
  Layout l;
  if (!layout(p, width, b, force, &l)) return static_cast<int>(cudaErrorInvalidValue);
  if (width == 0) return 0;
  if (l.shared_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(shuffle_perm_floor_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(l.shared_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  shuffle_perm_floor_kernel<<<dim3(width, p), l.threads, l.shared_bytes,
                              static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
