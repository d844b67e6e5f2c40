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
// Batch (partition p, batch i < W): its key is split(keys[p], W)[i]
// (derive: the window engine hands one k_shuf a partition) or keys[p, i]
// (the loop engine's k_shuf of each step). Each round sorts the 64-bit
// composites (bits << 32) | position with a bitonic network over B rounded
// up to a power of two, sentinels (all ones) in the padding: ordering by
// the position breaks every tie as a stable sort does, and the composites
// are distinct, so any correct sort gives the stable order. The round's
// order then composes with the permutation so far. Last, the batch's
// planes are gathered through the permutation: the index plane (int16 or
// int32, written as int32), rows (int32) and valid (bytes), reading batch
// start[p] + i of the source planes [P, src_batches, B] — the window
// engine's slice at each lane's pointer, so the slice's gather costs
// nothing more.
//
// What bounds it. At the window engine's shapes (B = 100, 16 partitions, a
// window of 128 batches a launch) a batch is 100 hashes (~69 integer
// operations each), a 128-wide network of 28 stages, and 1.8 KB moved:
// microseconds of work over 2,048 batches, latency-bound. So a batch's
// work stays in one warp's registers (the warp path, B up to kWarpItems):
// lane l holds the K = npow2 / 32 composites of places l·K .. l·K + K − 1
// (B below 32 rounds the network up to 32), a stage of stride j < K
// compare-exchanges a lane's own registers, one of stride j ≥ K exchanges
// with lane l ^ (j / K) through __shfl_xor_sync; no block barrier, no
// shared memory for the sort. A warp's loads go first: its key, its
// lane's start and its source row (lane l loads places l + 32·q), so the
// row is in flight while the lanes hash the batch's key chain in step (the
// derived key once a warp, each round's split beside it) and their own K
// draws, which are independent, so their hashes overlap. The sorted
// composites' low words are the permutation (one round); the permutation
// and the row go to the warp's slice of shared memory, and the gather reads
// them there in place order, so its stores coalesce. A CTA holds
// kWarpsPerCta warps of one partition's row of batches.
// Up to kSharedItems (the CTA path) a CTA sorts a batch the same way, K =
// 16 composites a thread to a width of 4096 and 32 beyond (the faster of
// the two at each width on an H100), and only the stages whose
// stride crosses warps go through shared memory, two barriers each; two
// rounds (B ≥ 1626) compose there. A larger B sorts in a global scratch
// the wrapper allocates, a CTA a batch with a block barrier a stage
// (`force` 1 takes that path at any B), so every per_batch RunConfig admits
// runs, without a refusal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kMaxRounds = 4;          // n < 2^32 needs at most 4
constexpr int kWarpItems = 1024;       // ops/shuffle.py K13_WARP_ITEMS
constexpr int kSharedItems = 16384;    // ops/shuffle.py K13_SHARED_ITEMS
constexpr int kWarpsPerCta = 4;        // ops/shuffle.py K13_WARPS
constexpr int kCtaWide = 4096;         // the CTA path: 16 composites a thread to this
                                       // width, 32 beyond (ops/shuffle.py K13_CTA_WIDE)
constexpr int kCtaThreads = 512;       // its most threads a CTA
constexpr int kMaxThreads = 1024;      // the global path's CTA
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kSentinel = ~0ull;

enum Path { kWarp = 0, kCta = 1, kGlobal = 2 };

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

// A place's slot in a padded shared array: one slot skipped every 32, so a
// warp's blocked stores (stride K) and place-order loads hit distinct banks.
__device__ __forceinline__ unsigned pad(unsigned e) { return e + (e >> 5); }

__device__ __forceinline__ threefry::Pair batch_key(const Args& a, int p, int i,
                                                    long long batch) {
  return a.derive
             ? threefry::split({a.keys[2 * p], a.keys[2 * p + 1]}, static_cast<uint32_t>(i))
             : threefry::Pair{a.keys[2 * batch], a.keys[2 * batch + 1]};
}

// Round r's subkey from the chain's key k, and k moved on: split(k, 1) and
// split(k, 0). Lanes hash split(k, lane & 1) side by side and share both;
// the last round needs split(k, 1) alone.
__device__ __forceinline__ threefry::Pair round_key(threefry::Pair* k, bool last,
                                                    unsigned lane) {
  if (last) return threefry::split(*k, 1u);
  const threefry::Pair h = threefry::split(*k, lane & 1u);
  *k = {__shfl_sync(kFull, h.a, 0), __shfl_sync(kFull, h.b, 0)};
  return {__shfl_sync(kFull, h.a, 1), __shfl_sync(kFull, h.b, 1)};
}

// The composites of places e0 .. e0 + K − 1 for a round's subkey. Every
// place is hashed, the padding's too, so the K hashes are one block of
// independent chains that overlap.
template <int K>
__device__ __forceinline__ void draw(unsigned long long (&v)[K], threefry::Pair sub,
                                     unsigned e0, int n, uint32_t tie_mask) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const unsigned e = e0 + r;
    const unsigned long long c =
        (static_cast<unsigned long long>(threefry::bits(sub, e) & tie_mask) << 32) | e;
    v[r] = static_cast<int>(e) < n ? c : kSentinel;
  }
}

// The stages of merge level k (the bitonic network's block size) whose
// stride j is below 32·K, on the K composites of places e0 .. e0 + K − 1 a
// lane holds (e0 = the lane's first place, a multiple of K): stride j < K
// in the lane's registers, j ≥ K with lane ^ (j / K). Place e keeps the
// smaller of itself and its partner e ^ j when (e & j == 0) == (e & k ==
// 0), i.e. ascending in blocks of k with e & k clear, descending in the
// others. Two composites are equal only as sentinels, so "greater" is
// "not less" (one 64-bit compare a pair).
template <int K>
__device__ __forceinline__ void warp_merge(unsigned long long (&v)[K], unsigned e0,
                                           unsigned lane, unsigned k) {
#pragma unroll
  for (int j = 16 * K; j >= 1; j >>= 1) {
    if (static_cast<unsigned>(j) >= k) continue;
    if (j >= K) {
      const unsigned lm = static_cast<unsigned>(j / K);
      const bool keep_max = ((lane & lm) == 0) != ((e0 & k) == 0);
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const unsigned long long o = __shfl_xor_sync(kFull, v[r], lm);
        v[r] = ((o < v[r]) != keep_max) ? o : v[r];
      }
    } else {
#pragma unroll
      for (int r = 0; r < K; ++r) {
        if (r & j) continue;
        const bool down = ((e0 & k) | (r & k)) != 0;  // e0 + r = e0 | r: e0 is a multiple of K
        const unsigned long long x = v[r], y = v[r | j];
        const bool swap = (y < x) != down;
        v[r] = swap ? y : x;
        v[r | j] = swap ? x : y;
      }
    }
  }
}

// The gather of batch (p, i) through perm (place m's source place at
// perm[pad(m)]), thread `t` of `nt` threads.
__device__ __forceinline__ void gather(const Args& a, int p, int i, long long batch,
                                       const int* perm, int t, int nt) {
  const int n = a.b;
  const long long s0 = a.start ? a.start[p] : 0;
  const long long src = (static_cast<long long>(p) * a.src_batches + s0 + i) * n;
  const long long dst = batch * n;
  for (int m = t; m < n; m += nt) {
    const long long from = src + perm[pad(m)];
    a.out_idx[dst + m] = a.idx_bytes == 2
                             ? static_cast<int>(static_cast<const int16_t*>(a.idx)[from])
                             : static_cast<const int*>(a.idx)[from];
    a.out_rows[dst + m] = a.rows[from];
    a.out_valid[dst + m] = a.valid[from];
  }
}

// The warp path's shared ints a warp: its permutation (33·K, padded), then
// its source row's index plane and rows (32·K each) and valid bytes (8·K).
template <int K>
__host__ __device__ constexpr int warp_smem_ints() { return 33 * K + 64 * K + 8 * K; }

// The warp path: a warp a batch, K = npow2 / 32 composites a lane (at most
// one round: B ≤ kWarpItems < 1626). Each lane loads its places lane + 32·q
// of the batch's source row first, so the loads are in flight while the key
// chain hashes and the network sorts; then the permutation (blocked) and
// the row (in place order) go to the warp's slice of shared memory, and
// lane l writes places l + 32·q of the batch from there: the stores
// coalesce.
template <int K>
__global__ void __launch_bounds__(kWarpsPerCta * 32) shuffle_perm_kernel_warp(const __grid_constant__ Args a) {
  extern __shared__ int warp_s[];
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const int p = blockIdx.y, i = blockIdx.x * kWarpsPerCta + warp;
  if (i >= a.width) return;  // the row's tail: whole warps
  const long long batch = static_cast<long long>(p) * a.width + i;
  const int n = a.b;
  // every load first: the key's words, the lane's start, then the row
  const uint32_t* kw = a.keys + 2 * (a.derive ? p : batch);
  threefry::Pair key{kw[0], kw[1]};
  const long long s0 = a.start ? a.start[p] : 0;
  const long long src = (static_cast<long long>(p) * a.src_batches + s0 + i) * n;
  int row_idx[K], row_rows[K], row_valid[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int m = static_cast<int>(lane) + 32 * q;
    if (m < n) {
      row_idx[q] = a.idx_bytes == 2
                       ? static_cast<int>(static_cast<const int16_t*>(a.idx)[src + m])
                       : static_cast<const int*>(a.idx)[src + m];
      row_rows[q] = a.rows[src + m];
      row_valid[q] = a.valid[src + m];
    }
  }
  const unsigned e0 = lane * K;
  unsigned long long v[K];
  if (a.rounds == 0) {  // one place: the identity
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = e0 + r;
  } else {
    if (a.derive) key = threefry::split(key, static_cast<uint32_t>(i));
    draw<K>(v, round_key(&key, true, lane), e0, n, a.tie_mask);
#pragma unroll
    for (unsigned k = 2; k <= 32u * K; k <<= 1) warp_merge<K>(v, e0, lane, k);
  }
  int* perm = warp_s + warp * warp_smem_ints<K>();
  int* s_idx = perm + 33 * K;
  int* s_rows = s_idx + 32 * K;
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_rows + 32 * K);
#pragma unroll
  for (int r = 0; r < K; ++r) perm[pad(e0 + r)] = static_cast<int>(static_cast<unsigned>(v[r]));
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int m = static_cast<int>(lane) + 32 * q;
    if (m < n) {
      s_idx[m] = row_idx[q];
      s_rows[m] = row_rows[q];
      s_valid[m] = static_cast<uint8_t>(row_valid[q]);
    }
  }
  __syncwarp();
  const long long dst = batch * n;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int m = static_cast<int>(lane) + 32 * q;
    if (m < n) {
      const int from = perm[pad(m)];
      a.out_idx[dst + m] = s_idx[from];
      a.out_rows[dst + m] = s_rows[from];
      a.out_valid[dst + m] = s_valid[from];
    }
  }
}

// The CTA path: a CTA a batch, npow2 / K threads of K composites each; the
// stages whose stride crosses warps exchange through shared memory
// (composites [npow2, padded], then the permutation [B, padded]).
template <int K>
__global__ void __launch_bounds__(kCtaThreads) shuffle_perm_kernel_cta(const __grid_constant__ Args a) {
  extern __shared__ unsigned long long comp_s[];
  const int i = blockIdx.x, p = blockIdx.y;
  const long long batch = static_cast<long long>(p) * a.width + i;
  const int n = a.b;
  const unsigned lane = threadIdx.x & 31u, e0 = threadIdx.x * K;
  const unsigned n2 = static_cast<unsigned>(a.npow2);
  int* perm = reinterpret_cast<int*>(comp_s + pad(n2));
  threefry::Pair key = batch_key(a, p, i, batch);
  unsigned long long v[K];
  for (int round = 0; round < a.rounds; ++round) {
    const threefry::Pair sub = round_key(&key, round + 1 == a.rounds, lane);
    if (static_cast<int>(e0) < n) {
      draw<K>(v, sub, e0, n, a.tie_mask);
    } else {  // a thread of padding alone hashes nothing
#pragma unroll
      for (int r = 0; r < K; ++r) v[r] = kSentinel;
    }
    for (unsigned k = 2; k <= n2; k <<= 1) {
      for (unsigned j = k >> 1; j >= 32u * K; j >>= 1) {
#pragma unroll
        for (int r = 0; r < K; ++r) comp_s[pad(e0 + r)] = v[r];
        __syncthreads();
        const bool keep_max = ((e0 & j) == 0) != ((e0 & k) == 0);
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const unsigned long long o = comp_s[pad((e0 + r) ^ j)];
          v[r] = ((o < v[r]) != keep_max) ? o : v[r];
        }
        __syncthreads();
      }
      warp_merge<K>(v, e0, lane, k);
    }
    // place m of the new order holds the item at place low(v) of the old
    if (round == 0) {
#pragma unroll
      for (int r = 0; r < K; ++r)
        if (static_cast<int>(e0) + r < n) perm[pad(e0 + r)] = static_cast<int>(static_cast<unsigned>(v[r]));
    } else {
      int now[K];
#pragma unroll
      for (int r = 0; r < K; ++r)
        now[r] = static_cast<int>(e0) + r < n ? perm[pad(static_cast<unsigned>(v[r]))] : 0;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < K; ++r)
        if (static_cast<int>(e0) + r < n) perm[pad(e0 + r)] = now[r];
    }
    __syncthreads();
  }
  gather(a, p, i, batch, perm, static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x));
}

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

// The global path: a CTA a batch, its composites and permutation in the
// wrapper's global scratch, a block barrier a stage.
__global__ void __launch_bounds__(kMaxThreads) shuffle_perm_kernel(const __grid_constant__ Args a) {
  __shared__ threefry::Pair subkeys[kMaxRounds];
  const int i = blockIdx.x, p = blockIdx.y;
  const long long batch = static_cast<long long>(p) * a.width + i;
  const int n = a.b;
  unsigned long long* comp = a.scratch + batch * a.npow2;
  int* perm = a.scratch_perm + batch * n;
  if (threadIdx.x == 0) {
    threefry::Pair k = batch_key(a, p, i, batch);
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
  int path, npow2, per_thread, threads, warps;
  size_t shared_bytes;
};

// The layout of batches of b places (force 1: the global path).
bool plan(int b, int force, Layout* l) {
  if (b <= 0 || force < 0 || force > 1) return false;
  int n2 = 1;
  while (n2 < b) {
    if (n2 > (1 << 29)) return false;
    n2 <<= 1;
  }
  l->npow2 = n2;
  l->warps = 1;
  if (force == 0 && n2 <= kWarpItems) {
    l->path = kWarp;
    l->npow2 = n2 < 32 ? 32 : n2;
    l->per_thread = l->npow2 / 32;
    l->warps = kWarpsPerCta;
    l->threads = 32 * l->warps;
    l->shared_bytes = static_cast<size_t>(l->warps) * 105 * l->per_thread * 4;
  } else if (force == 0 && n2 <= kSharedItems) {
    l->path = kCta;
    l->per_thread = n2 <= kCtaWide ? 16 : 32;
    l->threads = n2 / l->per_thread;
    l->shared_bytes = static_cast<size_t>(n2 + n2 / 32) * 8 + static_cast<size_t>(b + b / 32 + 1) * 4;
  } else {
    l->path = kGlobal;
    l->per_thread = 0;
    l->threads = n2 / 2 < 32 ? 32 : (n2 / 2 > kMaxThreads ? kMaxThreads : n2 / 2);
    l->shared_bytes = 0;
  }
  return true;
}

bool grid_of(const Layout& l, int p, int width, dim3* grid) {
  if (p <= 0 || p > 65535 || width < 0) return false;
  // the warp path: a row of CTAs a partition, warps batches each
  *grid = dim3(static_cast<unsigned>(l.path == kWarp ? (width + l.warps - 1) / l.warps : width),
               static_cast<unsigned>(p));
  return true;
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int K>
cudaError_t launch_cta(const Args& a, dim3 grid, const Layout& l, cudaStream_t s) {
  const cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(shuffle_perm_kernel_cta<K>), l.shared_bytes);
  if (e != cudaSuccess) return e;
  shuffle_perm_kernel_cta<K><<<grid, l.threads, l.shared_bytes, s>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_warp(const Args& a, dim3 grid, const Layout& l, cudaStream_t s) {
  static_assert(warp_smem_ints<K>() == 105 * K, "plan() counts 105·K ints a warp");
  const cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(shuffle_perm_kernel_warp<K>), l.shared_bytes);
  if (e != cudaSuccess) return e;
  shuffle_perm_kernel_warp<K><<<grid, l.threads, l.shared_bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The layout the launch takes for batches of b places (force 1: the global
// path), into out[6]: the path (0 warp, 1 CTA, 2 global), the network's
// width, composites a thread (0 on the global path), threads a CTA, batches
// a CTA, dynamic shared bytes. ops/shuffle.py `k13_layout` mirrors it.
extern "C" int shuffle_perm_path(int b, int force, int* out) {
  Layout l;
  if (!plan(b, force, &l)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = l.path;
  out[1] = l.npow2;
  out[2] = l.per_thread;
  out[3] = l.threads;
  out[4] = l.warps;
  out[5] = static_cast<int>(l.shared_bytes);
  return 0;
}

// keys: int32 words of [P, 2] (derive) or [P, W, 2]; idx [P, src_batches, B]
// of idx_bytes 2 or 4, rows int32 and valid bytes of the same shape; start
// [P] int64 or null; force 1 takes the global path; out_* [P, W, B];
// scratch: null but on the global path, there P·W·(8·npow2 + 4·B) bytes.
extern "C" int shuffle_perm_launch(const int* keys, int derive, int p, int width,
                                   const void* idx, int idx_bytes, const int* rows,
                                   const unsigned char* valid, const long long* start,
                                   int src_batches, int b, int rounds, unsigned tie_mask,
                                   int force, int* out_idx, int* out_rows,
                                   unsigned char* out_valid, void* scratch, void* stream) {
  Layout l;
  dim3 grid;
  if (!plan(b, force, &l) || !grid_of(l, p, width, &grid) ||
      (idx_bytes != 2 && idx_bytes != 4) || rounds < 0 || rounds > kMaxRounds ||
      (l.path == kWarp && rounds > 1) || (l.path == kCta && rounds > 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (width == 0) return 0;
  if (l.path == kGlobal && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
  a.scratch_perm = l.path != kGlobal ? nullptr
                                     : reinterpret_cast<int*>(a.scratch + static_cast<long long>(p) *
                                                                              width * l.npow2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l.path == kWarp) {
    switch (l.per_thread) {
      case 1: return static_cast<int>(launch_warp<1>(a, grid, l, s));
      case 2: return static_cast<int>(launch_warp<2>(a, grid, l, s));
      case 4: return static_cast<int>(launch_warp<4>(a, grid, l, s));
      case 8: return static_cast<int>(launch_warp<8>(a, grid, l, s));
      case 16: return static_cast<int>(launch_warp<16>(a, grid, l, s));
      case 32: return static_cast<int>(launch_warp<32>(a, grid, l, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (l.path == kCta) {
    switch (l.per_thread) {
      case 16: return static_cast<int>(launch_cta<16>(a, grid, l, s));
      case 32: return static_cast<int>(launch_cta<32>(a, grid, l, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  shuffle_perm_kernel<<<grid, l.threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shuffle_perm_floor_launch(int p, int width, int b, int force, void* stream) {
  Layout l;
  dim3 grid;
  if (!plan(b, force, &l) || !grid_of(l, p, width, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (width == 0) return 0;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(shuffle_perm_floor_kernel),
                                   l.shared_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  shuffle_perm_floor_kernel<<<grid, l.threads, l.shared_bytes,
                              static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
