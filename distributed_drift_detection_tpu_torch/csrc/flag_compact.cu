// K4 — flag compaction: the flagged slots of a [5, P, NBF] flag plane,
// compacted in row-major order into a [K + 1, 7] int32 table, in one pass.
//
// Replaces the XLA-lowered compaction epilogue of the JAX package's
// parallel/mesh.py (`compact_flag_table` :251, `jnp.nonzero(size=K)` and
// its gathers). The plain version is parallel/mesh.py
// `compact_flag_table_reference`, and the two are equal byte for byte.
//
// Input: the packed plane, planes (warning_local, warning_global,
// change_local, change_global, forced_retrain) of P·NBF int32 each. A slot
// is flagged when warning_local >= 0, change_local >= 0 or forced != 0.
// Output: row r < min(n, K) is the r-th flagged slot s in row-major order,
// (s / NBF + offset, s % NBF, its four flag values, forced); rows
// min(n, K) .. K−1 are −1; row K is (n, 0, 0, 0, 0, 0, 0), n the true count
// (it may exceed K: the table is then partial, and the collect falls back to
// the plane). `offset` is a mesh shard's first partition, so a shard's table
// names global partitions.
//
// One CTA a tile of kTile slots, the tile taken from a counter in launch
// order. A thread loads its kItems slots (kThreads apart, coalesced) from
// the three planes that decide a flag before it tests any, so a tile costs
// one memory round trip; each round a warp ballots its flags, so a slot's
// rank in its warp is a popcount; warp 0 scans the (round, warp) totals,
// which lie in slot order. The tile's prefix comes from a decoupled
// look-back over the tiles before it: each tile publishes its total, then
// its inclusive prefix, in a 64-bit status word (flag << 32 | value); warp
// 0 of a later tile reads 32 predecessors' words at once and sums them back
// to the nearest inclusive prefix, a window of 32 further back while there
// is none. Tiles take their index when they start, so a tile's
// predecessors have all started, and the spin ends. The launcher sets
// the table and the status words to all ones with one memset: −1 is the
// table's fill and all ones a status word's "not ready", and the tile
// counter starts at 0xFFFFFFFF, so the first tile is 0. No host
// synchronization: the count lands in the table on the device.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kAggregate = 1u;
constexpr unsigned kInclusive = 2u;
constexpr unsigned kNotReady = 0xFFFFFFFFu;
static_assert(kItems * kWarps == 64, "warp 0 scans two (round, warp) totals a lane");

__device__ __forceinline__ void publish(unsigned long long* word, unsigned flag, int value) {
  __threadfence();
  atomicExch(word, (static_cast<unsigned long long>(flag) << 32) | static_cast<unsigned>(value));
}

__device__ __forceinline__ unsigned long long read_status(const unsigned long long* word) {
  unsigned long long v;
  do {
    v = *reinterpret_cast<const volatile unsigned long long*>(word);
  } while (static_cast<unsigned>(v >> 32) == kNotReady);
  return v;
}

__global__ void __launch_bounds__(kThreads)
flag_compact_kernel(const int* __restrict__ packed, int slots, int nbf, int k, int offset,
                    int tiles, int* __restrict__ out, unsigned long long* status,
                    unsigned* counter) {
  __shared__ unsigned tile_sh;
  __shared__ int base_sh[kItems * kWarps];  // exclusive prefix of each (round, warp)
  __shared__ int prefix_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_sh = atomicAdd(counter, 1u) + 1u;
  __syncthreads();
  const int tile = static_cast<int>(tile_sh);
  const long long first = static_cast<long long>(tile) * kTile;
  const long long n_slots = slots;
  int warn[kItems], change[kItems], forced[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long s = first + r * kThreads + tid;
    const bool in = s < n_slots;
    warn[r] = in ? __ldg(packed + s) : -1;
    change[r] = in ? __ldg(packed + 2 * n_slots + s) : -1;
    forced[r] = in ? __ldg(packed + 4 * n_slots + s) : 0;
  }
  unsigned masks[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    masks[r] = __ballot_sync(0xFFFFFFFFu, (warn[r] >= 0) | (change[r] >= 0) | (forced[r] != 0));
    if (lane == 0) base_sh[r * kWarps + warp] = __popc(masks[r]);
  }
  __syncthreads();
  if (warp == 0) {
    const int a = base_sh[2 * lane], b = base_sh[2 * lane + 1];
    int incl = a + b;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += up;
    }
    const int excl = incl - a - b;
    const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    base_sh[2 * lane] = excl;
    base_sh[2 * lane + 1] = excl + a;
    int prefix = 0;
    if (tile == 0) {
      if (lane == 0) publish(status, kInclusive, total);
    } else {
      if (lane == 0) publish(status + tile, kAggregate, total);
      // lane i reads tile top − i: the nearest inclusive prefix is the
      // lowest lane holding one, and the lanes up to it hold the sum
      for (int top = tile - 1;; top -= 32) {
        const int j = top - lane;
        const unsigned long long v =
            j >= 0 ? read_status(status + j) : static_cast<unsigned long long>(kInclusive) << 32;
        const unsigned incl_lanes =
            __ballot_sync(0xFFFFFFFFu, static_cast<unsigned>(v >> 32) == kInclusive);
        const int stop = incl_lanes ? __ffs(incl_lanes) - 1 : 31;
        int val = lane <= stop ? static_cast<int>(static_cast<unsigned>(v)) : 0;
#pragma unroll
        for (int d = 16; d; d >>= 1) val += __shfl_xor_sync(0xFFFFFFFFu, val, d);
        prefix += val;
        if (incl_lanes) break;
      }
      if (lane == 0) publish(status + tile, kInclusive, prefix + total);
    }
    if (lane == 0) {
      prefix_sh = prefix;
      if (tile == tiles - 1) {
        int* row = out + static_cast<long long>(k) * 7;
        row[0] = prefix + total;
        for (int c = 1; c < 7; ++c) row[c] = 0;
      }
    }
  }
  __syncthreads();
  const int prefix = prefix_sh;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (!((masks[r] >> lane) & 1u)) continue;
    const int rank = prefix + base_sh[r * kWarps + warp] + __popc(masks[r] & below);
    if (rank >= k) continue;
    const long long s = first + r * kThreads + tid;
    int* row = out + static_cast<long long>(rank) * 7;
    row[0] = static_cast<int>(s / nbf) + offset;
    row[1] = static_cast<int>(s % nbf);
    row[2] = warn[r];
    row[3] = __ldg(packed + n_slots + s);
    row[4] = change[r];
    row[5] = __ldg(packed + 3 * n_slots + s);
    row[6] = forced[r];
  }
}

__global__ void flag_compact_floor_kernel() {}

int tiles_of(long long slots) {
  return slots <= 0 ? 1 : static_cast<int>((slots + kTile - 1) / kTile);
}

}  // namespace

// The int32 words of the launch's buffer: the [k + 1, 7] table, padded to
// 8 bytes, then a 64-bit status word a tile and the tile counter
// (parallel/mesh.py `k4_words` mirrors it).
extern "C" long long flag_compact_words(int p, int nbf, int k) {
  const long long table = (static_cast<long long>(k) + 1) * 7;
  return ((table + 1) & ~1LL) + 2LL * tiles_of(static_cast<long long>(p) * nbf) + 1;
}

extern "C" int flag_compact_launch(const int* packed, int p, int nbf, int k, int offset,
                                   int* buf, void* stream) {
  const long long slots = static_cast<long long>(p) * nbf;
  if (p < 0 || nbf < 0 || k < 0 || slots > INT_MAX - kTile || (static_cast<long long>(k) + 1) * 7 > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = tiles_of(slots);
  const long long table = (static_cast<long long>(k) + 1) * 7;
  const long long words = flag_compact_words(p, nbf, k);
  auto* status = reinterpret_cast<unsigned long long*>(buf + ((table + 1) & ~1LL));
  auto* counter = reinterpret_cast<unsigned*>(buf + words - 1);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(buf, 0xFF, static_cast<size_t>(words) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  flag_compact_kernel<<<tiles, kThreads, 0, s>>>(packed, static_cast<int>(slots), nbf, k, offset,
                                                 tiles, buf, status, counter);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel with K4's grid and block: the floor under its time.
extern "C" int flag_compact_floor_launch(int p, int nbf, void* stream) {
  flag_compact_floor_kernel<<<tiles_of(static_cast<long long>(p) * nbf), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
