// K5-adwin — the ADWIN window statistic, one partition row per CTA.
//
// Replaces the JAX package's ops/adwin.py `adwin_window` -> `_adwin_masks`
// (:348) with its chunk scan over `_flush_chunk` (:210), and
// `summarise_window` (XLA-lowered there: cumsum, segment_sum, a lax.scan of
// N/clock + 1 closed-form cascades with a flattened cut test each, a
// gather, masked argmax). Per row of W·B 0/1 error indicators:
//
// 1. each thread's absorb counter at the start of its contiguous chunk of
//    elements (a block scan of valid counts), the chunk sums (shared-memory
//    atomics of each thread's run of errors into the chunk it feeds, the
//    carried pending sum in the first) and the row's error total; beside
//    them, the table lg[j] = ln(2/δ) + ln n for the n that flush j sees
//    while the histogram has not forgotten (n = n_in + (j+1)·clock);
// 2. the n_flush completed chunks, flushed in order. Lane k of a warp owns
//    histogram level k (L <= 30 lanes). A flush is the closed-form cascade
//    — lane k receives a bucket iff every level below it is full (a
//    ballot), a full receiving level drops its two oldest slots (the top
//    level one), and appends the chunk (level 0) or the merged pair of the
//    level below (a shuffle) — then the cut test at every bucket boundary
//    (`verdict`): a suffix scan over the lanes gives each level the sizes,
//    sums and boundary count of the levels above it, each level writes its
//    boundaries' (n0, s0), oldest first, into a flat shared array, lane i
//    tests boundaries i, i + 32, ..., and __any_sync reduces the verdicts.
//    With C = max_buckets + 1 <= 8 slots a level (the launcher picks the
//    path from the parameters), a level's slots live in registers and the
//    work splits: warp 0 runs only the cascades, a round of kRound flushes
//    at a time, and publishes each flush's histogram (counts, slots, n,
//    total) to a double-buffered ring in shared memory; during the next
//    round the other 15 warps run those flushes' cut tests, one flush a
//    warp at a time. With larger C the slots are a row of an [L, C]
//    histogram in shared memory and warp 0 runs cascade and cut test;
// 3. each chunk-completing element's verdict (the absorb counters
//    recomputed from step 1's scan), and per batch the first change (no
//    warnings: first_warning is -1).
//
// It writes [W] first-change (and first-warning) indices and the end state:
// t, pending sum, n, total, the [L, C] histogram and [L] counts, all int32.
//
// Bound on an H100: the inputs are 5 B an element — 1 MB per call at
// [16, 12800] — but the flushes are a dependent chain of n_flush steps
// (≈ 400 at clock 32), one per row; the bound is the chain's latency on
// one warp, not the bytes. On the chain (register path): the next chunk
// sum, loaded a flush ahead from shared memory; a ballot and two shuffles;
// register selects for the slots; the ring stores. Off it, on the other
// warps: the 5-step shuffle scan, the boundaries' shared-memory round
// trip, the cut tests (4 IEEE divisions and a square root each, one a lane
// while the boundaries are at most 32, ≈ 15–25 at SMOKE) and ln n (the
// table, or `xla_logf` once the top level has overflowed).
// The chunk table (sums, then verdicts, and lg) lives in shared memory, or
// in a global scratch for a row whose table does not fit beside the ring
// or the histogram. The JAX package runs all N/clock + 1 steps (dead ones
// are the identity); the kernel stops at the last completed chunk.
//
// Exactness: the histogram, counts and totals are int32, so the end state
// and the flags equal `adwin_window_reference` exactly where the cut tests
// do; which lane or warp tests a boundary cannot change an OR. The cut
// bound is the plain version's float32 expression, built with -fmad=false,
// the one fused multiply-add XLA forms there as __fmaf_rn, and ln n of
// f32(max(n, 1)) computed as XLA's CPU float32 log computes it (`xla_logf`,
// the plain version's `xla_log`): not correctly rounded, but the same bits
// as the JAX package's for every n below 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

#include "zoo_scan.cuh"

namespace {

using zoo::kThreads;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
constexpr int kRegSlots = 8;  // C up to this: a level's slots in registers
constexpr int kRound = 32;    // flushes warp 0 publishes between barriers
// A published flush, in ints: slots as [2][32] int4 (half, lane), [32]
// counts, n, total (padded to 16 bytes).
constexpr int kRec = 2 * 32 * 4 + 32 + 4;
constexpr int kRing = 2 * kRound * kRec;

// A level's slots (bucket sums, oldest first) in registers. Slots at and
// above C hold 0 and stay 0, as do all of a lane above the top level.
struct RegSlots {
  static constexpr bool kShared = false;
  int s[kRegSlots];

  __device__ void init(int* /*hist*/, const int* src, int /*lane*/, int C, bool mine) {
#pragma unroll
    for (int c = 0; c < kRegSlots; ++c) s[c] = mine && c < C ? src[c] : 0;
  }
  __device__ int at(int c) const { return s[c]; }
  // Drop the `shift` (0, 1 or 2) oldest slots, then put `val` in slot
  // `app` if `received`.
  __device__ void update(int /*C*/, int shift, bool received, int app, int val) {
#pragma unroll
    for (int c = 0; c < kRegSlots; ++c) {  // ascending: reads slots >= c
      const int s1 = c + 1 < kRegSlots ? s[c + 1] : 0;
      const int s2 = c + 2 < kRegSlots ? s[c + 2] : 0;
      const int keep = shift == 0 ? s[c] : (shift == 1 ? s1 : s2);
      s[c] = received && c == app ? val : keep;
    }
  }
  __device__ int sum(int cnt) const {
    int t = 0;
#pragma unroll
    for (int c = 0; c < kRegSlots; ++c) t += c < cnt ? s[c] : 0;
    return t;
  }
  // (n0, s0) after each of the level's cnt slots into out[0..cnt).
  __device__ void bounds(int2* out, int cnt, int size, int n0, int s0) const {
#pragma unroll
    for (int c = 0; c < kRegSlots; ++c) {
      n0 += size;
      s0 += s[c];
      if (c < cnt) out[c] = make_int2(n0, s0);
    }
  }
  __device__ void store(int* dst, int C) const {
#pragma unroll
    for (int c = 0; c < kRegSlots; ++c)
      if (c < C) dst[c] = s[c];
  }
  // Lane `lane`'s slots in a published flush.
  __device__ void put(int* rec, int lane) const {
    int4* q = reinterpret_cast<int4*>(rec);
    q[lane] = make_int4(s[0], s[1], s[2], s[3]);
    q[32 + lane] = make_int4(s[4], s[5], s[6], s[7]);
  }
  __device__ void get(const int* rec, int lane) {
    const int4* q = reinterpret_cast<const int4*>(rec);
    const int4 a = q[lane], b = q[32 + lane];
    s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w;
    s[4] = b.x, s[5] = b.y, s[6] = b.z, s[7] = b.w;
  }
};

// A level's slots as row `lane` of the [L, C] histogram in shared memory
// (filled by the whole block before the flushes); only that lane, and only
// a lane of a level, touches it.
struct SharedSlots {
  static constexpr bool kShared = true;
  int* s;

  __device__ void init(int* hist, const int* /*src*/, int lane, int C, bool /*mine*/) {
    s = hist + lane * C;
  }
  __device__ int at(int c) const { return s[c]; }
  __device__ void update(int C, int shift, bool received, int app, int val) {
    for (int c = 0; c < C; ++c) {  // in place: reads slot c + shift >= c
      const int src = c + shift;
      const int keep = src < C ? s[src] : 0;
      s[c] = received && c == app ? val : keep;
    }
  }
  __device__ int sum(int cnt) const {
    int t = 0;
    for (int c = 0; c < cnt; ++c) t += s[c];
    return t;
  }
  __device__ void bounds(int2* out, int cnt, int size, int n0, int s0) const {
    for (int c = 0; c < cnt; ++c) {
      n0 += size;
      s0 += s[c];
      out[c] = make_int2(n0, s0);
    }
  }
  __device__ void store(int* dst, int C) const {
    for (int c = 0; c < C; ++c) dst[c] = s[c];
  }
};

// What a lane of a flushing warp knows of its level.
struct Level {
  int lane;
  bool mine;        // lane < L: the lane holds level `lane`
  int size;         // clock·2^lane elements a bucket (0 above the top level)
  unsigned below;   // the lanes under this one
  unsigned every;   // the lanes of all L levels
  int L, C, max_buckets, clock;

  __device__ Level(int lane_, int L_, int C_, int max_buckets_, int clock_)
      : lane(lane_), mine(lane_ < L_), size(lane_ < L_ ? clock_ << lane_ : 0),
        below((1u << lane_) - 1u), every((1u << L_) - 1u),  // lane < 32, L <= 30
        L(L_), C(C_), max_buckets(max_buckets_), clock(clock_) {}
};

// ln x for a normal float x > 0 as XLA's CPU backend computes float32 log
// (GenerateVF32Log, Cephes' logf, with the fused multiply-adds of its LLVM
// lowering); the plain version is ops/prefix.py `xla_log`, step for step.
__device__ __forceinline__ float xla_logf(float x) {
  const int bits = __float_as_int(x);
  float e = __fadd_rn(static_cast<float>((bits >> 23) - 0x7f), 1.0f);
  const float m = __int_as_float((bits & ~0x7f800000) | 0x3f000000);
  const bool lo = m < 0.707106781186547524f;
  e = __fsub_rn(e, lo ? 1.0f : 0.0f);
  float r = __fadd_rn(__fsub_rn(m, 1.0f), lo ? m : 0.0f);
  const float r2 = __fmul_rn(r, r);
  const float r3 = __fmul_rn(r2, r);
  float y = __fmaf_rn(__fmaf_rn(r, 7.0376836292e-2f, -1.1514610310e-1f), r, 1.1676998740e-1f);
  const float y1 =
      __fmaf_rn(__fmaf_rn(r, -1.2420140846e-1f, 1.4249322787e-1f), r, -1.6668057665e-1f);
  const float y2 =
      __fmaf_rn(__fmaf_rn(r, 2.0000714765e-1f, -2.4999993993e-1f), r, 3.3333331174e-1f);
  y = __fmaf_rn(__fmaf_rn(y, r3, y1), r3, y2);
  y = __fmaf_rn(y, r3, __fmul_rn(-2.12194440e-4f, e));
  r = __fmaf_rn(-r2, 0.5f, r);
  return __fmaf_rn(0.693359375f, e, __fadd_rn(r, y));
}

// ln(2/δ) + ln(f32(max(n, 1))), ln as XLA computes it (header).
__device__ __forceinline__ float log_term(float log_2_delta, long long n) {
  return __fadd_rn(log_2_delta, xla_logf(static_cast<float>(n > 1 ? n : 1)));
}

// One flush's cascade, by the warp holding the histogram: chunk sum x in;
// the slots, count, n and total updated.
template <class Slots>
__device__ __forceinline__ void cascade(const Level& lv, Slots& slots, int& cnt, int& n,
                                        int& total, int x) {
  const int first = lv.mine ? slots.at(0) : 0;
  const int up = __shfl_up_sync(kFull, first + (lv.mine ? slots.at(1) : 0), 1);
  const int top0 = __shfl_sync(kFull, first, lv.L - 1);
  const bool full = lv.mine && cnt == lv.max_buckets;
  const unsigned fb = __ballot_sync(kFull, full);
  const bool received = lv.mine && (fb & lv.below) == lv.below;
  const bool top_ovf = (fb & lv.every) == lv.every;  // every level full
  const int shift = received && full ? (lv.lane == lv.L - 1 ? 1 : 2) : 0;
  if (lv.mine) slots.update(lv.C, shift, received, cnt - shift, lv.lane == 0 ? x : up);
  cnt += (received ? 1 : 0) - shift;
  n += lv.clock - (top_ovf ? lv.clock << (lv.L - 1) : 0);
  total += x - (top_ovf ? top0 : 0);
}

// The cut test at the boundary with (n0, s0) before it: the plain
// version's float32 expression, operation for operation.
__device__ __forceinline__ bool cut(int n0, int s0, int n, int total, float var_w,
                                    float lg, int min_side) {
  const int n1 = n - n0;
  const int s1 = total - s0;
  const float n0f = static_cast<float>(n0 > 1 ? n0 : 1);
  const float n1f = static_cast<float>(n1 > 1 ? n1 : 1);
  const float mu0 = __fdiv_rn(static_cast<float>(s0), n0f);
  const float mu1 = __fdiv_rn(static_cast<float>(s1), n1f);
  const float inv_m = __fadd_rn(__fdiv_rn(1.0f, n0f), __fdiv_rn(1.0f, n1f));
  const float root = __fsqrt_rn(__fmul_rn(__fmul_rn(__fmul_rn(2.0f, inv_m), var_w), lg));
  const float eps_cut = __fmaf_rn(__fmul_rn(2.0f / 3.0f, inv_m), lg, root);
  return n0 >= min_side && n1 >= min_side && fabsf(__fsub_rn(mu0, mu1)) >= eps_cut;
}

// A flush's verdict, by one warp over the histogram after the flush (lane
// k: level k's slots and count): the cut test at every boundary, oldest
// (level L-1, slot 0) first, through the warp's boundary array `bd`
// [L·C]. Every lane returns the verdict.
template <class Slots>
__device__ bool verdict(const Level& lv, const Slots& slots, int cnt, int n, int total,
                        float lg, int min_window, int min_side, int2* bd) {
  // suffix sums over the higher lanes of the boundary counts, sizes, sums
  const int own_n = cnt * lv.size;
  const int own_s = lv.mine ? slots.sum(cnt) : 0;
  const int n_bounds = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(cnt)));
  int pre_c = cnt, pre_n = own_n, pre_s = own_s;
  for (int d = 1; d < 32; d <<= 1) {
    const int oc = __shfl_down_sync(kFull, pre_c, d);
    const int on = __shfl_down_sync(kFull, pre_n, d);
    const int os = __shfl_down_sync(kFull, pre_s, d);
    if (lv.lane + d < 32) {
      pre_c += oc;
      pre_n += on;
      pre_s += os;
    }
  }
  __syncwarp();  // the warp's reads of its previous flush's boundaries
  if (lv.mine) slots.bounds(bd + pre_c - cnt, cnt, lv.size, pre_n - own_n, pre_s - own_s);
  __syncwarp();
  const float nf = static_cast<float>(n > 1 ? n : 1);
  const float p = __fdiv_rn(static_cast<float>(total), nf);
  const float var_w = __fmul_rn(p, __fsub_rn(1.0f, p));
  bool viol = false;
  for (int i = lv.lane; i < n_bounds; i += 32) {  // boundaries i, i + 32, ...
    const int2 q = bd[i];
    viol |= cut(q.x, q.y, n, total, var_w, lg, min_side);
  }
  const bool any = __any_sync(kFull, viol);
  return n >= min_window && any;
}

template <class Slots>
__global__ void __launch_bounds__(kThreads) adwin_window_kernel(
    const float* __restrict__ errs, const uint8_t* __restrict__ live,
    const int* __restrict__ t_in, const int* __restrict__ pend_in,
    const int* __restrict__ n_in, const int* __restrict__ total_in,
    const int* __restrict__ sums_in, const int* __restrict__ counts_in, int w,
    int b, int clock, int max_buckets, int levels, int min_window,
    int min_side, float log_2_delta, int table_in_smem, int* __restrict__ scratch,
    int* __restrict__ first_warning, int* __restrict__ first_change,
    int* __restrict__ t_out, int* __restrict__ pend_out,
    int* __restrict__ n_out, int* __restrict__ total_out,
    int* __restrict__ sums_out, int* __restrict__ counts_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scan_buf[2 * kThreads];
  __shared__ int t_end_s, err_total_s, flushed_s;
  const int row = blockIdx.x;
  const int n_el = w * b;
  const int C = max_buckets + 1;
  const int L = levels;
  const int LC = L * C;
  const int nc = n_el / clock + 1;
  const int warp = threadIdx.x / 32;
  // [fc w][fw w] | registers: ring [kRing], boundaries [kWarps-1][L·C];
  // shared: boundaries [L·C], histogram [L·C] | chunk table
  int* fc = reinterpret_cast<int*>(smem);
  int* fw = fc + w;
  const size_t firsts = (2 * static_cast<size_t>(w) * sizeof(int) + 15) & ~size_t(15);
  int* ring = reinterpret_cast<int*>(smem + firsts);
  int2* bounds = reinterpret_cast<int2*>(Slots::kShared ? ring : ring + kRing);
  int* hist = reinterpret_cast<int*>(bounds + (Slots::kShared ? 1 : kWarps - 1) * LC);
  // per chunk: its sum until its flush reads it, then its verdict; and lg
  int* chunk = table_in_smem ? hist + (Slots::kShared ? LC : 0)
                             : scratch + static_cast<size_t>(row) * 2 * nc;
  float* lgt = reinterpret_cast<float*>(chunk + nc);
  const float* e = errs + static_cast<size_t>(row) * n_el;
  const uint8_t* v = live + static_cast<size_t>(row) * n_el;
  zoo::first_init(fc, fw, w, b);
  const int t0 = t_in[row];
  const int base = t0 / clock;
  const int n_start = n_in[row];
  for (int j = threadIdx.x; j < nc; j += blockDim.x) {
    chunk[j] = 0;
    lgt[j] = log_term(log_2_delta, n_start + (j + 1LL) * clock);
  }
  if (Slots::kShared)
    for (int i = threadIdx.x; i < LC; i += blockDim.x)
      hist[i] = sums_in[static_cast<size_t>(row) * LC + i];
  if (threadIdx.x == 0) err_total_s = 0;
  __syncthreads();

  // 1. absorb counters, chunk sums, the error total
  int lo, hi;
  zoo::chunk_of(n_el, lo, hi);
  int mine = 0;
  for (int j = lo; j < hi; ++j) mine += v[j] != 0;
  const int t_first = t0 + zoo::block_exclusive_scan(
                               mine, 0, [](int x, int y) { return x + y; }, scan_buf);
  int t = t_first;
  int run_sid = 0, run_sum = 0, err_sum = 0;  // a run of errors into one chunk
  for (int j = lo; j < hi; ++j) {
    if (v[j]) {
      ++t;
      const int ev = static_cast<int>(e[j]);  // truncation, as astype(int32)
      if (ev != 0) {
        const int sid = (t - 1) / clock - base;  // nc: a chunk no flush reaches
        if (sid != run_sid) {
          if (run_sum != 0 && run_sid < nc) atomicAdd(&chunk[run_sid], run_sum);
          run_sid = sid;
          run_sum = 0;
        }
        run_sum += ev;
        err_sum += ev;
      }
    }
  }
  if (run_sum != 0 && run_sid < nc) atomicAdd(&chunk[run_sid], run_sum);
  const int pend0 = pend_in[row];
  if (threadIdx.x == 0) atomicAdd(&chunk[0], pend0);
  const int warp_err = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(err_sum)));
  if ((threadIdx.x & 31) == 0) atomicAdd(&err_total_s, warp_err);
  if (threadIdx.x == blockDim.x - 1) t_end_s = t;  // t0 + every valid element
  __syncthreads();
  const int t_end = t_end_s;
  const int n_flush = (t0 % clock + (t_end - t0)) / clock;

  // 2. the flushes (lane k: level k)
  const Level lv(threadIdx.x & 31, L, C, max_buckets, clock);
  // ln n for flush j: the table while n is n_in + (j+1)·clock, that is,
  // while nothing was forgotten (forgetting only lowers n)
  auto lg_of = [&](int j, int n) {
    return n == n_start + (j + 1LL) * clock ? lgt[j] : log_term(log_2_delta, n);
  };
  Slots slots;  // warp 0: the histogram
  int cnt = 0, n = n_start, total = 0, flushed = 0;
  if (warp == 0) {
    slots.init(hist, sums_in + static_cast<size_t>(row) * LC + lv.lane * C, lv.lane, C, lv.mine);
    cnt = lv.mine ? counts_in[static_cast<size_t>(row) * L + lv.lane] : 0;
    total = total_in[row];
  }
  int next = n_flush > 0 ? chunk[0] : 0;
  auto flush = [&](int j) {  // warp 0: flush j's cascade, the next sum loaded
    const int x = next;
    if (j + 1 < n_flush) next = chunk[j + 1];
    flushed += x;
    cascade(lv, slots, cnt, n, total, x);
  };
  if constexpr (Slots::kShared) {  // warp 0 runs cascade and cut test
    if (warp == 0)
      for (int j = 0; j < n_flush; ++j) {
        flush(j);
        const bool fired = verdict(lv, slots, cnt, n, total, lg_of(j, n), min_window,
                                   min_side, bounds);
        if (lv.lane == 0) chunk[j] = fired ? 1 : 0;
      }
  } else {  // warp 0 publishes rounds of flushes, the other warps test them
    const int rounds = (n_flush + kRound - 1) / kRound;
    for (int r = 0; r <= rounds; ++r) {
      if (warp == 0) {
        const int end = min(n_flush, (r + 1) * kRound);
        for (int j = r * kRound; j < end; ++j) {
          flush(j);
          int* rec = ring + (j % (2 * kRound)) * kRec;
          slots.put(rec, lv.lane);
          rec[256 + lv.lane] = cnt;
          if (lv.lane == 0) {
            rec[288] = n;
            rec[289] = total;
          }
        }
      } else if (r > 0) {
        const int end = min(n_flush, r * kRound);
        int2* bd = bounds + (warp - 1) * LC;
        for (int j = (r - 1) * kRound + warp - 1; j < end; j += kWarps - 1) {
          const int* rec = ring + (j % (2 * kRound)) * kRec;
          RegSlots got;
          got.get(rec, lv.lane);
          const int fn = rec[288];
          const bool fired = verdict(lv, got, rec[256 + lv.lane], fn, rec[289],
                                     lg_of(j, fn), min_window, min_side, bd);
          if (lv.lane == 0) chunk[j] = fired ? 1 : 0;
        }
      }
      __syncthreads();  // a round published; the one before it tested
    }
  }
  if (warp == 0) {
    if (lv.mine) {
      counts_out[static_cast<size_t>(row) * L + lv.lane] = cnt;
      slots.store(sums_out + static_cast<size_t>(row) * LC + lv.lane * C, C);
    }
    if (lv.lane == 0) {
      n_out[row] = n;
      total_out[row] = total;
      flushed_s = flushed;
    }
  }
  __syncthreads();

  // 3. verdicts at chunk-completing elements; the end state
  t = t_first;
  for (int j = lo; j < hi; ++j) {
    if (v[j]) {
      ++t;
      if (t % clock == 0) {
        int cid = t / clock - base - 1;
        cid = cid < 0 ? 0 : (cid > nc - 1 ? nc - 1 : cid);
        zoo::first_mark(fc, fw, j, b, false, chunk[cid] != 0);
      }
    }
  }
  if (threadIdx.x == 0) {
    t_out[row] = t_end;
    pend_out[row] = pend0 + err_total_s - (n_flush > 0 ? flushed_s : 0);
  }
  __syncthreads();
  zoo::first_store(fc, fw, w, b, first_warning + static_cast<size_t>(row) * w,
                   first_change + static_cast<size_t>(row) * w);
}

template <class Slots>
int launch(const float* errs, const uint8_t* live, const int* t_in,
           const int* pend_in, const int* n_in, const int* total_in,
           const int* sums_in, const int* counts_in, int p, int w, int b,
           int clock, int max_buckets, int levels, int min_window, int min_side,
           float log_2_delta, int* scratch, int* first_warning,
           int* first_change, int* t_out, int* pend_out, int* n_out,
           int* total_out, int* sums_out, int* counts_out, cudaStream_t stream) {
  const long long lc = static_cast<long long>(levels) * (max_buckets + 1);
  // registers: the ring and a boundary array a testing warp; shared: one
  // boundary array and the histogram
  const long long need =
      Slots::kShared ? lc * static_cast<long long>(sizeof(int2) + sizeof(int))
                     : kRing * static_cast<long long>(sizeof(int)) +
                           (kWarps - 1) * lc * static_cast<long long>(sizeof(int2));
  const long long table = (static_cast<long long>(w) * b / clock + 1) * 2 * sizeof(int);
  size_t smem = 0;
  int table_in_smem = 0, fits = 0;
  cudaError_t e = zoo::dynamic_smem(adwin_window_kernel<Slots>, w, need + table, smem,
                                    table_in_smem);
  if (e == cudaSuccess && !table_in_smem)  // the chunk table in the global scratch
    e = zoo::dynamic_smem(adwin_window_kernel<Slots>, w, need, smem, fits);
  else
    fits = table_in_smem;
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);  // histogram too large
  adwin_window_kernel<Slots><<<p, kThreads, smem, stream>>>(
      errs, live, t_in, pend_in, n_in, total_in, sums_in, counts_in, w, b,
      clock, max_buckets, levels, min_window, min_side, log_2_delta,
      table_in_smem, scratch, first_warning, first_change, t_out, pend_out,
      n_out, total_out, sums_out, counts_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One CTA per partition row (levels <= 30, checked by the wrapper); a
// level's slots in registers when max_buckets + 1 <= 8, else in shared
// memory. `scratch` holds p rows of 2·(n/clock + 1) ints (n = w·b), used
// for the chunk table when it does not fit in shared memory. Returns a
// CUDA error code.
extern "C" int adwin_window_launch(
    const float* errs, const uint8_t* live, const int* t_in,
    const int* pend_in, const int* n_in, const int* total_in,
    const int* sums_in, const int* counts_in, int p, int w, int b, int clock,
    int max_buckets, int levels, int min_window, int min_side,
    float log_2_delta, int* scratch, int* first_warning, int* first_change,
    int* t_out, int* pend_out, int* n_out, int* total_out, int* sums_out,
    int* counts_out, void* stream) {
  auto* go = max_buckets + 1 <= kRegSlots ? launch<RegSlots> : launch<SharedSlots>;
  return go(errs, live, t_in, pend_in, n_in, total_in, sums_in, counts_in, p, w, b,
            clock, max_buckets, levels, min_window, min_side, log_2_delta, scratch,
            first_warning, first_change, t_out, pend_out, n_out, total_out,
            sums_out, counts_out, static_cast<cudaStream_t>(stream));
}
