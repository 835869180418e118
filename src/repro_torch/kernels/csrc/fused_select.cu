// Fused scan->select over the probed grains of an HNTL index, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_select.py::
// fused_scan_select (bodies _select_kernel / _select_kernel_sketch from
// _make_select_kernel, helpers _tile_dist and _merge_tile).  Its plain
// PyTorch version is repro_torch.core.scan.blocksoa_select_ref.
//
// What it computes, per query q: for every slot c of every probed grain
// g = gids[q, p] (p < n_active[q], keep[q, p] set), the Eq. 6 distance
//
//   d = ((float(sum_j (zq[q,p,j] - coords[g,j,c])^2) * scale[g]^2
//         + float(res[g,c]) * res_scale[g]) + rq[q,p])
//       + float(sum_j (sq[q,p,j] - sketch[g,j,c])^2) * sketch_scale[g]^2
//
// with the integer sums exact in int32 and the float steps rounded one by
// one (__fmul_rn / __fadd_rn: no FMA contraction, so the result equals the
// plain version bit for bit).  Slots failing mask[g, c] (and, with
// tenants, tenant_mask[tenant_ix[q], g, c]) are dropped.  The output is
// the first `width` entries of a stable ascending sort of all candidates
// by (dist, visit order), visit order being (p, c); an initial carry of
// (BIG, -1) entries counts as visited first, so no entry at or above BIG
// ever enters and positions beyond the live candidates read (BIG, -1).
// Rows are -1 wherever dist >= BIG / 2.
//
// Every candidate is a 64-bit key: order-preserving bits of its f32
// distance << 32 | (p * cap + c + 1).  Keys are unique within a query and
// sort exactly as (dist, p, c); the carry's entries are all
// big_key = bits(BIG) << 32 | 0, which sorts before every slot at BIG.
// Within one pair the keys are made in ascending slot order, so a STABLE
// sort of a pair's keys on their upper 32 bits alone gives the exact key
// order (block_sort_hi below).
//
// What bounds it on this card: bytes.  Each probed slot costs 2k + s
// bytes of panel plus 4 of residual and 1 of mask, against about 3(k + s)
// integer operations: far below the ~20 operations per byte where the
// SIMT integer units would become the limit.  The (query, probe) pairs
// touch fewer distinct grains than pairs (at the main path's shape 4,096
// pairs visit ~944 grains), so the bytes the card must move are the
// distinct panels; the rest can come from the 50 MB L2 if the pairs that
// share a grain run together.  On the wide paths (a pair's list of L =
// min(width, cap) >= kBlockSortL keys, or width > kSmemWidth) the outputs
// and the pairs' sorted lists dominate: every design writes Q * width
// outputs, and one that sorts per pair writes and reads Q * P * L keys
// once more.
//
// What the design does about it: a schedule, a per-pair kernel of two
// forms, and a merge of two forms.  The shape picks each; no switch.
//  * Schedule (the wrapper, one stable torch.sort on the card, no host
//    sync): the Q*P pairs ordered by grain id, killed pairs (keep == 0 or
//    p >= n_active[q]) last.  The TPU kernel walks pairs in (q, p) order;
//    the order of visits is a schedule, not part of what is computed.
//    Both per-pair kernels take pairs in this order (blockIdx.x ->
//    order[blockIdx.x]), so the CTAs that read one panel run side by side
//    and all but the first read it from L2.  A killed pair's CTA exits.
//  * fused_scan_select_probe_kernel (L < kBlockSortL, the main path's
//    W=64): one CTA of one warp per pair.  Each lane owns 4 consecutive
//    slots of a 128-slot chunk: one 8-byte load per coordinate row (the
//    warp reads 256 B), 4 bytes of sketch, 16 of residual, 4 of mask; a
//    scalar path (template kVec = false) takes caps that are not a
//    multiple of 4 and misaligned panels.  The warp keeps the pair's own
//    top-L as a sorted carry in shared memory.  Keys at or above the
//    carry's L-th are dropped; a chunk with none left costs one warp
//    scan.  Up to 32 survivors are compacted one per lane and sorted in
//    registers (15 shuffle stages), more are sorted as the chunk's 128 (4
//    per lane), and the run is merged into the carry by merge path (a
//    binary search per output).  No block barrier anywhere: an SM holds
//    32 of these warps, each at its own phase, so one warp's loads overlap
//    another's sort (a form with 256-thread CTAs sorting 1024-slot tiles
//    block-wide took 1.7x as long on an H100 at W=64, PERF.md).
//  * fused_scan_select_block_probe_kernel (L >= kBlockSortL: the
//    cascade's stage 1 at L = cap, and lists above 8,192 keys): at such L
//    the carry drops nothing, and one warp merging every chunk into it
//    was the slow part of the wide paths.  One CTA of kThreads per pair
//    prices up to kSortKeys slots at once (the same loads and arithmetic,
//    4 slots a thread), compacts the live keys in slot order (a block
//    scan; dropped slots would all sort last as big_key), and sorts them
//    block-wide in shared memory: a stable LSD radix sort on the upper 32
//    bits, 8 bits a pass (digits counted with shared atomics, placed by
//    warps in order with ballots), a pass skipped where every key shares
//    its digit (block_sort_hi).  A cap of at most kSortKeys gives the
//    pair's list
//    at once (its first L keys go to `lists`); a larger cap gives
//    ceil(cap / kSortKeys) sorted runs, each cut to min(kSortKeys, L) keys
//    and padded with big_keys, in global scratch, which the multi-way
//    merge then folds into the pair's list (kRuns).
//  * fused_scan_select_merge_kernel (L < kBlockSortL and width <=
//    kSmemWidth): one CTA per query folds the sorted lists of its live
//    probes into a carry of `width` big_keys, probe by probe in visit
//    order, each fold one merge path of two sorted runs (lists staged in
//    shared memory, as many probes at once as fit), then maps the first
//    `width` keys to (dist, row).  A query's top-width holds at most
//    min(width, cap) slots of one probe, and keys are unique, so these are
//    the first `width` of the global sort: bit for bit the plain version.
//  * The multi-way merge (every other shape): n sorted inputs per group
//    (a query's P lists, cut to `width`; or, kRuns, a live pair's runs,
//    cut to L) in one pass.  Only an input's live prefix (its keys below
//    big_key) counts; a dead probe is an empty input, and outputs past
//    the group's live keys are big_keys, as the carry's initial big_keys
//    give.  The first `cut` keys of a merge depend only on the first
//    `cut` keys of each input, so the cuts lose nothing.  Outputs come in
//    tiles of kSortKeys.
//    - fused_scan_select_corank_kernel: one warp per tile boundary b
//      finds how many keys of each input come before output b.  Keys are
//      unique, so a binary search on the upper 32 bits (the distance)
//      finds the distance D of output b, counting in each input (one
//      lane each) the keys below a candidate; outputs of distance D
//      follow input order (probe order, or slot order for runs), so the
//      prefix over inputs of their counts at D settles each co-rank.
//    - fused_scan_select_multiway_merge_kernel: one CTA of kMergeThreads
//      per tile stages the tile's slice of every input (between two
//      co-ranks) in shared memory, merges the sorted slices two by two in
//      ceil(log2 n) rounds (merge_runs: merge path to each thread's first
//      output, then a sequential merge of 8; a spare slot every 8 keys
//      keeps the lanes' writes on distinct banks), and writes its outputs:
//      (dist, row) of a query, or a pair's list.
//    A pass over the Q * P * L keys: the block-sort kernel writes each
//    pair's list (or runs) once, the merge reads it once; the co-ranks
//    read O(P * log L) keys a boundary.  Stage 1's query merge is 1 write
//    + 1 read of Q * P * L keys (the tree merge it replaces: ceil(log2 P)
//    rounds of both); lists above kSortKeys add one write + read of the
//    runs (it replaced 8 tree rounds over 128-key chunk runs).
//
// Limits: 1 <= width, and width <= kSmemWidth or width <= P * cap;
// P * cap < 2^32 - 1; Q * P < 2^31.  Shared memory: the warp probe kernel
// 2 L + 128 keys of 8 bytes (129 KB at L = 8192); the block-sort probe
// kernel 2 min(cap, kSortKeys) keys and the radix counters; the multi-way
// merge two padded buffers of kSortKeys keys (74 KB) and 2 ints an input;
// the shared merge 2 width keys plus a staging area, within kSmemBudget;
// the co-rank kernel an int per input per warp.  Global
// scratch: fused_scan_select_scratch_keys() keys, allocated by the
// caller: the runs (Q * P * ceil(cap / kSortKeys) * min(kSortKeys, L)
// keys, where cap > kSortKeys) and the co-ranks of both merges.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;            // the block-wide kernels' CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSlotsPerThread = 4;
constexpr int kChunk = 32 * kSlotsPerThread;        // slots a warp prices
constexpr int kSmemWidth = 8192;                    // widest shared carry
// A pair's list of at least this many keys is built by the block-sort
// probe kernel (and merged by the multi-way merge), a shorter one by the
// warp's carry.  Chosen on an H100 by chip_select_threshold.py, which
// builds this file with the threshold overridden at each end and times
// both forms at L = 256..2048 (PERF.md).
#ifndef FUSED_SELECT_BLOCK_SORT_L
#define FUSED_SELECT_BLOCK_SORT_L 256
#endif
constexpr int kBlockSortL = FUSED_SELECT_BLOCK_SORT_L;
constexpr int kSortKeys = 4096;          // keys a CTA sorts: a run, a tile
constexpr int kRadix = 256;              // 8-bit digits
constexpr int kMergePer = 8;             // outputs a thread merges a round
constexpr int kMergeThreads = 512;       // the multi-way merge's CTA
constexpr size_t kSmemBudget = 200 * 1024;
constexpr u64 kEmpty = ~0ull;
constexpr unsigned kAll = 0xffffffffu;

static_assert(kThreads == kRadix, "block_sort_hi: a thread per digit");
static_assert(kSortKeys % kSlotsPerThread == 0,
              "a run starts on a 4-slot load");

struct Params {
  const int32_t* gids;          // [Q, P]
  const int32_t* zq;            // [Q, P, k]
  const float* rq;              // [Q, P]
  const uint8_t* keep;          // [Q, P] bool
  const int16_t* coords;        // [G, k, cap]
  const int32_t* res;           // [G, cap]
  const uint8_t* mask;          // [G, cap] bool
  const int32_t* rows;          // [G, cap]
  const float* scale;           // [G]
  const float* res_scale;       // [G]
  const int32_t* sq;            // [Q, P, s] or null
  const int8_t* sketch;         // [G, s, cap] or null
  const float* sketch_scale;    // [G] or null
  const uint8_t* tenant_mask;   // [T, G, cap] bool or null
  const int32_t* tenant_ix;     // [Q] or null
  const int32_t* n_active;      // [Q] or null (= all P probes)
  const int64_t* order;         // [Q * P] pairs q * P + p, grain order
  u64* lists;                   // [Q * P, L] per-pair sorted top-L keys
  u64* runs;                    // [Q * P, n_runs, run_stride] sorted runs
  float* out_d;                 // [Q, width]
  int32_t* out_r;               // [Q, width]
  int P, k, s, G, cap, width, L, stage_probes, n_runs, run_stride;
  u64 big_key;
  float big;
};

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of_order(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ bool pair_alive(const Params& p, int q, int pi) {
  if (!p.keep[static_cast<int64_t>(q) * p.P + pi]) return false;
  return p.n_active == nullptr || pi < p.n_active[q];
}

// The number of a's among the first i outputs of the ascending merge of
// sorted runs a[0, la) and b[0, lb) (ties: a first), i <= la + lb: merge
// path, by binary search.
__device__ __forceinline__ int merge_split(const u64* a, int la, const u64* b,
                                           int lb, int i) {
  int lo = max(0, i - lb), hi = min(i, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[i - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Output i of that merge.
__device__ __forceinline__ u64 merge_at(const u64* a, int la, const u64* b,
                                        int lb, int i) {
  const int na = merge_split(a, la, b, lb, i);
  const int j = i - na;
  if (na < la && (j >= lb || a[na] <= b[j])) return a[na];
  return b[j];
}

// The number of keys of sorted a[0, n) below x.
__device__ __forceinline__ int lower_bound(const u64* a, int n, u64 x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Output i of query q from its key: (dist, row), row -1 at dist >= BIG / 2.
__device__ __forceinline__ void emit(const Params& p, int q, int64_t i,
                                     u64 key) {
  const float d = float_of_order(static_cast<uint32_t>(key >> 32));
  int32_t row = -1;
  if (d < p.big * 0.5f) {
    const uint32_t v = static_cast<uint32_t>(key) - 1u;
    const int pi = static_cast<int>(v / static_cast<uint32_t>(p.cap));
    const int c = static_cast<int>(v % static_cast<uint32_t>(p.cap));
    const int g = __ldg(p.gids + static_cast<int64_t>(q) * p.P + pi);
    row = __ldg(p.rows + static_cast<int64_t>(g) * p.cap + c);
  }
  const int64_t o = static_cast<int64_t>(q) * p.width + i;
  p.out_d[o] = d;
  p.out_r[o] = row;
}

// Ascending bitonic sort of the warp's 32 * kPer keys, element
// e = lane * kPer + r in v[r], in registers.
template <int kPer>
__device__ __forceinline__ void warp_sort(u64 (&v)[kPer]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * kPer; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int e = lane * kPer + r;
        const bool up = (e & size) == 0;
        if (stride >= kPer) {
          const u64 o = __shfl_xor_sync(kAll, v[r], stride / kPer);
          const bool lower = (e & stride) == 0;
          const u64 lo = v[r] < o ? v[r] : o;
          const u64 hi = v[r] < o ? o : v[r];
          v[r] = lower == up ? lo : hi;
        } else if ((r & stride) == 0) {
          const u64 a = v[r], b = v[r + stride];
          if ((a > b) == up) {
            v[r] = b;
            v[r + stride] = a;
          }
        }
      }
    }
  }
}

// Loads 4 consecutive elements starting at element c0 of a row (kVec: one
// aligned vector load; else one guarded load each, 0 beyond `cap`).
template <bool kVec, typename T>
__device__ __forceinline__ void load4(const T* row, int c0, int cap,
                                      int (&x)[kSlotsPerThread]) {
  if constexpr (kVec) {
    if constexpr (sizeof(T) == 1) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(row + c0);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        x[r] = static_cast<int>(static_cast<T>((w >> (8 * r)) & 0xffu));
    } else if constexpr (sizeof(T) == 2) {
      const uint2 w = *reinterpret_cast<const uint2*>(row + c0);
      x[0] = static_cast<int>(static_cast<T>(w.x & 0xffffu));
      x[1] = static_cast<int>(static_cast<T>(w.x >> 16));
      x[2] = static_cast<int>(static_cast<T>(w.y & 0xffffu));
      x[3] = static_cast<int>(static_cast<T>(w.y >> 16));
    } else {
      const int4 w = *reinterpret_cast<const int4*>(row + c0);
      x[0] = w.x;
      x[1] = w.y;
      x[2] = w.z;
      x[3] = w.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = c0 + r < cap ? static_cast<int>(row[c0 + r]) : 0;
  }
}

// What pricing the slots of one (query, probe) pair reads besides the
// query's coordinates.
struct Pair {
  const int16_t* coords;        // the grain's [k, cap] panel
  const int8_t* sketch;         // [s, cap] or null
  const uint8_t* tenant;        // the query's tenant row [cap] or null
  const int32_t* res;           // [cap]
  const uint8_t* mask;          // [cap]
  float sc2, rs, rqv, sk2;
  uint32_t visit0;              // p * cap + 1
};

template <bool kSketch, bool kTenant>
__device__ __forceinline__ Pair pair_of(const Params& p, int64_t pair, int q,
                                        int pi) {
  Pair x;
  const int g = p.gids[pair];
  const float sc = p.scale[g];
  x.sc2 = __fmul_rn(sc, sc);
  x.rs = p.res_scale[g];
  x.rqv = p.rq[pair];
  x.sk2 = 0.0f;
  if (kSketch) {
    const float ss = p.sketch_scale[g];
    x.sk2 = __fmul_rn(ss, ss);
  }
  const int64_t gc = static_cast<int64_t>(g) * p.cap;
  x.coords = p.coords + gc * p.k;
  x.sketch = kSketch ? p.sketch + gc * p.s : nullptr;
  x.tenant = nullptr;
  if (kTenant)
    x.tenant = p.tenant_mask +
               (static_cast<int64_t>(p.tenant_ix[q]) * p.G + g) * p.cap;
  x.res = p.res + gc;
  x.mask = p.mask + gc;
  x.visit0 = static_cast<uint32_t>(pi) * p.cap + 1u;
  return x;
}

// The keys of slots c0 .. c0 + 3 (c0 < cap) of a pair: kEmpty for a
// dropped slot or one past cap.  zq_s / sq_s: the pair's query
// coordinates.
template <bool kSketch, bool kTenant, bool kVec>
__device__ __forceinline__ void price4(const Params& p, const Pair& x,
                                       const int* zq_s, const int* sq_s,
                                       int c0, u64 (&v)[kSlotsPerThread]) {
  uint32_t acc[kSlotsPerThread] = {0u, 0u, 0u, 0u};   // int32, wraps
#pragma unroll 8
  for (int j = 0; j < p.k; ++j) {
    int z[kSlotsPerThread];
    load4<kVec>(x.coords + static_cast<int64_t>(j) * p.cap, c0, p.cap, z);
    const int zj = zq_s[j];
#pragma unroll
    for (int r = 0; r < kSlotsPerThread; ++r) {
      const uint32_t df =
          static_cast<uint32_t>(zj) - static_cast<uint32_t>(z[r]);
      acc[r] += df * df;
    }
  }
  uint32_t sacc[kSlotsPerThread] = {0u, 0u, 0u, 0u};
  if (kSketch) {
#pragma unroll 8
    for (int j = 0; j < p.s; ++j) {
      int z[kSlotsPerThread];
      load4<kVec>(x.sketch + static_cast<int64_t>(j) * p.cap, c0, p.cap, z);
      const int zj = sq_s[j];
#pragma unroll
      for (int r = 0; r < kSlotsPerThread; ++r) {
        const uint32_t df =
            static_cast<uint32_t>(zj) - static_cast<uint32_t>(z[r]);
        sacc[r] += df * df;
      }
    }
  }
  int rv[kSlotsPerThread], mv[kSlotsPerThread], tv[kSlotsPerThread];
  load4<kVec>(x.res, c0, p.cap, rv);
  load4<kVec>(x.mask, c0, p.cap, mv);
  if (kTenant) load4<kVec>(x.tenant, c0, p.cap, tv);
#pragma unroll
  for (int r = 0; r < kSlotsPerThread; ++r) {
    float d = __fmul_rn(static_cast<float>(static_cast<int32_t>(acc[r])),
                        x.sc2);
    d = __fadd_rn(__fadd_rn(d, __fmul_rn(static_cast<float>(rv[r]), x.rs)),
                  x.rqv);
    if (kSketch)
      d = __fadd_rn(d, __fmul_rn(static_cast<float>(
                                     static_cast<int32_t>(sacc[r])), x.sk2));
    bool live = c0 + r < p.cap && mv[r] != 0;
    if (kTenant) live = live && tv[r] != 0;
    const u64 key = (static_cast<u64>(order_bits(d)) << 32) |
                    (x.visit0 + static_cast<uint32_t>(c0 + r));
    v[r] = live ? key : kEmpty;
  }
}

// 32 resident CTAs of one warp fill an SM's 64K registers at 64 each.
template <bool kSketch, bool kTenant, bool kVec>
__global__ void __launch_bounds__(32, 32)
fused_scan_select_probe_kernel(const Params p) {
  extern __shared__ u64 smem[];
  const int L = p.L;                           // the carry's keys
  u64* carry = smem;                           // [L]
  u64* spare = carry + L;                      // [L]
  u64* run = spare + L;                        // [kChunk] a chunk's survivors
  int* zq_s = reinterpret_cast<int*>(run + kChunk);
  int* sq_s = zq_s + p.k;

  const int64_t pair = p.order[blockIdx.x];
  const int q = static_cast<int>(pair / p.P);
  const int pi = static_cast<int>(pair - static_cast<int64_t>(q) * p.P);
  if (!pair_alive(p, q, pi)) return;           // warp-uniform
  const int lane = threadIdx.x;

  for (int j = lane; j < p.k; j += 32) zq_s[j] = p.zq[pair * p.k + j];
  if (kSketch)
    for (int j = lane; j < p.s; j += 32) sq_s[j] = p.sq[pair * p.s + j];
  for (int i = lane; i < L; i += 32) carry[i] = p.big_key;
  __syncwarp();

  const Pair pr = pair_of<kSketch, kTenant>(p, pair, q, pi);
  u64 thr = p.big_key;                         // the carry's L-th key

  for (int base = 0; base < p.cap; base += kChunk) {
    const int c0 = base + lane * kSlotsPerThread;
    u64 v[kSlotsPerThread];
    int cnt = 0;
    if (c0 < p.cap) {
      price4<kSketch, kTenant, kVec>(p, pr, zq_s, sq_s, c0, v);
#pragma unroll
      for (int r = 0; r < kSlotsPerThread; ++r) {
        if (v[r] >= thr) v[r] = kEmpty;
        cnt += v[r] != kEmpty;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kSlotsPerThread; ++r) v[r] = kEmpty;
    }
    // survivors of the warp, each lane's count summed inclusively
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += x;
    }
    const int n = __shfl_sync(kAll, incl, 31);
    if (n == 0) continue;                      // warp-uniform

    // The survivors as one sorted run in run[0, m): few of them (the
    // common case once the carry holds L real keys) are compacted one per
    // lane and sorted as 32; else the chunk's 128 keys are sorted whole.
    int m;
    if (n <= 32) {
      int at = incl - cnt;
#pragma unroll
      for (int r = 0; r < kSlotsPerThread; ++r)
        if (v[r] != kEmpty) run[at++] = v[r];
      __syncwarp();
      u64 x[1] = {lane < n ? run[lane] : kEmpty};
      warp_sort(x);
      __syncwarp();
      run[lane] = x[0];
      m = min(n, L);
    } else {
      warp_sort(v);
#pragma unroll
      for (int r = 0; r < kSlotsPerThread; ++r)
        run[lane * kSlotsPerThread + r] = v[r];
      m = min(n, L);
    }
    __syncwarp();
    for (int i = lane; i < L; i += 32) spare[i] = merge_at(carry, L, run, m, i);
    __syncwarp();
    u64* tmp = carry;
    carry = spare;
    spare = tmp;
    thr = carry[L - 1];
  }

  u64* out = p.lists + pair * L;
  for (int i = lane; i < L; i += 32) out[i] = carry[i];
}

// The lanes whose digit d (8 bits) equals this lane's, among the lanes
// where `live` holds: eight ballots, one per bit.
__device__ __forceinline__ unsigned peers_of(unsigned d, bool live) {
  unsigned m = __ballot_sync(kAll, live);
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const unsigned b = __ballot_sync(kAll, (d >> bit) & 1u);
    m &= (d >> bit) & 1u ? b : ~b;
  }
  return m;
}

// Sorts keys[0, n) ascending by their upper 32 bits, stably, with the
// CTA's kThreads threads: an LSD radix sort of 4 passes of 8 bits.
// tmp[n] is the second buffer, cnt[kWarps * kRadix] the warps' digit
// counters and wsum[kWarps] the scan's warp totals, all shared.  Warp w
// owns a contiguous segment of the keys: it counts their digits with
// shared atomics, then walks the segment 32 keys at a time in order to
// place them (a key's rank among equal digits of its 32 from eight
// ballots), so equal digits keep their order: a pass is stable.  A pass
// whose digit every key shares moves nothing and is skipped.  Returns the
// buffer that holds the result (keys or tmp).  Every thread must call it.
__device__ u64* block_sort_hi(u64* keys, u64* tmp, int n, int* cnt,
                              int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int seg = (n + kWarps - 1) / kWarps;
  const int s0 = min(n, w * seg), s1 = min(n, s0 + seg);
  int* mine = cnt + w * kRadix;
  const unsigned below = (1u << lane) - 1u;
  for (int shift = 32; shift < 64; shift += 8) {
    for (int d = lane; d < kRadix; d += 32) mine[d] = 0;
    __syncwarp();
    for (int i = s0 + lane; i < s1; i += 32)     // count
      atomicAdd(&mine[static_cast<unsigned>(keys[i] >> shift) & 0xffu], 1);
    __syncthreads();
    // offsets in (digit, warp) order: thread tid owns digit tid
    int tot = 0;
    for (int v = 0; v < kWarps; ++v) {
      const int c = cnt[v * kRadix + tid];
      cnt[v * kRadix + tid] = tot;
      tot += c;
    }
    int incl = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) wsum[w] = incl;
    if (__syncthreads_or(tot == n)) continue;    // one digit: nothing moves
    int base = incl - tot;
    for (int v = 0; v < w; ++v) base += wsum[v];
    for (int v = 0; v < kWarps; ++v) cnt[v * kRadix + tid] += base;
    __syncthreads();
    for (int b = s0; b < s1; b += 32) {          // scatter, in order
      const int i = b + lane;
      const u64 key = i < s1 ? keys[i] : 0ull;
      const unsigned d = static_cast<unsigned>(key >> shift) & 0xffu;
      const unsigned peers = peers_of(d, i < s1);
      const int at = mine[d] + __popc(peers & below);
      if (i < s1) tmp[at] = key;
      __syncwarp();
      if (i < s1 && (peers >> lane) == 1u) mine[d] = at + 1;  // the last
      __syncwarp();
    }
    __syncthreads();
    u64* t = keys;
    keys = tmp;
    tmp = t;
  }
  return keys;
}

// Position of key i in a padded buffer of the multi-way merge: a spare
// slot after every 8 keys, so the 32 lanes of a warp, each writing its
// own run of kMergePer = 8 consecutive outputs, hit distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

// Keys of a padded buffer of n keys.
__host__ __device__ constexpr int padded(int n) { return n + n / 8 + 1; }

// merge_split over runs buf[a0, a0 + la) and buf[b0, b0 + lb) of a padded
// buffer.
__device__ __forceinline__ int merge_split_padded(const u64* buf, int a0,
                                                  int la, int b0, int lb,
                                                  int i) {
  int lo = max(0, i - lb), hi = min(i, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (buf[pad(a0 + mid)] <= buf[pad(b0 + i - 1 - mid)]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Merges the sorted runs [bound[i], bound[i + 1]) (i < n_runs,
// bound[n_runs] = n) of the padded buffer keys into one sorted run, two by
// two in ceil(log2 n_runs) rounds through the padded buffer tmp, with the
// CTA's kMergeThreads threads.  Each thread makes kMergePer consecutive
// outputs of a round: merge path to the first (merge_split_padded), then
// a sequential merge.  Keys are compared whole, and equal keys are equal
// bits.  Returns the buffer holding the result.  Every thread must call
// it.
__device__ u64* merge_runs(u64* keys, u64* tmp, int n, const int* bound,
                           int n_runs) {
  for (int span = 1; span < n_runs; span *= 2) {
    const int n_pairs = (n_runs + 2 * span - 1) / (2 * span);
    for (int o0 = threadIdx.x * kMergePer; o0 < n;
         o0 += kMergeThreads * kMergePer) {
      int j = 0, top = n_pairs - 1;          // the last pair from <= o0
      while (j < top) {
        const int mid = (j + top + 1) >> 1;
        if (bound[min(2 * span * mid, n_runs)] <= o0) j = mid;
        else top = mid - 1;
      }
      int a0 = bound[min(2 * span * j, n_runs)];
      int b0 = bound[min(2 * span * j + span, n_runs)];
      int e = bound[min(2 * span * (j + 1), n_runs)];
      int ia = merge_split_padded(keys, a0, b0 - a0, b0, e - b0, o0 - a0);
      int ib = o0 - a0 - ia;
      u64 ha = a0 + ia < b0 ? keys[pad(a0 + ia)] : kEmpty;
      u64 hb = b0 + ib < e ? keys[pad(b0 + ib)] : kEmpty;
      const int o1 = min(o0 + kMergePer, n);
      for (int o = o0; o < o1; ++o) {
        while (o == e) {                     // on into the next pair
          ++j;
          a0 = e;
          b0 = bound[min(2 * span * j + span, n_runs)];
          e = bound[min(2 * span * (j + 1), n_runs)];
          ia = ib = 0;
          ha = a0 < b0 ? keys[pad(a0)] : kEmpty;
          hb = b0 < e ? keys[pad(b0)] : kEmpty;
        }
        if (ha <= hb) {
          tmp[pad(o)] = ha;
          ++ia;
          ha = a0 + ia < b0 ? keys[pad(a0 + ia)] : kEmpty;
        } else {
          tmp[pad(o)] = hb;
          ++ib;
          hb = b0 + ib < e ? keys[pad(b0 + ib)] : kEmpty;
        }
      }
    }
    __syncthreads();
    u64* t = keys;
    keys = tmp;
    tmp = t;
  }
  return keys;
}

// Shared memory of the block-sort probe kernel: two buffers of `keys`
// keys, then the radix counters and the warp totals, then `ints` more.
size_t sort_smem(int keys, int ints) {
  return 2 * static_cast<size_t>(keys) * sizeof(u64) +
         static_cast<size_t>(kWarps * kRadix + kWarps + ints) * sizeof(int);
}

// L >= kBlockSortL: one CTA of kThreads per pair prices kSortKeys slots
// at a time and sorts them block-wide; a cap of at most kSortKeys is the
// pair's list, a larger one a run of it.
template <bool kSketch, bool kTenant, bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_scan_select_block_probe_kernel(const Params p) {
  extern __shared__ u64 smem[];
  const int n_keys = min(p.cap, kSortKeys);
  u64* keys = smem;                            // [n_keys]
  u64* tmp = keys + n_keys;                    // [n_keys]
  int* cnt = reinterpret_cast<int*>(tmp + n_keys);
  int* wsum = cnt + kWarps * kRadix;
  int* zq_s = wsum + kWarps;
  int* sq_s = zq_s + p.k;

  const int64_t pair = p.order[blockIdx.x];
  const int q = static_cast<int>(pair / p.P);
  const int pi = static_cast<int>(pair - static_cast<int64_t>(q) * p.P);
  if (!pair_alive(p, q, pi)) return;           // block-uniform
  const int tid = threadIdx.x;
  for (int j = tid; j < p.k; j += kThreads) zq_s[j] = p.zq[pair * p.k + j];
  if (kSketch)
    for (int j = tid; j < p.s; j += kThreads) sq_s[j] = p.sq[pair * p.s + j];
  __syncthreads();
  const Pair pr = pair_of<kSketch, kTenant>(p, pair, q, pi);

  const int lane = tid & 31, w = tid >> 5;
  for (int r = 0; r < p.n_runs; ++r) {
    const int base = r * kSortKeys;
    const int n = min(kSortKeys, p.cap - base);
    // the run's live keys, compacted in slot order (dropped slots all
    // sort last as big_key, so only the live ones are sorted)
    int live = 0;
    for (int c0 = 0; c0 < n; c0 += kThreads * kSlotsPerThread) {
      const int c = c0 + tid * kSlotsPerThread;
      u64 v[kSlotsPerThread];
      int kept = 0;
      if (c < n) {
        price4<kSketch, kTenant, kVec>(p, pr, zq_s, sq_s, base + c, v);
#pragma unroll
        for (int e = 0; e < kSlotsPerThread; ++e) {
          if (c + e >= n || v[e] >= p.big_key) v[e] = kEmpty;
          kept += v[e] != kEmpty;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kSlotsPerThread; ++e) v[e] = kEmpty;
      }
      int incl = kept;                         // block exclusive scan
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(kAll, incl, o);
        if (lane >= o) incl += x;
      }
      if (lane == 31) wsum[w] = incl;
      __syncthreads();
      int at = live + incl - kept;
      for (int u = 0; u < kWarps; ++u) {
        if (u < w) at += wsum[u];
        live += wsum[u];
      }
#pragma unroll
      for (int e = 0; e < kSlotsPerThread; ++e)
        if (v[e] != kEmpty) keys[at++] = v[e];
      __syncthreads();                         // wsum is reused
    }
    const u64* sorted = block_sort_hi(keys, tmp, live, cnt, wsum);
    if (p.n_runs == 1) {                       // the list: L <= cap = n
      u64* out = p.lists + pair * p.L;
      for (int i = tid; i < p.L; i += kThreads)
        out[i] = i < live ? sorted[i] : p.big_key;
    } else {
      u64* out = p.runs + (pair * p.n_runs + r) * p.run_stride;
      for (int i = tid; i < p.run_stride; i += kThreads)
        out[i] = i < live ? sorted[i] : p.big_key;
    }
    __syncthreads();                           // keys are refilled
  }
}

__global__ void __launch_bounds__(kThreads)
fused_scan_select_merge_kernel(const Params p) {
  extern __shared__ u64 smem[];
  u64* carry = smem;                           // [width]
  u64* spare = carry + p.width;                // [width]
  u64* stage = spare + p.width;                // [stage_probes * L]

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = p.L, W = p.width;
  for (int i = tid; i < W; i += kThreads) carry[i] = p.big_key;
  int n_probe = p.P;
  if (p.n_active != nullptr) n_probe = min(max(p.n_active[q], 0), p.P);
  const int64_t qp = static_cast<int64_t>(q) * p.P;

  for (int p0 = 0; p0 < n_probe; p0 += p.stage_probes) {
    const int n = min(p.stage_probes, n_probe - p0);
    for (int t = tid; t < n * L; t += kThreads) {
      const int j = t / L;
      if (p.keep[qp + p0 + j]) stage[t] = p.lists[(qp + p0) * L + t];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const u64* list = stage + j * L;
      // block-uniform: skip a dead probe, or one whose best key cannot
      // enter the carry
      if (!p.keep[qp + p0 + j] || list[0] >= carry[W - 1]) continue;
      for (int i = tid; i < W; i += kThreads)
        spare[i] = merge_at(carry, W, list, L, i);
      __syncthreads();
      u64* tmp = carry;
      carry = spare;
      spare = tmp;
    }
    __syncthreads();                           // stage is reloaded
  }

  for (int i = tid; i < W; i += kThreads) emit(p, q, i, carry[i]);
}

// The sorted inputs of group g of a multi-way merge: kRuns, pair g's
// runs, merged and cut to L (its list); else query g's probes' lists,
// cut to width (its outputs).  Input j is base[j * stride, ...); only its
// live prefix (keys below big_key) counts, and a dead probe's list is
// empty.  False for a dead pair (kRuns), which has nothing to merge.
struct Group {
  const u64* base;
  int64_t stride;
  int n, cut;
};

template <bool kRuns>
__device__ __forceinline__ bool group_of(const Params& p, int64_t g,
                                         Group& G) {
  if (kRuns) {
    const int q = static_cast<int>(g / p.P);
    if (!pair_alive(p, q, static_cast<int>(g - int64_t{q} * p.P)))
      return false;
    G.base = p.runs + g * p.n_runs * p.run_stride;
    G.stride = p.run_stride;
    G.n = p.n_runs;
    G.cut = p.L;
  } else {
    G.base = p.lists + g * p.P * p.L;
    G.stride = p.L;
    G.n = p.P;
    G.cut = p.width;
  }
  return true;
}

template <bool kRuns>
__device__ __forceinline__ int input_len(const Params& p, const Group& G,
                                         int64_t g, int j) {
  if (!kRuns && !pair_alive(p, static_cast<int>(g), j)) return 0;
  return lower_bound(G.base + j * G.stride, static_cast<int>(G.stride),
                     p.big_key);
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// Co-ranks of a multi-way merge: for tile boundary t of group g (output
// b = min(t * kSortKeys, cut), t <= n_tiles), how many keys of each input
// come before output b, to corank[(g * (n_tiles + 1) + t) * n + j].  One
// warp per boundary (blockDim.x / 32 a block); each warp keeps its
// inputs' live lengths and its candidates' counts in n + 32 ints of
// dynamic shared memory.
template <bool kRuns>
__global__ void __launch_bounds__(kThreads)
fused_scan_select_corank_kernel(const Params p, int64_t n_groups,
                                int n_tiles, int* corank) {
  extern __shared__ int lens_all[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t item =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + w;
  if (item >= n_groups * (n_tiles + 1)) return;        // warp-uniform
  const int64_t g = item / (n_tiles + 1);
  const int t = static_cast<int>(item - g * (n_tiles + 1));
  Group G;
  if (!group_of<kRuns>(p, g, G)) return;               // warp-uniform
  const int n = G.n;
  int* lens = lens_all + w * (n + 32);
  int* sums = lens + n;                        // [32] a candidate's count
  int* out = corank + item * n;
  int total = 0;
  uint32_t lo = ~0u, hi = 0u;                  // the live keys' distances
  for (int j = lane; j < n; j += 32) {
    const int len = input_len<kRuns>(p, G, g, j);
    lens[j] = len;
    total += len;
    if (len > 0) {
      const u64* in = G.base + j * G.stride;
      lo = min(lo, static_cast<uint32_t>(in[0] >> 32));
      hi = max(hi, static_cast<uint32_t>(in[len - 1] >> 32));
    }
  }
  total = warp_sum(total);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(kAll, lo, o));
    hi = max(hi, __shfl_xor_sync(kAll, hi, o));
  }
  const int64_t b64 = min(static_cast<int64_t>(t) * kSortKeys,
                          static_cast<int64_t>(G.cut));
  if (b64 == 0 || b64 >= total) {             // none or every live key
    for (int j = lane; j < n; j += 32) out[j] = b64 == 0 ? 0 : lens[j];
    return;
  }
  const int b = static_cast<int>(b64);
  // D: the least distance with more than b keys at or below it, by a
  // (c + 1)-ary search: c = 32 / n candidates a round where n <= 16 (lane
  // l counts for candidate l / n in input l % n), else one (lane l for
  // inputs l, l + 32, ...)
  const int c = n <= 16 ? 32 / n : 1;
  const int ci = c > 1 ? lane / n : 0;
  while (lo < hi) {
    const u64 span = hi - lo;
    if (lane < c) sums[lane] = 0;
    __syncwarp();
    if (ci < c) {
      const uint32_t m =
          lo + static_cast<uint32_t>(span * (ci + 1) / (c + 1));
      const u64 x = (static_cast<u64>(m) + 1) << 32;
      int cnt = 0;
      for (int j = c > 1 ? lane % n : lane; j < n; j += c > 1 ? n : 32)
        cnt += lower_bound(G.base + j * G.stride, lens[j], x);
      atomicAdd(sums + ci, cnt);
    }
    __syncwarp();
    int first = c;                             // the first above b
    for (int i = c - 1; i >= 0; --i)
      if (sums[i] > b) first = i;
    __syncwarp();                              // sums are reset
    if (first < c)
      hi = lo + static_cast<uint32_t>(span * (first + 1) / (c + 1));
    if (first > 0)
      lo += static_cast<uint32_t>(span * first / (c + 1)) + 1;
  }
  const u64 x0 = static_cast<u64>(lo) << 32;
  const u64 x1 = (static_cast<u64>(lo) + 1) << 32;
  int below_d = 0;
  for (int j = lane; j < n; j += 32)
    below_d += lower_bound(G.base + j * G.stride, lens[j], x0);
  // outputs below b at distance D: the first r of them in input order
  const int r = b - warp_sum(below_d);
  int carry = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {         // warp-uniform
    const int j = j0 + lane;
    int lt = 0, at_d = 0;
    if (j < n) {
      const u64* in = G.base + j * G.stride;
      lt = lower_bound(in, lens[j], x0);
      at_d = lower_bound(in, lens[j], x1) - lt;
    }
    int incl = at_d;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += y;
    }
    const int before = carry + incl - at_d;
    if (j < n) out[j] = lt + min(max(r - before, 0), at_d);
    carry += __shfl_sync(kAll, incl, 31);
  }
}

// Tile t of group g's multi-way merge (block g * n_tiles + t): outputs
// [t * kSortKeys, min((t + 1) * kSortKeys, cut)).  The tile's slice of
// each input, between its co-ranks at boundaries t and t + 1, is staged
// in shared memory, the sorted slices are merged (merge_runs), and the
// result written: a pair's list (kRuns) or (dist, row) of a query;
// positions past the group's live keys are big_keys.
template <bool kRuns>
__global__ void __launch_bounds__(kMergeThreads)
fused_scan_select_multiway_merge_kernel(const Params p, int n_tiles,
                                        const int* corank) {
  extern __shared__ u64 smem[];
  u64* keys = smem;                            // padded, kSortKeys keys
  u64* tmp = keys + padded(kSortKeys);         // the same
  int* at = reinterpret_cast<int*>(tmp + padded(kSortKeys));  // [n + 1]
  const int64_t g = blockIdx.x / n_tiles;
  const int t = static_cast<int>(blockIdx.x - g * n_tiles);
  Group G;
  if (!group_of<kRuns>(p, g, G)) return;       // block-uniform
  const int n = G.n;
  int* from = at + n + 1;                      // [n] slice starts in inputs
  const int* lo = corank + (g * (n_tiles + 1) + t) * n;
  const int* hi = lo + n;
  const int tid = threadIdx.x;
  for (int j = tid; j < n; j += kMergeThreads) {
    from[j] = lo[j];
    at[j + 1] = hi[j] - lo[j];
  }
  __syncthreads();
  if (tid == 0) {                              // prefix of slice lengths
    at[0] = 0;
    for (int j = 0; j < n; ++j) at[j + 1] += at[j];
  }
  __syncthreads();
  const int m = at[n];
  for (int i = tid; i < m; i += kMergeThreads) {
    int a = 0, z = n;                          // the slice holding i
    while (z - a > 1) {
      const int mid = (a + z) >> 1;
      if (at[mid] <= i) a = mid;
      else z = mid;
    }
    keys[pad(i)] = G.base[a * G.stride + from[a] + (i - at[a])];
  }
  __syncthreads();
  const u64* sorted = merge_runs(keys, tmp, m, at, n);
  const int64_t i0 = static_cast<int64_t>(t) * kSortKeys;
  const int len = static_cast<int>(
      min(static_cast<int64_t>(kSortKeys), G.cut - i0));
  for (int i = tid; i < len; i += kMergeThreads) {
    const u64 key = i < m ? sorted[pad(i)] : p.big_key;
    if (kRuns) p.lists[g * p.L + i0 + i] = key;
    else emit(p, static_cast<int>(g), i0 + i, key);
  }
}

typedef void (*Kernel)(const Params);

template <bool kSketch, bool kTenant, bool kBlock>
Kernel probe_kernel(bool vec) {
  if (kBlock)
    return vec ? fused_scan_select_block_probe_kernel<kSketch, kTenant, true>
               : fused_scan_select_block_probe_kernel<kSketch, kTenant,
                                                      false>;
  return vec ? fused_scan_select_probe_kernel<kSketch, kTenant, true>
             : fused_scan_select_probe_kernel<kSketch, kTenant, false>;
}

template <bool kBlock>
Kernel probe_kernel(bool sketch, bool tenant, bool vec) {
  if (sketch)
    return tenant ? probe_kernel<true, true, kBlock>(vec)
                  : probe_kernel<true, false, kBlock>(vec);
  return tenant ? probe_kernel<false, true, kBlock>(vec)
                : probe_kernel<false, false, kBlock>(vec);
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Which kernels a launch takes, and its global scratch (in keys of 8
// bytes): the runs first, then the two merges' co-ranks (ints).
struct Plan {
  bool block;       // L >= kBlockSortL: the block-sort probe kernel
  bool runs;        // and cap > kSortKeys: runs, merged per pair
  bool multiway;    // the query's multi-way merge (else the shared merge)
  int L, n_runs, run_stride, run_tiles, tiles;
  int64_t runs_keys, run_coranks, coranks, scratch_keys;
};

Plan plan_of(int64_t q, int64_t P, int64_t cap, int64_t width) {
  Plan s{};
  s.L = static_cast<int>(width < cap ? width : cap);
  s.block = s.L >= kBlockSortL;
  s.runs = s.block && cap > kSortKeys;
  s.multiway = s.block || width > kSmemWidth;
  s.n_runs = s.runs ? static_cast<int>(ceil_div(cap, kSortKeys)) : 1;
  s.run_stride = s.L < kSortKeys ? s.L : kSortKeys;
  s.run_tiles = static_cast<int>(ceil_div(s.L, kSortKeys));
  s.tiles = static_cast<int>(ceil_div(width, kSortKeys));
  if (s.runs) {
    s.runs_keys = q * P * s.n_runs * s.run_stride;
    s.run_coranks = q * P * (s.run_tiles + 1) * s.n_runs;
  }
  if (s.multiway) s.coranks = q * (s.tiles + 1) * P;
  s.scratch_keys = s.runs_keys + ceil_div(s.run_coranks, 2) +
                   ceil_div(s.coranks, 2);
  return s;
}

// One multi-way merge (the co-ranks, then the tiles) of n_groups groups
// of n inputs each, on `st`.
cudaError_t multiway_merge(const Params& p, bool runs, int64_t n_groups,
                           int n, int tiles, int* corank, cudaStream_t st) {
  const int64_t items = n_groups * (tiles + 1);
  int wpb = static_cast<int>(kSmemBudget / (sizeof(int) * (n + 32)));
  wpb = wpb < 1 ? 1 : (wpb > kWarps ? kWarps : wpb);
  const size_t corank_smem = sizeof(int) * (n + 32) * wpb;
  const size_t merge_smem =
      2 * padded(kSortKeys) * sizeof(u64) + (2 * n + 1) * sizeof(int);
  if (corank_smem > kSmemBudget || merge_smem > kSmemBudget)
    return cudaErrorInvalidConfiguration;
  const int64_t corank_blocks = ceil_div(items, wpb);
  if (corank_blocks >= (1ll << 31) || n_groups * tiles >= (1ll << 31))
    return cudaErrorInvalidConfiguration;
  cudaError_t e =
      runs ? set_smem(fused_scan_select_corank_kernel<true>, corank_smem)
           : set_smem(fused_scan_select_corank_kernel<false>, corank_smem);
  if (e == cudaSuccess)
    e = runs ? set_smem(fused_scan_select_multiway_merge_kernel<true>,
                        merge_smem)
             : set_smem(fused_scan_select_multiway_merge_kernel<false>,
                        merge_smem);
  if (e != cudaSuccess) return e;
  const unsigned cb = static_cast<unsigned>(corank_blocks);
  const unsigned mb = static_cast<unsigned>(n_groups * tiles);
  if (runs)
    fused_scan_select_corank_kernel<true><<<cb, 32 * wpb, corank_smem, st>>>(
        p, n_groups, tiles, corank);
  else
    fused_scan_select_corank_kernel<false><<<cb, 32 * wpb, corank_smem, st>>>(
        p, n_groups, tiles, corank);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (runs)
    fused_scan_select_multiway_merge_kernel<true>
        <<<mb, kMergeThreads, merge_smem, st>>>(p, tiles, corank);
  else
    fused_scan_select_multiway_merge_kernel<false>
        <<<mb, kMergeThreads, merge_smem, st>>>(p, tiles, corank);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_scan_select_smem_width() { return kSmemWidth; }

extern "C" int fused_scan_select_block_sort_length() { return kBlockSortL; }

// Keys of global scratch the launch needs (0 on the shared merge's path):
// a pair's runs where its list is built from them, and the co-ranks of
// the multi-way merges.
extern "C" long long fused_scan_select_scratch_keys(int n_queries,
                                                    int n_probes, int cap,
                                                    int width) {
  return plan_of(n_queries, n_probes, cap, width).scratch_keys;
}

extern "C" const char* fused_scan_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the probe kernel over `n_pairs` = Q * P CTAs (the block-sort
// form at L >= kBlockSortL, then, where the cap exceeds kSortKeys, the
// multi-way merge of each pair's runs), then the shared merge kernel over
// Q or the query's multi-way merge, on `stream`; returns
// cudaGetLastError() after the launches (0 on success).  Null pointers
// mark absent optional inputs.  `order` is the schedule (int64 pair
// indices, killed pairs anywhere), `lists` scratch of Q * P * min(width,
// cap) keys, `scratch` that of fused_scan_select_scratch_keys(); `vec`
// selects the vector loads (cap % 4 == 0 and 16-byte aligned panels,
// checked here).
extern "C" int fused_scan_select_launch(
    const void* gids, const void* zq, const void* rq, const void* keep,
    const void* coords, const void* res, const void* mask, const void* rows,
    const void* scale, const void* res_scale, const void* sq,
    const void* sketch, const void* sketch_scale, const void* tenant_mask,
    const void* tenant_ix, const void* n_active, const void* order,
    void* lists, void* scratch, void* out_d, void* out_r, int n_queries,
    int n_probes, int k, int s, int n_grains, int cap, int width, int vec,
    float big, void* stream) {
  if (width < 1 || n_queries < 1 || n_probes < 1 || cap < 1 ||
      (width > kSmemWidth && width > static_cast<int64_t>(n_probes) * cap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (cap % kSlotsPerThread != 0 || !aligned16(coords) ||
              !aligned16(res) || !aligned16(mask) || !aligned16(sketch) ||
              !aligned16(tenant_mask)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Plan plan = plan_of(n_queries, n_probes, cap, width);
  if (plan.scratch_keys > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool has_sketch = sketch != nullptr;
  const bool has_tenant = tenant_mask != nullptr;
  Params p;
  p.gids = static_cast<const int32_t*>(gids);
  p.zq = static_cast<const int32_t*>(zq);
  p.rq = static_cast<const float*>(rq);
  p.keep = static_cast<const uint8_t*>(keep);
  p.coords = static_cast<const int16_t*>(coords);
  p.res = static_cast<const int32_t*>(res);
  p.mask = static_cast<const uint8_t*>(mask);
  p.rows = static_cast<const int32_t*>(rows);
  p.scale = static_cast<const float*>(scale);
  p.res_scale = static_cast<const float*>(res_scale);
  p.sq = static_cast<const int32_t*>(sq);
  p.sketch = static_cast<const int8_t*>(sketch);
  p.sketch_scale = static_cast<const float*>(sketch_scale);
  p.tenant_mask = static_cast<const uint8_t*>(tenant_mask);
  p.tenant_ix = static_cast<const int32_t*>(tenant_ix);
  p.n_active = static_cast<const int32_t*>(n_active);
  p.order = static_cast<const int64_t*>(order);
  p.lists = static_cast<u64*>(lists);
  p.runs = static_cast<u64*>(scratch);         // first in the scratch
  p.out_d = static_cast<float*>(out_d);
  p.out_r = static_cast<int32_t*>(out_r);
  p.P = n_probes;
  p.k = k;
  p.s = has_sketch ? s : 0;
  p.G = n_grains;
  p.cap = cap;
  p.width = width;
  p.L = plan.L;
  p.n_runs = plan.n_runs;
  p.run_stride = plan.run_stride;
  p.big = big;
  uint32_t big_bits;
  memcpy(&big_bits, &big, sizeof(big_bits));
  big_bits = (big_bits & 0x80000000u) ? ~big_bits : (big_bits | 0x80000000u);
  p.big_key = static_cast<u64>(big_bits) << 32;
  // shared merge: carry + spare of `width` keys, then as many probes'
  // lists as fit the budget (at least one)
  const size_t fixed = 2 * static_cast<size_t>(width) * sizeof(u64);
  const size_t per_list = static_cast<size_t>(p.L) * sizeof(u64);
  const int fit =
      plan.multiway ? 1 : static_cast<int>((kSmemBudget - fixed) / per_list);
  p.stage_probes = fit < 1 ? 1 : (fit > n_probes ? n_probes : fit);
  int* run_corank = nullptr;
  int* corank = nullptr;
  if (scratch != nullptr) {
    run_corank = reinterpret_cast<int*>(p.runs + plan.runs_keys);
    corank = run_corank + 2 * ceil_div(plan.run_coranks, 2);
  }

  const size_t probe_smem =
      plan.block
          ? sort_smem(cap < kSortKeys ? cap : kSortKeys, p.k + p.s)
          : (2 * static_cast<size_t>(p.L) + kChunk) * sizeof(u64) +
                static_cast<size_t>(p.k + p.s) * sizeof(int);
  const size_t merge_smem =
      fixed + static_cast<size_t>(p.stage_probes) * per_list;
  const Kernel probe =
      plan.block ? probe_kernel<true>(has_sketch, has_tenant, vec)
                 : probe_kernel<false>(has_sketch, has_tenant, vec);
  cudaError_t e = set_smem(probe, probe_smem);
  if (e == cudaSuccess && !plan.multiway)
    e = set_smem(fused_scan_select_merge_kernel, merge_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned n_pairs = static_cast<unsigned>(n_queries) * n_probes;
  probe<<<n_pairs, plan.block ? kThreads : 32, probe_smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (plan.runs) {
    e = multiway_merge(p, true, static_cast<int64_t>(n_queries) * n_probes,
                       plan.n_runs, plan.run_tiles, run_corank, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (!plan.multiway) {
    fused_scan_select_merge_kernel<<<n_queries, kThreads, merge_smem, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(multiway_merge(p, false, n_queries, n_probes,
                                         plan.tiles, corank, st));
}
