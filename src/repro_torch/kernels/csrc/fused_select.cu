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
//
// What bounds it on this card: bytes.  Each probed slot costs 2k + s
// bytes of panel plus 4 of residual and 1 of mask, against about 3(k + s)
// integer operations: far below the ~20 operations per byte where the
// SIMT integer units would become the limit.  The (query, probe) pairs
// touch fewer distinct grains than pairs (at the main path's shape 4,096
// pairs visit ~944 grains), so the bytes the card must move are the
// distinct panels; the rest can come from the 50 MB L2 if the pairs that
// share a grain run together.
//
// What the design does about it: two kernels and a schedule.
//  * Schedule (the wrapper, one stable torch.sort on the card, no host
//    sync): the Q*P pairs ordered by grain id, killed pairs (keep == 0 or
//    p >= n_active[q]) last.  The TPU kernel walks pairs in (q, p) order;
//    the order of visits is a schedule, not part of what is computed.
//  * fused_scan_select_probe_kernel: one CTA of one warp per pair, in the
//    schedule's order (blockIdx.x -> order[blockIdx.x]), so the CTAs that
//    read one panel run side by side and all but the first read it from
//    L2.  A killed pair's CTA exits at once.  Each lane owns 4
//    consecutive slots of a 128-slot chunk: one 8-byte load per
//    coordinate row (the warp reads 256 B), 4 bytes of sketch, 16 of
//    residual, 4 of mask; a scalar path (template kVec = false) takes caps
//    that are not a multiple of 4 and misaligned panels.  The warp keeps
//    the pair's own top-L, L = min(width, cap), as a sorted carry in
//    shared memory.  Keys at or above the carry's L-th are dropped; a
//    chunk with none left costs one warp scan.  Up to 32 survivors are
//    compacted one per lane and sorted in registers (15 shuffle stages),
//    more are sorted as the chunk's 128 (4 per lane), and the run is
//    merged into the carry by merge path (a binary search per output).
//    No block barrier anywhere: an SM holds 32 of these warps, each at
//    its own phase, so one warp's loads overlap another's sort (a form
//    with 256-thread CTAs sorting 1024-slot tiles block-wide took 1.7x
//    as long on an H100, PERF.md).  The L sorted keys go to a scratch
//    tensor [Q*P, L].
//  * fused_scan_select_merge_kernel (width <= kSmemWidth): one CTA per
//    query folds the sorted lists of its live probes into a carry of
//    `width` big_keys, probe by probe in visit order, each fold one merge
//    path of two sorted runs (lists staged in shared memory, as many
//    probes at once as fit), then maps the first `width` keys to
//    (dist, row).  A query's top-width holds at most min(width, cap) slots
//    of one probe, and keys are unique, so these are the first `width` of
//    the global sort: bit for bit the plain version.
//  * fused_scan_select_wide_merge_kernel (width > kSmemWidth, the
//    cascade's stage 1 at up to P * cap): the carry no longer fits shared
//    memory, so the probes' lists are merged pairwise as a tree in global
//    scratch, ceil(log2 P) launches.  Round r merges runs of 2^(r-1)
//    probes two by two and cuts each output run to its first
//    min(2^r * L, width) keys: the first `width` keys of a merge depend
//    only on the first `width` keys of each run, so the cut loses nothing.
//    A dead probe's list is an empty run (its CTA never wrote it), and
//    every run is padded with big_keys past its live keys, which is what
//    the carry's initial big_keys give.  Each CTA makes 1024 outputs of
//    one run: two merge-path searches bound the slices of the two input
//    runs that feed them, the slices are staged in shared memory, and
//    each output is one binary search there.  The last round writes
//    (dist, row) straight to the outputs.  A round reads and writes each
//    key once: ceil(log2 P) passes over Q * P * L keys, where folding the
//    probes one by one into a width-key carry would re-read it P times.
//  * Chunk runs (L > kSmemWidth: a grain of more than 8,192 slots with
//    width above it, the cascade's stage 1 at b1 = P * cap on such an
//    index): a pair's top-L no longer fits shared memory as a carry.
//    The probe kernel (template kRuns) then prices and sorts each
//    128-slot chunk as before and writes it whole to global scratch as
//    one sorted run, dropped slots as big_key, so a pair owns
//    ceil(cap / 128) runs of 128 keys.  The same tree merge
//    (fused_scan_select_wide_merge_kernel<kRuns = true>, one group per
//    live pair) merges them pairwise and cuts each output run to L keys;
//    its last round writes the pair's L keys to `lists`, the same keys
//    the carry would hold: the live ones ascending, then big_keys.  From
//    there the per-query merge runs unchanged.  The shape picks the path
//    (L <= kSmemWidth keeps the carry); there is no switch.
//
// Limits: 1 <= width, and width <= kSmemWidth or width <= P * cap;
// P * cap < 2^32 - 1; Q * P < 2^31 (and Q * P * ceil(cap / 128) < 2^31
// on the chunk-run path).  Shared memory: probe kernel 2 L + 128 keys of
// 8 bytes (129 KB at L = 8192; only the query's coordinates with chunk
// runs); merge kernel 2 width keys plus a staging area, within
// kSmemBudget; wide merge kernel kTile keys.  Global scratch:
// fused_scan_select_scratch_keys() keys, allocated by the caller: the
// wide merge's two halves and, with chunk runs, about twice
// Q * P * round_up(cap, 128) keys (the runs and one round's output; the
// two merges run one after the other and share it).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;                       // merge kernel
constexpr int kSlotsPerThread = 4;
constexpr int kChunk = 32 * kSlotsPerThread;        // slots a warp prices
constexpr int kSmemWidth = 8192;                    // widest shared carry
constexpr int kTile = 4 * kThreads;                 // wide merge outputs/CTA
constexpr size_t kSmemBudget = 200 * 1024;
constexpr u64 kEmpty = ~0ull;

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
  u64* runs;                    // [Q * P, n_chunks * kChunk] chunk runs
  float* out_d;                 // [Q, width]
  int32_t* out_r;               // [Q, width]
  int P, k, s, G, cap, width, L, stage_probes, n_chunks;
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

// Output i of query q from its key: (dist, row), row -1 at dist >= BIG / 2.
__device__ __forceinline__ void emit(const Params& p, int q, int i, u64 key) {
  const float d = float_of_order(static_cast<uint32_t>(key >> 32));
  int32_t row = -1;
  if (d < p.big * 0.5f) {
    const uint32_t v = static_cast<uint32_t>(key) - 1u;
    const int pi = static_cast<int>(v / static_cast<uint32_t>(p.cap));
    const int c = static_cast<int>(v % static_cast<uint32_t>(p.cap));
    const int g = p.gids[static_cast<int64_t>(q) * p.P + pi];
    row = p.rows[static_cast<int64_t>(g) * p.cap + c];
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
          const u64 o = __shfl_xor_sync(0xffffffffu, v[r], stride / kPer);
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

// 32 resident CTAs of one warp fill an SM's 64K registers at 64 each.
// kRuns: no carry; each chunk's 128 keys go out sorted as one run.
template <bool kSketch, bool kTenant, bool kVec, bool kRuns>
__global__ void __launch_bounds__(32, 32)
fused_scan_select_probe_kernel(const Params p) {
  extern __shared__ u64 smem[];
  const int L = kRuns ? 0 : p.L;               // the carry's keys
  u64* carry = smem;                           // [L]
  u64* spare = carry + L;                      // [L]
  u64* run = spare + L;                        // [kChunk] a chunk's survivors
  int* zq_s = reinterpret_cast<int*>(run + kChunk);
  int* sq_s = zq_s + p.k;
  constexpr unsigned kAll = 0xffffffffu;

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

  const int g = p.gids[pair];
  const float sc = p.scale[g];
  const float sc2 = __fmul_rn(sc, sc);
  const float rs = p.res_scale[g];
  const float rqv = p.rq[pair];
  float sk2 = 0.0f;
  if (kSketch) {
    const float ss = p.sketch_scale[g];
    sk2 = __fmul_rn(ss, ss);
  }
  const int64_t gc = static_cast<int64_t>(g) * p.cap;
  const int16_t* cg = p.coords + gc * p.k;
  const int8_t* skg = kSketch ? p.sketch + gc * p.s : nullptr;
  const uint8_t* tg = nullptr;
  if (kTenant)
    tg = p.tenant_mask +
         (static_cast<int64_t>(p.tenant_ix[q]) * p.G + g) * p.cap;
  const uint32_t visit0 = static_cast<uint32_t>(pi) * p.cap + 1u;
  u64 thr = p.big_key;                         // the carry's L-th key

  for (int base = 0; base < p.cap; base += kChunk) {
    const int c0 = base + lane * kSlotsPerThread;
    u64 v[kSlotsPerThread];
    int cnt = 0;
    if (c0 < p.cap) {
      uint32_t acc[kSlotsPerThread] = {0u, 0u, 0u, 0u};   // int32, wraps
#pragma unroll 8
      for (int j = 0; j < p.k; ++j) {
        int z[kSlotsPerThread];
        load4<kVec>(cg + static_cast<int64_t>(j) * p.cap, c0, p.cap, z);
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
          load4<kVec>(skg + static_cast<int64_t>(j) * p.cap, c0, p.cap, z);
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
      load4<kVec>(p.res + gc, c0, p.cap, rv);
      load4<kVec>(p.mask + gc, c0, p.cap, mv);
      if (kTenant) load4<kVec>(tg, c0, p.cap, tv);
#pragma unroll
      for (int r = 0; r < kSlotsPerThread; ++r) {
        float d = __fmul_rn(static_cast<float>(static_cast<int32_t>(acc[r])),
                            sc2);
        d = __fadd_rn(__fadd_rn(d, __fmul_rn(static_cast<float>(rv[r]), rs)),
                      rqv);
        if (kSketch)
          d = __fadd_rn(d, __fmul_rn(static_cast<float>(
                                         static_cast<int32_t>(sacc[r])), sk2));
        bool live = c0 + r < p.cap && mv[r] != 0;
        if (kTenant) live = live && tv[r] != 0;
        const u64 key = (static_cast<u64>(order_bits(d)) << 32) |
                        (visit0 + static_cast<uint32_t>(c0 + r));
        v[r] = live && key < thr ? key : kEmpty;
        cnt += v[r] != kEmpty;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kSlotsPerThread; ++r) v[r] = kEmpty;
    }
    if constexpr (kRuns) {
      // the whole chunk as one sorted run, dropped slots as big_key
      // (thr stays big_key, so every kept key is below it)
#pragma unroll
      for (int r = 0; r < kSlotsPerThread; ++r)
        if (v[r] == kEmpty) v[r] = p.big_key;
      warp_sort(v);
      u64* out = p.runs + pair * (static_cast<int64_t>(p.n_chunks) * kChunk) +
                 base + lane * kSlotsPerThread;
#pragma unroll
      for (int r = 0; r < kSlotsPerThread; ++r) out[r] = v[r];
      continue;
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

  if (kRuns) return;
  u64* out = p.lists + pair * L;
  for (int i = lane; i < L; i += 32) out[i] = carry[i];
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

// One round of a tree merge of sorted runs, in groups: the wide merge
// (kRuns false: group q, a query, whose runs are its probes' lists of L
// keys, cut to `width`) or the chunk-run merge (kRuns true: group
// q * P + p, a pair, whose runs are its chunks' runs of kChunk keys, cut
// to L).  Input run r of group g, the runs [r * span, min((r + 1) * span,
// n)) merged and cut to min(count * base, cut) keys, sits at
// src + (g * n_in + r) * in_stride; output run j, the merge of input runs
// 2j and 2j + 1 cut the same way, goes to dst + (g * n_out + j) *
// out_stride, or, at the last round (dst null, one output run), to
// out_d / out_r (the wide merge) or to the pair's `lists` row (chunk
// runs).  At the wide merge's first round (span 1) src is `lists`, and a
// dead probe's run is empty; a dead pair has no chunk runs and makes
// nothing.  Block b makes outputs [t * kTile, (t + 1) * kTile) of run j
// of group g, with b = (g * n_out + j) * n_tiles + t.
template <bool kRuns>
__global__ void __launch_bounds__(kThreads)
fused_scan_select_wide_merge_kernel(const Params p, const u64* src, u64* dst,
                                    int span, int in_stride, int out_stride,
                                    int n_tiles) {
  __shared__ u64 stage[kTile];
  __shared__ int cut[2];
  const int n = kRuns ? p.n_chunks : p.P;      // runs of a group at span 1
  const int64_t base = kRuns ? kChunk : p.L;   // keys of such a run
  const int64_t W = kRuns ? p.L : p.width;     // each output cut to W
  const int n_in = (n + span - 1) / span;
  const int n_out = (n_in + 1) / 2;
  const int t = static_cast<int>(blockIdx.x % n_tiles);
  const int j = static_cast<int>(blockIdx.x / n_tiles % n_out);
  const int64_t g = blockIdx.x / n_tiles / n_out;
  const int q = static_cast<int>(kRuns ? g / p.P : g);
  if (kRuns && !pair_alive(p, q, static_cast<int>(g - int64_t{q} * p.P)))
    return;                                     // block-uniform
  const int r0 = 2 * j * span;                  // the first run of run 2j
  const int cnt_a = min(span, n - r0);
  const int cnt_b = max(0, min(span, n - r0 - span));
  const int out_len = static_cast<int>(min((cnt_a + cnt_b) * base, W));
  const int i0 = t * kTile;
  if (i0 >= out_len) return;                    // block-uniform
  const int i1 = min(i0 + kTile, out_len);
  int la = static_cast<int>(min(cnt_a * base, W));
  int lb = static_cast<int>(min(cnt_b * base, W));
  if (!kRuns && span == 1) {
    if (!pair_alive(p, q, r0)) la = 0;
    if (cnt_b == 0 || !pair_alive(p, q, r0 + 1)) lb = 0;
  }
  const u64* a = src + (g * n_in + 2 * j) * in_stride;
  const u64* b = a + in_stride;
  // outputs [e0, e1) come from the runs' live keys, the rest are big_keys;
  // they are the merge of a[cut[0], cut[1]) and b[e0 - cut[0], e1 - cut[1])
  const int e0 = min(i0, la + lb), e1 = min(i1, la + lb);
  if (threadIdx.x < 2)
    cut[threadIdx.x] = merge_split(a, la, b, lb, threadIdx.x ? e1 : e0);
  __syncthreads();
  const int na = cut[1] - cut[0];
  const int b0 = e0 - cut[0], nb = e1 - cut[1] - b0;
  for (int x = threadIdx.x; x < na; x += kThreads) stage[x] = a[cut[0] + x];
  for (int x = threadIdx.x; x < nb; x += kThreads) stage[na + x] = b[b0 + x];
  __syncthreads();
  u64* out = dst != nullptr ? dst + (g * n_out + j) * out_stride
             : kRuns        ? p.lists + g * p.L
                            : nullptr;
  for (int i = i0 + threadIdx.x; i < i1; i += kThreads) {
    const u64 key =
        i < e1 ? merge_at(stage, na, stage + na, nb, i - e0) : p.big_key;
    if (out == nullptr) emit(p, q, i, key);
    else out[i] = key;
  }
}

typedef void (*Kernel)(const Params);

template <bool kSketch, bool kTenant, bool kRuns>
Kernel probe_kernel(bool vec) {
  return vec ? fused_scan_select_probe_kernel<kSketch, kTenant, true, kRuns>
             : fused_scan_select_probe_kernel<kSketch, kTenant, false, kRuns>;
}

template <bool kRuns>
Kernel probe_kernel(bool sketch, bool tenant, bool vec) {
  if (sketch)
    return tenant ? probe_kernel<true, true, kRuns>(vec)
                  : probe_kernel<true, false, kRuns>(vec);
  return tenant ? probe_kernel<false, true, kRuns>(vec)
                : probe_kernel<false, false, kRuns>(vec);
}

cudaError_t set_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The rounds of a tree merge of `groups` groups of n runs of `base` keys,
// each output cut to `cut` keys: round r (from 0) merges runs of 2^r
// input runs two by two into ceil(n / 2^(r+1)) runs of min(2^(r+1) base,
// cut) keys.  All but the last write to the global scratch, even rounds
// to its first half, odd rounds to its second; round 0 reads its input
// from the second half when `in_keys` (the input's keys) is not 0, else
// from elsewhere.  Returns the scratch's keys and sets `second`, the
// second half's offset.
int64_t tree_scratch(int64_t groups, int64_t n, int64_t base, int64_t cut,
                     int64_t in_keys, int64_t* second) {
  int64_t half[2] = {0, in_keys};
  int r = 0;
  for (int64_t span = 1; span < n; span *= 2, ++r) {
    const int64_t n_out = (n + 2 * span - 1) / (2 * span);
    if (n_out == 1) break;                     // the last round
    const int64_t stride = 2 * span * base < cut ? 2 * span * base : cut;
    const int64_t keys = groups * n_out * stride;
    if (keys > half[r % 2]) half[r % 2] = keys;
  }
  if (second != nullptr) *second = half[0];
  return half[0] + half[1];
}

int64_t chunks_of(int64_t cap) { return (cap + kChunk - 1) / kChunk; }

// The chunk-run path's tree scratch (runs in its second half).
int64_t runs_scratch(int64_t q, int64_t P, int64_t cap, int64_t L,
                     int64_t* second) {
  const int64_t pairs = q * P, n = chunks_of(cap);
  return tree_scratch(pairs, n, kChunk, L, pairs * n * kChunk, second);
}

// Launches the rounds of one tree merge (see tree_scratch) on `st`: the
// input at src with in_stride keys per run, outputs of the last round to
// the kernel's destination (one round for a single run: n = 1).
cudaError_t tree_merge(const Params& p, bool runs, int64_t groups, int64_t n,
                       int64_t base, int64_t cut, const u64* src,
                       int in_stride, u64* scratch, int64_t second,
                       cudaStream_t st) {
  int r = 0;
  for (int64_t span = 1;; span *= 2, ++r) {    // one round at least
    const int64_t n_out = (n + 2 * span - 1) / (2 * span);
    const int out_stride =
        static_cast<int>(2 * span * base < cut ? 2 * span * base : cut);
    u64* dst = n_out == 1 ? nullptr : scratch + (r % 2 ? second : 0);
    const int n_tiles = (out_stride + kTile - 1) / kTile;
    const unsigned blocks = static_cast<unsigned>(groups * n_out * n_tiles);
    if (runs)
      fused_scan_select_wide_merge_kernel<true><<<blocks, kThreads, 0, st>>>(
          p, src, dst, static_cast<int>(span), in_stride, out_stride,
          n_tiles);
    else
      fused_scan_select_wide_merge_kernel<false><<<blocks, kThreads, 0, st>>>(
          p, src, dst, static_cast<int>(span), in_stride, out_stride,
          n_tiles);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || n_out == 1) return e;
    src = dst;
    in_stride = out_stride;
  }
}

}  // namespace

extern "C" int fused_scan_select_smem_width() { return kSmemWidth; }

// Keys of global scratch the launch needs (0 when width <= kSmemWidth):
// the wide merge's, or the chunk-run path's where that is larger (the two
// run one after the other in the same scratch).
extern "C" long long fused_scan_select_scratch_keys(int n_queries,
                                                    int n_probes, int cap,
                                                    int width) {
  if (width <= kSmemWidth) return 0;
  const int L = width < cap ? width : cap;
  const int64_t wide =
      tree_scratch(n_queries, n_probes, L, width, 0, nullptr);
  if (L <= kSmemWidth) return wide;
  const int64_t runs = runs_scratch(n_queries, n_probes, cap, L, nullptr);
  return wide > runs ? wide : runs;
}

extern "C" const char* fused_scan_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the probe kernel over `n_pairs` = Q * P CTAs (with chunk
// runs, L > kSmemWidth: its kRuns form, then the chunk-run merge's
// rounds), then the merge kernel over Q (width <= kSmemWidth) or the wide
// merge's rounds, on `stream`; returns cudaGetLastError() after the
// launches (0 on success).  Null pointers mark absent optional inputs.
// `order` is the schedule (int64 pair indices, killed pairs anywhere),
// `lists` scratch of Q * P * min(width, cap) keys, `scratch` that of
// fused_scan_select_scratch_keys(); `vec` selects the vector loads
// (cap % 4 == 0 and 16-byte aligned panels, checked here).
extern "C" int fused_scan_select_launch(
    const void* gids, const void* zq, const void* rq, const void* keep,
    const void* coords, const void* res, const void* mask, const void* rows,
    const void* scale, const void* res_scale, const void* sq,
    const void* sketch, const void* sketch_scale, const void* tenant_mask,
    const void* tenant_ix, const void* n_active, const void* order,
    void* lists, void* scratch, void* out_d, void* out_r, int n_queries,
    int n_probes, int k, int s, int n_grains, int cap, int width, int vec,
    float big, void* stream) {
  const bool wide = width > kSmemWidth;
  const bool runs = (width < cap ? width : cap) > kSmemWidth;
  if (width < 1 || n_queries < 1 || n_probes < 1 || cap < 1 ||
      (wide && width > static_cast<int64_t>(n_probes) * cap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (cap % kSlotsPerThread != 0 || !aligned16(coords) ||
              !aligned16(res) || !aligned16(mask) || !aligned16(sketch) ||
              !aligned16(tenant_mask)))
    return static_cast<int>(cudaErrorMisalignedAddress);
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
  p.runs = nullptr;
  p.out_d = static_cast<float*>(out_d);
  p.out_r = static_cast<int32_t*>(out_r);
  p.P = n_probes;
  p.k = k;
  p.s = has_sketch ? s : 0;
  p.G = n_grains;
  p.cap = cap;
  p.width = width;
  p.L = width < cap ? width : cap;
  p.n_chunks = static_cast<int>(chunks_of(cap));
  p.big = big;
  uint32_t big_bits;
  memcpy(&big_bits, &big, sizeof(big_bits));
  big_bits = (big_bits & 0x80000000u) ? ~big_bits : (big_bits | 0x80000000u);
  p.big_key = static_cast<u64>(big_bits) << 32;
  // merge kernel: carry + spare of `width` keys, then as many probes'
  // lists as fit the budget (at least one)
  const size_t fixed = 2 * static_cast<size_t>(width) * sizeof(u64);
  const size_t per_list = static_cast<size_t>(p.L) * sizeof(u64);
  const int fit =
      wide ? 1 : static_cast<int>((kSmemBudget - fixed) / per_list);
  p.stage_probes = fit < 1 ? 1 : (fit > n_probes ? n_probes : fit);
  // the wide merge and the chunk runs: every round's grid must fit a launch
  int64_t second = 0, runs_second = 0;
  if (wide) {
    if (tree_scratch(n_queries, n_probes, p.L, width, 0, &second) > 0 &&
        scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t tiles = (static_cast<int64_t>(width) + kTile - 1) / kTile;
    if (static_cast<int64_t>(n_queries) * n_probes * tiles >= (1ll << 31))
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (runs) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    runs_scratch(n_queries, n_probes, cap, p.L, &runs_second);
    p.runs = static_cast<u64*>(scratch) + runs_second;
    if (static_cast<int64_t>(n_queries) * n_probes * p.n_chunks >=
        (1ll << 31))
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }

  const size_t probe_smem =
      (2 * static_cast<size_t>(runs ? 0 : p.L) + kChunk) * sizeof(u64) +
      static_cast<size_t>(p.k + p.s) * sizeof(int);
  const size_t merge_smem =
      fixed + static_cast<size_t>(p.stage_probes) * per_list;
  const Kernel probe =
      runs ? probe_kernel<true>(has_sketch, has_tenant, vec)
           : probe_kernel<false>(has_sketch, has_tenant, vec);
  cudaError_t e = set_smem(probe, probe_smem);
  if (e == cudaSuccess && !wide)
    e = set_smem(fused_scan_select_merge_kernel, merge_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned n_pairs = static_cast<unsigned>(n_queries) * n_probes;
  probe<<<n_pairs, 32, probe_smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (runs) {
    e = tree_merge(p, true, static_cast<int64_t>(n_queries) * n_probes,
                   p.n_chunks, kChunk, p.L, p.runs, kChunk,
                   static_cast<u64*>(scratch), runs_second, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (!wide) {
    fused_scan_select_merge_kernel<<<n_queries, kThreads, merge_smem, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(tree_merge(p, false, n_queries, n_probes, p.L,
                                     width, p.lists, p.L,
                                     static_cast<u64*>(scratch), second, st));
}
