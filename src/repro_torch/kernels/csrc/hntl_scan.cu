// Block-SoA quantized scan of HNTL grain panels, for Hopper (sm_90a),
// CUDA C++: the single-query and the batched-query form.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/hntl_scan.py:
//   hntl_scan_single (body _scan_single_kernel) -> hntl_scan_single_kernel
//   hntl_scan        (body _scan_kernel)        -> hntl_scan_kernel
// Their plain PyTorch versions are repro_torch.kernels.ref.
// hntl_scan_single_ref and hntl_scan_ref.
//
// What they compute, for every pair p, query q and slot c:
//
//   d = (float(sum_j (zq[p,q,j] - coords[p,j,c])^2) * scale[p]^2
//        + float(res[p,c]) * res_scale[p]) + rq[p,q]
//
// or `big` where valid[p,c] is 0.  The integer sum is taken modulo 2^32,
// so it wraps exactly as int32 does in JAX and in the plain version.
// Every float step is rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction) in the JAX op order, so a kernel equals its plain version
// bit for bit.  The coordinate type is a template parameter: int16
// panels, and int8 for the residual sketch pass.
//
// hntl_scan_single: bound by bytes.  Each slot costs k coordinates (2k
// bytes at int16), 4 bytes of residual, 1 of mask and 4 of output against
// about 3k integer operations.  A grid of (P, cap tiles of 256) with one
// thread per slot; the pair's zq lives in shared memory and is read as a
// broadcast; coords[p, j, c] is contiguous along c (the panel is
// dimension-major), so each warp's read of a coordinate row is coalesced.
//
// hntl_scan: bound by the bytes of its output, [P, Q, cap] float32 (at
// P=1024 Q=128 cap=1664, 872 MB of the ~1.0 GB the call must move).  Its
// first version priced every output on the CUDA cores, ~3k integer and
// shared-memory lane-instructions per output, and took 1.6353 ms on
// the coordinate launch (k=32 int16) and 1.0642 ms on the sketch launch
// (k=8 int8) against byte bounds of 0.3007 and 0.2684 ms (chip_smoke.py,
// H100 80GB HBM3, 700 W).  The design moves the integer work to the int8
// tensor cores, as the TPU kernel moves it to the MXU, and keeps the
// query loop free of device-memory reads:
//  * the identity of the TPU body: sum (zq - c)^2 = zq2 + c2 - 2 cross,
//    exact modulo 2^32 for any int32 inputs.  zq2 (per query) and c2 (per
//    slot) are summed on the CUDA cores in uint32.
//  * cross = sum zq * c in byte limbs.  An int16 coordinate is its low
//    byte (u8) plus 256 times its high byte (s8); an int8 one is one s8
//    limb.  A 16-query tile's zq are 1 limb (s8) where all of them fit
//    int8, 2 (u8, s8) where they fit int16, else 4 (u8, u8, u8, s8):
//    exact for any int32.  The limbs are the bytes of the two's-complement
//    values.  The count is taken once per tile (a half-warp reduction in
//    the prologue), so the branch is uniform.  Limb l of zq times limb m
//    of c falls in the shift class l + m (0, 8, 16, 24 bits); products
//    shifted by 32 bits or more vanish modulo 2^32 and are skipped.  The
//    main path's zq fit int16 (the planner clips them to
//    int32_safe_qmax <= 32767) and its sketch int8: 4 products per
//    32-deep step on the coordinates, 1 on the sketch; wraparound inputs
//    take up to 7.
//  * each product is one mma.sync.m16n8k32 (s8/u8 operands, s32 sums):
//    16 queries by 8 slots by 32 dimensions.  A class of one step sums at
//    most 2 products of 32 bytes of 255 * 255, below 2^22, so no
//    accumulator overflows; it is shifted and added to a uint32 total at
//    once, which wraps as int32 does.  No limit on k follows.  wgmma is
//    not needed: the tensor-core work is a small share of the bound.
//  * a CTA owns one panel's tile of 128 slots and loops over all its
//    query tiles.  The panel is staged once as limb planes laid out
//    [step][slot][32 dims] bytes, the mma's B fragment: each lane reads
//    its two registers with one 8-byte shared load, free of bank
//    conflicts; the staging writes rotate by slot so 32 lanes hit 32
//    banks, and every staging load is issued before any is used.  The
//    query rows (k rounded up to 32; up to 128 rows a group) are copied into
//    shared memory with cp.async while the panel is staged; the mma's A
//    fragments come from there by 16-byte loads (row stride 4 mod 32
//    words: no conflicts).  The mma's k positions map to dimensions
//    (k position 4t+i to dimension 8t+i, 16+4t+i to 8t+4+i) the same way
//    on both sides, which a sum over k does not see.  With k above 64
//    the panel is staged in chunks of 64 dimensions, again for every
//    query tile.
//  * 4 warps of 32 slots each (4 n-tiles).  The epilogue runs on the
//    fragments in registers; each warp's 16 x 32 outputs go through a
//    padded shared tile so that every store instruction writes 4 whole
//    128-byte lines, with streaming stores (__stcs: the output is 17
//    times the L2 cache).
//  * the grid is (slot tiles, panels): slot tiles vary fastest, so a
//    panel's CTAs run together and read its query rows from L2.
//  * ragged Q and cap, and k off the mma's depth of 32, are masked and
//    zero-filled in the kernel: no panel is copied.
//
// The mma and the asynchronous copies sit behind mma_i8, copy16_async
// and copy_async_wait alone, so scalar stand-ins with the same fragment
// layout can replace them to rehearse the kernel off the card.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 4096;        // single form: zq in shared memory

// Batched form.
constexpr int kWarps = 4;                       // warps per CTA
constexpr int kBatchThreads = 32 * kWarps;      // 128
constexpr int kTileC = 128;                     // slots per CTA
constexpr int kNTiles = kTileC / kWarps / 8;    // mma n-tiles per warp: 4
constexpr int kTileQ = 16;                      // queries per mma m-tile
constexpr int kStepK = 32;                      // mma depth
constexpr int kChunkK = 64;                     // dimensions staged at once
constexpr int kSteps = kChunkK / kStepK;        // 2
constexpr int kClasses = 4;                     // shifts of 0, 8, 16, 24 bits
constexpr int kQGroup = 128;                    // query rows staged at once
constexpr int kZqWords = kQGroup * (kStepK + 4);   // their words at k <= 32
constexpr int kOutStride = kTileC / kWarps + 8;  // a warp's output tile row
static_assert(kTileC == kBatchThreads, "one slot per thread in the prologue");
static_assert(kQGroup == kBatchThreads, "one query row per thread");

struct Params {
  const int32_t* zq;       // [P, Q, k]
  const float* rq;         // [P, Q]
  const void* coords;      // [P, k, cap], int16 or int8
  const int32_t* res;      // [P, cap]
  const uint8_t* valid;    // [P, cap] bool
  const float* scale;      // [P]
  const float* res_scale;  // [P]
  float* out;              // [P, Q, cap]
  int Q, k, cap;
  float big;
  // Batched form: which vector accesses the shapes and pointers allow.
  bool vec_coords;         // 4 slots of a coordinate row per load
  bool vec_zq;             // 8 dimensions of a query per two 16-byte loads
  bool quad_out;           // 4 neighbouring outputs per 16-byte store
};

__device__ __forceinline__ float epilogue(uint32_t acc, float sc2, float res,
                                          float rs, float rq) {
  float d = __fmul_rn(static_cast<float>(static_cast<int32_t>(acc)), sc2);
  d = __fadd_rn(d, __fmul_rn(res, rs));
  return __fadd_rn(d, rq);
}

template <typename CoordT>
__global__ void __launch_bounds__(kThreads)
hntl_scan_single_kernel(const Params p) {
  extern __shared__ int32_t zq_s[];   // [k]
  const int64_t pi = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  for (int j = threadIdx.x; j < p.k; j += kThreads) zq_s[j] = p.zq[pi * p.k + j];
  __syncthreads();
  if (c >= p.cap) return;

  const CoordT* cp = static_cast<const CoordT*>(p.coords) + pi * p.k * p.cap + c;
  uint32_t acc = 0;                   // int32 arithmetic, wraps
  for (int j = 0; j < p.k; ++j) {
    const uint32_t df = static_cast<uint32_t>(zq_s[j]) -
                        static_cast<uint32_t>(static_cast<int32_t>(cp[static_cast<int64_t>(j) * p.cap]));
    acc += df * df;
  }
  const int64_t o = pi * p.cap + c;
  const float sc = p.scale[pi];
  const float d = epilogue(acc, __fmul_rn(sc, sc), static_cast<float>(p.res[o]),
                           p.res_scale[pi], p.rq[pi]);
  p.out[o] = p.valid[o] ? d : p.big;
}

// ---------------------------------------------------------------------------
// Batched form
// ---------------------------------------------------------------------------

// d += a * b for one 16 x 8 x 32 tile: a the row-major A fragment (4
// registers of 4 bytes), b the column-major B fragment (2 registers),
// each byte signed (s8) or not (u8) as the template says.
template <bool ASigned, bool BSigned>
__device__ __forceinline__ void mma_i8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
#define HNTL_SCAN_MMA(AT, BT)                                                 \
  asm("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT ".s32 "              \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"       \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))
  if constexpr (ASigned && BSigned) HNTL_SCAN_MMA("s8", "s8");
  else if constexpr (ASigned) HNTL_SCAN_MMA("s8", "u8");
  else if constexpr (BSigned) HNTL_SCAN_MMA("u8", "s8");
  else HNTL_SCAN_MMA("u8", "u8");
#undef HNTL_SCAN_MMA
}

// Byte l of each of v0..v3, packed low to high: limb l of four values.
__device__ __forceinline__ uint32_t limb4(int32_t v0, int32_t v1, int32_t v2,
                                          int32_t v3, int l) {
  const uint32_t sel = l | ((l + 4) << 4);
  const uint32_t lo = __byte_perm(v0, v1, sel);
  const uint32_t hi = __byte_perm(v2, v3, sel);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// Limb planes of one staged chunk: [limb][step][slot][32 dims] bytes.
template <int NC>
using Planes = uint32_t[NC][kSteps][kTileC][8];

// One staging task's coordinates: 4 slots of one dimension, as loaded.
template <typename CoordT>
using Raw = typename std::conditional<sizeof(CoordT) == 2, uint2, uint32_t>::type;

__device__ __forceinline__ int32_t raw_slot(uint2 u, int i) {
  return static_cast<int16_t>(((i < 2 ? u.x : u.y) >> (16 * (i & 1))) & 0xffff);
}
__device__ __forceinline__ int32_t raw_slot(uint32_t u, int i) {
  return static_cast<int8_t>((u >> (8 * i)) & 0xff);
}

// Stage dimensions k0 .. k0 + kChunkK of the CTA's slot tile as limb
// planes, and add each slot's sum of squares over them to c2_s (if not
// null).  One task is 4 dimensions x 4 slots; a warp's 32 tasks are 8
// dimension quads x 4 slot quads, so each coordinate load covers whole
// 32-byte sectors.  Every task's loads are issued before any is used.
// Dimensions past k and slots past cap read 0.
template <typename CoordT, int NC>
__device__ __forceinline__ void stage_chunk(Planes<NC>& b_s, const Params& p,
                                            const CoordT* cg, int c0, int k0,
                                            uint32_t* c2_s) {
  constexpr int kQuads = kTileC / 4;
  constexpr int kIters = kSteps * kQuads * 8 / kBatchThreads;
  const int kn = min(kChunkK, p.k - k0);
  const int tasks = (kn + kStepK - 1) / kStepK * kQuads * 8;
  Raw<CoordT> raw[kIters][4];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int task = threadIdx.x + it * kBatchThreads;
    const int jq = task & 7, x = (task >> 3) % kQuads, s = task / (kQuads * 8);
    const int cb = c0 + x * 4;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int dim = k0 + s * kStepK + jq * 4 + d;
      const CoordT* row = cg + static_cast<int64_t>(dim) * p.cap + cb;
      const bool in = task < tasks && dim < p.k;
      if (p.vec_coords) {          // cap % 4 == 0: all 4 slots or none
        raw[it][d] = in && cb < p.cap
            ? *reinterpret_cast<const Raw<CoordT>*>(row) : Raw<CoordT>{};
      } else {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = in && cb + i < p.cap
              ? static_cast<uint32_t>(row[i]) & (sizeof(CoordT) == 2 ? 0xffffu : 0xffu)
              : 0u;
        if constexpr (sizeof(CoordT) == 2)
          raw[it][d] = Raw<CoordT>{w[0] | (w[1] << 16), w[2] | (w[3] << 16)};
        else
          raw[it][d] = w[0] | (w[1] << 8) | (w[2] << 16) | (w[3] << 24);
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int task = threadIdx.x + it * kBatchThreads;
    if (task >= tasks) break;        // uniform over the warp
    const int jq = task & 7, x = (task >> 3) % kQuads, s = task / (kQuads * 8);
    int32_t v[4][4];
#pragma unroll
    for (int d = 0; d < 4; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[d][i] = raw_slot(raw[it][d], i);
    if (c2_s) {   // c2 of the 4 slots: summed over the 8 dimension quads
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t part = 0;
#pragma unroll
        for (int d = 0; d < 4; ++d)
          part += static_cast<uint32_t>(v[d][i]) * static_cast<uint32_t>(v[d][i]);
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (jq == 0) atomicAdd(&c2_s[x * 4 + i], part);
      }
    }
    // Slot quad x writes its 4 slots rotated by x: word jq of slot
    // 4x + i lies in bank 8i + jq, so a warp's 4 quads x 8 words hit 32
    // banks.
    const int r = x & 3;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = limb4(v[0][i], v[1][i], v[2][i], v[3][i], m);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = (ii + r) & 3;
        b_s[m][s][x * 4 + i][jq] = pick4(w, i);
      }
    }
  }
}

// 16 bytes from global to shared memory without waiting (0 bytes: zeros).
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem,
                                             int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four dimensions j .. j + 3 of one query row of zq, 0 past k.
__device__ __forceinline__ int4 zq_quad(const Params& p, const int32_t* row,
                                        int j) {
  if (p.vec_zq) {                  // k % 8 == 0: all 4 dimensions or none
    return j < p.k ? *reinterpret_cast<const int4*>(row + j)
                   : make_int4(0, 0, 0, 0);
  }
  return make_int4(j < p.k ? row[j] : 0, j + 1 < p.k ? row[j + 1] : 0,
                   j + 2 < p.k ? row[j + 2] : 0, j + 3 < p.k ? row[j + 3] : 0);
}

// Stage dimensions j0 .. j0 + width of query row q (0 past Q and past k)
// at dst: without waiting where 16-byte loads are allowed.
__device__ __forceinline__ void stage_row(int32_t* dst, const Params& p,
                                          const int32_t* zg, int q, int j0,
                                          int width) {
  const int32_t* row = zg + static_cast<int64_t>(q) * p.k;
  for (int j = 0; j < width; j += 4) {
    const bool in = q < p.Q && j0 + j < p.k;
    if (p.vec_zq)
      copy16_async(dst + j, in ? row + j0 + j : zg, in ? 16 : 0);
    else
      *reinterpret_cast<int4*>(dst + j) =
          in ? zq_quad(p, row, j0 + j) : make_int4(0, 0, 0, 0);
  }
}

// This lane's zq of one 32-deep step from the staged rows (row stride
// `stride` words, a multiple of 4 that is 4 mod 32, so the 16-byte loads
// of 8 lanes hit 32 banks): rows row0 + g and row0 + g + 8, dimensions
// d0 + 8t .. d0 + 8t + 7 (zv[0..7] and zv[8..15]).
__device__ __forceinline__ void load_zq(int32_t (&zv)[16], const int32_t* zq_s,
                                        int stride, int row0, int g, int t,
                                        int d0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int4* src = reinterpret_cast<const int4*>(
        zq_s + (row0 + g + 8 * r) * stride + d0 + 8 * t);
    const int4 a = src[0], b = src[1];
    zv[8 * r + 0] = a.x; zv[8 * r + 1] = a.y;
    zv[8 * r + 2] = a.z; zv[8 * r + 3] = a.w;
    zv[8 * r + 4] = b.x; zv[8 * r + 5] = b.y;
    zv[8 * r + 6] = b.z; zv[8 * r + 7] = b.w;
  }
}

// The products of NL query limbs by NC coordinate limbs in shift class
// CLS (limb l times limb CLS - l), into acc.  The top limb of each is
// signed.
template <int NC, int NL, int CLS, int L = 0>
__device__ __forceinline__ void class_products(int32_t (&acc)[4],
                                               const uint32_t (&a)[NL][4],
                                               const uint32_t (&b)[NC][2]) {
  if constexpr (L < NL) {
    constexpr int M = CLS - L;
    if constexpr (M >= 0 && M < NC)
      mma_i8<L == NL - 1, M == NC - 1>(acc, a[L], b[M]);
    class_products<NC, NL, CLS, L + 1>(acc, a, b);
  }
}

// One 32-deep step of every shift class below 32 bits, class by class:
// a class's sum (at most 2 products of 32 bytes of 255 * 255, below 2^22)
// is shifted and added to the uint32 total, which holds 2 cross and wraps
// as int32 does.
template <int NC, int NL, int CLS = 0>
__device__ __forceinline__ void step_classes(uint32_t (&cross2)[kNTiles][4],
                                             const uint32_t (&a)[NL][4],
                                             const uint32_t (&b)[kNTiles][NC][2]) {
  if constexpr (CLS < kClasses && CLS < NL + NC - 1) {
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      int32_t acc[4] = {0, 0, 0, 0};
      class_products<NC, NL, CLS>(acc, a, b[n]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cross2[n][e] += static_cast<uint32_t>(acc[e]) << (8 * CLS + 1);
    }
    step_classes<NC, NL, CLS + 1>(cross2, a, b);
  }
}

// 2 cross of the warp's 16 queries x 32 slots over the staged chunk of kn
// dimensions: query rows from row0 of zq_s, slots from b_s.
template <int NC, int NL>
__device__ __forceinline__ void chunk_cross(uint32_t (&cross2)[kNTiles][4],
                                            const int32_t* zq_s, int stride,
                                            int row0, const Planes<NC>& b_s,
                                            int kn, int slot0, int g, int t) {
  for (int s = 0; s * kStepK < kn; ++s) {
    int32_t zv[16];
    load_zq(zv, zq_s, stride, row0, g, t, s * kStepK);
    uint32_t a[NL][4];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      a[l][0] = limb4(zv[0], zv[1], zv[2], zv[3], l);      // row g, dims 8t..
      a[l][1] = limb4(zv[8], zv[9], zv[10], zv[11], l);    // row g + 8
      a[l][2] = limb4(zv[4], zv[5], zv[6], zv[7], l);      // row g, dims 8t+4..
      a[l][3] = limb4(zv[12], zv[13], zv[14], zv[15], l);  // row g + 8
    }
    uint32_t b[kNTiles][NC][2];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            &b_s[m][s][slot0 + n * 8 + g][2 * t]);
        b[n][m][0] = u.x;
        b[n][m][1] = u.y;
      }
    step_classes<NC, NL>(cross2, a, b);
  }
}

template <typename CoordT, int NC>
__global__ void __launch_bounds__(kBatchThreads, 4)
hntl_scan_kernel(const Params p) {
  __shared__ __align__(16) Planes<NC> b_s;
  __shared__ __align__(16) int32_t zq_s[kZqWords];
  __shared__ __align__(16) float out_s[kWarps][kTileQ][kOutStride];
  __shared__ uint32_t c2_s[kTileC];     // sum_j c^2 per slot, mod 2^32
  __shared__ float res_s[kTileC];
  __shared__ uint8_t ok_s[kTileC];
  __shared__ uint32_t zq2_s[kQGroup];   // sum_j zq^2 per query, mod 2^32
  __shared__ float rq_s[kQGroup];
  __shared__ uint8_t nl_s[kQGroup / kTileQ];   // limbs per query tile

  // Slot tiles vary fastest (x), so a panel's CTAs run together and share
  // its query rows through L2.
  const int64_t pi = blockIdx.y;
  const int c0 = blockIdx.x * kTileC;
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int slot0 = (tid >> 5) * (kTileC / kWarps);   // the warp's slots
  const CoordT* cg = static_cast<const CoordT*>(p.coords) + pi * p.k * p.cap;
  const int32_t* zg = p.zq + pi * p.Q * p.k;

  // One chunk (k <= kChunkK): the panel is staged once, and zq_s holds
  // whole query rows (k rounded up to 32, plus 4 words) for a group of up
  // to kQGroup queries, one row per thread.  More chunks: every query tile
  // restages the panel's chunk and its own 16 rows of it.
  const bool one_chunk = p.k <= kChunkK;
  const int kpad = one_chunk ? (p.k + kStepK - 1) / kStepK * kStepK : kChunkK;
  const int stride = kpad + 4;
  const int group = one_chunk
      ? min(kQGroup, kZqWords / stride / kTileQ * kTileQ) : kQGroup;
  const float sc = p.scale[pi];
  const float sc2 = __fmul_rn(sc, sc);
  const float rs = p.res_scale[pi];
  const int c = c0 + tid;
  const float res_t = c < p.cap ? static_cast<float>(p.res[pi * p.cap + c]) : 0.0f;
  const uint8_t ok_t = c < p.cap ? p.valid[pi * p.cap + c] : 0;
  // The first group's rows are on their way while the panel is staged.
  if (one_chunk && tid < group) stage_row(zq_s + tid * stride, p, zg, tid, 0, kpad);
  c2_s[tid] = 0;
  __syncthreads();
  for (int k0 = 0; k0 < p.k; k0 += kChunkK) {   // c2 over every chunk
    if (k0 > 0) __syncthreads();
    stage_chunk<CoordT, NC>(b_s, p, cg, c0, k0, c2_s);
  }
  res_s[tid] = res_t;
  ok_s[tid] = ok_t;

  for (int qg = 0; qg < p.Q; qg += group) {
    // Per query of the group (one per thread): zq2, rq and whether it
    // fits int8 / int16; per 16-query tile (a half warp) the limb count.
    const int q = qg + tid;
    const bool live = tid < group && q < p.Q;
    if (qg > 0) {
      __syncthreads();
      if (one_chunk && tid < group) stage_row(zq_s + tid * stride, p, zg, q, 0, kpad);
    }
    const float rq_t = live ? p.rq[pi * p.Q + q] : 0.0f;
    uint32_t zq2 = 0;
    bool fit8 = true, fit16 = true;
    auto count = [&](int4 v4) {
      const int32_t vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int32_t v = vv[e];
        zq2 += static_cast<uint32_t>(v) * static_cast<uint32_t>(v);
        fit8 = fit8 && v == static_cast<int8_t>(v);
        fit16 = fit16 && v == static_cast<int16_t>(v);
      }
    };
    if (one_chunk) {
      copy_async_wait();
      if (tid < group)
        for (int j = 0; j < kpad; j += 4)
          count(*reinterpret_cast<const int4*>(zq_s + tid * stride + j));
    } else if (live) {
      const int32_t* row = zg + static_cast<int64_t>(q) * p.k;
      for (int j = 0; j < p.k; j += 4) count(zq_quad(p, row, j));
    }
    uint32_t need = fit8 ? 1 : fit16 ? 2 : 4;
#pragma unroll
    for (int o = 1; o < kTileQ; o <<= 1)
      need = max(need, __shfl_xor_sync(0xffffffffu, need, o));
    if (tid < group) {
      zq2_s[tid] = zq2;
      rq_s[tid] = rq_t;
      if ((tid & (kTileQ - 1)) == 0) nl_s[tid / kTileQ] = need;
    }
    __syncthreads();
    // The per-slot terms of this lane's 8 output columns.
    uint32_t c2[kNTiles][2];
    float res[kNTiles][2];
    bool ok[kNTiles][2];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = slot0 + n * 8 + 2 * t + e;
        c2[n][e] = c2_s[cl];
        res[n][e] = res_s[cl];
        ok[n][e] = ok_s[cl] != 0;
      }

    for (int q0 = qg; q0 < min(p.Q, qg + group); q0 += kTileQ) {
      const int nl = nl_s[(q0 - qg) / kTileQ];
      uint32_t cross2[kNTiles][4];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cross2[n][e] = 0;
      for (int k0 = 0; k0 < p.k; k0 += kChunkK) {
        int row0 = q0 - qg;
        if (!one_chunk) {
          __syncthreads();
          stage_chunk<CoordT, NC>(b_s, p, cg, c0, k0, nullptr);
          for (int e = tid; e < kTileQ * kChunkK / 4; e += kBatchThreads) {
            const int r = e / (kChunkK / 4), j = e % (kChunkK / 4) * 4;
            stage_row(zq_s + r * stride + j, p, zg, q0 + r, k0 + j, 4);
          }
          copy_async_wait();
          __syncthreads();
          row0 = 0;
        }
        const int kn = min(kChunkK, p.k - k0);
        if (nl == 1)
          chunk_cross<NC, 1>(cross2, zq_s, stride, row0, b_s, kn, slot0, g, t);
        else if (nl == 2)
          chunk_cross<NC, 2>(cross2, zq_s, stride, row0, b_s, kn, slot0, g, t);
        else
          chunk_cross<NC, 4>(cross2, zq_s, stride, row0, b_s, kn, slot0, g, t);
      }

      // Epilogue: fragment e of n-tile n is row g + 8 (e >> 1), slot
      // slot0 + 8n + 2t + (e & 1).  The warp's 16 x 32 outputs go through
      // its rows of out_s (stride 40 words: a half warp's 8-byte writes
      // hit 32 banks), so that each store instruction writes 4 whole
      // 128-byte lines.
      float (&ob)[kTileQ][kOutStride] = out_s[tid >> 5];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t zq2 = zq2_s[q0 - qg + g + 8 * r];
        const float rq = rq_s[q0 - qg + g + 8 * r];
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t di = zq2 + c2[n][e] - cross2[n][2 * r + e];
            d[e] = ok[n][e] ? epilogue(di, sc2, res[n][e], rs, rq) : p.big;
          }
          *reinterpret_cast<float2*>(&ob[g + 8 * r][n * 8 + 2 * t]) =
              make_float2(d[0], d[1]);
        }
      }
      __syncwarp();
      const int rr = lane >> 3, cl = (lane & 7) * 4;
      const int cw = c0 + slot0 + cl;
      float* dst = p.out + (pi * p.Q + q0 + rr) * p.cap + cw;
      if (p.quad_out) {                  // cap % 4 == 0: cw + 3 < cap too
#pragma unroll
        for (int i = 0; i < kTileQ / 4; ++i)
          if (q0 + rr + 4 * i < p.Q && cw < p.cap)
            __stcs(reinterpret_cast<float4*>(dst + 4 * i * p.cap),
                   *reinterpret_cast<const float4*>(&ob[rr + 4 * i][cl]));
      } else {
        for (int i = 0; i < kTileQ / 4; ++i) {
          if (q0 + rr + 4 * i >= p.Q) break;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (cw + e < p.cap) __stcs(dst + 4 * i * p.cap + e, ob[rr + 4 * i][cl + e]);
        }
      }
      __syncwarp();
    }
  }
}

Params make_params(const void* zq, const void* rq, const void* coords,
                   const void* res, const void* valid, const void* scale,
                   const void* res_scale, void* out, int n_queries, int k,
                   int cap, float big) {
  Params p;
  p.zq = static_cast<const int32_t*>(zq);
  p.rq = static_cast<const float*>(rq);
  p.coords = coords;
  p.res = static_cast<const int32_t*>(res);
  p.valid = static_cast<const uint8_t*>(valid);
  p.scale = static_cast<const float*>(scale);
  p.res_scale = static_cast<const float*>(res_scale);
  p.out = static_cast<float*>(out);
  p.Q = n_queries;
  p.k = k;
  p.cap = cap;
  p.big = big;
  p.vec_coords = p.vec_zq = p.quad_out = false;
  return p;
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" int hntl_scan_max_k() { return kMaxK; }

extern "C" const char* hntl_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Single-query form: zq [P, k], rq [P], coords [P, k, cap] of
// `coord_bytes` (2: int16, 1: int8), res/valid [P, cap], scale/res_scale
// [P] -> out [P, cap].  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int hntl_scan_single_launch(
    const void* zq, const void* rq, const void* coords, int coord_bytes,
    const void* res, const void* valid, const void* scale,
    const void* res_scale, void* out, int n_pairs, int k, int cap, float big,
    void* stream) {
  const int tiles = (cap + kThreads - 1) / kThreads;
  if (n_pairs < 1 || cap < 1 || k < 0 || k > kMaxK || tiles > 65535 ||
      (coord_bytes != 1 && coord_bytes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(zq, rq, coords, res, valid, scale, res_scale,
                               out, 1, k, cap, big);
  const dim3 grid(n_pairs, tiles);
  const size_t smem = static_cast<size_t>(k) * sizeof(int32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coord_bytes == 2)
    hntl_scan_single_kernel<int16_t><<<grid, kThreads, smem, s>>>(p);
  else
    hntl_scan_single_kernel<int8_t><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Batched-query form: zq [P, Q, k], rq [P, Q], coords [P, k, cap],
// res/valid [P, cap], scale/res_scale [P] -> out [P, Q, cap].  One launch
// for every 65535 panels (the grid's y limit).
extern "C" int hntl_scan_launch(
    const void* zq, const void* rq, const void* coords, int coord_bytes,
    const void* res, const void* valid, const void* scale,
    const void* res_scale, void* out, int n_pairs, int n_queries, int k,
    int cap, float big, void* stream) {
  constexpr int kMaxPanels = 65535;
  const int c_tiles = (cap + kTileC - 1) / kTileC;
  if (n_pairs < 1 || n_queries < 1 || cap < 1 || k < 0 || c_tiles > 65535 ||
      (coord_bytes != 1 && coord_bytes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(zq, rq, coords, res, valid, scale, res_scale, out,
                         n_queries, k, cap, big);
  // Offsets of whole panels keep these alignments.
  p.vec_coords = cap % 4 == 0 && aligned(coords, 4 * coord_bytes);
  p.vec_zq = k % 8 == 0 && aligned(zq, 16);
  p.quad_out = cap % 4 == 0 && aligned(out, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int p0 = 0; p0 < n_pairs; p0 += kMaxPanels) {
    const int n = n_pairs - p0 < kMaxPanels ? n_pairs - p0 : kMaxPanels;
    const int64_t pq = static_cast<int64_t>(p0) * n_queries, pc = static_cast<int64_t>(p0) * cap;
    Params c = p;
    c.zq = p.zq + pq * k;
    c.rq = p.rq + pq;
    c.coords = static_cast<const char*>(coords) + pc * k * coord_bytes;
    c.res = p.res + pc;
    c.valid = p.valid + pc;
    c.scale = p.scale + p0;
    c.res_scale = p.res_scale + p0;
    c.out = p.out + pq * cap;
    const dim3 grid(c_tiles, n);
    if (coord_bytes == 2)
      hntl_scan_kernel<int16_t, 2><<<grid, kBatchThreads, 0, s>>>(c);
    else
      hntl_scan_kernel<int8_t, 1><<<grid, kBatchThreads, 0, s>>>(c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
