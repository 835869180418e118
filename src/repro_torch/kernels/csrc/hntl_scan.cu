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
// or `big` where valid[p,c] is 0.  The integer sum is taken in unsigned
// 32-bit arithmetic, so it wraps exactly as int32 does in JAX and in the
// plain version (the JAX batched form zq^2 + z^2 - 2 zq.z is the same sum
// modulo 2^32).  Every float step is rounded on its own (__fmul_rn /
// __fadd_rn: no FMA contraction) in the JAX op order, so a kernel equals
// its plain version bit for bit.  The coordinate type is a template
// parameter: int16 panels, and int8 for the residual sketch pass.
//
// What bounds them on this card:
//  * hntl_scan_single: bytes.  Each slot costs k coordinates (2k bytes at
//    int16), 4 bytes of residual, 1 of mask and 4 of output against about
//    3k integer operations: about one operation per byte, far below the
//    card's ratio of operations to bytes.
//  * hntl_scan: with Q queries sharing each panel the integer work grows
//    to about 3k operations per output while each panel byte is read once,
//    so at Q in the hundreds the CUDA cores' integer rate, and the 4-byte
//    output per (query, slot), are what bound it.
//
// What the design does about it (simple first; see ROADMAP for the
// tensor-core plan of the batched form):
//  * hntl_scan_single: a grid of (P, cap tiles of 256) with one thread per
//    slot.  The pair's zq lives in shared memory and is read as a
//    broadcast; the loop over k reads coords[p, j, c], which is contiguous
//    along c (the panel is dimension-major), so each warp's read of a
//    coordinate row is one coalesced run.
//  * hntl_scan: a grid of (P, query tiles of 32, slot tiles of 64).  The
//    block stages a [32 dims x 64 slots] coordinate tile and a
//    [32 queries x 32 dims] query tile in shared memory per step over k;
//    each of its 256 threads owns one slot and 8 queries, so a warp reads
//    one query value as a broadcast and 32 neighbouring slots without bank
//    conflicts, and writes 32 neighbouring outputs.
//  * neither pads anything: the ragged tails of cap and Q are masked in
//    the kernel, so no panel is copied.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 4096;        // single form: zq in shared memory

// Batched form's tiles.
constexpr int kTileC = 64;         // slots per block
constexpr int kTileQ = 32;         // queries per block
constexpr int kTileK = 32;         // dimensions per shared-memory step
constexpr int kQPerThread = kTileQ * kTileC / kThreads;   // 8

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

template <typename CoordT>
__global__ void __launch_bounds__(kThreads)
hntl_scan_kernel(const Params p) {
  __shared__ int32_t z_s[kTileK][kTileC];     // coordinates, dim-major
  __shared__ int32_t q_s[kTileQ][kTileK + 1]; // queries (+1: no bank clash on fill)

  const int64_t pi = blockIdx.x;
  const int q0 = blockIdx.y * kTileQ;
  const int c0 = blockIdx.z * kTileC;
  const int tid = threadIdx.x;
  const int cl = tid % kTileC;                // this thread's slot in the tile
  const int qg = tid / kTileC;                // and its first query
  const CoordT* cg = static_cast<const CoordT*>(p.coords) + pi * p.k * p.cap;
  const int32_t* zg = p.zq + pi * p.Q * p.k;

  uint32_t acc[kQPerThread];
#pragma unroll
  for (int i = 0; i < kQPerThread; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < p.k; k0 += kTileK) {
    const int kn = min(kTileK, p.k - k0);
    for (int e = tid; e < kTileK * kTileC; e += kThreads) {
      const int j = e / kTileC, c = c0 + e % kTileC;
      z_s[j][e % kTileC] = (j < kn && c < p.cap)
          ? static_cast<int32_t>(cg[static_cast<int64_t>(k0 + j) * p.cap + c]) : 0;
    }
    for (int e = tid; e < kTileQ * kTileK; e += kThreads) {
      const int qq = e / kTileK, j = e % kTileK, q = q0 + qq;
      q_s[qq][j] = (j < kn && q < p.Q)
          ? zg[static_cast<int64_t>(q) * p.k + k0 + j] : 0;
    }
    __syncthreads();
    for (int j = 0; j < kn; ++j) {
      const uint32_t z = static_cast<uint32_t>(z_s[j][cl]);
#pragma unroll
      for (int i = 0; i < kQPerThread; ++i) {
        const uint32_t df =
            static_cast<uint32_t>(q_s[qg + i * (kThreads / kTileC)][j]) - z;
        acc[i] += df * df;
      }
    }
    __syncthreads();
  }

  const int c = c0 + cl;
  if (c >= p.cap) return;
  const float sc = p.scale[pi];
  const float sc2 = __fmul_rn(sc, sc);
  const float rs = p.res_scale[pi];
  const int64_t slot = pi * p.cap + c;
  const float res = static_cast<float>(p.res[slot]);
  const bool ok = p.valid[slot] != 0;
#pragma unroll
  for (int i = 0; i < kQPerThread; ++i) {
    const int q = q0 + qg + i * (kThreads / kTileC);
    if (q >= p.Q) break;
    const int64_t pq = pi * p.Q + q;
    p.out[pq * p.cap + c] = ok ? epilogue(acc[i], sc2, res, rs, p.rq[pq]) : p.big;
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
  return p;
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
// res/valid [P, cap], scale/res_scale [P] -> out [P, Q, cap].
extern "C" int hntl_scan_launch(
    const void* zq, const void* rq, const void* coords, int coord_bytes,
    const void* res, const void* valid, const void* scale,
    const void* res_scale, void* out, int n_pairs, int n_queries, int k,
    int cap, float big, void* stream) {
  const int q_tiles = (n_queries + kTileQ - 1) / kTileQ;
  const int c_tiles = (cap + kTileC - 1) / kTileC;
  if (n_pairs < 1 || n_queries < 1 || cap < 1 || k < 0 || q_tiles > 65535 ||
      c_tiles > 65535 || (coord_bytes != 1 && coord_bytes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(zq, rq, coords, res, valid, scale, res_scale,
                               out, n_queries, k, cap, big);
  const dim3 grid(n_pairs, q_tiles, c_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coord_bytes == 2)
    hntl_scan_kernel<int16_t><<<grid, kThreads, 0, s>>>(p);
  else
    hntl_scan_kernel<int8_t><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
