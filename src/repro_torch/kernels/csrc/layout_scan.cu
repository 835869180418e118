// The two baseline layouts of the paper's Table 2, for Hopper (sm_90a),
// CUDA C++: an Array-of-Structures scan and a linked-list (pointer-chase)
// scan, one device program each.
//
// They replace no Pallas kernel.  They are the device programs that
// jax.jit makes of src/repro/core/scan.py's
//   aos_scan            (:147) -> aos_scan_kernel
//   pointer_chase_scan  (:163) -> pointer_chase_scan_kernel
// On the TPU each function is one program, the chase's lax.scan loop
// included.  Eager PyTorch would run the chase as ~8 launches per step
// (timing the host's launch rate, not a dependent gather) and would
// write AoS's [P, cap, k] int32 difference to device memory, which XLA
// fuses away; either would hide what Table 2 compares.  Their plain
// PyTorch versions are repro_torch.kernels.ref.aos_scan_ref and
// pointer_chase_scan_ref.
//
// What they compute:
//
//   aos:   d[p,c] = (float(sum_j (zq[p,j] - coords[p,c,j])^2) * scale[p]^2
//                    + float(res[p,c]) * res_scale[p]) + rq[p]
//          or `big` where valid[p,c] is 0;
//   chase: for t < n_steps, with ptr_0 = head and ptr_{t+1} = next[ptr_t],
//          d[t] = ((float(sum_j (zq[j] - coords[ptr_t,j])^2) * scale) * scale
//                  + float(res[ptr_t]) * res_scale) + rq.
//
// The two products differ in order, as they do in the JAX package.  A
// pointer is read as JAX's gather reads it: a negative one counts from
// the end, then it is clamped to [0, N-1].  Integer sums are taken
// modulo 2^32 (they wrap as int32 does), and every float step is rounded
// on its own (__fmul_rn / __fadd_rn: no FMA contraction), so each kernel
// equals its plain version bit for bit.  Coordinates are int16 or int32
// (a template parameter).
//
// aos_scan_kernel: bound by bytes (2k + 9 bytes a slot at int16 against
// ~3k integer operations).  One thread per (panel, slot), as the
// Block-SoA single-query kernel, but a thread reads its own vector's k
// coordinates in order from its vector-major row: a warp's loads of one
// dimension are k elements apart, so each load instruction touches
// min(32, 32 * k * size / 128) cache lines and relies on L1 to serve the
// rest of the row.  That access pattern is the layout's cost, and what
// Table 2 measures.  zq is read through the read-only cache (every
// thread of a panel reads the same address).
//
// pointer_chase_scan_kernel: bound by latency, one dependent load of
// next_ptr per step.  One warp walks the list; its lanes stride over the
// k coordinates of the row (no limit on k), a warp reduction sums them
// (order-free: the sum is exact modulo 2^32), and lane 0 writes step t's
// distance in visit order.  The step's row, residual and next pointer
// are loaded together once ptr is known.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;     // AoS: slots per block

struct AosParams {
  const int32_t* __restrict__ zq;         // [P, k]
  const float* __restrict__ rq;           // [P]
  const void* coords;                     // [P, cap, k], int16 or int32
  const int32_t* __restrict__ res;        // [P, cap]
  const uint8_t* __restrict__ valid;      // [P, cap] bool
  const float* __restrict__ scale;        // [P]
  const float* __restrict__ res_scale;    // [P]
  float* __restrict__ out;                // [P, cap]
  int k, cap;
  float big;
};

struct ChaseParams {
  const int32_t* __restrict__ zq;         // [k]
  const float* __restrict__ rq;           // []
  const void* coords;                     // [N, k], int16 or int32
  const int32_t* __restrict__ res;        // [N]
  const int32_t* __restrict__ next_ptr;   // [N]
  const int32_t* __restrict__ head;       // []
  const float* __restrict__ scale;        // []
  const float* __restrict__ res_scale;    // []
  float* __restrict__ out;                // [n_steps]
  int64_t n_rows, n_steps;
  int k;
};

template <typename CoordT>
__global__ void __launch_bounds__(kThreads) aos_scan_kernel(const AosParams p) {
  const int64_t pi = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= p.cap) return;
  const int64_t o = pi * p.cap + c;
  const int32_t* zq = p.zq + pi * p.k;
  const CoordT* row = static_cast<const CoordT*>(p.coords) + o * p.k;
  uint32_t acc = 0;                       // int32 arithmetic, wraps
  for (int j = 0; j < p.k; ++j) {
    const uint32_t df = static_cast<uint32_t>(__ldg(zq + j)) -
                        static_cast<uint32_t>(static_cast<int32_t>(row[j]));
    acc += df * df;
  }
  const float sc = p.scale[pi];
  float d = __fmul_rn(static_cast<float>(static_cast<int32_t>(acc)), __fmul_rn(sc, sc));
  d = __fadd_rn(d, __fmul_rn(static_cast<float>(p.res[o]), p.res_scale[pi]));
  d = __fadd_rn(d, p.rq[pi]);
  p.out[o] = p.valid[o] ? d : p.big;
}

// JAX's reading of an index into n rows: negative counts from the end,
// then clamped to [0, n-1].
__device__ __forceinline__ int64_t row_of(int64_t ptr, int64_t n) {
  if (ptr < 0) ptr += n;
  return ptr < 0 ? 0 : (ptr >= n ? n - 1 : ptr);
}

template <typename CoordT>
__global__ void __launch_bounds__(32) pointer_chase_scan_kernel(const ChaseParams p) {
  const int lane = threadIdx.x;
  const CoordT* coords = static_cast<const CoordT*>(p.coords);
  const float rq = *p.rq, sc = *p.scale, rs = *p.res_scale;
  int64_t ptr = row_of(*p.head, p.n_rows);
  for (int64_t t = 0; t < p.n_steps; ++t) {
    const CoordT* row = coords + ptr * p.k;
    const int32_t nxt = p.next_ptr[ptr];
    const int32_t r = p.res[ptr];
    uint32_t acc = 0;
    for (int j = lane; j < p.k; j += 32) {
      const uint32_t df = static_cast<uint32_t>(__ldg(p.zq + j)) -
                          static_cast<uint32_t>(static_cast<int32_t>(row[j]));
      acc += df * df;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      float d = __fmul_rn(__fmul_rn(static_cast<float>(static_cast<int32_t>(acc)), sc), sc);
      d = __fadd_rn(d, __fmul_rn(static_cast<float>(r), rs));
      p.out[t] = __fadd_rn(d, rq);
    }
    ptr = row_of(nxt, p.n_rows);
  }
}

}  // namespace

extern "C" const char* layout_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// zq [P, k] i32, rq [P] f32, coords [P, cap, k] of `coord_bytes` (2:
// int16, 4: int32), res [P, cap] i32, valid [P, cap] bool, scale and
// res_scale [P] f32 -> out [P, cap] f32.  Launches on `stream` and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int aos_scan_launch(const void* zq, const void* rq, const void* coords,
                               int coord_bytes, const void* res, const void* valid,
                               const void* scale, const void* res_scale, void* out,
                               int n_panels, int k, int cap, float big,
                               void* stream) {
  const int tiles = (cap + kThreads - 1) / kThreads;
  if (n_panels < 1 || cap < 1 || k < 0 || tiles > 65535 ||
      (coord_bytes != 2 && coord_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  AosParams p;
  p.zq = static_cast<const int32_t*>(zq);
  p.rq = static_cast<const float*>(rq);
  p.coords = coords;
  p.res = static_cast<const int32_t*>(res);
  p.valid = static_cast<const uint8_t*>(valid);
  p.scale = static_cast<const float*>(scale);
  p.res_scale = static_cast<const float*>(res_scale);
  p.out = static_cast<float*>(out);
  p.k = k;
  p.cap = cap;
  p.big = big;
  const dim3 grid(n_panels, tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coord_bytes == 2)
    aos_scan_kernel<int16_t><<<grid, kThreads, 0, s>>>(p);
  else
    aos_scan_kernel<int32_t><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// zq [k] i32, rq [] f32, coords [N, k] of `coord_bytes` (2: int16, 4:
// int32), res [N] i32, next_ptr [N] i32, head [] i32, scale and
// res_scale [] f32 -> out [n_steps] f32.  One warp.
extern "C" int pointer_chase_scan_launch(const void* zq, const void* rq,
                                         const void* coords, int coord_bytes,
                                         const void* res, const void* next_ptr,
                                         const void* head, const void* scale,
                                         const void* res_scale, void* out,
                                         long long n_rows, long long n_steps, int k,
                                         void* stream) {
  if (n_rows < 1 || n_steps < 1 || k < 0 || (coord_bytes != 2 && coord_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  ChaseParams p;
  p.zq = static_cast<const int32_t*>(zq);
  p.rq = static_cast<const float*>(rq);
  p.coords = coords;
  p.res = static_cast<const int32_t*>(res);
  p.next_ptr = static_cast<const int32_t*>(next_ptr);
  p.head = static_cast<const int32_t*>(head);
  p.scale = static_cast<const float*>(scale);
  p.res_scale = static_cast<const float*>(res_scale);
  p.out = static_cast<float*>(out);
  p.n_rows = n_rows;
  p.n_steps = n_steps;
  p.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coord_bytes == 2)
    pointer_chase_scan_kernel<int16_t><<<1, 32, 0, s>>>(p);
  else
    pointer_chase_scan_kernel<int32_t><<<1, 32, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
