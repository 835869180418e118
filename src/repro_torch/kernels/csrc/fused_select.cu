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
// What bounds it on this card: bytes.  Each probed slot costs 2k + s
// bytes of panel plus 4 of residual and 1 of mask, against about 3(k + s)
// integer operations: far below the ~20 operations per byte where the
// SIMT integer units would become the limit.  Panels probed by several
// queries are re-read per query (from L2 when they are still there).
//
// What the design does about it:
//  * one CTA per query walks that query's probes and cap tiles in a loop
//    (the TPU's sequential grid axes); panel offsets come from gids[q, p]
//    in the kernel, so no per-query copy of a panel is ever made;
//  * each thread owns one slot of a 256-slot tile, so a warp reads each
//    dimension-major coordinate row as one contiguous run;
//  * killed probes (p >= n_active[q]) and pruned probes (keep == 0) are
//    skipped whole, and the ragged tail of cap is masked in the kernel;
//  * the running top-W lives in shared memory as 64-bit keys
//    (order-preserving bits of the f32 distance << 32 | visit index + 1).
//    A slot only competes if its key beats the current W-th key; the few
//    that do are appended to a buffer, and a full buffer is folded into
//    the carry by one block-wide bitonic sort.  Only [Q, width] is ever
//    written to device memory.  Every thread reads the append counter to
//    decide whether to fold, and a barrier separates that read from the
//    tile's appends: so all threads take the same decision, and either
//    all reach the sort's barriers or none does.
//
// Limits: width <= kMaxWidth (shared memory: next_pow2(width + 256) keys
// of 8 bytes, 128 KB at the limit); P * cap < 2^32 - 1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 8192;

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
  float* out_d;                 // [Q, width]
  int32_t* out_r;               // [Q, width]
  int P, k, s, G, cap, width, n_keys;
  float big;
};

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of_order(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Ascending bitonic sort of n (a power of two) keys in shared memory.
// Every thread of the block calls it; it ends synchronised.
__device__ void block_sort(unsigned long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long x = a[lo], y = a[hi];
        if ((x > y) == up) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

template <bool kSketch, bool kTenant>
__global__ void __launch_bounds__(kThreads)
fused_scan_select_kernel(const Params p) {
  extern __shared__ unsigned long long keys[];   // [n_keys]: carry, buffer
  int* zq_s = reinterpret_cast<int*>(keys + p.n_keys);
  int* sq_s = zq_s + p.k;
  __shared__ int buf_n;

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int carry_n = p.width;
  const int buf_cap = p.n_keys - carry_n;
  const unsigned long long empty = ~0ull;
  const unsigned long long big_key =
      static_cast<unsigned long long>(order_bits(p.big)) << 32;  // visit 0

  for (int i = tid; i < p.n_keys; i += kThreads)
    keys[i] = i < carry_n ? big_key : empty;
  if (tid == 0) buf_n = 0;
  __syncthreads();

  unsigned long long thr = big_key;   // key of the carry's width-th entry
  int n_probe = p.P;
  if (p.n_active != nullptr) n_probe = min(max(p.n_active[q], 0), p.P);

  for (int pi = 0; pi < n_probe; ++pi) {
    const int64_t qp = static_cast<int64_t>(q) * p.P + pi;
    if (!p.keep[qp]) continue;                    // block-uniform
    const int g = p.gids[qp];
    for (int j = tid; j < p.k; j += kThreads) zq_s[j] = p.zq[qp * p.k + j];
    if (kSketch)
      for (int j = tid; j < p.s; j += kThreads) sq_s[j] = p.sq[qp * p.s + j];
    __syncthreads();

    const float sc = p.scale[g];
    const float sc2 = __fmul_rn(sc, sc);
    const float rs = p.res_scale[g];
    const float rqv = p.rq[qp];
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

    for (int base = 0; base < p.cap; base += kThreads) {
      // No thread appends before every thread has read the counter, so
      // `full` is the same in all of them.
      const bool full = buf_n > buf_cap - kThreads;
      __syncthreads();
      if (full) {
        block_sort(keys, p.n_keys);
        for (int i = carry_n + tid; i < p.n_keys; i += kThreads)
          keys[i] = empty;
        if (tid == 0) buf_n = 0;
        __syncthreads();
        thr = keys[carry_n - 1];
      }
      const int c = base + tid;
      bool live = c < p.cap && p.mask[gc + c] != 0;
      if (kTenant) live = live && tg[c] != 0;
      if (live) {
        uint32_t acc = 0;                         // int32 arithmetic, wraps
        for (int j = 0; j < p.k; ++j) {
          const uint32_t df = static_cast<uint32_t>(
              zq_s[j] - static_cast<int>(cg[static_cast<int64_t>(j) * p.cap + c]));
          acc += df * df;
        }
        float d = __fmul_rn(static_cast<float>(static_cast<int32_t>(acc)), sc2);
        d = __fadd_rn(__fadd_rn(d, __fmul_rn(static_cast<float>(p.res[gc + c]), rs)),
                      rqv);
        if (kSketch) {
          uint32_t sacc = 0;
          for (int j = 0; j < p.s; ++j) {
            const uint32_t df = static_cast<uint32_t>(
                sq_s[j] - static_cast<int>(skg[static_cast<int64_t>(j) * p.cap + c]));
            sacc += df * df;
          }
          d = __fadd_rn(d, __fmul_rn(static_cast<float>(static_cast<int32_t>(sacc)), sk2));
        }
        const uint32_t visit = static_cast<uint32_t>(pi) * p.cap + c + 1u;
        const unsigned long long key =
            (static_cast<unsigned long long>(order_bits(d)) << 32) | visit;
        if (key < thr) keys[carry_n + atomicAdd(&buf_n, 1)] = key;
      }
      __syncthreads();
    }
  }

  if (buf_n > 0) block_sort(keys, p.n_keys);

  const float half_big = p.big * 0.5f;
  for (int i = tid; i < p.width; i += kThreads) {
    const unsigned long long key = keys[i];
    const float d = float_of_order(static_cast<uint32_t>(key >> 32));
    int32_t row = -1;
    if (d < half_big) {
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
}

int next_pow2(int v) {
  int n = 1;
  while (n < v) n <<= 1;
  return n;
}

}  // namespace

extern "C" int fused_scan_select_max_width() { return kMaxWidth; }

extern "C" const char* fused_scan_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  Null pointers mark absent optional inputs.
extern "C" int fused_scan_select_launch(
    const void* gids, const void* zq, const void* rq, const void* keep,
    const void* coords, const void* res, const void* mask, const void* rows,
    const void* scale, const void* res_scale, const void* sq,
    const void* sketch, const void* sketch_scale, const void* tenant_mask,
    const void* tenant_ix, const void* n_active, void* out_d, void* out_r,
    int n_queries, int n_probes, int k, int s, int n_grains, int cap,
    int width, float big, void* stream) {
  if (width < 1 || width > kMaxWidth || n_queries < 1)
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
  p.out_d = static_cast<float*>(out_d);
  p.out_r = static_cast<int32_t*>(out_r);
  p.P = n_probes;
  p.k = k;
  p.s = has_sketch ? s : 0;
  p.G = n_grains;
  p.cap = cap;
  p.width = width;
  p.n_keys = next_pow2(width + kThreads);
  p.big = big;

  const size_t smem = static_cast<size_t>(p.n_keys) * sizeof(unsigned long long) +
                      static_cast<size_t>(p.k + p.s) * sizeof(int);
  void (*kern)(const Params);
  if (has_sketch)
    kern = has_tenant ? fused_scan_select_kernel<true, true>
                      : fused_scan_select_kernel<true, false>;
  else
    kern = has_tenant ? fused_scan_select_kernel<false, true>
                      : fused_scan_select_kernel<false, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<n_queries, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
