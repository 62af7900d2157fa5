// Fused gather + distance for one beam-search hop, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flatnav_tpu/ops/gather_distance.py:_kernel
// (driven by gather_distances). It computes
//     out[b, c] = sum_i (V[ids[b, c], i] - q[b, i])^2          (L2)
//     out[b, c] = 1 - sum_i q[b, i] * V[ids[b, c], i]          (IP)
// with the sum taken in the FIXED binary-tree order of _tree_sum_last in
// flatnav_tpu_torch/ops/distances.py: zero-pad to the next power of two p,
// then add the upper half onto the lower half until one element is left.
// Every product, difference and add is a separately rounded intrinsic
// (__fmul_rn / __fsub_rn / __fadd_rn), so nvcc cannot contract them into
// FMAs and the result is bit-equal to the plain PyTorch version.
//
// Bound on this card: bytes. Each candidate row is read once for 2-3
// operations per element; at a search hop (B=1024, C=512, d=128 f32) the
// distinct rows, ids, queries and output are ~50 MB, about 15 us at
// 3.35 TB/s, and the gathered bytes (B*C*d*4 = 268 MB, mostly L2 hits)
// about 80 us. The kernel therefore has to keep many row loads in flight
// and spend few instructions per element.
//
// Design: the tree lives in registers. With K = max(p/32, 1), lane l of a
// warp holds terms l + 32k (k < K) of a row, a strided layout in which a
// warp's loads of one k are 32 neighbouring elements (coalesced). The
// tree's levels h >= 32 pair term l + 32k with l + 32(k + h/32): both in
// the same lane, so they are in-lane adds of register k + h/32 onto k.
// The last five levels (16, 8, 4, 2, 1; for p < 32 only those from p/2
// down) pair lane l with lane l + h: __shfl_down_sync. That is exactly the
// tree's association, with no shared memory and no __syncwarp. The query
// stays in registers in the same layout. Each warp scores R candidates at
// once (R*K = 8-64 registers of terms) and issues all of their loads before
// the first add; the block loads its CPB candidate ids once, coalesced,
// into shared memory. bf16/f16 rows of even d are read as 4-byte pairs
// that two shuffles redistribute into the strided layout (2-byte loads in
// that layout are the other choice, and slower). d runs to 4096: at
// p = 4096 (K would be 128) a lane keeps 64 registers of sums, the tree's
// top level added as the terms are formed, and the query moves to shared
// memory. An id outside [0, n) reads nothing and scores NaN.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int CPB = 128;  // candidates per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// the low (hi = false) or high half of a 4-byte pair of 16-bit elements
__device__ __forceinline__ float half_of(uint32_t w, bool hi, __nv_bfloat16*) {
  return __uint_as_float((hi ? (w >> 16) : (w & 0xffffu)) << 16);
}
__device__ __forceinline__ float half_of(uint32_t w, bool hi, __half*) {
  return __half2float(__ushort_as_half((unsigned short)(hi ? (w >> 16) : (w & 0xffffu))));
}

template <bool IP>
__device__ __forceinline__ float term(float q, float x) {
  if (IP) return __fmul_rn(q, x);
  float diff = __fsub_rn(q, x);
  return __fmul_rn(diff, diff);
}

// elements base + lane + 32k (k < K) of a row as floats, 0 past d or for an
// invalid row. PAIRED (16-bit rows of even d, K >= 2) reads 4-byte pairs
// and redistributes them into that strided layout with two shuffles.
template <typename VT, int K, bool PAIRED>
__device__ __forceinline__ void load_row(const VT* row, bool ok, int base, int d, int lane,
                                         float (&v)[K]) {
  if constexpr (PAIRED) {
    uint32_t w[K / 2];
#pragma unroll
    for (int m = 0; m < K / 2; ++m) {
      const int e = base + 64 * m + 2 * lane;
      w[m] = (ok && e < d) ? *reinterpret_cast<const uint32_t*>(row + e) : 0u;
    }
    // lane l needs elements 64m + l (held by lane l/2) and 64m + 32 + l
    // (held by lane 16 + l/2), each the (l & 1) half of that lane's pair
#pragma unroll
    for (int m = 0; m < K / 2; ++m) {
      const uint32_t lo = __shfl_sync(FULL, w[m], lane / 2);
      const uint32_t hi = __shfl_sync(FULL, w[m], 16 + lane / 2);
      v[2 * m] = half_of(lo, lane & 1, (VT*)nullptr);
      v[2 * m + 1] = half_of(hi, lane & 1, (VT*)nullptr);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = base + lane + 32 * k;
      v[k] = (ok && i < d) ? to_f(row[i]) : 0.f;
    }
  }
}

// K registers per lane per row; R rows in flight per warp. FOLD (p = 64K):
// each lane loads 2K terms and the tree's top level, term i + 32K onto
// term i, is the first add; the query then lives in shared memory.
template <typename VT, bool IP, int K, int R, bool PAIRED, bool FOLD>
__global__ void __launch_bounds__(WARPS * 32)
gather_distance_kernel(const VT* __restrict__ vec, const int* __restrict__ ids,
                       const float* __restrict__ q, int n, int d, int p, int C,
                       float* __restrict__ out) {
  __shared__ int sid[CPB];
  __shared__ float qs[FOLD ? 64 * K : 1];
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * CPB;
  const int cn = min(CPB, C - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < cn; i += WARPS * 32) sid[i] = ids[(size_t)b * C + c0 + i];

  float qr[FOLD ? 1 : K];
  if constexpr (FOLD) {
    for (int i = threadIdx.x; i < d; i += WARPS * 32) qs[i] = q[(size_t)b * d + i];
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + 32 * k;
      qr[k] = i < d ? q[(size_t)b * d + i] : 0.f;
    }
  }
  __syncthreads();

  float* ob = out + (size_t)b * C + c0;
  for (int g = warp * R; g < cn; g += WARPS * R) {
    int id[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = g + r;
      id[r] = c < cn ? sid[c] : -1;
      if (id[r] >= n) id[r] = -1;  // warp-uniform: every lane reads the same id
    }
    // every row load of the R candidates first, then the arithmetic
    float v[R][K];
    float u[R][FOLD ? K : 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const VT* row = vec + (size_t)max(id[r], 0) * d;
      load_row<VT, K, PAIRED>(row, id[r] >= 0, 0, d, lane, v[r]);
      if constexpr (FOLD) load_row<VT, K, PAIRED>(row, id[r] >= 0, 32 * K, d, lane, u[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < K; ++k) {  // padding terms (i >= d) are +0, as in the plain pad
        const int i = lane + 32 * k;
        if constexpr (FOLD) {
          const int j = i + 32 * K;
          v[r][k] = __fadd_rn(i < d ? term<IP>(qs[i], v[r][k]) : 0.f,
                              j < d ? term<IP>(qs[j], u[r][k]) : 0.f);
        } else {
          v[r][k] = i < d ? term<IP>(qr[k], v[r][k]) : 0.f;
        }
      }
#pragma unroll
      for (int h = K / 2; h >= 1; h /= 2)  // tree levels 32h: in-lane
#pragma unroll
        for (int k = 0; k < h; ++k) v[r][k] = __fadd_rn(v[r][k], v[r][k + h]);
    }
    for (int h = p >= 32 ? 16 : p / 2; h >= 1; h /= 2)  // levels 16..1: across lanes
#pragma unroll
      for (int r = 0; r < R; ++r) v[r][0] = __fadd_rn(v[r][0], __shfl_down_sync(FULL, v[r][0], h));
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (g + r >= cn) break;
        ob[g + r] = id[r] < 0 ? __int_as_float(0x7fc00000)
                              : (IP ? __fsub_rn(1.f, v[r][0]) : v[r][0]);
      }
    }
  }
}

template <typename VT, bool IP, int K, bool PAIRED, bool FOLD = false>
cudaError_t launch_k(const void* vec, const void* ids, const void* q, int n,
                     int d, int p, int B, int C, void* out, cudaStream_t stream) {
  constexpr int R = K >= 32 ? 1 : (K >= 16 ? 2 : (K >= 8 ? 4 : 8));
  dim3 grid(B, (C + CPB - 1) / CPB);
  gather_distance_kernel<VT, IP, K, R, PAIRED, FOLD><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const VT*>(vec), static_cast<const int*>(ids),
      static_cast<const float*>(q), n, d, p, C, static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename VT, bool IP, bool PAIRED>
cudaError_t launch_p(const void* vec, const void* ids, const void* q, int n,
                     int d, int B, int C, void* out, cudaStream_t s) {
  int p = 1;
  while (p < d) p *= 2;
  switch (p <= 32 ? 1 : p / 32) {
    case 1: return launch_k<VT, IP, 1, false>(vec, ids, q, n, d, p, B, C, out, s);
    case 2: return launch_k<VT, IP, 2, PAIRED>(vec, ids, q, n, d, p, B, C, out, s);
    case 4: return launch_k<VT, IP, 4, PAIRED>(vec, ids, q, n, d, p, B, C, out, s);
    case 8: return launch_k<VT, IP, 8, PAIRED>(vec, ids, q, n, d, p, B, C, out, s);
    case 16: return launch_k<VT, IP, 16, PAIRED>(vec, ids, q, n, d, p, B, C, out, s);
    case 32: return launch_k<VT, IP, 32, PAIRED>(vec, ids, q, n, d, p, B, C, out, s);
    case 64: return launch_k<VT, IP, 64, PAIRED>(vec, ids, q, n, d, p, B, C, out, s);
    case 128: return launch_k<VT, IP, 64, PAIRED, true>(vec, ids, q, n, d, p, B, C, out, s);
    default: return cudaErrorInvalidValue;  // d > 4096
  }
}

// 16-bit rows of even d in a 4-byte-aligned table are read as 4-byte pairs
// (measured faster than 2-byte loads at a bf16 search hop: PERF.md), the
// rest as single elements
template <typename VT>
cudaError_t launch_t(int ip, const void* vec, const void* ids, const void* q, int n, int d,
                     int B, int C, void* out, cudaStream_t s) {
  if constexpr (sizeof(VT) == 2) {
    if (d % 2 == 0 && (uintptr_t)vec % 4 == 0)
      return ip ? launch_p<VT, true, true>(vec, ids, q, n, d, B, C, out, s)
                : launch_p<VT, false, true>(vec, ids, q, n, d, B, C, out, s);
  }
  return ip ? launch_p<VT, true, false>(vec, ids, q, n, d, B, C, out, s)
            : launch_p<VT, false, false>(vec, ids, q, n, d, B, C, out, s);
}

}  // namespace

// vec_type: 0 = float32, 1 = bfloat16, 2 = float16; d <= 4096. Returns
// cudaGetLastError().
extern "C" int gather_distance_launch(const void* vec, int vec_type,
                                      const void* ids, const void* q, int n,
                                      int d, int B, int C, int ip, void* out,
                                      void* stream) {
  if (B == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_type) {
    case 0: return launch_t<float>(ip, vec, ids, q, n, d, B, C, out, s);
    case 1: return launch_t<__nv_bfloat16>(ip, vec, ids, q, n, d, B, C, out, s);
    case 2: return launch_t<__half>(ip, vec, ids, q, n, d, B, C, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
