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
// Bound on this card: bytes. Each candidate row is read once (B*C*d*size
// bytes) for 2-3 flops per element; at B=1024, C=512, d=128 f32 that is
// 268 MB per hop, about 80 us at 3.35 TB/s. The design moves each row from
// device memory exactly once, with 16-byte loads where the row allows, and
// keeps the query row in shared memory for all the block's candidates.
//
// Layout: one block per (query b, chunk of CPB candidates); each of its
// WARPS warps takes one candidate row at a time, stages the row's p terms
// in its own slice of shared memory and reduces them there. An id outside
// [0, n) reads nothing and scores NaN.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int CPB = 64;  // candidates per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <bool IP>
__device__ __forceinline__ float term(float q, float x) {
  if (IP) return __fmul_rn(q, x);
  float diff = __fsub_rn(q, x);
  return __fmul_rn(diff, diff);
}

template <typename VT, bool IP>
__global__ void gather_distance_kernel(const VT* __restrict__ vec,
                                       const int* __restrict__ ids,
                                       const float* __restrict__ q, int n,
                                       int d, int p, int C, bool vec_ok,
                                       float* __restrict__ out) {
  extern __shared__ float smem[];
  const int d_al = (d + 3) & ~3;
  float* qs = smem;
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* wb = smem + d_al + warp * p;

  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = q[(size_t)b * d + i];
  __syncthreads();

  constexpr int VEC = 16 / sizeof(VT);
  const int c_end = min(C, (int)(blockIdx.y + 1) * CPB);
  for (int c = blockIdx.y * CPB + warp; c < c_end; c += WARPS) {
    const int id = ids[(size_t)b * C + c];
    if (id < 0 || id >= n) {  // warp-uniform
      if (lane == 0) out[(size_t)b * C + c] = __int_as_float(0x7fc00000);
      continue;
    }
    const VT* row = vec + (size_t)id * d;
    if (vec_ok) {
      // 16-byte loads: VEC elements per lane per step
      for (int i = lane * VEC; i < d; i += 32 * VEC) {
        uint4 raw = *reinterpret_cast<const uint4*>(row + i);
        const VT* v = reinterpret_cast<const VT*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) wb[i + e] = term<IP>(qs[i + e], to_f(v[e]));
      }
    } else {
      for (int i = lane; i < d; i += 32) wb[i] = term<IP>(qs[i], to_f(row[i]));
    }
    for (int i = d + lane; i < p; i += 32) wb[i] = 0.f;
    __syncwarp();
    for (int h = p / 2; h >= 1; h /= 2) {
      // lanes write [0, h) and read [h, 2h): no overlap within a level
      for (int i = lane; i < h; i += 32) wb[i] = __fadd_rn(wb[i], wb[i + h]);
      __syncwarp();
    }
    if (lane == 0) out[(size_t)b * C + c] = IP ? __fsub_rn(1.f, wb[0]) : wb[0];
    __syncwarp();
  }
}

template <typename VT, bool IP>
cudaError_t launch(const void* vec, const void* ids, const void* q, int n,
                   int d, int B, int C, void* out, cudaStream_t stream) {
  int p = 1;
  while (p < d) p *= 2;
  const size_t smem = sizeof(float) * (((d + 3) & ~3) + (size_t)WARPS * p);
  auto kern = gather_distance_kernel<VT, IP>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  constexpr int VEC = 16 / sizeof(VT);
  const bool vec_ok = (d % VEC == 0) && ((uintptr_t)vec % 16 == 0);
  dim3 grid(B, (C + CPB - 1) / CPB);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const VT*>(vec), static_cast<const int*>(ids),
      static_cast<const float*>(q), n, d, p, C, vec_ok,
      static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename VT>
cudaError_t launch_metric(int ip, const void* vec, const void* ids,
                          const void* q, int n, int d, int B, int C, void* out,
                          cudaStream_t s) {
  return ip ? launch<VT, true>(vec, ids, q, n, d, B, C, out, s)
            : launch<VT, false>(vec, ids, q, n, d, B, C, out, s);
}

}  // namespace

// vec_type: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError().
extern "C" int gather_distance_launch(const void* vec, int vec_type,
                                      const void* ids, const void* q, int n,
                                      int d, int B, int C, int ip, void* out,
                                      void* stream) {
  if (B == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_type) {
    case 0: return launch_metric<float>(ip, vec, ids, q, n, d, B, C, out, s);
    case 1: return launch_metric<__nv_bfloat16>(ip, vec, ids, q, n, d, B, C, out, s);
    case 2: return launch_metric<__half>(ip, vec, ids, q, n, d, B, C, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
