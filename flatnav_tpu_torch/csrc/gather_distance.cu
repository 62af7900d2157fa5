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
// FMAs and the result is bit-equal to the plain PyTorch version, at any d.
//
// Bound on this card: bytes. Each candidate row is read once for 2-3
// operations per element; at a search hop (B=1024, C=512, d=128 f32) the
// distinct rows, ids, queries and output are ~50 MB, about 15 us at
// 3.35 TB/s, and the gathered bytes (B*C*d*4 = 268 MB, mostly L2 hits)
// about 80 us. The kernel therefore has to keep many row loads in flight
// and spend few instructions per element.
//
// Layout: with K = max(p/32, 1), lane l of a warp holds terms l + 32k
// (k < K) of a row, a strided layout in which a warp's loads of one k are
// 32 neighbouring elements (coalesced). The tree's levels h >= 32 pair
// term l + 32k with l + 32(k + h/32): both in the same lane, so they are
// in-lane adds. The last five levels (16, 8, 4, 2, 1; for p < 32 only
// those from p/2 down) pair lane l with lane l + h: __shfl_down_sync. The
// block loads its CPB candidate ids once, coalesced, into shared memory.
// bf16/f16 rows of even d are read as 4-byte pairs that two shuffles
// redistribute into the strided layout (2-byte loads in that layout are
// the other choice, and slower). An id outside [0, n) reads nothing and
// scores NaN.
//
// The search's hop hands K2 -1 for each candidate that is not fresh, about
// two thirds of them. So the block stages its ids packed: those in [0, n)
// first, in position order, each beside its position, and it writes NaN
// for the others as it stages them. The warps then take only live ids, R
// at a time, so the row loads a warp keeps in flight all read a row. A
// row's sum is formed as it would be in any other slot: the same bits.
//
// p <= 1024 ("registers"; f16 pairs at p = 1024 take the carry stack,
// where ptxas gave this form an 8-byte stack frame): a lane keeps all K
// terms of a row in registers
// and adds the in-lane levels as a fold in half (register k + K/2 onto k,
// ...). The query stays in registers in the same layout. Each warp scores R
// candidates at once (R*K = 8-32 registers of terms) and issues all of
// their loads before the first add.
//
// p >= 2048 ("carry stack", any d): holding K >= 64 terms spilled to local
// memory (256-272-byte stack frames). A fold in half over K values is the binary tree whose leaves,
// read left to right, are the k in bit-reversed order (K = 4:
// (v0 + v2) + (v1 + v3)). So its top level splits the even k from the odd
// k, and each half is again a fold in half, over m = k/2 < K/2. A lane
// forms the terms of each half in chunks of DG positions m = mc + nc*j
// (j < DG, nc = K/(2 DG) chunks, mc = chunk c bit-reversed), which are
// exactly DG consecutive leaves: it folds them in half in registers and
// pushes the chunk's root onto a carry stack in shared memory, as a binary
// counter does (while bit s of c is set, the root is added onto slot s,
// the subtree to its left). After nc chunks the last slot holds the half's
// root, and the two halves' roots are the tree's in-lane root: the same
// adds of the same values, so the same bits, in O(log p) slots. Padding
// terms past d are +0.0 as in the plain version (their loads are skipped,
// the adds are not). The query is read through the L1 cache (every warp of
// the block reads the same one) and the row loads bypass it; each warp
// keeps R candidates x 2 DG loads in flight.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int CPB = 128;  // candidates per block
constexpr unsigned FULL = 0xffffffffu;
static_assert(CPB == WARPS * 32, "stage_ids gives each thread one candidate");

// Stages a block's cn <= CPB candidate ids (`ids`, its slice of a row) in
// shared memory, packed: sid[j] is the j-th id in [0, n) in position order
// and spos[j] its position. Every other slot gets NaN in `ob` (the block's
// slice of the output). Every thread calls it; the caller syncs before it
// reads sid. -> the number of ids in [0, n).
__device__ __forceinline__ int stage_ids(const int* ids, int n, int cn, int* sid, int* spos,
                                         float* ob) {
  __shared__ int warp_live[WARPS];
  const int i = threadIdx.x, lane = i % 32, warp = i / 32;
  const int id = i < cn ? ids[i] : -1;
  const bool live = id >= 0 && id < n;
  const unsigned mask = __ballot_sync(FULL, live);
  if (lane == 0) warp_live[warp] = __popc(mask);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? warp_live[w] : 0;
    total += warp_live[w];
  }
  if (live) {
    const int j = before + __popc(mask & ((1u << lane) - 1));
    sid[j] = id;
    spos[j] = i;
  } else if (i < cn) {
    ob[i] = __int_as_float(0x7fc00000);
  }
  return total;
}

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

// "registers": K registers per lane per row; R rows in flight per warp
template <typename VT, bool IP, int K, int R, bool PAIRED>
__global__ void __launch_bounds__(WARPS * 32)
gather_distance_kernel(const VT* __restrict__ vec, const int* __restrict__ ids,
                       const float* __restrict__ q, int n, int d, int p, int C,
                       float* __restrict__ out) {
  __shared__ int sid[CPB], spos[CPB];
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * CPB;
  const int cn = min(CPB, C - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ob = out + (size_t)b * C + c0;
  const int live = stage_ids(ids + (size_t)b * C + c0, n, cn, sid, spos, ob);

  float qr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    qr[k] = i < d ? q[(size_t)b * d + i] : 0.f;
  }
  __syncthreads();

  for (int g = warp * R; g < live; g += WARPS * R) {
    int id[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = g + r;
      id[r] = c < live ? sid[c] : -1;  // warp-uniform: every lane reads the same id
    }
    // every row load of the R candidates first, then the arithmetic
    float v[R][K];
#pragma unroll
    for (int r = 0; r < R; ++r)
      load_row<VT, K, PAIRED>(vec + (size_t)max(id[r], 0) * d, id[r] >= 0, 0, d, lane, v[r]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < K; ++k) {  // padding terms (i >= d) are +0, as in the plain pad
        const int i = lane + 32 * k;
        v[r][k] = i < d ? term<IP>(qr[k], v[r][k]) : 0.f;
      }
#pragma unroll
      for (int h = K / 2; h >= 1; h /= 2)  // tree levels 32h: in-lane
#pragma unroll
        for (int k = 0; k < h; ++k) v[r][k] = __fadd_rn(v[r][k], v[r][k + h]);
    }
    // levels 16..1 across lanes (for p < 32 only those from p/2 down). For
    // 16-bit rows a loop of run-time length gave ptxas 8-byte stack frames,
    // and for float rows the unrolled one ran a build wave 13% slower
    if constexpr (sizeof(VT) == 2) {
#pragma unroll
      for (int h = 16; h >= 1; h /= 2)
        if (K > 1 || h < p)
#pragma unroll
          for (int r = 0; r < R; ++r)
            v[r][0] = __fadd_rn(v[r][0], __shfl_down_sync(FULL, v[r][0], h));
    } else {
      for (int h = p >= 32 ? 16 : p / 2; h >= 1; h /= 2)
#pragma unroll
        for (int r = 0; r < R; ++r)
          v[r][0] = __fadd_rn(v[r][0], __shfl_down_sync(FULL, v[r][0], h));
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (g + r >= live) break;
        ob[spos[g + r]] = IP ? __fsub_rn(1.f, v[r][0]) : v[r][0];
      }
    }
  }
}

// ------------------------------------------------------- carry stack

constexpr int DG = 8;  // positions m of a chunk: 2 DG terms a lane and candidate
constexpr int RD = 4;  // candidates in flight a warp

// one element of a row, loaded past the L1 cache (the rows stream; the
// query, read by every warp of the block, stays there)
__device__ __forceinline__ float ld_row(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_row(const __nv_bfloat16* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __uint_as_float((uint32_t)v << 16);
}
__device__ __forceinline__ float ld_row(const __half* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __half2float(__ushort_as_half(v));
}
__device__ __forceinline__ uint32_t ld_pair(const void* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// p >= 2048 (see the top of the file). nc chunks of DG positions per half
// (nc = p / (64 DG), a power of two, lg = log2(nc)); the stack is
// [WARPS][RD][2 halves][lg + 1 slots][32 lanes] floats of dynamic shared
// memory, each lane reading back only what it wrote.
template <typename VT, bool IP, bool PAIRED>
__global__ void __launch_bounds__(WARPS * 32)
gather_distance_deep(const VT* __restrict__ vec, const int* __restrict__ ids,
                     const float* __restrict__ q, int n, int d, int nc, int lg, int C,
                     float* __restrict__ out) {
  extern __shared__ float stack[];
  __shared__ int sid[CPB], spos[CPB];
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * CPB;
  const int cn = min(CPB, C - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ob = out + (size_t)b * C + c0;
  const int live = stage_ids(ids + (size_t)b * C + c0, n, cn, sid, spos, ob);
  __syncthreads();

  const float* qb = q + (size_t)b * d;
  const int slots = lg + 1;
  for (int g = warp * RD; g < live; g += WARPS * RD) {
    int id[RD];
#pragma unroll
    for (int r = 0; r < RD; ++r) {
      const int c = g + r;
      id[r] = c < live ? sid[c] : -1;  // warp-uniform
    }
    float root[RD][2];
    for (int c = 0; c < nc; ++c) {
      const int mc = lg ? (int)(__brev((unsigned)c) >> (32 - lg)) : 0;
      // e[r][j], o[r][j]: elements 64 m + lane (k = 2m) and 64 m + 32 +
      // lane (k = 2m + 1) of candidate r at m = mc + nc j; every load first
      float e[RD][DG], o[RD][DG];
#pragma unroll
      for (int r = 0; r < RD; ++r) {
        const VT* row = vec + (size_t)max(id[r], 0) * d;
        const bool ok = id[r] >= 0;
#pragma unroll
        for (int j = 0; j < DG; ++j) {
          const int base = 64 * (mc + nc * j);
          if constexpr (PAIRED) {
            const int w = base + 2 * lane;  // d even: a pair is all in or all out
            e[r][j] = __uint_as_float((ok && w < d) ? ld_pair(row + w) : 0u);
          } else {
            e[r][j] = (ok && base + lane < d) ? ld_row(row + base + lane) : 0.f;
            o[r][j] = (ok && base + 32 + lane < d) ? ld_row(row + base + 32 + lane) : 0.f;
          }
        }
      }
      if constexpr (PAIRED) {  // lane l takes its halves from lanes l/2 and 16 + l/2
#pragma unroll
        for (int r = 0; r < RD; ++r)
#pragma unroll
          for (int j = 0; j < DG; ++j) {
            const uint32_t w = __float_as_uint(e[r][j]);
            const uint32_t lo = __shfl_sync(FULL, w, lane / 2);
            const uint32_t hi = __shfl_sync(FULL, w, 16 + lane / 2);
            e[r][j] = half_of(lo, lane & 1, (VT*)nullptr);
            o[r][j] = half_of(hi, lane & 1, (VT*)nullptr);
          }
      }
#pragma unroll
      for (int j = 0; j < DG; ++j) {
        const int ie = 64 * (mc + nc * j) + lane, io = ie + 32;
        const float qe = ie < d ? __ldg(qb + ie) : 0.f;
        const float qo = io < d ? __ldg(qb + io) : 0.f;
#pragma unroll
        for (int r = 0; r < RD; ++r) {  // padding terms (past d) are +0, as in the plain pad
          e[r][j] = ie < d ? term<IP>(qe, e[r][j]) : 0.f;
          o[r][j] = io < d ? term<IP>(qo, o[r][j]) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < RD; ++r) {
#pragma unroll
        for (int h = DG / 2; h >= 1; h /= 2)  // the chunk's subtree: a fold in half over j
#pragma unroll
          for (int j = 0; j < h; ++j) {
            e[r][j] = __fadd_rn(e[r][j], e[r][j + h]);
            o[r][j] = __fadd_rn(o[r][j], o[r][j + h]);
          }
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // push: a binary counter's carries
          float x = half ? o[r][0] : e[r][0];
          float* st = stack + ((warp * RD + r) * 2 + half) * slots * 32 + lane;
          int s = 0;
          for (; (c >> s) & 1; ++s) x = __fadd_rn(st[32 * s], x);
          st[32 * s] = x;
          root[r][half] = x;  // after the last chunk: the half's root
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RD; ++r) root[r][0] = __fadd_rn(root[r][0], root[r][1]);
    for (int h = 16; h >= 1; h /= 2)  // levels 16..1: across lanes
#pragma unroll
      for (int r = 0; r < RD; ++r)
        root[r][0] = __fadd_rn(root[r][0], __shfl_down_sync(FULL, root[r][0], h));
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RD; ++r)
        if (g + r < live) ob[spos[g + r]] = IP ? __fsub_rn(1.f, root[r][0]) : root[r][0];
    }
  }
}

template <typename VT, bool IP, int K, bool PAIRED>
cudaError_t launch_k(const void* vec, const void* ids, const void* q, int n,
                     int d, int p, int B, int C, void* out, cudaStream_t stream) {
  constexpr int R = K >= 32 ? 1 : (K >= 16 ? 2 : (K >= 8 ? 4 : 8));
  dim3 grid(B, (C + CPB - 1) / CPB);
  gather_distance_kernel<VT, IP, K, R, PAIRED><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const VT*>(vec), static_cast<const int*>(ids),
      static_cast<const float*>(q), n, d, p, C, static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename VT, bool IP, bool PAIRED>
cudaError_t launch_deep(const void* vec, const void* ids, const void* q, int n, int d,
                        long long p, int B, int C, void* out, cudaStream_t stream) {
  const int nc = (int)(p / (64 * DG));
  int lg = 0;
  while ((1 << lg) < nc) ++lg;
  const size_t smem = sizeof(float) * WARPS * RD * 2 * (lg + 1) * 32;
  auto kern = gather_distance_deep<VT, IP, PAIRED>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return cudaGetLastError();  // clears it for the next launch
  }
  dim3 grid(B, (C + CPB - 1) / CPB);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const VT*>(vec), static_cast<const int*>(ids), static_cast<const float*>(q),
      n, d, nc, lg, C, static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename VT, bool IP, bool PAIRED>
cudaError_t launch_p(const void* vec, const void* ids, const void* q, int n,
                     int d, int B, int C, void* out, cudaStream_t s) {
  long long p = 1;
  while (p < d) p *= 2;
  switch (p <= 32 ? 1 : (p >= 2048 ? 64 : (int)(p / 32))) {
    case 1: return launch_k<VT, IP, 1, false>(vec, ids, q, n, d, (int)p, B, C, out, s);
    case 2: return launch_k<VT, IP, 2, PAIRED>(vec, ids, q, n, d, (int)p, B, C, out, s);
    case 4: return launch_k<VT, IP, 4, PAIRED>(vec, ids, q, n, d, (int)p, B, C, out, s);
    case 8: return launch_k<VT, IP, 8, PAIRED>(vec, ids, q, n, d, (int)p, B, C, out, s);
    case 16: return launch_k<VT, IP, 16, PAIRED>(vec, ids, q, n, d, (int)p, B, C, out, s);
    case 32:  // f16 pairs at p = 1024 kept an 8-byte stack frame in registers
      if constexpr (PAIRED && std::is_same<VT, __half>::value)
        return launch_deep<VT, IP, PAIRED>(vec, ids, q, n, d, p, B, C, out, s);
      else
        return launch_k<VT, IP, 32, PAIRED>(vec, ids, q, n, d, (int)p, B, C, out, s);
    default: return launch_deep<VT, IP, PAIRED>(vec, ids, q, n, d, p, B, C, out, s);  // p >= 2048
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

// vec_type: 0 = float32, 1 = bfloat16, 2 = float16; any d >= 1. Returns
// cudaGetLastError().
extern "C" int gather_distance_launch(const void* vec, int vec_type,
                                      const void* ids, const void* q, int n,
                                      int d, int B, int C, int ip, void* out,
                                      void* stream) {
  if (B == 0 || C == 0) return 0;
  if (d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_type) {
    case 0: return launch_t<float>(ip, vec, ids, q, n, d, B, C, out, s);
    case 1: return launch_t<__nv_bfloat16>(ip, vec, ids, q, n, d, B, C, out, s);
    case 2: return launch_t<__half>(ip, vec, ids, q, n, d, B, C, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
