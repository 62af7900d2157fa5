// Fused scan with a strided bucket minimum, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flatnav_tpu/ops/fused_scan.py:_scan_kernel
// (driven by fused_knn). For row tile j (T rows) and every query q it
// computes
//     key[q, col] = pen[col] - 2 * <q_bf, row_col>      (f32 accumulation)
// with key = +inf for col >= nlim, and reduces the T columns into S = T/L
// strided buckets: bucket b holds columns {b, b+S, ..., b+(L-1)S}. It
// writes each bucket's minimum key and the global id attaining it; ties go
// to the lowest slice l, that is the lowest id (l ascends, strict <). The
// [B, N] key matrix never reaches device memory: only the 1/L-size
// [qc, nb] f32 + i32 summary does.
//
// Rows are bf16, or uint8/int8 converted to bf16 as they are staged (exact
// for 8-bit values; with d <= 257 every partial sum is an integer below
// 2^24, so the f32 keys are exact and bit-equal to any summation order).
//
// Bound on this card: operations for wide batches. At N = 1M, d = 128,
// B = 4096 the products are 1.07 TFLOP, about 1.1 ms at 989 TFLOP/s bf16
// dense; the summary written is 2.1 GB, about 0.63 ms at 3.35 TB/s. The
// products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32); the
// keys and the running min/argmin stay in registers, and each row tile is
// re-read from L2, not device memory. wgmma, TMA and a pipelined load are
// left to a later change: this version stages every chunk synchronously.
//
// Layout: one block per (row tile j, BS = 128 buckets, BQ = 64 queries);
// blocks write disjoint outputs, so no cross-block reduction exists. The
// block loops over the L slices; for each it runs a shared-memory tiled
// product over d in chunks of DK, where each of the 8 warps owns a 32 x 32
// (query, bucket) tile, then folds that slice's keys into the running min.
// Every row load is bound-checked against n: the last tile's rows past the
// table are never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BS = 128;  // buckets per block (S is a multiple of 128)
constexpr int DK = 64;   // depth chunk staged in shared memory
constexpr int LD = DK + 8;  // padded row stride: conflict-free fragment loads
constexpr int NT = 256;  // 8 warps: 2 (queries) x 4 (buckets), 32 x 32 each

__device__ __forceinline__ __nv_bfloat16 to_bf(__nv_bfloat16 v) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_bf(uint8_t v) { return __float2bfloat16((float)v); }
__device__ __forceinline__ __nv_bfloat16 to_bf(int8_t v) { return __float2bfloat16((float)v); }

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [rbase, rbase + BS) x columns [k0, k0 + DK) as bf16 into rs.
// 16-byte loads when every row starts 16-byte aligned (vec), else scalar.
template <typename RowT>
__device__ __forceinline__ void stage_rows(__nv_bfloat16 (*rs)[LD],
                                           const RowT* __restrict__ rows,
                                           long long rbase, int n, int d,
                                           int k0, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(RowT);  // elements per 16-byte load
    constexpr int PER_ROW = DK / V;
    for (int e = threadIdx.x; e < BS * PER_ROW; e += NT) {
      const int ri = e / PER_ROW, kk = (e % PER_ROW) * V;
      const long long gr = rbase + ri;
      const int gk = k0 + kk;
      __nv_bfloat16* dst = &rs[ri][kk];
      if (gr < n && gk < d) {  // d % V == 0: a piece is all in or all out
        const uint4 raw = *reinterpret_cast<const uint4*>(rows + (size_t)gr * d + gk);
        if constexpr (sizeof(RowT) == 2) {
          *reinterpret_cast<uint4*>(dst) = raw;
        } else {
          const RowT* v = reinterpret_cast<const RowT*>(&raw);
          __align__(16) __nv_bfloat16 out[16];
#pragma unroll
          for (int x = 0; x < 16; ++x) out[x] = to_bf(v[x]);
          reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(out)[0];
          reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(out)[1];
        }
      } else {
#pragma unroll
        for (int x = 0; x < V; ++x) dst[x] = __float2bfloat16(0.f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < BS * DK; e += NT) {
      const int ri = e / DK, kk = e % DK;
      const long long gr = rbase + ri;
      const int gk = k0 + kk;
      rs[ri][kk] = (gr < n && gk < d) ? to_bf(rows[(size_t)gr * d + gk])
                                      : __float2bfloat16(0.f);
    }
  }
}

template <typename RowT>
__global__ void __launch_bounds__(NT)
scan_kernel(const __nv_bfloat16* __restrict__ q, const RowT* __restrict__ rows,
            const float* __restrict__ pen, int qc, int n, int d, int nlim,
            int t, int L, int nb, bool vec, float* __restrict__ out_min,
            int* __restrict__ out_id) {
  // the block's query tile stays in shared memory for every slice:
  // [BQ][qld] bf16, d zero-padded to a multiple of 16 plus 8 (conflict-free)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16(*rs)[LD] = reinterpret_cast<__nv_bfloat16(*)[LD]>(smem_raw);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + sizeof(__nv_bfloat16) * BS * LD);
  const int d16 = (d + 15) & ~15;
  const int qld = d16 + 8;

  const int s = t / L;
  const int tiles_s = s / BS;
  const int j = blockIdx.x / tiles_s;
  const int b0 = (blockIdx.x % tiles_s) * BS;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, tig = lane % 4;

  for (int e = threadIdx.x; e < BQ * d16; e += NT) {
    const int qi = e / d16, kk = e % d16;
    const int gq = q0 + qi;
    qs[qi * qld + kk] = (gq < qc && kk < d) ? q[(size_t)gq * d + kk] : __float2bfloat16(0.f);
  }

  float best[2][4][4];
  int barg[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        best[mt][nt][e] = INFINITY;
        barg[mt][nt][e] = 0;
      }

  for (int l = 0; l < L; ++l) {
    const long long rbase = (long long)j * t + (long long)l * s + b0;
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int k0 = 0; k0 < d; k0 += DK) {
      stage_rows(rs, rows, rbase, n, d, k0, vec);
      __syncthreads();
      const int kmax = min(DK, d16 - k0);
      for (int k = 0; k < kmax; k += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* r0 = qs + (wm * 32 + mt * 16 + g) * qld + k0 + k + tig * 2;
          const __nv_bfloat16* r8 = r0 + 8 * qld;
          a[mt][0] = pair(r0);
          a[mt][1] = pair(r8);
          a[mt][2] = pair(r0 + 8);
          a[mt][3] = pair(r8 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn * 32 + nt * 8 + g;
          b[nt][0] = pair(&rs[c][k + tig * 2]);
          b[nt][1] = pair(&rs[c][k + tig * 2 + 8]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long col = rbase + wn * 32 + nt * 8 + tig * 2 + e;
        // col < nlim <= n, so pen is only read in bounds; 2*acc is exact,
        // so a contracted fma(-2, acc, pen) rounds the same as pen - 2*acc
        const bool ok = col < nlim;
        const float p = ok ? pen[col] : 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = h * 2 + e;
            const float key = ok ? p - 2.f * acc[mt][nt][i] : INFINITY;
            if (key < best[mt][nt][i]) {
              best[mt][nt][i] = key;
              barg[mt][nt][i] = l;
            }
          }
      }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gq = q0 + wm * 32 + mt * 16 + g + h * 8;
      if (gq >= qc) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bucket = b0 + wn * 32 + nt * 8 + tig * 2 + e;
          const int i = h * 2 + e;
          const size_t o = (size_t)gq * nb + (size_t)j * s + bucket;
          out_min[o] = best[mt][nt][i];
          out_id[o] = j * t + barg[mt][nt][i] * s + bucket;
        }
    }
}

template <typename RowT>
cudaError_t launch(const void* q, const void* rows, const void* pen, int qc,
                   int n, int d, int nlim, int t, int L, int nb, void* out_min,
                   void* out_id, cudaStream_t stream) {
  const int s = t / L;
  if (s % BS) return cudaErrorInvalidValue;
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)BS * LD + (size_t)BQ * (((d + 15) & ~15) + 8));
  auto kern = scan_kernel<RowT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  constexpr int V = 16 / sizeof(RowT);
  const bool vec = d % V == 0 && (uintptr_t)rows % 16 == 0;
  const int n_tiles = (n + t - 1) / t;
  dim3 grid(n_tiles * (s / BS), (qc + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const RowT*>(rows),
      static_cast<const float*>(pen), qc, n, d, nlim, t, L, nb, vec,
      static_cast<float*>(out_min), static_cast<int*>(out_id));
  return cudaGetLastError();
}

}  // namespace

// row_type: 0 = bfloat16, 1 = uint8, 2 = int8. Returns cudaGetLastError().
extern "C" int fused_scan_launch(const void* q, const void* rows, int row_type,
                                 const void* pen, int qc, int n, int d,
                                 int nlim, int t, int L, int nb, void* out_min,
                                 void* out_id, void* stream) {
  if (qc == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (row_type) {
    case 0: return launch<__nv_bfloat16>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    case 1: return launch<uint8_t>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    case 2: return launch<int8_t>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
