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
// Bound on this card: operations for wide batches. At N = 1M, d = 128,
// B = 4096 the products are 1.05 TFLOP, about 1.06 ms at 989 TFLOP/s bf16
// dense; the summary written is 2.0 GB, about 0.6 ms at 3.35 TB/s, and the
// table is 256 MB. Every block re-reads its rows from L2, so the query tile
// a block holds sets the L2 traffic: (B / queries per block) x table bytes.
//
// Two variants. The wrapper's scan_variant (ops/fused_scan.py) picks one by
// shape; the entry only refuses a "wgmma" launch that wgmma_scan::fits
// rejects.
//
// "wgmma" (bf16 rows, d % 8 == 0, 64 <= d <= 384, L <= 256, S % 128 == 0): one block per
// (row tile j, BN = 128 buckets, BM = 128 queries), 384 threads.
// Warpgroup 0 is the producer: one thread loads the block's query tile once
// by TMA, then streams the slices' rows as [128 rows x 64 columns] chunks
// through an 8-stage ring of shared-memory buffers guarded by mbarriers
// (full: the TMA bytes landed; empty: all 8 consumer warps are done), so
// loads run ahead of the products. Warpgroups 1 and 2 are the consumers, 64
// queries each. For every slice l a consumer issues wgmma m64n64k16 (bf16
// -> f32, both operands K-major in 128-byte-swizzled shared memory, as TMA
// writes them) over d into two accumulators, buckets 0-63 and 64-127, one
// commit group each; it folds the first half while the second half's
// products run, then the second, then frees the slice's buffers. The fold
// is elementwise, because every slice's accumulator holds the same (query,
// bucket) positions: key = fma(-2, acc, pen), strict < against the running
// min in registers, l (< 256) packed four to a register. What the design
// had to get past (PERF.md has the measurements):
//  - every wgmma wait retires a group committed in the same iteration; a
//    wait that retires the previous iteration's group made ptxas serialize
//    every wgmma;
//  - a wgmma fence waits for every register load in flight, so the next
//    slice's penalties are loaded after this slice's products are issued.
// setmaxnreg moves registers from the producer (40) to the consumers (232).
// TMA zero-fills rows past n and queries past qc, so no load is
// bound-checked; the keys of columns at or past nlim are +inf. A slice holds
// d/64 ring buffers until it is folded, and the query tile d/64 more: with
// 8 buffers of 16 KB, d <= 6 * 64 fits 227 KB of shared memory. Blocks are
// numbered query block first, so the query blocks of one row tile run
// together and its rows are read from device memory about once.
//
// "mma" (uint8/int8 rows and every other shape; the first port): one block
// per (row tile j, 128 buckets, 64 queries), 256 threads. The query tile
// stays in shared memory; each 64-deep chunk of the slice's rows is staged
// synchronously (converted to bf16: exact for 8-bit values, and with
// d <= 257 every partial sum is an integer below 2^24, so 8-bit keys are
// exact in any summation order), then each of 8 warps runs mma.sync
// m16n8k16 over a 32 x 32 (query, bucket) tile. Row loads are bound-checked
// against n.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ mma

namespace mma_scan {

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

}  // namespace mma_scan

// ---------------------------------------------------------------- wgmma

namespace wgmma_scan {

constexpr int BM = 128;      // queries per block: two consumer warpgroups x 64
constexpr int BN = 128;      // buckets per block (S is a multiple of 128)
constexpr int KW = 64;       // columns per TMA box: 64 bf16 = one 128-byte swizzle row
constexpr int STAGES = 8;    // row-slice ring depth
constexpr int MAX_KC = 6;    // d <= 384: query tile + ring fit shared memory
constexpr int THREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr int Q_CHUNK = BM * KW * 2;  // bytes of one query box
constexpr int R_STAGE = BN * KW * 2;  // bytes of one row box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// box (c0 = column, c1 = row) of the tensor map into dst; completes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma operand descriptor: K-major, 128-byte swizzle, 8-row groups 1024 B apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// one arrival per consumer warp frees a ring buffer for the producer
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// keep the compiler from moving accumulator reads across the async product
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// KCS = ceil(d / 64) depth chunks: a compile-time count, so that every
// product group has a fixed length and ptxas can tell which accumulator a
// wgmma.wait_group retires
template <int KCS>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap rmap,
            const float* __restrict__ pen, int qc, int nlim, int t, int L, int nb,
            int nqb, float* __restrict__ out_min, int* __restrict__ out_id) {
  constexpr int kcs = KCS;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte alignment
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base;                         // [STAGES][BN rows x 128 B]
  unsigned char* qs = base + STAGES * R_STAGE;        // [kcs][BM rows x 128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + kcs * Q_CHUNK);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int s = t / L;
  const int tiles_s = s / BN;
  const int q0 = (blockIdx.x % nqb) * BM;
  const int rest = blockIdx.x / nqb;
  const int j = rest / tiles_s;
  const int b0 = (rest % tiles_s) * BN;
  const int row0 = j * t + b0;  // global row of bucket b0 in slice 0

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, kcs * Q_CHUNK);
      for (int kc = 0; kc < kcs; ++kc) tma_load(qs + kc * Q_CHUNK, &qmap, qbar, kc * KW, q0);
      int stage = 0;
      uint32_t phase = 0;
      for (int l = 0; l < L; ++l)
        for (int kc = 0; kc < kcs; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], R_STAGE);
          tma_load(ring + stage * R_STAGE, &rmap, &full[stage], kc * KW, row0 + l * s);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;  // consumer warpgroup: queries [64 cw, 64 cw + 64)
    const int warp = (ct % 128) / 32, lane = ct % 32;
    // The warpgroup's 64 x 128 (query, bucket) tile is two 64 x 64 halves
    // with an accumulator each (acc0, acc1). Element 4i + 2r + e of half h
    // sits at query row 16 warp + lane/4 + 8r and bucket 64h + 8i +
    // 2 (lane % 4) + e; its running min is best[32h + 4i + 2r + e], and the
    // slice attaining it byte (2r + e) of arg[8h + i].
    float acc0[32], acc1[32], best[64];
    uint32_t arg[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc0[i] = 0.f;
      acc1[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) best[i] = INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i) arg[i] = 0;

    const uint32_t qa = smem_u32(qs) + cw * (64 * 128);
    const uint32_t ra = smem_u32(ring);
    mbar_wait(qbar, 0);

    // slice l's depth chunk kc is ring load g = l * kcs + kc: buffer g % STAGES,
    // filled for the (g / STAGES)-th time; half h reads its rows 64h.. of it.
    // One product group per (slice, half).
    auto issue = [&](float(&acc)[32], int l, int h) {
      pin(acc);
#pragma unroll
      for (int kc = 0; kc < kcs; ++kc) {
        const int g = l * kcs + kc;
        mbar_wait(&full[g % STAGES], (g / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 16 columns = 32 bytes per step
          wgmma_m64n64k16(acc, desc(qa + kc * Q_CHUNK + kk * 32),
                          desc(ra + (g % STAGES) * R_STAGE + h * (64 * 128) + kk * 32),
                          (kc | kk) != 0);
      }
      wgmma_commit();
    };
    // the penalties of this thread's 32 columns of slice l: pv[16h + 2i + e]
    // for bucket 64h + 8i + 2 (lane % 4) + e. Columns at or past nlim get
    // +inf, hence a +inf key.
    auto load_pen = [&](float(&pv)[32], int l) {
      const int cbase = row0 + l * s + 2 * (lane % 4);
      if (row0 + l * s + BN <= nlim) {  // warp-uniform: the whole slice is valid
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float2 p = __ldg(reinterpret_cast<const float2*>(pen + cbase + 8 * i));
          pv[2 * i] = p.x;
          pv[2 * i + 1] = p.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = cbase + 8 * (i / 2) + (i & 1);
          pv[i] = col < nlim ? __ldg(pen + col) : INFINITY;  // nlim <= n
        }
      }
    };
    // fold half h of slice l (its products are done) into the running min;
    // 2*acc is exact, so one fma(-2, acc, pen) rounds the same as pen - 2*acc
    auto fold = [&](float(&acc)[32], const float(&pv)[32], int l, int h) {
      pin(acc);
      const uint32_t lsplat = (uint32_t)l * 0x01010101u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int o = 32 * h + 4 * i + x;
          const float key = __fmaf_rn(-2.f, acc[4 * i + x], pv[16 * h + 2 * i + (x & 1)]);
          const bool lt = key < best[o];
          best[o] = lt ? key : best[o];
          // byte x of arg[o / 4] <- l: selector 0x3210 with nibble x = 4
          // (byte 0 of lsplat)
          const uint32_t sel = (0x3210u & ~(0xfu << (4 * x))) | (4u << (4 * x));
          arg[o / 4] = lt ? __byte_perm(arg[o / 4], lsplat, sel) : arg[o / 4];
        }
      }
    };
    // both halves of slice l are folded: free its ring buffers
    auto release_slice = [&](int l) {
#pragma unroll
      for (int kc = 0; kc < kcs; ++kc) release(&empty[(l * kcs + kc) % STAGES], lane);
    };

    // half 1's products run while half 0 folds. Every wait retires a group
    // issued in the same iteration: a pipeline across iterations (the next
    // slice's half 0 during this slice's half 1) makes ptxas serialize
    // every wgmma, which costs more than it overlaps.
    float pv[32], pn[32];
    load_pen(pv, 0);
    for (int l = 0; l < L; ++l) {
      issue(acc0, l, 0);
      issue(acc1, l, 1);
      // the next slice's penalties: loaded after this slice's fences (a
      // wgmma fence waits for every register load in flight) and used a
      // slice later
      if (l + 1 < L) load_pen(pn, l + 1);
      wgmma_wait<1>();
      fold(acc0, pv, l, 0);
      wgmma_wait<0>();
      fold(acc1, pv, l, 1);
      release_slice(l);
#pragma unroll
      for (int i = 0; i < 32; ++i) pv[i] = pn[i];
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gq = q0 + 64 * cw + 16 * warp + lane / 4 + 8 * h;
      if (gq >= qc) continue;
      float* om = out_min + (size_t)gq * nb + (size_t)j * s + b0;
      int* oi = out_id + (size_t)gq * nb + (size_t)j * s + b0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = 8 * i + 2 * (lane % 4);
        const int l0 = (arg[i] >> (16 * h)) & 0xff;
        const int l1 = (arg[i] >> (16 * h + 8)) & 0xff;
        *reinterpret_cast<float2*>(om + c) = make_float2(best[4 * i + 2 * h], best[4 * i + 2 * h + 1]);
        *reinterpret_cast<int2*>(oi + c) = make_int2(row0 + l0 * s + c, row0 + l1 * s + c + 1);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [rows, d] bf16, row-major, read as boxes of 64 columns x box_rows rows;
// out-of-bounds elements read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int rows, int d, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  cuuint32_t box[2] = {(cuuint32_t)KW, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool fits(const void* q, const void* rows, const void* pen, int d, int t, int L) {
  return d % 8 == 0 && d >= KW && d <= MAX_KC * KW && L <= 256 && t % L == 0 && (t / L) % BN == 0 &&
         (uintptr_t)q % 16 == 0 && (uintptr_t)rows % 16 == 0 && (uintptr_t)pen % 8 == 0;
}

template <int KCS>
cudaError_t run(const CUtensorMap& qmap, const CUtensorMap& rmap, const void* pen, int qc,
                int nlim, int t, int L, int nb, int nqb, long long blocks, void* out_min,
                void* out_id, cudaStream_t stream) {
  const size_t smem = 1024 + (size_t)STAGES * R_STAGE + (size_t)KCS * Q_CHUNK +
                      (2 * STAGES + 1) * sizeof(uint64_t);
  cudaError_t e = cudaFuncSetAttribute(scan_kernel<KCS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  scan_kernel<KCS><<<(unsigned)blocks, THREADS, smem, stream>>>(
      qmap, rmap, static_cast<const float*>(pen), qc, nlim, t, L, nb, nqb,
      static_cast<float*>(out_min), static_cast<int*>(out_id));
  return cudaGetLastError();
}


cudaError_t launch(const void* q, const void* rows, const void* pen, int qc, int n, int d,
                   int nlim, int t, int L, int nb, void* out_min, void* out_id,
                   cudaStream_t stream) {
  CUtensorMap qmap, rmap;
  if (!make_map(&qmap, q, qc, d, BM) || !make_map(&rmap, rows, n, d, BN))
    return cudaErrorInvalidValue;
  const int kcs = (d + KW - 1) / KW;
  const int nqb = (qc + BM - 1) / BM;
  const int n_tiles = (n + t - 1) / t;
  const long long blocks = (long long)nqb * n_tiles * ((t / L) / BN);
  switch (kcs) {
    case 1: return run<1>(qmap, rmap, pen, qc, nlim, t, L, nb, nqb, blocks, out_min, out_id, stream);
    case 2: return run<2>(qmap, rmap, pen, qc, nlim, t, L, nb, nqb, blocks, out_min, out_id, stream);
    case 3: return run<3>(qmap, rmap, pen, qc, nlim, t, L, nb, nqb, blocks, out_min, out_id, stream);
    case 4: return run<4>(qmap, rmap, pen, qc, nlim, t, L, nb, nqb, blocks, out_min, out_id, stream);
    case 5: return run<5>(qmap, rmap, pen, qc, nlim, t, L, nb, nqb, blocks, out_min, out_id, stream);
    case 6: return run<6>(qmap, rmap, pen, qc, nlim, t, L, nb, nqb, blocks, out_min, out_id, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wgmma_scan

}  // namespace

// row_type: 0 = bfloat16, 1 = uint8, 2 = int8. variant: 0 = "mma", 1 =
// "wgmma", as the wrapper's scan_variant chose it; a "wgmma" launch at a
// shape outside that rule returns cudaErrorInvalidValue. Returns
// cudaGetLastError().
extern "C" int fused_scan_launch(const void* q, const void* rows, int row_type,
                                 const void* pen, int qc, int n, int d,
                                 int nlim, int t, int L, int nb, int variant,
                                 void* out_min, void* out_id, void* stream) {
  if (qc == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (row_type != 0 || !wgmma_scan::fits(q, rows, pen, d, t, L)) return (int)cudaErrorInvalidValue;
    return wgmma_scan::launch(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
  }
  switch (row_type) {
    case 0: return mma_scan::launch<__nv_bfloat16>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    case 1: return mma_scan::launch<uint8_t>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    case 2: return mma_scan::launch<int8_t>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
