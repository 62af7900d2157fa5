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
// Eight variants. The wrapper's scan_variant (ops/fused_scan.py) picks one
// by shape and type alone; the entry refuses a launch outside the rule of
// the variant it names.
//
// "wgmma" (bf16 rows and queries, d % 8 == 0, 8 <= d <= 384, L <= 256,
// S % 128 == 0): one block per (row tile j, BN = 128 buckets, BM = 128
// queries), 384 threads.
// Warpgroup 0 is the producer: one thread loads the block's query tile once
// by TMA, then streams the slices' rows as [128 rows x 128 bytes] chunks
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
// ceil(d/64) ring buffers until it is folded, and the query tile as many
// more: with 8 buffers of 16 KB, d <= 6 * 64 fits 227 KB of shared memory.
// Blocks are numbered query block first, so the query blocks of one row
// tile run together and its rows are read from device memory about once.
// A bf16 table whose d is not a multiple of 8 (angular's d = 100) is padded
// with zero columns by fused_knn, in the bf16 copy it makes anyway. Below
// d = 64 (GloVe-25 and -50: copies of 32 and 56 columns) a box still spans
// 64 columns: TMA reads the columns past d as zeros, which add exactly 0.
//
// "wgmma_narrow" (bf16, d % 8 == 0, d <= 32): the same kernel on 64-byte
// box rows (32 columns, two k16 steps) under the 64-byte swizzle, so a
// 32-column table does half the products of "wgmma"'s 64-column boxes.
//
// "wgmma_int8" (uint8 or int8 rows AND queries of the same type, d % 16 ==
// 0, d <= 256): the same kernel with wgmma m64n64k32 .s32.{u8,s8} and s32
// sums. A 128-byte swizzle row holds 128 one-byte columns, so boxes, ring,
// descriptors and the fold are those of "wgmma"; the table stays 1 byte an
// element on the card (100M x 128 resident), with no copy. |sum| <= 256 *
// 255^2 < 2^24, so float(sum) is exact and the keys fma(-2, float(sum), pen)
// are bit-equal to the plain version's. Bound: operations at the int8 rate
// (1,979 TOP/s), twice the bf16 one, so the fold weighs twice as much.
//
// "wgmma_int8_packed" (8-bit rows and queries of one type, d % 4 == 0, d %
// 16 != 0, d <= 256; MS SPACEV's int8 d = 100): "wgmma_int8"'s consumers on
// rows TMA cannot stride (a 100-byte row). The table is scanned as it is,
// with no padded copy (at 100M x 100 one would take 12.8 GB beside the
// 10 GB table). A block's 128 rows of slice l are rows row0 + l*S .. +127,
// one contiguous run of 128 d bytes that starts on a multiple of 512 bytes.
// The producer warpgroup copies it, and the block's queries, by 4-byte
// cp.async straight to their swizzled places (a bulk copy into staging,
// repacked by three warps, ran 2.6 times slower: PERF.md); each producer
// thread arrives on the buffer's barrier once its copies land, and each
// consumer thread fences the async proxy once a slice before its products.
// The ring and the query tile are zeroed once at the start and the copies
// write only columns below d, so the pad columns stay zero. Rows at or
// past n are not copied: their keys are +inf whatever the buffer holds.
//
// "wgmma_wide" (bf16, d % 8 == 0, 384 < d <= 1024; gist's d = 960). A
// 128-query tile of d = 960 is 240 KB, more than a block's 227 KB, so a
// block holds 64 queries: [64 x d <= 1024] bf16 is at most 16 boxes of 8 KB
// = 128 KB, and two 3-stage rings of 16 KB row boxes (96 KB) take the rest
// (230,504 of 232,448 bytes at d = 1024, with the 13 barriers and the 1 KB
// alignment pad). Each block re-reads its rows from L2 once per query
// block, so at 64 queries a block the L2 reads double (gist 1M, 4096
// queries: 4096/64 x 1.92 GB = 123 GB a launch against 61 GB at 128). To
// keep them at the 128-query level, CS = 2 blocks form a cluster on
// neighbouring SMs and take consecutive query blocks of the same rows:
// each block loads 1/CS of every row box by TMA multicast into the ring of
// every block of the cluster, and a ring buffer is refilled only when the
// consumer warps of all CS blocks have freed it (each arrives on the empty
// barrier of every block, by mapa). The two consumer warpgroups take
// alternate slices, each slice one m64n128k16 product over the block's 64
// queries and 128 buckets (6 KB of shared-memory operands a step, where two
// m64n64 halves read 8 KB), so one's products run while the other folds;
// at the end warpgroup 1 hands its minima to warpgroup 0 through the
// drained ring (lower key, then lower slice, wins). The depth loop runs over ceil(d/64)
// chunks at run time (one instantiation, not one per depth): each chunk is
// its own product group, retired one chunk later, when its buffer is
// freed, so a slice need not fit the ring. Bound: operations (gist 1M x
// 960, 4096 queries: 7.86 TFLOP, 7.95 ms at 989 TFLOP/s).
//
// "wgmma_deep" (bf16, d % 8 == 0, d > 1024: OpenAI's 1536 and 3072). A
// query tile of 64 x 1536 bf16 is 192 KB: beside any ring it no longer
// fits a block's shared memory, and a smaller one would multiply the row
// reads. So neither operand stays: a block takes 128 queries x 128
// buckets, and one ring of 6 stages carries both, each stage one 64-column
// depth chunk of the query tile (16 KB) and of the slice's row box (16 KB),
// for any d. The two consumer warpgroups read every stage, 64 queries
// each, one m64n128k16 product a 16-column step, and fold each slice into
// their own running minima (at d >= 1032 a slice's products outweigh its
// fold 20 to 1, so no warpgroup alternation hides it). The query tile is
// re-read from L2 once a slice; CS = 2 blocks of a cluster (consecutive
// query blocks of the same rows) load half of each row box each by TMA
// multicast, so L2 serves 1.5 row-box bytes where a cluster of stationary
// 64-query blocks serves 1 for the same work and a lone block 2. Bound:
// operations (1M x 1536, 4096 queries: 12.6 TFLOP, 12.7 ms at 989
// TFLOP/s).
//
// "wgmma_mixed" (uint8 or int8 rows against bf16 queries, d % 4 == 0, d <=
// 256: the TPU kernel's own form for 8-bit tables, which widens the rows to
// bf16 in VMEM; float queries of a BigANN- or SPACEV-class table). The
// narrow operand goes through registers: the rows are wgmma's A, 64 rows
// (buckets) a consumer warpgroup, read from the 8-bit ring (by TMA, or by
// "wgmma_int8_packed"'s copies where d % 16 != 0) and widened to bf16 pairs
// in registers (exact for 8-bit values); the bf16 queries are B, 128 a
// block, stationary in shared memory. A slice of 128 rows x 128 columns
// moves 96 KB through shared memory (16 KB written by the copies, 16 KB of
// A fragments read, 64 KB of B read by the two warpgroups), where "wgmma"
// on bf16 rows moves 128 KB and a second, bf16, ring would move 160 KB.
// The accumulator is [buckets x queries]: the fold is elementwise as in
// "wgmma", with one penalty a row, and each warp store of the minima covers
// whole 32-byte sectors. Integer-valued queries give keys bit-equal to the
// plain version's (every partial sum an integer below 2^24); other bf16
// queries sum in another order. Bound: operations at the bf16 rate (u8 10M
// x 128, 4096 queries: 10.5 TFLOP, 10.6 ms at 989 TFLOP/s).
//
// "mma" (the first port; every shape no other variant takes: 8-bit rows
// with d % 4 != 0 or d > 256, L > 256, pointers off 16 bytes, bf16 rows of
// a width TMA cannot stride): one block
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

// ------------------------------------------------------ TMA and wgmma

namespace tma {

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

// arrive on the barrier at the same offset in block `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
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
__device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                     int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the same box into dst and onto bar at the same offsets in every block of
// `mask` in the cluster
__device__ __forceinline__ void load_multicast(void* dst, const CUtensorMap* map, uint64_t* bar,
                                               int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}

// wgmma operand descriptor of a K-major tile of RB-byte rows under the
// swizzle of that width (RB = 128: layout 1, RB = 64: layout 2), 8-row
// groups 8 * RB bytes apart
template <int RB = 128>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  static_assert(RB == 128 || RB == 64, "128- or 64-byte swizzle");
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * RB / 16) << 32) | ((uint64_t)(RB == 128 ? 1 : 2) << 62);
}

// one 4-byte cp.async (generic proxy) from global src into shared dst
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// arrive on bar once every cp.async this thread has issued has landed; the
// arrival counts against the barrier's expected count (.noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// shared memory written through the generic proxy (stores, cp.async) is
// read by wgmma through the async proxy: a thread that has seen the writes
// (by a barrier) orders them before its own later wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads across the async product
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(int32_t (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D32(c)                                                                         \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),       \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),       \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define WGMMA_REGS                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// The operand types of a scan. Each 128-byte swizzle row of a TMA box is
// one K-step group of four wgmma: 64 bf16 columns (k16 each) or 128 8-bit
// columns (k32 each), so boxes, descriptors and the fold are the same for
// both; only the instruction, the column count and the accumulator differ.
// Bf16Narrow takes 64-byte rows (32 bf16 columns, two k16 steps) under the
// 64-byte swizzle. RB is the bytes of a box row.
struct Bf16 {
  using acc_t = float;
  static constexpr int KW = 64;  // columns per 128-byte row
  static constexpr int RB = 128;
  static constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T; scale_d = 0 overwrites d
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
#define F_(x) "+f"(x)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_REGS
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : WGMMA_D32(F_)
        : "l"(da), "l"(db), "r"(scale_d));
#undef F_
  }
  __device__ __forceinline__ static float value(float a) { return a; }
};

struct Bf16Narrow : Bf16 {
  static constexpr int KW = 32;
  static constexpr int RB = 64;
  static constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_64B;
};

// 8-bit rows and queries of one type; s32 sums. While d <= 256 every sum
// is an integer below 2^24 in magnitude, so value() is exact.
template <bool SIGNED>
struct Int8 {
  using acc_t = int32_t;
  static constexpr int KW = 128;
  static constexpr int RB = 128;
  static constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // bytes
  // d[64 x 64] (+)= A[64 x 32] B[64 x 32]^T
  __device__ __forceinline__ static void mma(int32_t (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
#define R_(x) "+r"(x)
    if constexpr (SIGNED)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WGMMA_REGS "%32, %33, p;\n}\n"
          : WGMMA_D32(R_)
          : "l"(da), "l"(db), "r"(scale_d));
    else
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 " WGMMA_REGS "%32, %33, p;\n}\n"
          : WGMMA_D32(R_)
          : "l"(da), "l"(db), "r"(scale_d));
#undef R_
  }
  __device__ __forceinline__ static float value(int32_t a) { return __int2float_rn(a); }
};

// The penalties of one thread's columns of a 128-bucket slice: pv[2i + e]
// for bucket col0 + 8i + 2 (lane % 4) + e, i < 16 (half h of the slice is
// pv[16h ..]). Columns at or past nlim get +inf, hence a +inf key.
__device__ __forceinline__ void load_pen(float (&pv)[32], const float* __restrict__ pen,
                                         int col0, int nlim, int lane) {
  const int cbase = col0 + 2 * (lane % 4);
  if (col0 + 128 <= nlim) {  // warp-uniform: the whole slice is valid
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
}

// Fold H 64 x 64 (query, bucket) halves of slice l's accumulator into
// the running min: element 4i + 2r + e sits at query row 16 warp + lane/4 +
// 8r and bucket 8i + 2 (lane % 4) + e; its running min is best[4i + 2r +
// e], and the slice attaining it byte (2r + e) of arg[i]. 2*acc is exact,
// so one fma(-2, acc, pen) rounds the same as pen - 2*acc.
template <typename Op, int H>
__device__ __forceinline__ void fold_halves(const typename Op::acc_t* acc, const float* pv,
                                            float* best, uint32_t* arg, int l) {
  const uint32_t lsplat = (uint32_t)l * 0x01010101u;
#pragma unroll
  for (int i = 0; i < 8 * H; ++i) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float key = __fmaf_rn(-2.f, Op::value(acc[4 * i + x]), pv[2 * i + (x & 1)]);
      const bool lt = key < best[4 * i + x];
      best[4 * i + x] = lt ? key : best[4 * i + x];
      // byte x of arg[i] <- l: selector 0x3210 with nibble x = 4 (byte 0 of lsplat)
      const uint32_t sel = (0x3210u & ~(0xfu << (4 * x))) | (4u << (4 * x));
      arg[i] = lt ? __byte_perm(arg[i], lsplat, sel) : arg[i];
    }
  }
}

template <typename Op>
__device__ __forceinline__ void fold(typename Op::acc_t (&acc)[32], const float* pv, float* best,
                                     uint32_t* arg, int l) {
  pin(acc);
  fold_halves<Op, 1>(acc, pv, best, arg, l);
}

// Write one thread's share of a 64 x 128 (query, bucket) tile: queries
// q_row + {0, 8}, buckets b0 + 8i + 2 (lane % 4) + {0, 1}, as minima and
// global ids (row_b0 = the global row of bucket b0 in slice 0); best and
// arg in fold's order, i < 16.
__device__ __forceinline__ void store_tile(const float* best, const uint32_t* arg, int q_row,
                                           int qc, int nb, int j, int s, int b0, int row_b0,
                                           int lane, float* __restrict__ out_min,
                                           int* __restrict__ out_id) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gq = q_row + 8 * h;
    if (gq >= qc) continue;
    float* om = out_min + (size_t)gq * nb + (size_t)j * s + b0;
    int* oi = out_id + (size_t)gq * nb + (size_t)j * s + b0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = 8 * i + 2 * (lane % 4);
      const int l0 = (arg[i] >> (16 * h)) & 0xff;
      const int l1 = (arg[i] >> (16 * h + 8)) & 0xff;
      *reinterpret_cast<float2*>(om + c) = make_float2(best[4 * i + 2 * h], best[4 * i + 2 * h + 1]);
      *reinterpret_cast<int2*>(oi + c) = make_int2(row_b0 + l0 * s + c, row_b0 + l1 * s + c + 1);
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

// [rows, d] row-major of `Op`'s element type, read as boxes of Op::RB bytes
// of columns x box_rows rows under Op's swizzle; out-of-bounds elements
// (columns past d included) read as zeros
template <typename Op>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int d, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const int esize = Op::RB / Op::KW;
  cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)d * esize};
  cuuint32_t box[2] = {(cuuint32_t)Op::KW, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return enc(map, Op::TMA, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, Op::SW, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma

// ------------------------------------------------- wgmma and wgmma_int8

namespace wgmma_scan {

using namespace tma;

constexpr int BM = 128;      // queries per block: two consumer warpgroups x 64
constexpr int BN = 128;      // buckets per block (S is a multiple of 128)
constexpr int STAGES = 8;    // row-slice ring depth
constexpr int MAX_KC = 6;    // d <= 384 bf16 columns: query tile + ring fit shared memory
constexpr int THREADS = 384; // producer warpgroup + two consumer warpgroups

// producer arrivals that fill a ring buffer or the query tile: TMA's one
// thread, or every thread of the producer warpgroup ("wgmma_int8_packed")
template <bool PACKED>
constexpr uint32_t FILLERS = PACKED ? 128 : 1;

// one arrival per consumer warp frees a ring buffer for the producer
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// byte offset of 4-byte word w (< 32) of row r in a [rows x 128 B] tile
// under the 128-byte swizzle: 16-byte chunk c of row r sits at c ^ (r % 8)
__device__ __forceinline__ int swz(int r, int w) {
  return r * 128 + (((w >> 2) ^ (r & 7)) << 4) + (w & 3) * 4;
}

// "wgmma_int8_packed": the block's BM queries of d bytes (d % 4 == 0) into
// the swizzled query tile by 4-byte cp.async (the tile was zeroed, so the
// words past d and past qc stay zero); all 128 producer threads, each
// arriving on qbar once its copies have landed
template <int KCS>
__device__ __forceinline__ void pack_queries(unsigned char* qs, const uint8_t* __restrict__ q,
                                             int q0, int qc, int d, int tid, uint64_t* qbar) {
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BM && q0 + r < qc; r += 4)
#pragma unroll
    for (int kc = 0; kc < KCS; ++kc)
      if (128 * kc + 4 * lane < d)
        cp_async4(smem_u32(qs + kc * BM * 128 + swz(r, lane)),
                  q + (size_t)(q0 + r) * d + 128 * kc + 4 * lane);
  cp_async_arrive(qbar);
}

// "wgmma_int8_packed": ring load g (slice l = g / KCS, depth chunk kc = g
// % KCS) is words [32 kc, 32 kc + 32) of each of the slice's rows, copied
// by 4-byte cp.async straight to their swizzled places: warp w copies rows
// w, w + 4, ..., one row a warp instruction (lane = word), which reads 4d
// contiguous bytes. Each producer thread arrives on the buffer's full
// barrier once its copies have landed (FILLERS arrivals); the consumers
// fence before their products. Rows at or past n are not copied (their
// keys are +inf whatever the buffer holds); columns at or past d keep the
// zeros written at kernel start.
template <int KCS>
__device__ __forceinline__ void pack_rows(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                          const uint8_t* __restrict__ rows, int n, int d,
                                          int row0, int s, int L, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int loads = L * KCS;
  for (int g = 0; g < loads; ++g) {
    const int kc = g % KCS;
    const long long r0 = (long long)row0 + (long long)(g / KCS) * s;
    const int nv = (int)max(0LL, min((long long)BN, n - r0));
    mbar_wait(&empty[g % STAGES], ((g / STAGES) & 1) ^ 1);
    if (4 * (32 * kc + lane) < d) {
      const uint8_t* src = rows + (size_t)r0 * d + 128 * kc + 4 * lane;
      const uint32_t dst = smem_u32(ring + (g % STAGES) * (BN * 128));
      for (int r = warp; r < nv; r += 4) cp_async4(dst + swz(r, lane), src + (size_t)r * d);
    }
    cp_async_arrive(&full[g % STAGES]);
  }
}

// KCS = ceil(d / Op::KW) depth chunks: a compile-time count, so that every
// product group has a fixed length and ptxas can tell which accumulator a
// wgmma.wait_group retires. PACKED ("wgmma_int8_packed"): the producer
// warpgroup fills the query tile and the ring from q8 / rows8 (8-bit rows
// of d % 4 == 0 bytes, which TMA cannot stride) instead of TMA from the
// maps; everything else is the same kernel.
template <int KCS, typename Op, bool PACKED>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap rmap,
            const uint8_t* __restrict__ q8, const uint8_t* __restrict__ rows8, int n, int d,
            const float* __restrict__ pen, int qc, int nlim, int t, int L, int nb,
            int nqb, float* __restrict__ out_min, int* __restrict__ out_id) {
  using acc_t = typename Op::acc_t;
  constexpr int kcs = KCS;
  constexpr int RB = Op::RB;          // bytes of a box row
  constexpr int Q_CHUNK = BM * RB;    // bytes of one query box
  constexpr int R_STAGE = BN * RB;    // bytes of one row box
  // a ring buffer holds the same depth chunk at every fill (STAGES % KCS ==
  // 0), so PACKED's pad columns, zeroed once, stay zero
  static_assert(!PACKED || STAGES % KCS == 0, "a buffer keeps its depth chunk");
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles want 1024-byte alignment
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base;                         // [STAGES][BN rows x RB]
  unsigned char* qs = base + STAGES * R_STAGE;        // [kcs][BM rows x RB]
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
      mbar_init(&full[i], FILLERS<PACKED>);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    mbar_init(qbar, FILLERS<PACKED>);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (PACKED)  // the copies write only columns below d (and queries below qc)
    for (int i = threadIdx.x; i < (STAGES * R_STAGE + kcs * Q_CHUNK) / 16; i += THREADS)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if constexpr (PACKED) {
      pack_queries<KCS>(qs, q8, q0, qc, d, threadIdx.x, qbar);
      pack_rows<KCS>(ring, full, empty, rows8, n, d, row0, s, L, threadIdx.x);
    } else if (threadIdx.x == 0) {  // one thread issues every load
      mbar_expect_tx(qbar, kcs * Q_CHUNK);
      for (int kc = 0; kc < kcs; ++kc) load(qs + kc * Q_CHUNK, &qmap, qbar, kc * Op::KW, q0);
      int stage = 0;
      uint32_t phase = 0;
      for (int l = 0; l < L; ++l)
        for (int kc = 0; kc < kcs; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], R_STAGE);
          load(ring + stage * R_STAGE, &rmap, &full[stage], kc * Op::KW, row0 + l * s);
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
    // with an accumulator each (acc0, acc1) and a running min each: half h
    // keeps best[32h ..] and arg[8h ..] (see fold).
    acc_t acc0[32], acc1[32];
    float best[64];
    uint32_t arg[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc0[i] = 0;
      acc1[i] = 0;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) best[i] = INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i) arg[i] = 0;

    const uint32_t qa = smem_u32(qs) + cw * (64 * RB);
    const uint32_t ra = smem_u32(ring);
    mbar_wait(qbar, 0);
    if (PACKED) fence_async_smem();  // the zeros and the producers' cp.async

    // slice l's depth chunk kc is ring load g = l * kcs + kc: buffer g % STAGES,
    // filled for the (g / STAGES)-th time; half h reads its rows 64h.. of it.
    // One product group per (slice, half).
    auto issue = [&](acc_t(&acc)[32], int l, int h) {
      pin(acc);
#pragma unroll
      for (int kc = 0; kc < kcs; ++kc) {
        const int g = l * kcs + kc;
        mbar_wait(&full[g % STAGES], (g / STAGES) & 1);
        if (PACKED && h == 0) fence_async_smem();  // half 1 reads what half 0 fenced
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < RB / 32; ++kk)  // 32 bytes of columns per step
          Op::mma(acc, desc<RB>(qa + kc * Q_CHUNK + kk * 32),
                  desc<RB>(ra + (g % STAGES) * R_STAGE + h * (64 * RB) + kk * 32),
                  (kc | kk) != 0);
      }
      wgmma_commit();
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
    load_pen(pv, pen, row0, nlim, lane);
    for (int l = 0; l < L; ++l) {
      issue(acc0, l, 0);
      issue(acc1, l, 1);
      // the next slice's penalties: loaded after this slice's fences (a
      // wgmma fence waits for every register load in flight) and used a
      // slice later
      if (l + 1 < L) load_pen(pn, pen, row0 + (l + 1) * s, nlim, lane);
      wgmma_wait<1>();
      fold<Op>(acc0, pv, best, arg, l);
      wgmma_wait<0>();
      fold<Op>(acc1, pv + 16, best + 32, arg + 8, l);
      release_slice(l);
#pragma unroll
      for (int i = 0; i < 32; ++i) pv[i] = pn[i];
    }

    store_tile(best, arg, q0 + 64 * cw + 16 * warp + lane / 4, qc, nb, j, s, b0, row0, lane,
               out_min, out_id);
  }
}

// The width rule of each variant (TMA strides rows by a multiple of 16
// bytes; 8-bit sums stay exact while d <= 256). bf16 ("wgmma"): d % 8 ==
// 0, 8 <= d <= 384, the box's columns past d read as zeros. Bf16Narrow
// ("wgmma_narrow"): d % 8 == 0, d <= 32. 8-bit ("wgmma_int8"): d % 16 ==
// 0, d <= 256. PACKED 8-bit ("wgmma_int8_packed"): d % 4 == 0, d % 16 !=
// 0, d <= 256 (a slice's run of 128 rows starts on a multiple of 512
// bytes). Every one: L <= 256, whole 128-bucket tiles, aligned pointers.
template <typename Op, bool PACKED = false>
bool fits(const void* q, const void* rows, const void* pen, int d, int t, int L) {
  bool width;
  if constexpr (PACKED)
    width = d % 4 == 0 && d % 16 != 0 && d <= 256;
  else if constexpr (Op::KW == 128)
    width = d % 16 == 0 && d <= 256;
  else if constexpr (Op::KW == 64)
    width = d % 8 == 0 && d >= 8 && d <= MAX_KC * 64;
  else
    width = d % 8 == 0 && d <= Op::KW;
  return width && L <= 256 && t % L == 0 && (t / L) % BN == 0 && (uintptr_t)q % 16 == 0 &&
         (uintptr_t)rows % 16 == 0 && (uintptr_t)pen % 8 == 0;
}

template <int KCS, typename Op, bool PACKED>
cudaError_t run(const CUtensorMap& qmap, const CUtensorMap& rmap, const void* q, const void* rows,
                int n, int d, const void* pen, int qc, int nlim, int t, int L, int nb, int nqb,
                long long blocks, void* out_min, void* out_id, cudaStream_t stream) {
  const size_t smem = 1024 + (size_t)STAGES * BN * Op::RB + (size_t)KCS * BM * Op::RB +
                      (2 * STAGES + 1) * sizeof(uint64_t);
  auto kern = scan_kernel<KCS, Op, PACKED>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      qmap, rmap, static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(rows), n, d,
      static_cast<const float*>(pen), qc, nlim, t, L, nb, nqb, static_cast<float*>(out_min),
      static_cast<int*>(out_id));
  return cudaGetLastError();
}

template <typename Op, bool PACKED = false>
cudaError_t launch(const void* q, const void* rows, const void* pen, int qc, int n, int d,
                   int nlim, int t, int L, int nb, void* out_min, void* out_id,
                   cudaStream_t stream) {
  CUtensorMap qmap{}, rmap{};
  if (!PACKED &&
      (!make_map<Op>(&qmap, q, qc, d, BM) || !make_map<Op>(&rmap, rows, n, d, BN)))
    return cudaErrorInvalidValue;
  const int kcs = (d + Op::KW - 1) / Op::KW;
  const int nqb = (qc + BM - 1) / BM;
  const int n_tiles = (n + t - 1) / t;
  const long long blocks = (long long)nqb * n_tiles * ((t / L) / BN);
#define RUN_(K)                                                                                  \
  return run<K, Op, PACKED>(qmap, rmap, q, rows, n, d, pen, qc, nlim, t, L, nb, nqb, blocks, \
                            out_min, out_id, stream)
  if constexpr (Op::KW != 64) {  // 8-bit d <= 256: one or two chunks; narrow bf16: one
    switch (kcs) {
      case 1: RUN_(1);
      case 2: RUN_(2);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (kcs) {
      case 1: RUN_(1);
      case 2: RUN_(2);
      case 3: RUN_(3);
      case 4: RUN_(4);
      case 5: RUN_(5);
      case 6: RUN_(6);
      default: return cudaErrorInvalidValue;
    }
  }
#undef RUN_
}

}  // namespace wgmma_scan

// --------------------------------------------------------- wgmma_mixed

namespace mixed_scan {

using namespace tma;
using wgmma_scan::BN;       // buckets per block: two consumer warpgroups x 64 rows
using wgmma_scan::STAGES;   // ring of [128 rows x 128 8-bit columns] buffers
using wgmma_scan::THREADS;  // producer warpgroup + two consumer warpgroups

constexpr int BM = 128;             // queries per block: the N of one m64n128k16 product
constexpr int Q_CHUNK = BM * 128;   // bytes of 64 bf16 columns of the query tile
constexpr int R_STAGE = BN * 128;   // bytes of a ring buffer

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T; A from registers (warp w of
// the warpgroup holds rows 16w .., in mma.m16n8k16's A-fragment layout), B
// K-major in 128-byte-swizzled shared memory; scale_d = 0 overwrites d
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// One word of four 8-bit columns -> two bf16 pairs (bytes 0, 1 and 2, 3)
// of the columns' values times 2^-7 (SCALE), exactly: bf16 bits 0x00XX are
// XX * 2^-133 for every byte XX (subnormal below 0x80, the first binade from
// it on), so one packed fma by 2^126 gives XX * 2^-7; an int8 byte, its top
// bit flipped, is x + 128, and the fma subtracts 1 = 128 * 2^-7. Every
// product and partial sum of the wgmma is then the unscaled one times 2^-7,
// rounded alike, and the fold multiplies by 2^7 back (fma(-2 / SCALE, acc,
// pen)).
constexpr float SCALE = 1.f / 128;

template <bool SIGNED>
__device__ __forceinline__ uint32_t scale_pair(uint32_t x) {
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(y)
      : "r"(x), "r"(0x7E807E80u), "r"(SIGNED ? 0xBF80BF80u : 0x80008000u));  // 2^126; -1 or -0
  return y;
}

template <bool SIGNED>
__device__ __forceinline__ void widen(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if (SIGNED) w ^= 0x80808080u;
  lo = scale_pair<SIGNED>(__byte_perm(w, 0, 0x4140));
  hi = scale_pair<SIGNED>(__byte_perm(w, 0, 0x4342));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The depth order of the products. A thread of a consumer warp (lane 4g +
// t) supplies, for each k16 step, row columns 2t, 2t+1 and 2t+8, 2t+9 of
// its two rows. Reading them as they lie would take 2-byte loads, so the
// k-steps run over the columns in another order: within each 64-column
// group, physical column 16t + 4s + 2h + e (byte e of half h of word s of
// the thread's 16-byte chunk t) is logical column 16s + 8h + 2t + e of
// k-step s, and one 16-byte load a row and group serves four k-steps. A
// dot product does not depend on the order of its terms, so the query tile
// holds the queries' columns in the same logical order: physical bf16 pair
// m = 8t + 2s + h of a group sits at logical pair 8s + 4h + t.
__device__ __forceinline__ int logical_pair(int m) {
  return ((m & 6) << 2) | ((m & 1) << 2) | (m >> 3);
}

// The block's BM bf16 queries into the query tile (zeroed: the pairs past
// d and the queries past qc stay zero) by 4-byte cp.async, each pair at its
// logical place under the 128-byte swizzle; all 128 producer threads, each
// arriving on qbar once its copies have landed. Warp w copies queries w, w
// + 4, ..., a row's 64-column group a warp instruction (lane = pair).
template <int KH>
__device__ __forceinline__ void pack_queries(unsigned char* qs, const __nv_bfloat16* __restrict__ q,
                                             int q0, int qc, int d, int tid, uint64_t* qbar) {
  const int warp = tid / 32, lane = tid % 32;
  const int w = logical_pair(lane);
  for (int r = warp; r < BM && q0 + r < qc; r += 4)
#pragma unroll
    for (int kq = 0; kq < KH; ++kq)
      if (64 * kq + 2 * lane < d)  // d % 4 == 0: a pair is all in or all out
        cp_async4(smem_u32(qs + kq * Q_CHUNK + wgmma_scan::swz(r, w)),
                  q + (size_t)(q0 + r) * d + 64 * kq + 2 * lane);
  cp_async_arrive(qbar);
}

// Rows TMA cannot stride (d % 16 != 0), as "wgmma_int8_packed"'s pack_rows
// copies them (the same ring loads, barriers and swizzled places), with the
// addresses stepped instead of recomputed: warp w copies rows w + 8m at
// byte c0 of their 128 and rows w + 4 + 8m at c1 (row % 8 = w, w + 4), so
// a 4-byte copy costs a few instructions of the producer warps, which issue
// on the consumers' schedulers.
template <int KCS>
__device__ __forceinline__ void copy_rows(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                          const uint8_t* __restrict__ rows, int n, int d,
                                          int row0, int s, int L, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t c0 = warp * 128 + ((((lane >> 2) ^ warp) << 4) | ((lane & 3) << 2));
  const uint32_t c1 = (c0 ^ 64) + 512;
  const size_t step = 8 * (size_t)d;
  for (int g = 0; g < L * KCS; ++g) {
    const int kc = g % KCS;
    const long long r0 = (long long)row0 + (long long)(g / KCS) * s;
    const int nv = (int)max(0LL, min((long long)BN, n - r0));
    mbar_wait(&empty[g % STAGES], ((g / STAGES) & 1) ^ 1);
    if (4 * (32 * kc + lane) < d) {
      const uint8_t* src = rows + (size_t)(r0 + warp) * d + 128 * kc + 4 * lane;
      uint32_t dst = smem_u32(ring + (g % STAGES) * R_STAGE);
      int r = warp;
      for (; r + 4 < nv; r += 8, src += step, dst += 1024) {
        cp_async4(dst + c0, src);
        cp_async4(dst + c1, src + 4 * d);
      }
      if (r < nv) cp_async4(dst + c0, src);
    }
    cp_async_arrive(&full[g % STAGES]);
  }
}

// Fold slice l's 64 x 128 (bucket, query) accumulator into the running
// min: element 4i + 2r + e sits at row (bucket) 16 warp + lane/4 + 8r of
// the warpgroup's 64 and query 8i + 2 (lane % 4) + e; its penalty is
// pv[r], its running min best[4i + 2r + e] and the slice attaining it byte
// 2r + e of arg[i]. acc holds the dots times SCALE; 2*dot = (2 / SCALE)*acc
// is exact, so one fma(-2 / SCALE, acc, pen) rounds as pen - 2*dot does.
__device__ __forceinline__ void fold(float (&acc)[64], const float (&pv)[2], float (&best)[64],
                                     uint32_t (&arg)[16], int l) {
  pin(acc);
  const uint32_t lsplat = (uint32_t)l * 0x01010101u;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float key = __fmaf_rn(-2.f / SCALE, acc[4 * i + x], pv[x >> 1]);
      const bool lt = key < best[4 * i + x];
      best[4 * i + x] = lt ? key : best[4 * i + x];
      const uint32_t sel = (0x3210u & ~(0xfu << (4 * x))) | (4u << (4 * x));
      arg[i] = lt ? __byte_perm(arg[i], lsplat, sel) : arg[i];
    }
  }
}

// One block per (row tile j, 128 buckets, 128 queries). The producer
// warpgroup copies the queries once into a stationary tile (pack_queries)
// and streams each slice's 128 rows of 8-bit columns through the ring: by
// TMA (d % 16 == 0; one thread) or, for rows TMA cannot stride, by 4-byte
// copies (copy_rows; all 128 threads). Consumer warpgroup cw takes rows
// (buckets) 64 cw .. 64 cw + 63 of every slice: it reads its rows' bytes
// from the ring (two 16-byte loads a row and 128-column chunk), widens
// them to bf16 in registers, issues one m64n128k16 product a k16 step with
// them as A against the 128-query tile as B, frees the ring buffer once the
// products are done, and folds. The two warpgroups' products and folds
// overlap as they fall (turns taken by named barriers, and a fold of one
// 64-query half under the other half's products, both read slower:
// PERF.md). KH = ceil(d / 64) groups of 64 columns, two to a ring load.
template <int KH, bool SIGNED>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const __grid_constant__ CUtensorMap rmap, const __nv_bfloat16* __restrict__ q,
            const uint8_t* __restrict__ rows8, int packed, int n, int d,
            const float* __restrict__ pen, int qc, int nlim, int t, int L, int nb, int nqb,
            float* __restrict__ out_min, int* __restrict__ out_id) {
  constexpr int KCS = (KH + 1) / 2;  // ring loads a slice
  // a ring buffer holds the same depth chunk at every fill, so copied rows'
  // pad columns, zeroed once, stay zero
  static_assert(STAGES % KCS == 0, "a buffer keeps its depth chunk");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base;                    // [STAGES][BN rows x 128 B]
  unsigned char* qs = base + STAGES * R_STAGE;   // [KH][BM rows x 128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + KH * Q_CHUNK);
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
      mbar_init(&full[i], packed ? 128 : 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    mbar_init(qbar, 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  {  // the copies write only columns below d: zero the query tile, and the ring for packed rows
    uint4* z = reinterpret_cast<uint4*>(packed ? ring : qs);
    const int words = ((packed ? STAGES * R_STAGE : 0) + KH * Q_CHUNK) / 16;
    for (int i = threadIdx.x; i < words; i += THREADS) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    pack_queries<KH>(qs, q, q0, qc, d, threadIdx.x, qbar);
    if (packed) {
      copy_rows<KCS>(ring, full, empty, rows8, n, d, row0, s, L, threadIdx.x);
    } else if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int l = 0; l < L; ++l)
        for (int kc = 0; kc < KCS; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], R_STAGE);
          load(ring + stage * R_STAGE, &rmap, &full[stage], kc * 128, row0 + l * s);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int g = lane / 4, tq = lane % 4;
    const int rloc = 64 * cw + 16 * warp + g;  // the thread's rows: rloc and rloc + 8
    float acc[64], best[64];
    uint32_t arg[16];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      best[i] = INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) arg[i] = 0;

    // the B descriptor of k-step s of query box kq is qd + (kq Q_CHUNK + 32 s) / 16
    const uint64_t qd = desc<128>(smem_u32(qs));
    // the thread's chunk t of group h of row rloc (row rloc + 8 is 1024 bytes on)
    const unsigned char* rbase = ring + rloc * 128;
    const int off0 = (tq ^ g) << 4, off1 = ((4 + tq) ^ g) << 4;
    mbar_wait(qbar, 0);
    fence_async_smem();  // the zeros and the producers' cp.async, read by wgmma

    auto load_pen = [&](float (&pv)[2], int l) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = row0 + l * s + rloc + 8 * r;
        pv[r] = col < nlim ? __ldg(pen + col) : INFINITY;  // nlim <= n
      }
    };
    float pv[2], pn[2];
    load_pen(pv, 0);
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int c = 0; c < KCS; ++c) {
        const int hc = 2 * c + 1 < KH ? 2 : 1;  // 64-column groups in this load
        const int gl = l * KCS + c;
        const int stage = gl % STAGES;
        mbar_wait(&full[stage], (gl / STAGES) & 1);
        uint4 x[2][2];  // [row r][group h]
        const unsigned char* rb = rbase + stage * R_STAGE;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          x[r][0] = *reinterpret_cast<const uint4*>(rb + r * 1024 + off0);
          if (hc == 2) x[r][1] = *reinterpret_cast<const uint4*>(rb + r * 1024 + off1);
        }
        uint32_t a[8][4];
#pragma unroll
        for (int h = 0; h < hc; ++h)
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            widen<SIGNED>(word(x[0][h], w), a[4 * h + w][0], a[4 * h + w][2]);  // row rloc
            widen<SIGNED>(word(x[1][h], w), a[4 * h + w][1], a[4 * h + w][3]);  // row rloc + 8
          }
        if (c == 0) pin(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4 * hc; ++ks)
          mma(acc, a[ks], qd + (((2 * c + ks / 4) * Q_CHUNK + (ks % 4) * 32) >> 4), (c | ks) != 0);
        wgmma_commit();
        // A buffer is freed once the products that consumed its widened
        // words are done. Freed right after its loads, the arrival issues
        // before their data return (ptxas waits on no load for it), and
        // the TMA route gave wrong keys at 10M rows: the release orders
        // these generic-proxy reads, apparently not against the next
        // fill's TMA (async-proxy) writes.
        if (c + 1 < KCS) {
          wgmma_wait<0>();  // a[] is refilled for the next load
          wgmma_scan::release(&empty[stage], lane);
        }
      }
      // the next slice's penalties: after this slice's fence, used a slice later
      if (l + 1 < L) load_pen(pn, l + 1);
      wgmma_wait<0>();
      wgmma_scan::release(&empty[(l * KCS + KCS - 1) % STAGES], lane);
      fold(acc, pv, best, arg, l);
      pv[0] = pn[0];
      pv[1] = pn[1];
    }

    // Each warp store writes 8 consecutive buckets (32 bytes, a whole
    // sector) of 4 queries: the [queries, buckets] output needs no staging.
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int gq = q0 + 8 * i + 2 * tq + (x & 1);
        if (gq >= qc) continue;
        const int bl = rloc + 8 * (x >> 1);  // the bucket's row in the block's slice
        const size_t o = (size_t)gq * nb + (size_t)j * s + b0 + bl;
        out_min[o] = best[4 * i + x];
        out_id[o] = row0 + (int)((arg[i] >> (8 * x)) & 0xff) * s + bl;
      }
  }
}

// uint8 or int8 rows against bf16 queries: d % 4 == 0, d <= 256 (|sum| of
// integer products stays below 2^24 for integer queries of magnitude <=
// 255), L <= 256, whole 128-bucket tiles, aligned pointers
bool fits(const void* q, const void* rows, const void* pen, int d, int t, int L) {
  return d > 0 && d % 4 == 0 && d <= 256 && L <= 256 && t % L == 0 && (t / L) % BN == 0 &&
         (uintptr_t)q % 16 == 0 && (uintptr_t)rows % 16 == 0 && (uintptr_t)pen % 8 == 0;
}

template <int KH, bool SIGNED>
cudaError_t run(const CUtensorMap& rmap, const void* q, const void* rows, int packed, int n, int d,
                const void* pen, int qc, int nlim, int t, int L, int nb, int nqb, long long blocks,
                void* out_min, void* out_id, cudaStream_t stream) {
  const size_t smem = 1024 + (size_t)STAGES * R_STAGE + (size_t)KH * Q_CHUNK +
                      (2 * STAGES + 1) * sizeof(uint64_t);
  auto kern = scan_kernel<KH, SIGNED>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return cudaGetLastError();  // clears it for the next launch
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      rmap, static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(rows), packed, n,
      d, static_cast<const float*>(pen), qc, nlim, t, L, nb, nqb, static_cast<float*>(out_min),
      static_cast<int*>(out_id));
  return cudaGetLastError();
}

template <bool SIGNED>
cudaError_t launch(const void* q, const void* rows, const void* pen, int qc, int n, int d,
                   int nlim, int t, int L, int nb, void* out_min, void* out_id,
                   cudaStream_t stream) {
  const int packed = d % 16 != 0;  // rows TMA cannot stride
  CUtensorMap rmap{};
  if (!packed && !make_map<Int8<SIGNED>>(&rmap, rows, n, d, BN)) return cudaErrorInvalidValue;
  const int nqb = (qc + BM - 1) / BM;
  const int n_tiles = (n + t - 1) / t;
  const long long blocks = (long long)nqb * n_tiles * ((t / L) / BN);
#define RUN_(K)                                                                               \
  return run<K, SIGNED>(rmap, q, rows, packed, n, d, pen, qc, nlim, t, L, nb, nqb, blocks, \
                        out_min, out_id, stream)
  switch ((d + 63) / 64) {
    case 1: RUN_(1);
    case 2: RUN_(2);
    case 3: RUN_(3);
    case 4: RUN_(4);
    default: return cudaErrorInvalidValue;
  }
#undef RUN_
}

}  // namespace mixed_scan

// ---------------------------------------------------------- wgmma_wide

namespace wide_scan {

using namespace tma;

// blocks of a cluster: they share every row box. 2 read faster than 1 or 4
// (copies of this source with CS changed, timed by bench/kernel_ab.py; PERF.md)
constexpr int CS = 2;
constexpr int BM = 64;            // queries per block
constexpr int BN = 128;           // buckets per block
constexpr int STAGES = 3;         // depth of each consumer warpgroup's row ring
constexpr int MAX_KC = 16;        // d <= 1024
constexpr int THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr int Q_CHUNK = BM * 128;      // bytes of one query box: 64 rows x 64 bf16
constexpr int R_STAGE = BN * 128;      // bytes of one row box: 128 rows x 64 bf16
constexpr int R_PART = R_STAGE / CS;   // the rows of it that each block loads

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// a consumer warp frees a ring buffer in every block of the cluster (the
// producers of all of them write into it): lane c arrives on block c's
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane < CS) mbar_arrive_cluster(bar, lane);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// One block per (row tile j, 128 buckets, 64 queries); the CS blocks of a
// cluster take consecutive query blocks of the same rows. Consumer
// warpgroup w takes the slices l = w (mod 2), each as one 64 x 128 product
// (m64n128k16: 6 KB of shared-memory operands a 64 x 128 x 16 step, where
// two m64n64 halves would read 8 KB), so one warpgroup's products run
// while the other folds. Each warpgroup has a ring of its own, filled by a
// producer thread of its own (threads 0 and 32), so each ring is read in
// the order it is filled: a parity wait on a shared ring could not tell a
// load two fills ahead from the one it waits for. The depth loop runs over
// kcs = ceil(d / 64) chunks at run time: each chunk is its own product
// group, retired one chunk later, when its ring buffer is freed. At the end
// warpgroup 1 hands its running minima to warpgroup 0 through the drained
// rings, and the lower key wins, the lower slice on a tie.
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(THREADS, 1)
scan_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap rmap,
            const float* __restrict__ pen, int qc, int nlim, int t, int L, int nb, int nqb,
            int kcs, float* __restrict__ out_min, int* __restrict__ out_id) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* rings = base;                    // [2][STAGES][BN rows x 128 B]
  unsigned char* qs = base + 2 * STAGES * R_STAGE;  // [kcs][BM rows x 128 B]
  uint64_t* fulls = reinterpret_cast<uint64_t*>(qs + kcs * Q_CHUNK);  // [2][STAGES]
  uint64_t* empties = fulls + 2 * STAGES;                              // [2][STAGES]
  uint64_t* qbar = empties + 2 * STAGES;

  const int s = t / L;
  const int tiles_s = s / BN;
  const int q0 = (blockIdx.x % nqb) * BM;
  const int rest = blockIdx.x / nqb;
  const int j = rest / tiles_s;
  const int b0 = (rest % tiles_s) * BN;
  const int row0 = j * t + b0;
  const uint32_t rank = cluster_rank();

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * STAGES; ++i) {
      mbar_init(&fulls[i], 1);
      mbar_init(&empties[i], 4 * CS);  // the owning warpgroup's warps in every block
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // no block arrives on or loads into another before its init

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, kcs * Q_CHUNK);
      for (int kc = 0; kc < kcs; ++kc) load(qs + kc * Q_CHUNK, &qmap, qbar, kc * 64, q0);
    }
    if (threadIdx.x % 32 == 0 && threadIdx.x < 64) {  // thread 32 w fills ring w
      const int w = threadIdx.x / 32;
      unsigned char* ring = rings + w * STAGES * R_STAGE;
      uint64_t* full = fulls + w * STAGES;
      uint64_t* empty = empties + w * STAGES;
      int stage = 0;
      uint32_t phase = 0;
      for (int l = w; l < L; l += 2)
        for (int kc = 0; kc < kcs; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], R_STAGE);  // CS parts, one from each block
          load_multicast(ring + stage * R_STAGE + rank * R_PART, &rmap, &full[stage], kc * 64,
                         row0 + l * s + rank * (BN / CS), (uint16_t)((1u << CS) - 1));
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;  // consumer warpgroup: slices l = cw (mod 2)
    const int wt = ct % 128;
    const int warp = wt / 32, lane = ct % 32;
    float acc[64], best[64], pv[32];
    uint32_t arg[16];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      best[i] = INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) arg[i] = 0;

    const uint32_t qa = smem_u32(qs);
    const uint32_t ra = smem_u32(rings + cw * STAGES * R_STAGE);
    uint64_t* full = fulls + cw * STAGES;
    uint64_t* empty = empties + cw * STAGES;
    mbar_wait(qbar, 0);
    int g = 0;  // loads of this warpgroup's ring consumed so far
    for (int l = cw; l < L; l += 2) {
      load_pen(pv, pen, row0 + l * s, nlim, lane);
      pin(acc);
      for (int kc = 0; kc < kcs; ++kc, ++g) {
        const int stage = g % STAGES;
        mbar_wait(&full[stage], (g / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16(acc, desc(qa + kc * Q_CHUNK + kk * 32),
                           desc(ra + stage * R_STAGE + kk * 32), (kc | kk) != 0);
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();  // chunk kc - 1's products are done
          release(&empty[(g - 1) % STAGES], lane);
        }
      }
      wgmma_wait<0>();
      release(&empty[(g - 1) % STAGES], lane);
      pin(acc);
      fold_halves<Bf16, 2>(acc, pv, best, arg, l);
    }

    // every load into this block's rings has landed and been read: reuse them
    float* mb = reinterpret_cast<float*>(rings);                  // [64][128]
    uint32_t* ma = reinterpret_cast<uint32_t*>(rings + 64 * 128 * 4);  // [16][128]
    consumers_sync();
    if (cw == 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) mb[i * 128 + wt] = best[i];
#pragma unroll
      for (int i = 0; i < 16; ++i) ma[i * 128 + wt] = arg[i];
    }
    consumers_sync();
    if (cw == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t other = ma[i * 128 + wt];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float b1 = mb[(4 * i + x) * 128 + wt];
          const uint32_t l1 = (other >> (8 * x)) & 0xff, l0 = (arg[i] >> (8 * x)) & 0xff;
          const bool take = b1 < best[4 * i + x] || (b1 == best[4 * i + x] && l1 < l0);
          best[4 * i + x] = take ? b1 : best[4 * i + x];
          const uint32_t sel = (0x3210u & ~(0xfu << (4 * x))) | ((4u + x) << (4 * x));
          arg[i] = take ? __byte_perm(arg[i], other, sel) : arg[i];
        }
      }
      store_tile(best, arg, q0 + 16 * warp + lane / 4, qc, nb, j, s, b0, row0, lane, out_min,
                 out_id);
    }
  }
  cluster_sync();  // no block leaves while another may still arrive on its barriers
}

bool fits(const void* q, const void* rows, const void* pen, int d, int t, int L) {
  return d % 8 == 0 && d > wgmma_scan::MAX_KC * 64 && d <= MAX_KC * 64 && L <= 256 &&
         t % L == 0 && (t / L) % BN == 0 && (uintptr_t)q % 16 == 0 &&
         (uintptr_t)rows % 16 == 0 && (uintptr_t)pen % 8 == 0;
}

cudaError_t launch(const void* q, const void* rows, const void* pen, int qc, int n, int d,
                   int nlim, int t, int L, int nb, void* out_min, void* out_id,
                   cudaStream_t stream) {
  CUtensorMap qmap, rmap;
  if (!make_map<Bf16>(&qmap, q, qc, d, BM) || !make_map<Bf16>(&rmap, rows, n, d, BN / CS))
    return cudaErrorInvalidValue;
  const int kcs = (d + 63) / 64;
  const int nqb = ((qc + BM - 1) / BM + CS - 1) / CS * CS;  // whole clusters
  const int n_tiles = (n + t - 1) / t;
  const long long blocks = (long long)nqb * n_tiles * ((t / L) / BN);
  const size_t smem = 1024 + (size_t)2 * STAGES * R_STAGE + (size_t)kcs * Q_CHUNK +
                      (4 * STAGES + 1) * sizeof(uint64_t);
  cudaError_t e =
      cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  scan_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      qmap, rmap, static_cast<const float*>(pen), qc, nlim, t, L, nb, nqb, kcs,
      static_cast<float*>(out_min), static_cast<int*>(out_id));
  return cudaGetLastError();
}

}  // namespace wide_scan

// ---------------------------------------------------------- wgmma_deep

namespace deep_scan {

using namespace tma;

// blocks of a cluster: consecutive query blocks of the same rows, each
// loading 1/CS of every row box by TMA multicast. At d = 1536, 2 read
// faster than 1, and than 2 x 2 blocks that also shared each query box
// (PERF.md)
constexpr int CS = 2;
constexpr int BM = 128;            // queries per block: two consumer warpgroups x 64
constexpr int BN = 128;            // buckets per block
constexpr int STAGES = 6;          // ring depth: a stage is one query box and one row box
constexpr int THREADS = 384;       // producer warpgroup + two consumer warpgroups
constexpr int Q_STAGE = BM * 128;  // bytes of a query box: 128 queries x 64 bf16
constexpr int R_STAGE = BN * 128;  // bytes of a row box: 128 rows x 64 bf16
constexpr int STAGE = Q_STAGE + R_STAGE;

// a consumer warp frees a ring buffer in every block of the cluster
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane < CS) mbar_arrive_cluster(bar, lane);
}

// One block per (128 queries, 128 buckets of a row tile); the CS blocks of a
// cluster take consecutive query blocks of the same rows.
// Both operands stream through one ring, depth chunk by depth chunk: no
// operand is held whole, so d has no upper limit. Both consumer warpgroups
// read every stage (warpgroup w the query rows 64w ..), each running one
// m64n128k16 product a 16-column step into its own 64 x 128 accumulator,
// and fold it into its own running minima after each slice; each chunk is
// its own product group, retired one chunk later, when its stage is freed.
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(THREADS, 1)
scan_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap rmap,
            const float* __restrict__ pen, int qc, int nlim, int t, int L, int nb, int nqb,
            int kcs, float* __restrict__ out_min, int* __restrict__ out_id) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int s = t / L;
  const int tiles_s = s / BN;
  const int q0 = (blockIdx.x % nqb) * BM;
  const int rest = blockIdx.x / nqb;
  const int j = rest / tiles_s;
  const int b0 = (rest % tiles_s) * BN;
  const int row0 = j * t + b0;  // global row of bucket b0 in slice 0
  const uint32_t rank = cluster_rank();

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8 * CS);  // every consumer warp of every block of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // no block arrives on or loads into another before its init

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int l = 0; l < L; ++l)
        for (int kc = 0; kc < kcs; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE);  // the query box, CS parts of the row box
          unsigned char* dst = ring + stage * STAGE;
          load(dst, &qmap, &full[stage], kc * 64, q0);
          load_multicast(dst + Q_STAGE + rank * (R_STAGE / CS), &rmap, &full[stage], kc * 64,
                         row0 + l * s + rank * (BN / CS), (uint16_t)((1u << CS) - 1));
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
    float acc[64], best[64], pv[32];
    uint32_t arg[16];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      best[i] = INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) arg[i] = 0;

    const uint32_t ra = smem_u32(ring);
    int g = 0;  // ring loads consumed so far
    for (int l = 0; l < L; ++l) {
      load_pen(pv, pen, row0 + l * s, nlim, lane);
      pin(acc);
      for (int kc = 0; kc < kcs; ++kc, ++g) {
        const int stage = g % STAGES;
        mbar_wait(&full[stage], (g / STAGES) & 1);
        wgmma_fence();
        const uint32_t sa = ra + stage * STAGE;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wide_scan::wgmma_m64n128k16(acc, desc(sa + cw * (64 * 128) + kk * 32),
                                      desc(sa + Q_STAGE + kk * 32), (kc | kk) != 0);
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();  // chunk kc - 1's products are done
          release(&empty[(g - 1) % STAGES], lane);
        }
      }
      wgmma_wait<0>();
      release(&empty[(g - 1) % STAGES], lane);
      pin(acc);
      fold_halves<Bf16, 2>(acc, pv, best, arg, l);
    }
    store_tile(best, arg, q0 + 64 * cw + 16 * warp + lane / 4, qc, nb, j, s, b0, row0, lane,
               out_min, out_id);
  }
  cluster_sync();  // no block leaves while another may still arrive on its barriers
}

bool fits(const void* q, const void* rows, const void* pen, int d, int t, int L) {
  return d % 8 == 0 && d > wide_scan::MAX_KC * 64 && L <= 256 && t % L == 0 &&
         (t / L) % BN == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)rows % 16 == 0 &&
         (uintptr_t)pen % 8 == 0;
}

cudaError_t launch(const void* q, const void* rows, const void* pen, int qc, int n, int d,
                   int nlim, int t, int L, int nb, void* out_min, void* out_id,
                   cudaStream_t stream) {
  CUtensorMap qmap, rmap;
  if (!make_map<Bf16>(&qmap, q, qc, d, BM) || !make_map<Bf16>(&rmap, rows, n, d, BN / CS))
    return cudaErrorInvalidValue;
  const int kcs = (d + 63) / 64;
  const int nqb = ((qc + BM - 1) / BM + CS - 1) / CS * CS;  // whole clusters
  const int n_tiles = (n + t - 1) / t;
  const long long blocks = (long long)nqb * n_tiles * ((t / L) / BN);
  const size_t smem = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
  cudaError_t e =
      cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return cudaGetLastError();  // clears it for the next launch
  scan_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      qmap, rmap, static_cast<const float*>(pen), qc, nlim, t, L, nb, nqb, kcs,
      static_cast<float*>(out_min), static_cast<int*>(out_id));
  return cudaGetLastError();
}

}  // namespace deep_scan

}  // namespace

// q_type / row_type: 0 = bfloat16, 1 = uint8, 2 = int8. variant: 0 = "mma",
// 1 = "wgmma", 2 = "wgmma_wide", 3 = "wgmma_int8", 4 = "wgmma_int8_packed",
// 5 = "wgmma_narrow", 6 = "wgmma_deep", 7 = "wgmma_mixed", as the wrapper's scan_variant chose it; a launch at a
// shape or type outside that variant's rule returns cudaErrorInvalidValue.
// Returns cudaGetLastError().
extern "C" int fused_scan_launch(const void* q, int q_type, const void* rows, int row_type,
                                 const void* pen, int qc, int n, int d, int nlim, int t, int L,
                                 int nb, int variant, void* out_min, void* out_id, void* stream) {
  using wgmma_scan::fits;
  using wgmma_scan::launch;
  constexpr int bad = (int)cudaErrorInvalidValue;
  if (q_type < 0 || q_type > 2 || row_type < 0 || row_type > 2) return bad;
  if (qc == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = q_type == 0 && row_type == 0;
  const bool int8 = q_type == row_type && row_type != 0;
  using U8 = tma::Int8<false>;
  using S8 = tma::Int8<true>;
  switch (variant) {
    case 0:  // bf16 queries; bf16 or 8-bit rows
      if (q_type != 0) return bad;
      switch (row_type) {
        case 0: return mma_scan::launch<__nv_bfloat16>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
        case 1: return mma_scan::launch<uint8_t>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
        default: return mma_scan::launch<int8_t>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
      }
    case 1:
      if (!bf16 || !fits<tma::Bf16>(q, rows, pen, d, t, L)) return bad;
      return launch<tma::Bf16>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    case 2:
      if (!bf16 || !wide_scan::fits(q, rows, pen, d, t, L)) return bad;
      return wide_scan::launch(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    case 3:
      if (!int8 || !fits<U8>(q, rows, pen, d, t, L)) return bad;
      if (row_type == 1) return launch<U8>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
      return launch<S8>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    case 4:
      if (!int8 || !fits<U8, true>(q, rows, pen, d, t, L)) return bad;
      if (row_type == 1) return launch<U8, true>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
      return launch<S8, true>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    case 5:
      if (!bf16 || !fits<tma::Bf16Narrow>(q, rows, pen, d, t, L)) return bad;
      return launch<tma::Bf16Narrow>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    case 6:
      if (!bf16 || !deep_scan::fits(q, rows, pen, d, t, L)) return bad;
      return deep_scan::launch(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    case 7:  // bf16 queries; uint8 or int8 rows
      if (q_type != 0 || row_type == 0 || !mixed_scan::fits(q, rows, pen, d, t, L)) return bad;
      if (row_type == 1) return mixed_scan::launch<false>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
      return mixed_scan::launch<true>(q, rows, pen, qc, n, d, nlim, t, L, nb, out_min, out_id, s);
    default:
      return bad;
  }
}
