// Exact row-wise k smallest (key, id) pairs (kernel K3), for Hopper (sm_90a).
//
// Replaces the TPU's hardware top-k, jax.lax.approx_min_k (XLA's partial-
// reduce top-k, not a pallas_call), at flatnav_tpu/ops/fused_scan.py:385
// (fused_knn phase B), flatnav_tpu/ops/distances.py:368 (fast_knn's shortlist
// a tile) and flatnav_tpu/quantization/pq.py:496 (pq_scan_knn's shortlist a
// tile); driven by flatnav_tpu_torch/ops/select_k.py:select_k. Unlike
// approx_min_k it is exact: it computes the function of select_k_plain bit
// for bit. For each row of a float32 key matrix [B, W] it returns the k
// smallest (key + 0.0, id) pairs in ascending order, ties to the lowest id.
// The order is that of one 64-bit word a pair,
//     (monotone image of the float's bits) << 32 | id,
// where the image flips every bit of a negative float and the sign bit of a
// non-negative one. So -0.0 and +0.0 tie (the key is taken after a real
// __fadd_rn(key, 0.0f)), a positive NaN ranks after +inf and a negative one
// before -inf, and the returned key is the bits of key + 0.0. Ids are the
// word's low 32 bits: non-negative int32 rank as their value.
//
// Bound on this card: bytes. A selection reads each key once (4 B) and each
// id where ids are given as a tensor (4 B more) and writes B*k pairs:
// [4096, 62592] -> 32 with ids (phase B at 1M x 128) is 2.05 GB, 0.612 ms
// at 3.35 TB/s; a fast_knn tile [4096, 131072] -> 32 with implicit ids
// 0.641 ms; a brute_force_knn tile [4096, 65536] -> 10 0.320 ms; phase B at
// 100M [512, 390656] -> 32 0.478 ms. It does no arithmetic beyond the add
// and integer compares, so what it must not do is touch a key twice.
//
// Design: a filter in front of a radix select. A block streams one slice of
// one row from device memory, once, coalesced, in steps of four words a
// thread, the next step's loads issued before this step is filtered (eight
// a thread in flight; on an H100 at 1M phase B, four alone read 1.07 ms and
// eight in one step 1.31 ms against 0.89: the registers of one wide step
// cost more blocks than its loads gain), and
// keeps a word only if it is below the block's threshold: the
// k-th smallest word kept so far (all ones at first). Kept words are
// appended to a buffer in shared memory (a ballot and one atomic a warp).
// When the buffer is nearly full, a radix select over it (8-bit digits
// from the top, a 256-bin histogram a pass; a warp whose lanes share a
// digit adds once, otherwise __match_any_sync groups the lanes; it stops as
// soon as the chosen bin holds exactly the words still wanted) keeps its k
// smallest and sets the threshold to the largest of them. A word equal to
// the threshold is the same (key, id) pair as the kept one, so dropping it
// changes nothing. After the first fill only words below the running k-th
// pass, so for keys in no particular order almost every word costs a load
// and a compare, and the buffer is selected a few times a row; keys that
// fall along the row pass every time and make it a radix select over
// everything (the rate of the first design, which selected every slice of
// 8,192 words in shared memory: 3.28 ms at 1M phase B on an H100). Because
// the id is part of the word, rows of thousands of equal keys (8-bit
// tables, rows of +inf past n_valid) are ordered by id, and the word is
// unique unless an id repeats with an equal key (then the copies are the
// same pair). At the
// end a last select takes the k smallest, a bitonic sort in shared memory
// orders them, and they are written out. A FAISS-style per-warp register
// queue (WarpSelect) was the other design; it serves k <= 64 or so, while
// this one takes k up to KMAX = 2048 in the same code.
//
// A batch of few rows (B = 1, the latency protocol; 512 rows at 100M) is
// cut into slices so that the grid fills the card; each slice writes its
// k best words (padded with the all-ones word, which no real pair equals)
// and the wrapper launches the same kernel again over the [B, slices * k]
// words. The wrapper plans the rounds (ops/select_k.py:_plan) and
// allocates every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 2048;    // largest k
constexpr int U = 4;          // words a thread loads a step
constexpr unsigned FULL = 0xffffffffu;
typedef unsigned long long u64;

struct Args {
  const float* keys;   // [B, W] float keys (pairs == nullptr)
  const int* ids;      // [B, W] or [1, W] ids, or nullptr: id_base + column
  int id_rows;         // 1: ids is [B, W]; 0: one [1, W] row for every row
  int id_base;
  const u64* pairs;    // [B, W] words of an earlier round, or nullptr
  int W, k, kpad;      // kpad: power of two >= min(k, slice)
  int col_lo, col_hi;  // keys of columns outside [col_lo, col_hi) are +inf
  int slice, nslices;
  int cap;             // words the candidate buffer holds
  float* out_d;        // final round: [B, k] keys and ids
  int* out_i;
  u64* out_pairs;      // other rounds: [B, nslices * k] words
};

struct Shared {
  unsigned hist[256];
  unsigned digit, below, cnt, take, eq, n;
  u64 theta;
};

__device__ __forceinline__ uint32_t ord_of(float v) {
  uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_of(u64 w) {
  uint32_t u = (uint32_t)(w >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// one warp's contribution to the histogram; dig < 0 counts nothing. Every
// lane of the warp calls it.
__device__ __forceinline__ void count_digit(unsigned* hist, int dig, int lane) {
  int d0 = __shfl_sync(FULL, dig, 0);
  if (__all_sync(FULL, dig == d0)) {
    if (lane == 0 && d0 >= 0) atomicAdd(&hist[d0], 32u);
    return;
  }
  unsigned peers = __match_any_sync(FULL, dig);
  if (dig >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[dig], (unsigned)__popc(peers));
}

// The kk smallest of the cnt words of buf, into outb[0, kk) in no order,
// and their largest into sh.theta. Called by the whole block; ends with a
// barrier.
__device__ void select_words(const u64* buf, int cnt, unsigned kk, u64* outb, Shared& sh) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int rounds = (cnt + nt - 1) / nt;
  u64 prefix = 0, mask = 0;
  unsigned krem = kk;
  bool done = false;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += nt) sh.hist[i] = 0;
    __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      const int j = r * nt + tid;
      int dig = -1;
      if (j < cnt) {
        const u64 w = buf[j];
        if ((w & mask) == prefix) dig = (int)((w >> shift) & 255u);
      }
      count_digit(sh.hist, dig, lane);
    }
    __syncthreads();
    if (tid < 32) {
      unsigned v[8], s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = sh.hist[lane * 8 + i];
        s += v[i];
      }
      unsigned inc = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(FULL, inc, off);
        if (lane >= off) inc += t;
      }
      const unsigned exc = inc - s;
      if (exc < krem && krem <= inc) {  // exactly one lane
        unsigned acc = exc;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (acc + v[i] >= krem) {
            sh.digit = lane * 8 + i;
            sh.below = acc;
            sh.cnt = v[i];
            break;
          }
          acc += v[i];
        }
      }
    }
    __syncthreads();
    krem -= sh.below;
    prefix |= (u64)sh.digit << shift;
    mask |= (u64)255u << shift;
    if (sh.cnt == krem) {  // the whole bin is wanted
      done = true;
      break;
    }
  }

  // every word below the prefix, and of those equal to it the whole bin
  // (done) or krem copies of the one word (all 64 bits chosen)
  if (tid == 0) {
    sh.take = 0;
    sh.eq = 0;
    sh.theta = 0;
  }
  __syncthreads();
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int r = 0; r < rounds; ++r) {
    const int j = r * nt + tid;
    u64 w = 0;
    bool lt = false, eq = false;
    if (j < cnt) {
      w = buf[j];
      const u64 hi = w & mask;
      lt = hi < prefix || (done && hi == prefix);
      eq = !done && hi == prefix;
    }
    const unsigned meq = __ballot_sync(FULL, eq);
    unsigned eq_base = 0;
    if (meq) {
      if (lane == 0) eq_base = atomicAdd(&sh.eq, (unsigned)__popc(meq));
      eq_base = __shfl_sync(FULL, eq_base, 0);
    }
    const bool take = lt || (eq && eq_base + __popc(meq & lt_mask) < krem);
    const unsigned mt = __ballot_sync(FULL, take);
    if (mt) {
      unsigned base = 0;
      if (lane == 0) base = atomicAdd(&sh.take, (unsigned)__popc(mt));
      base = __shfl_sync(FULL, base, 0);
      if (take) {
        outb[base + __popc(mt & lt_mask)] = w;
        atomicMax(&sh.theta, w);
      }
    }
  }
  __syncthreads();
}

// one step's loads of a thread, as they come from device memory
template <bool PAIRS_IN>
struct Raw {
  float v[U];
  uint32_t id[U];
};
template <>
struct Raw<true> {
  u64 p[U];
};

template <bool PAIRS_IN>
__device__ __forceinline__ void fetch(Raw<PAIRS_IN>& r, const Args& a, size_t rbase, int c0,
                                      int n, int base) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = base + u * blockDim.x + threadIdx.x;
    if (j >= n) break;
    const int col = c0 + j;
    if constexpr (PAIRS_IN) {
      r.p[u] = __ldcs(a.pairs + rbase + col);
    } else {
      r.v[u] = __ldcs(a.keys + rbase + col);
      if (a.ids) r.id[u] = (uint32_t)__ldcs(a.ids + (a.id_rows ? rbase : 0) + col);
    }
  }
}

template <bool PAIRS_IN>
__device__ __forceinline__ u64 word_of(const Raw<PAIRS_IN>& r, int u, const Args& a, int col) {
  if constexpr (PAIRS_IN) {
    return r.p[u];
  } else {
    float v = r.v[u];
    if (col < a.col_lo || col >= a.col_hi) v = __int_as_float(0x7f800000);
    v = __fadd_rn(v, 0.0f);  // -0.0 -> +0.0, as the plain version's key + 0.0
    const uint32_t id = a.ids ? r.id[u] : (uint32_t)(a.id_base + col);
    return ((u64)ord_of(v) << 32) | id;
  }
}

// Keep the words of one step that are below the threshold; shrink the
// buffer to the k smallest when it passes its mark. Called by the whole
// block.
template <bool PAIRS_IN>
__device__ __forceinline__ void filter_step(const Raw<PAIRS_IN>& r, const Args& a, int c0,
                                            int n, int base, u64* buf, u64* outb, Shared& sh) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const u64 theta = sh.theta;
  u64 w[U];
  bool keep[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = base + u * nt + tid;
    keep[u] = false;
    if (j < n) {
      w[u] = word_of<PAIRS_IN>(r, u, a, c0 + j);
      keep[u] = w[u] < theta;
    }
  }
  unsigned m[U], tot = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    m[u] = __ballot_sync(FULL, keep[u]);
    tot += __popc(m[u]);
  }
  unsigned end = 0;
  if (tot) {
    unsigned pos = 0;
    if (lane == 0) pos = atomicAdd(&sh.n, tot);
    pos = __shfl_sync(FULL, pos, 0);
    end = pos + tot;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (keep[u]) buf[pos + __popc(m[u] & lt_mask)] = w[u];
      pos += __popc(m[u]);
    }
  }
  // the warp that appended last sees the buffer's count: a barrier that
  // tells every thread whether any warp took it past the mark
  if (__syncthreads_or(end > (unsigned)(a.cap - nt * U))) {
    select_words(buf, sh.n, a.k, outb, sh);  // k < cap - step < count
    for (int i = tid; i < a.k; i += nt) buf[i] = outb[i];
    if (tid == 0) sh.n = a.k;
    __syncthreads();
  }
}

template <bool PAIRS_IN, bool PAIRS_OUT>
__global__ void __launch_bounds__(256) select_kernel(const Args a) {
  extern __shared__ u64 smem[];
  __shared__ Shared sh;

  const int row = blockIdx.x, sl = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c0 = sl * a.slice;
  const int n = min(a.slice, a.W - c0);
  const int step = nt * U;
  u64* buf = smem;             // [cap] kept words
  u64* outb = smem + a.cap;    // [kpad] the k smallest
  const size_t rbase = (size_t)row * a.W;

  if (tid == 0) {
    sh.n = 0;
    sh.theta = ~0ull;
  }
  __syncthreads();
  // two steps of loads in flight: the next step's are issued before this
  // step's words are filtered (and before its barrier)
  Raw<PAIRS_IN> ra, rb;
  fetch<PAIRS_IN>(ra, a, rbase, c0, n, 0);
  for (int base = 0; base < n; base += 2 * step) {
    if (base + step < n) fetch<PAIRS_IN>(rb, a, rbase, c0, n, base + step);
    filter_step<PAIRS_IN>(ra, a, c0, n, base, buf, outb, sh);
    if (base + step >= n) break;
    if (base + 2 * step < n) fetch<PAIRS_IN>(ra, a, rbase, c0, n, base + 2 * step);
    filter_step<PAIRS_IN>(rb, a, c0, n, base + step, buf, outb, sh);
  }

  const int cnt = sh.n;
  const int kk = min(a.k, cnt);  // == min(k, n): nothing is dropped before k are kept
  select_words(buf, cnt, kk, outb, sh);

  // bitonic sort of the kpad words (the tail padded with all-ones)
  const int P = a.kpad;
  for (int i = kk + tid; i < P; i += nt) outb[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += nt) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const u64 x = outb[lo], y = outb[hi];
        if ((x > y) == asc) {
          outb[lo] = y;
          outb[hi] = x;
        }
      }
      __syncthreads();
    }
  }

  if (PAIRS_OUT) {
    u64* o = a.out_pairs + ((size_t)row * a.nslices + sl) * a.k;
    for (int i = tid; i < a.k; i += nt) o[i] = i < kk ? outb[i] : ~0ull;
  } else {
    const size_t o = (size_t)row * a.k;
    for (int i = tid; i < kk; i += nt) {
      const u64 w = outb[i];
      a.out_d[o + i] = key_of(w);
      a.out_i[o + i] = (int)(uint32_t)w;
    }
  }
}

template <bool PAIRS_IN, bool PAIRS_OUT>
int launch(Args& a, int B, cudaStream_t s) {
  auto kern = select_kernel<PAIRS_IN, PAIRS_OUT>;
  static bool attr_set = false;
  if (!attr_set) {
    // the largest buffer: 256 threads, k = KMAX
    const int most = (2 * 256 * U + 2 * KMAX) * (int)sizeof(u64);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int threads = a.slice >= 1024 ? 256 : 64;
  // room for the kept k and two steps of the block's loads
  a.cap = 2 * threads * U + a.kpad;
  const size_t smem = (size_t)(a.cap + a.kpad) * sizeof(u64);
  kern<<<dim3(B, a.nslices), threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One round of the selection. keys (float, [B, W]) or pairs (the words of
// an earlier round, [B, W]) is given, the other null. ids: [B, W] int32
// (id_rows = 1), one [1, W] row (id_rows = 0), or null for id_base +
// column. The row is cut into ceil(W / slice) slices; with out_pairs null
// there must be one, and the k pairs a row go to out_d / out_i, else each
// slice's k words go to out_pairs [B, nslices * k]. Returns a cudaError_t.
extern "C" int select_k_launch(const void* keys, const void* ids, int id_rows, int id_base,
                               const void* pairs, int B, int W, int k, int col_lo,
                               int col_hi, int slice, void* out_d, void* out_i,
                               void* out_pairs, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || W < 1 || k < 1 || k > KMAX || slice < 1 || slice > W ||
      (keys == nullptr) == (pairs == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.keys = static_cast<const float*>(keys);
  a.ids = static_cast<const int*>(ids);
  a.id_rows = id_rows;
  a.id_base = id_base;
  a.pairs = static_cast<const u64*>(pairs);
  a.W = W;
  a.k = k;
  a.kpad = 1;
  while (a.kpad < (k < slice ? k : slice)) a.kpad <<= 1;
  a.col_lo = col_lo;
  a.col_hi = col_hi;
  a.slice = slice;
  a.nslices = (W + slice - 1) / slice;
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.out_pairs = static_cast<u64*>(out_pairs);
  if (a.nslices > 65535 || (out_pairs == nullptr && (a.nslices != 1 || k > W)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs) {
    return out_pairs ? launch<true, true>(a, B, s) : launch<true, false>(a, B, s);
  }
  return out_pairs ? launch<false, true>(a, B, s) : launch<false, false>(a, B, s);
}
