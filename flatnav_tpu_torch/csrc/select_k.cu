// Exact row-wise k smallest (key, id) pairs (kernel K3), for Hopper (sm_90a).
//
// Replaces the TPU's hardware top-k, jax.lax.approx_min_k (XLA's partial-
// reduce top-k, not a pallas_call), at flatnav_tpu/ops/fused_scan.py:385
// (fused_knn phase B), flatnav_tpu/ops/distances.py:368 (fast_knn's shortlist
// a tile) and flatnav_tpu/quantization/pq.py:496 (pq_scan_knn's shortlist a
// tile); driven by flatnav_tpu_torch/ops/select_k.py:select_k. Unlike
// approx_min_k it is exact: it computes the function of select_k_plain bit
// for bit. For each row of a float32 key matrix [B, W] it returns the k
// smallest (key + 0.0, id) pairs in ascending order, ties to the lowest id,
// of the row and, where a prior shortlist [B, k] is given, of the row and
// that shortlist together (a scan's running k: one launch a tile, no merge).
// The order is that of one 64-bit word a pair,
//     (monotone image of the float's bits) << 32 | id,
// where the image flips every bit of a negative float and the sign bit of a
// non-negative one. So -0.0 and +0.0 tie (the key is taken after a real
// __fadd_rn(key, 0.0f)), a positive NaN ranks after +inf and a negative one
// before -inf, and the returned key is the bits of key + 0.0. Ids are the
// word's low 32 bits: non-negative int32 rank as their value.
//
// Bound on this card: bytes. A selection reads each key once (4 B) and
// writes B*k pairs; ids of a tensor are read only for the words that pass
// the filter below on the block route (a few hundred a row), and beside the
// keys on the warp route. Per key the card has about one instruction a lane
// to spend at 3.35 TB/s, so the work a word has to stay near one compare.
//
// Design (measured on an H100; the numbers and the variants tried are in
// PERF.md, section 6): a threshold filter in front of a selection, on two routes.
//  - The filter. A word can be among the k smallest only if it is below the
//    running k-th (theta). Its key alone decides almost always: with tf the
//    float whose image is theta's high half, a key with key > tf fails (a
//    NaN never compares greater, so NaNs and the keys that tie tf go on to
//    the exact test). Only the keys that pass are made into words (the add,
//    the column window, the id) and compared with theta. A word equal to
//    theta is the same pair as one already kept, so dropping it changes
//    nothing.
//  - Block route (long rows, or k > 64): a block owns one slice of one row.
//    One thread issues 1-D bulk copies (cp.async.bulk ... complete_tx) of the
//    slice's keys into a ring of stages of 8 KB in shared memory (4 stages
//    for kpad <= 64, 2 above, where the buffer is larger), each stage on its
//    own mbarrier (phase parity = stage / ring); the threads read a stage
//    with 16-byte loads. Depth costs no registers. The values before the
//    row's first 16-byte boundary and after its last (at most three keys
//    each) are read with plain loads. Kept words go to a buffer in shared
//    memory that holds a whole stage's survivors (a ballot and one atomic a
//    warp), so a block meets once a stage, at the barrier that also frees
//    the stage for the next copy. Ids of a tensor are not waited for: a word
//    is kept on its key (image <= theta's) and its id copied in by cp.async;
//    the buffer's readers wait for the copies first. When the buffer passes
//    its mark, a radix select (8-bit digits from the top, 256 bins, stopping
//    as soon as the chosen bin holds exactly the words still wanted) keeps
//    its k smallest and lowers theta. For k <= 64 the mark is 5 kpad, so
//    theta falls early, and it doubles after a shrink that left theta's key
//    where it was (integer keys, kept on their key, tie it by thousands);
//    above, the mark is the room a stage needs. For k <= 64 the first stage
//    also sets a first theta: the k-th smallest of the minima of the
//    threads' 8 keys (at least k words lie at or below it). At the end a
//    last select takes the k smallest, and one warp sorts them in registers
//    (kpad <= 64) or the block sorts them in shared memory (bitonic).
//  - Warp route (k <= 64, slices of at most 8,192 columns: the build's
//    block, the routed scan, the second round of a small batch): a warp owns
//    one row and keeps its best 32 or 64 words sorted in registers, one or
//    two a lane. Each lane loads 16 bytes of keys a step (and 16 of ids
//    beside them where the ids are aligned alike), the next step's before
//    this one is filtered; survivors gather in the warp's own part of shared
//    memory, and every 32 or 64 of them are sorted by a bitonic network of
//    shuffles and merged into the list (the list against the reversed
//    batch, the smaller of each pair, then a bitonic clean-up). No block
//    barrier at all.
//  - Prior: slice 0 starts with the row's k prior words (the block route's
//    buffer, the warp route's list) and every slice starts with theta at
//    their largest, so after a scan's first tile only words below the
//    running k-th are ever kept.
// Because the id is part of the word, rows of thousands of equal keys (8-bit
// tables, rows of +inf past n_valid) are ordered by id, and a word is unique
// unless an id repeats with an equal key (then the copies are the same pair).
//
// A batch of few rows (B = 1, the latency protocol; 512 rows at 100M) is cut
// into slices so that the grid fills the card; each slice writes its k best
// words (padded with the all-ones word, which no real pair equals) and the
// wrapper launches again over the [B, slices * k] words. The wrapper plans
// the rounds and picks the route (ops/select_k.py:_plan, _route) and
// allocates every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 2048;         // largest k
constexpr int NT = 256;            // threads a block, both routes
constexpr int STAGE_BYTES = 8192;  // one stage of the ring: 2 vectors of 16 B a thread
constexpr int DEPTH = 4;           // stages of the ring for kpad <= 64 ...
constexpr int DEPTH_BIG_K = 2;     // ... and above
constexpr int SHRINK_X = 4;        // kpad <= 64: a shrink at (1 + SHRINK_X) * kpad words
constexpr unsigned FULL = 0xffffffffu;
typedef unsigned long long u64;

struct Args {
  const float* keys;      // [B, W] float keys (pairs == nullptr)
  const int* ids;         // [B, W] or [1, W] ids, or nullptr: id_base + column
  int id_rows;            // 1: ids is [B, W]; 0: one [1, W] row for every row
  int id_base;
  const u64* pairs;       // [B, W] words of an earlier round, or nullptr
  const float* prior_d;   // [B, k] prior keys and ids, or nullptr
  const int* prior_i;
  int B, W, k, kpad;      // kpad: power of two >= the most words a block sorts
  int col_lo, col_hi;     // keys of columns outside [col_lo, col_hi) are +inf
  int slice, nslices;
  int cap;                // words the block route's buffer holds
  int mark;               // ... and the count past which it is shrunk to k
  float* out_d;           // final round: [B, k] keys and ids
  int* out_i;
  u64* out_pairs;         // other rounds: [B, nslices * k] words
};

struct Shared {
  unsigned hist[256];
  unsigned digit, below, cnt, take, eq, n;
  int mark;  // the block route's buffer is shrunk to k past this count
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

__device__ __forceinline__ u64 umin(u64 x, u64 y) { return x < y ? x : y; }
__device__ __forceinline__ u64 umax(u64 x, u64 y) { return x < y ? y : x; }

// ---------------------------------------------------------- words

// the high half of a float key's word: its image after the column window
// and + 0.0 (-0.0 -> +0.0, as the plain version's key + 0.0)
__device__ __forceinline__ uint32_t key_hi(const Args& a, float v, int col) {
  if (col < a.col_lo || col >= a.col_hi) v = __int_as_float(0x7f800000);
  return ord_of(__fadd_rn(v, 0.0f));
}

// the word of a value at column col of the row at rbase: a float key with
// its id (read here where the ids are a tensor), or an earlier round's word
__device__ __forceinline__ u64 word_of(const Args& a, float v, int col, size_t rbase) {
  const uint32_t id = a.ids ? (uint32_t)__ldg(a.ids + (a.id_rows ? rbase : 0) + col)
                            : (uint32_t)(a.id_base + col);
  return ((u64)key_hi(a, v, col) << 32) | id;
}
__device__ __forceinline__ u64 word_of(const Args&, u64 v, int, size_t) { return v; }

// the prior's i-th word of row `row`
__device__ __forceinline__ u64 prior_word(const Args& a, int row, int i) {
  const size_t o = (size_t)row * a.k + i;
  return ((u64)ord_of(__fadd_rn(a.prior_d[o], 0.0f)) << 32) | (uint32_t)a.prior_i[o];
}

// What the kernels read: float keys (words made on the way) or the words of
// an earlier round, as 16-byte vectors. coarse() is true for every value
// whose word may be below theta (and for a few more).
template <bool PAIRS>
struct Src {
  typedef float T;
  typedef float4 Vec;
  static constexpr int V = 4;  // values a vector
  __device__ static bool coarse(float v, float tf, u64) { return !(v > tf); }
  __device__ static const float* row(const Args& a, size_t rbase) { return a.keys + rbase; }
  __device__ static Vec lds(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static Vec ldg(const float* p) { return __ldcs(reinterpret_cast<const float4*>(p)); }
  __device__ static float at(const Vec& x, int j) {
    return j == 0 ? x.x : (j == 1 ? x.y : (j == 2 ? x.z : x.w));
  }
};
template <>
struct Src<true> {
  typedef u64 T;
  typedef ulonglong2 Vec;
  static constexpr int V = 2;
  __device__ static bool coarse(u64 v, float, u64 theta) { return v < theta; }
  __device__ static const u64* row(const Args& a, size_t rbase) { return a.pairs + rbase; }
  __device__ static Vec lds(const u64* p) { return *reinterpret_cast<const ulonglong2*>(p); }
  __device__ static Vec ldg(const u64* p) { return __ldcs(reinterpret_cast<const ulonglong2*>(p)); }
  __device__ static u64 at(const Vec& x, int j) { return j == 0 ? x.x : x.y; }
};

// the values before the row's first 16-byte boundary
template <typename T>
__device__ __forceinline__ int head_of(const T* p, int n) {
  return min(n, (int)(((16u - (uint32_t)(reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) /
                      sizeof(T)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A kept word into buf[p]. With idp, the low half (the id) is copied from
// device memory asynchronously (cp.async), so no thread waits on it; every
// reader of the buffer waits for the copies first (wait_ids + a barrier).
__device__ __forceinline__ void put(u64* buf, unsigned p, u64 w, const int* idp) {
  if (idp == nullptr) {
    buf[p] = w;
    return;
  }
  reinterpret_cast<uint32_t*>(buf + p)[1] = (uint32_t)(w >> 32);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(buf + p)),
               "l"(reinterpret_cast<uint64_t>(idp))
               : "memory");
}

__device__ __forceinline__ void wait_ids() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// ---------------------------------------------------------- appends

// Append each lane's kept words at buf[*n] (one atomic a warp). Every lane
// of the warp calls it. -> the count after this warp's words (0: none)
template <int NW>
__device__ __forceinline__ unsigned append_block(const u64 (&w)[NW], const bool (&keep)[NW],
                                                 const int* const (&idp)[NW], u64* buf,
                                                 unsigned* n, int lane) {
  unsigned m[NW], tot = 0;
#pragma unroll
  for (int u = 0; u < NW; ++u) {
    m[u] = __ballot_sync(FULL, keep[u]);
    tot += __popc(m[u]);
  }
  if (tot == 0) return 0;
  unsigned pos = 0;
  if (lane == 0) pos = atomicAdd(n, tot);
  pos = __shfl_sync(FULL, pos, 0);
  const unsigned end = pos + tot, lt = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < NW; ++u) {
    if (keep[u]) put(buf, pos + __popc(m[u] & lt), w[u], idp[u]);
    pos += __popc(m[u]);
  }
  return end;
}

// the same into a warp's own buffer, its count `cnt` the same in every lane
template <int NW>
__device__ __forceinline__ void append_warp(const u64 (&w)[NW], const bool (&keep)[NW], u64* buf,
                                            int& cnt, int lane) {
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < NW; ++u) {
    const unsigned m = __ballot_sync(FULL, keep[u]);
    if (keep[u]) buf[cnt + __popc(m & lt)] = w[u];
    cnt += __popc(m);
  }
}

// ---------------------------------------------------------- sorts in registers

// One step of a bitonic network over a warp's 32 * NPL words, word e =
// lane * NPL + j in v[j]: e and e ^ stride are ordered ascending where
// (e & size) == 0, else descending.
template <int NPL>
__device__ __forceinline__ void bitonic_step(u64 (&v)[NPL], int lane, int size, int stride) {
  if (stride >= NPL) {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const u64 o = __shfl_xor_sync(FULL, v[j], stride / NPL);
      const int e = lane * NPL + j;
      const bool asc = (e & size) == 0, lower = (e & stride) == 0;
      v[j] = lower == asc ? umin(v[j], o) : umax(v[j], o);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      if ((j & stride) == 0) {
        const int e = lane * NPL + j;
        const u64 x = v[j], y = v[j + stride];
        const bool asc = (e & size) == 0;
        v[j] = asc ? umin(x, y) : umax(x, y);
        v[j + stride] = asc ? umax(x, y) : umin(x, y);
      }
    }
  }
}

template <int NPL>
__device__ __forceinline__ void warp_sort(u64 (&v)[NPL], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * NPL; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) bitonic_step<NPL>(v, lane, size, stride);
  }
}

// list := the 32 * NPL smallest of the sorted list and the sorted batch c,
// sorted
template <int NPL>
__device__ __forceinline__ void warp_merge(u64 (&list)[NPL], const u64 (&c)[NPL], int lane) {
#pragma unroll
  for (int j = 0; j < NPL; ++j)
    list[j] = umin(list[j], __shfl_sync(FULL, c[NPL - 1 - j], 31 - lane));
#pragma unroll
  for (int stride = 16 * NPL; stride > 0; stride >>= 1)
    bitonic_step<NPL>(list, lane, 64 * NPL, stride);
}

// word e = lane * NPL + j of a warp's list, in every lane
template <int NPL>
__device__ __forceinline__ u64 list_at(const u64 (&v)[NPL], int e) {
  u64 x = v[0];
#pragma unroll
  for (int j = 1; j < NPL; ++j)
    if (e % NPL == j) x = v[j];
  return __shfl_sync(FULL, x, e / NPL);
}

// ---------------------------------------------------------- radix select

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

// The kk smallest (1 <= kk <= cnt) of the cnt words of buf, into outb[0, kk)
// in no order, and their largest into sh.theta. Called by the whole block;
// ends with a barrier.
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

// ---------------------------------------------------------- bulk copies

__device__ __forceinline__ void mbar_init(u64* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(u64* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(u64* bar, uint32_t parity) {
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

// bytes (a multiple of 16) from src to dst, both 16-byte aligned; completes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The exact test of a value that passed the coarse one, on the way into a
// buffer: the word, whether it is kept, and where its id comes from when it
// is copied later (ids of a tensor: then it is kept on its key alone).
template <bool PAIRS>
__device__ __forceinline__ void exact(const Args& a, typename Src<PAIRS>::T v, int col,
                                      const int* ids_row, u64 theta, u64& w, bool& keep,
                                      const int*& idp) {
  if constexpr (PAIRS) {
    w = v;
    keep = v < theta;
  } else if (ids_row) {
    const uint32_t hi = key_hi(a, v, col);
    w = (u64)hi << 32;
    keep = hi <= (uint32_t)(theta >> 32);
    idp = ids_row + col;
  } else {
    w = ((u64)key_hi(a, v, col) << 32) | (uint32_t)(a.id_base + col);
    keep = w < theta;
  }
}

// ---------------------------------------------------------- block route

// stage s of the body (nbody values from body) into its slot of the ring
template <typename T, int RING>
__device__ __forceinline__ void issue_stage(u64* bars, T* ring, const T* body, int nbody, int s) {
  constexpr int SW = STAGE_BYTES / (int)sizeof(T);
  u64* bar = &bars[s % RING];
  const uint32_t bytes = (uint32_t)(min(SW, nbody - s * SW) * (int)sizeof(T));
  mbar_expect_tx(bar, bytes);
  bulk_load(ring + (s % RING) * SW, body + s * SW, bytes, bar);
}

template <bool PAIRS, bool PAIRS_OUT, int RING>
__global__ void __launch_bounds__(NT) block_kernel(const Args a) {
  typedef Src<PAIRS> S;
  typedef typename S::T T;
  typedef typename S::Vec Vec;
  constexpr int V = S::V;
  constexpr int SW = STAGE_BYTES / (int)sizeof(T);  // values a stage
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Shared sh;
  __shared__ __align__(8) u64 bars[RING];
  __shared__ u64 pmax;

  T* ring = reinterpret_cast<T*>(smem);
  u64* buf = reinterpret_cast<u64*>(smem + RING * STAGE_BYTES);  // [cap] kept words
  u64* outb = buf + a.cap;                                        // [kpad] the k smallest
  const int row = blockIdx.x, sl = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int c0 = sl * a.slice;
  const int n = min(a.slice, a.W - c0);
  const size_t rbase = (size_t)row * a.W;
  const T* src = S::row(a, rbase) + c0;
  // head: values before the first 16-byte boundary, by plain loads; body:
  // whole 16-byte vectors, by bulk copies; tail: the rest, by plain loads
  const int head = head_of(src, n);
  const int nbody = (n - head) / V * V;
  const int ntail = n - head - nbody;
  const int nstages = (nbody + SW - 1) / SW;
  const bool seeded = a.prior_d != nullptr;
  const int* ids_row = (!PAIRS && a.ids) ? a.ids + (a.id_rows ? rbase : 0) : nullptr;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    sh.n = (seeded && sl == 0) ? a.k : 0;
    sh.theta = ~0ull;
    sh.mark = a.mark;
    pmax = 0;
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < min(RING, nstages); ++s)
      issue_stage<T, RING>(bars, ring, src + head, nbody, s);
  if (seeded) {  // slice 0 keeps the prior's words; every slice starts at their largest
    for (int i = tid; i < a.k; i += NT) {
      const u64 w = prior_word(a, row, i);
      if (sl == 0) buf[i] = w;
      atomicMax(&pmax, w);
    }
    __syncthreads();
    if (tid == 0) sh.theta = pmax;
    __syncthreads();
  }
  {  // head and tail, a value a thread
    u64 w[1] = {0};
    bool keep[1] = {false};
    const int* const idp[1] = {nullptr};
    const int j = tid < head ? tid : (tid < head + ntail ? nbody + tid : -1);
    if (j >= 0) {
      w[0] = word_of(a, src[j], c0 + j, rbase);
      keep[0] = w[0] < sh.theta;
    }
    append_block<1>(w, keep, idp, buf, &sh.n, lane);
  }
  __syncthreads();

  for (int s = 0; s < nstages; ++s) {
    const T* st = ring + (s % RING) * SW;
    const int nv = min(SW, nbody - s * SW) / V;
    const int col0 = c0 + head + s * SW;
    mbar_wait(&bars[s % RING], (uint32_t)((s / RING) & 1));
    Vec x[2];
    bool in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      in[h] = tid + h * NT < nv;
      if (in[h]) x[h] = S::lds(st + (tid + h * NT) * V);
    }
    if constexpr (!PAIRS) {
      if (s == 0 && a.k <= 64) {
        // A first threshold from the first stage: the k-th smallest of the
        // minima of the threads' 8 keys. At least k words lie at or below
        // that key, so no word above it can be kept; ids are below 2^31, so
        // its word with the id all ones is a strict bound.
        uint32_t m = FULL;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (in[h]) m = min(m, key_hi(a, S::at(x[h], j), col0 + (tid + h * NT) * V + j));
        // past the prior and the head and tail: free until the stage's appends
        uint32_t* mins = reinterpret_cast<uint32_t*>(buf + a.kpad + 8);
        mins[tid] = m;
        __syncthreads();
        if (tid < 32) {
          u64 r[NT / 32];
#pragma unroll
          for (int j = 0; j < NT / 32; ++j) r[j] = (u64)mins[lane * (NT / 32) + j] << 32 | FULL;
          warp_sort<NT / 32>(r, lane);
          const u64 est = list_at<NT / 32>(r, a.k - 1);
          if (lane == 0) sh.theta = umin(sh.theta, est);
        }
        __syncthreads();
      }
    }
    const u64 theta = sh.theta;
    const float tf = key_of(theta);
    bool any = false;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < V; ++j) any |= in[h] && S::coarse(S::at(x[h], j), tf, theta);
    unsigned end = 0;
    if (__any_sync(FULL, any)) {
      u64 w[2 * V];
      bool keep[2 * V];
      const int* idp[2 * V];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int u = h * V + j;
          const T v = S::at(x[h], j);
          keep[u] = false;
          w[u] = 0;
          idp[u] = nullptr;
          if (in[h] && S::coarse(v, tf, theta))
            exact<PAIRS>(a, v, col0 + (tid + h * NT) * V + j, ids_row, theta, w[u], keep[u],
                         idp[u]);
        }
      }
      end = append_block<2 * V>(w, keep, idp, buf, &sh.n, lane);
    }
    // the one barrier of the stage: every thread has read it, and the warp
    // that appended last tells whether the buffer passed its mark (a
    // stage's survivors always fit: mark <= cap - SW)
    const bool full = __syncthreads_or(end > (unsigned)sh.mark);
    if (tid == 0 && s + RING < nstages) issue_stage<T, RING>(bars, ring, src + head, nbody, s + RING);
    if (full) {
      wait_ids();
      __syncthreads();
      select_words(buf, sh.n, a.k, outb, sh);  // k < mark < count
      for (int i = tid; i < a.k; i += NT) buf[i] = outb[i];
      if (tid == 0) {
        sh.n = a.k;
        // words kept on their key alone (ids of a tensor) that tie theta's
        // key do not lower it: a shrink that left the key where it was
        // doubles the mark, up to what a stage's survivors leave room for
        if ((sh.theta >> 32) == (theta >> 32))
          sh.mark = min(a.cap - SW, a.k + 2 * (sh.mark - a.k));
      }
      __syncthreads();
    }
  }
  wait_ids();
  __syncthreads();

  const int cnt = sh.n;
  const int kk = min(a.k, cnt);  // == k but in a seeded slice past the first
  if (kk == cnt) {
    for (int i = tid; i < cnt; i += NT) outb[i] = buf[i];
    __syncthreads();
  } else {
    select_words(buf, cnt, kk, outb, sh);
  }

  u64* op = PAIRS_OUT ? a.out_pairs + ((size_t)row * a.nslices + sl) * a.k : nullptr;
  const size_t o = (size_t)row * a.k;
  if (a.kpad <= 64) {  // one warp sorts in registers and writes
    if (tid >= 32) return;
    u64 r[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = lane * 2 + j;
      r[j] = e < kk ? outb[e] : ~0ull;
    }
    warp_sort<2>(r, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = lane * 2 + j;
      if (PAIRS_OUT) {
        if (e < a.k) op[e] = r[j];
      } else if (e < kk) {
        a.out_d[o + e] = key_of(r[j]);
        a.out_i[o + e] = (int)(uint32_t)r[j];
      }
    }
    return;
  }
  // bitonic sort of the kpad words in shared memory (the tail all-ones)
  const int P = a.kpad;
  for (int i = kk + tid; i < P; i += NT) outb[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += NT) {
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
    for (int i = tid; i < a.k; i += NT) op[i] = i < kk ? outb[i] : ~0ull;
  } else {
    for (int i = tid; i < kk; i += NT) {
      const u64 w = outb[i];
      a.out_d[o + i] = key_of(w);
      a.out_i[o + i] = (int)(uint32_t)w;
    }
  }
}

// ---------------------------------------------------------- warp route

template <int NPL, bool PAIRS>
__host__ __device__ constexpr int warp_cap() {
  return 32 * NPL + 32 * Src<PAIRS>::V;  // a batch short of a merge and a step
}

// Merge batches of 32 * NPL words of the warp's buffer into its list while
// the buffer holds at least `below` (the last batch padded with all-ones),
// lowering theta to the list's k-th.
template <int NPL>
__device__ __forceinline__ void warp_drain(u64 (&list)[NPL], u64* buf, int& cnt, u64& theta,
                                           int below, int k, int lane) {
  constexpr int L = 32 * NPL;
  while (cnt >= below) {
    __syncwarp();
    u64 c[NPL];
    const int b0 = cnt - L;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int e = lane * NPL + j;
      c[j] = e < cnt ? buf[b0 < 0 ? e : b0 + e] : ~0ull;
    }
    __syncwarp();
    cnt = max(b0, 0);
    warp_sort<NPL>(c, lane);
    warp_merge<NPL>(list, c, lane);
    theta = umin(theta, list_at<NPL>(list, k - 1));
  }
}

template <bool PAIRS, bool PAIRS_OUT, int NPL>
__global__ void __launch_bounds__(NT) warp_kernel(const Args a) {
  typedef Src<PAIRS> S;
  typedef typename S::T T;
  typedef typename S::Vec Vec;
  constexpr int V = S::V;
  constexpr int L = 32 * NPL;          // words of the list
  constexpr int STEP = 32 * V;  // values a warp-step: one 16-byte load a lane
  constexpr int CAP = warp_cap<NPL, PAIRS>();
  extern __shared__ __align__(16) u64 wsmem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x * (NT / 32) + warp, sl = blockIdx.y;
  if (row >= a.B) return;  // no block barrier below
  u64* buf = wsmem + warp * CAP;
  const int c0 = sl * a.slice;
  const int n = min(a.slice, a.W - c0);
  const size_t rbase = (size_t)row * a.W;
  const T* src = S::row(a, rbase) + c0;
  const int head = head_of(src, n);
  const int nbody = (n - head) / V * V;
  const int ntail = n - head - nbody;

  u64 list[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) list[j] = ~0ull;
  u64 theta = ~0ull;
  if (a.prior_d) {  // slice 0 starts from the prior's words; every slice at their largest
    u64 m = 0;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int e = lane * NPL + j;
      if (e < a.k) {
        const u64 w = prior_word(a, row, e);
        m = umax(m, w);
        if (sl == 0) list[j] = w;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = umax(m, __shfl_xor_sync(FULL, m, off));
    theta = m;
    if (sl == 0) warp_sort<NPL>(list, lane);
  }
  int cnt = 0;
  {  // head and tail, a value a lane
    u64 w[1] = {0};
    bool keep[1] = {false};
    const int j = lane < head ? lane : (lane < head + ntail ? nbody + lane : -1);
    if (j >= 0) {
      w[0] = word_of(a, src[j], c0 + j, rbase);
      keep[0] = w[0] < theta;
    }
    append_warp<1>(w, keep, buf, cnt, lane);
  }
  const T* body = src + head;
  // Ids of a tensor are loaded with their keys, a 16-byte vector of ids
  // beside each vector of keys, where the ids are aligned at the same column
  // (else one at a time, for the words that pass the coarse test only).
  const int* ids_base = (!PAIRS && a.ids) ? a.ids + (a.id_rows ? rbase : 0) : nullptr;
  const bool idvec =
      ids_base && (reinterpret_cast<uintptr_t>(ids_base + c0 + head) & 15u) == 0;
  // the next step's loads are issued before this step is filtered
  Vec nx;
  int4 ni;
  if (lane * V < nbody) {
    nx = S::ldg(body + lane * V);
    if (idvec) ni = __ldg(reinterpret_cast<const int4*>(ids_base + c0 + head + lane * V));
  }
  for (int base = 0; base < nbody; base += STEP) {
    const float tf = key_of(theta);
    const int off = base + lane * V;
    const bool in = off < nbody;
    const Vec x = nx;
    const int4 xi = ni;
    if (off + STEP < nbody) {
      nx = S::ldg(body + off + STEP);
      if (idvec) ni = __ldg(reinterpret_cast<const int4*>(ids_base + c0 + head + off + STEP));
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < V; ++j) any |= in && S::coarse(S::at(x, j), tf, theta);
    if (__any_sync(FULL, any)) {
      u64 w[V];
      bool keep[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int col = c0 + head + off + j;
        const T v = S::at(x, j);
        keep[j] = false;
        w[j] = 0;
        if (in && S::coarse(v, tf, theta)) {
          if constexpr (PAIRS) {
            w[j] = v;
          } else {
            const int* iv = reinterpret_cast<const int*>(&xi);
            const uint32_t id = !ids_base ? (uint32_t)(a.id_base + col)
                                : idvec   ? (uint32_t)iv[j]
                                          : (uint32_t)__ldg(ids_base + col);
            w[j] = ((u64)key_hi(a, v, col) << 32) | id;
          }
          keep[j] = w[j] < theta;
        }
      }
      append_warp<V>(w, keep, buf, cnt, lane);
      warp_drain<NPL>(list, buf, cnt, theta, L, a.k, lane);
    }
  }
  warp_drain<NPL>(list, buf, cnt, theta, 1, a.k, lane);  // the last, partial batch

  if (PAIRS_OUT) {
    u64* op = a.out_pairs + ((size_t)row * a.nslices + sl) * a.k;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int e = lane * NPL + j;
      if (e < a.k) op[e] = list[j];
    }
  } else {
    const size_t o = (size_t)row * a.k;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int e = lane * NPL + j;
      if (e < a.k) {
        a.out_d[o + e] = key_of(list[j]);
        a.out_i[o + e] = (int)(uint32_t)list[j];
      }
    }
  }
}

// ---------------------------------------------------------- launches

template <bool PAIRS, bool PAIRS_OUT, int RING>
int launch_block(Args& a, cudaStream_t s) {
  auto kern = block_kernel<PAIRS, PAIRS_OUT, RING>;
  constexpr int SW = STAGE_BYTES / (PAIRS ? 8 : 4);
  // room for the prior and head and tail, the words kept and a stage's
  // survivors past the mark
  a.cap = a.kpad + 2 * SW + 8;
  // a small k shrinks early, so that theta falls soon; a large one only
  // when the buffer could not take another stage
  a.mark = a.kpad <= 64 ? (1 + SHRINK_X) * a.kpad : a.cap - SW;
  const size_t smem = RING * STAGE_BYTES + (size_t)(a.cap + a.kpad) * sizeof(u64);
  static bool attr_set = false;
  if (!attr_set) {  // the largest: kpad = KMAX
    const int most = RING * STAGE_BYTES + (2 * KMAX + 2 * SW + 8) * (int)sizeof(u64);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kern<<<dim3(a.B, a.nslices), NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool PAIRS, bool PAIRS_OUT, int NPL>
int launch_warp(Args& a, cudaStream_t s) {
  const size_t smem = (size_t)(NT / 32) * warp_cap<NPL, PAIRS>() * sizeof(u64);
  warp_kernel<PAIRS, PAIRS_OUT, NPL>
      <<<dim3((a.B + NT / 32 - 1) / (NT / 32), a.nslices), NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool PAIRS, bool PAIRS_OUT>
int launch(Args& a, int route, cudaStream_t s) {
  if (route == 1) {  // a warp's list holds 32 or 64 words
    if (a.k <= 32) return launch_warp<PAIRS, PAIRS_OUT, 1>(a, s);
    if (a.k <= 64) return launch_warp<PAIRS, PAIRS_OUT, 2>(a, s);
    return (int)cudaErrorInvalidValue;
  }
  // a deep ring while the buffer is small; a shallow one, and more blocks
  // an SM, where a large k makes the radix select the larger part
  return a.kpad <= 64 ? launch_block<PAIRS, PAIRS_OUT, DEPTH>(a, s)
                      : launch_block<PAIRS, PAIRS_OUT, DEPTH_BIG_K>(a, s);
}

}  // namespace

// One round of the selection. keys (float, [B, W]) or pairs (the words of
// an earlier round, [B, W]) is given, the other null. ids: [B, W] int32
// (id_rows = 1), one [1, W] row (id_rows = 0), or null for id_base +
// column. prior_d / prior_i: [B, k] keys and ids that every row's selection
// includes (first round only), or both null. The row is cut into
// ceil(W / slice) slices; with out_pairs null there must be one, and the k
// pairs a row go to out_d / out_i, else each slice's k words go to
// out_pairs [B, nslices * k]. route: 0 the block route, 1 the warp route
// (refused for k > 64); the wrapper picks it. Returns a cudaError_t.
extern "C" int select_k_launch(const void* keys, const void* ids, int id_rows, int id_base,
                               const void* pairs, const void* prior_d, const void* prior_i,
                               int B, int W, int k, int col_lo, int col_hi, int slice,
                               int route, void* out_d, void* out_i, void* out_pairs,
                               void* stream) {
  if (B == 0) return 0;
  const bool seeded = prior_d != nullptr;
  if (B < 0 || W < 1 || k < 1 || k > KMAX || slice < 1 || slice > W ||
      (keys == nullptr) == (pairs == nullptr) || seeded != (prior_i != nullptr) ||
      (seeded && pairs != nullptr) || route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.keys = static_cast<const float*>(keys);
  a.ids = static_cast<const int*>(ids);
  a.id_rows = id_rows;
  a.id_base = id_base;
  a.pairs = static_cast<const u64*>(pairs);
  a.prior_d = static_cast<const float*>(prior_d);
  a.prior_i = static_cast<const int*>(prior_i);
  a.B = B;
  a.W = W;
  a.k = k;
  // a block sorts at most min(k, slice) words, or k with a prior
  const int most = seeded ? k : (k < slice ? k : slice);
  a.kpad = 1;
  while (a.kpad < most) a.kpad <<= 1;
  a.col_lo = col_lo;
  a.col_hi = col_hi;
  a.slice = slice;
  a.nslices = (W + slice - 1) / slice;
  a.cap = 0;
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.out_pairs = static_cast<u64*>(out_pairs);
  if (a.nslices > 65535 || (out_pairs == nullptr && (a.nslices != 1 || (!seeded && k > W))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs) {
    return out_pairs ? launch<true, true>(a, route, s) : launch<true, false>(a, route, s);
  }
  return out_pairs ? launch<false, true>(a, route, s) : launch<false, false>(a, route, s);
}
