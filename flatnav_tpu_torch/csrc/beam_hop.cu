// The beam-search hop's bookkeeping for Hopper (sm_90a): the select,
// membership and merge stages of index/search.py's lockstep hop, one launch
// each for the whole batch, one block a query row.
//
// Replaces no TPU kernel. The JAX package leaves these stages to XLA
// (flatnav_tpu/index/search.py, the loop body of beam_search_core); the port
// ran them as ~90 PyTorch operations a hop (index/search.py: _select,
// _membership, _merge), which kept the host launching and the card idle
// between small operations. Here a row's beam, history and candidates stay
// in shared memory for the length of a stage.
//
// Each kernel gives what its stage of the PyTorch chain gives, bit for bit:
//   select      the first E unexpanded beam positions, marked expanded; their
//               ids (0 where fewer than E are left) and whether each is
//               valid. The ids (-1 where not valid) join the row's
//               expanded-id history, which this route keeps SORTED where
//               the chain keeps it in hop order and sorts it every hop: E of
//               its -1 padding entries leave (the slots the chain writes
//               held -1), the E new values merge in.
//   membership  a candidate is fresh iff its source was selected, it is the
//               first occurrence of its id in the row, its id is not one of
//               the finite-distance beam entries' (the sentinel stands for
//               the others) and is not in the history. Two hash sets in
//               shared memory: one of every known id (beam and history),
//               one of the candidates' ids, where each add lands in one
//               slot per id and keeps the id's lowest position. With a
//               compact width CC: the first CC candidates with the fresh
//               ones first, each group in position order (the chain's
//               stable argsort of ~fresh).
//   merge       the chain sorts the new distances stably (+inf where not
//               fresh), keeps ef of them and merges them into the beam,
//               beam entries first on ties: the first ef of beam and new
//               entries in the order of (distance, beam before new, index).
//               In a beam in key order, a new entry below the last beam
//               key can enter and no other can, so only those are sorted,
//               by (distance key, position), and merged by rank. (A beam
//               out of order, which a NaN from the entry scan makes, sorts
//               everything.) The key orders floats as torch.sort does: -0.0
//               equals +0.0, every NaN equals every other and follows +inf
//               (K2 scores an id outside the table NaN). Adds the row's
//               fresh count to the distance counter, and writes `stamp` to
//               the flag where the row's new beam holds an unexpanded entry.
// (select adds the valid selections to the hop counter.)
//
// Bound on this card: bytes, and few of them. A query's stages read and
// write its beam, history, candidates and their distances: ~48 KB at
// ef = 512, E = 64, M = 32 (the SIFT cell), ~14 us for 1,000 queries at
// 3.35 TB/s (bench/measure.hop_stage_bounds, stage by stage). Select also
// reads and rewrites the whole history to keep it sorted, ~9 KB more of
// this design's own. What the design removes is launches
// (three a hop in place of ~90) and the chain's [B, ef, E] mask, full
// history sort and four argsorts. Full bitonic sorts of the E*M candidates
// in shared memory, the first design, took 145 us (membership) and 100 us
// (merge) a SIFT hop: their shared-memory traffic, not their bytes, bound
// them. Lookups bind the hash sets: each dependent probe of a warp costs
// several cycles of the SM, so membership makes one probe chain a set and
// evaluates its terms without branches (short-circuit divergence cost 40%).

// Where a row's working set outgrows a block's shared memory (227 KB on
// this card: ef past ~8,000, or a history of tens of thousands of ids from
// a large max_hops), the stage keeps the same layout in a global-memory
// workspace, one slice a row (ops/beam_hop.py sizes it), and runs the same
// code on it: slower, the same results.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int INT_SENTINEL = 0x7fffffff;  // index/search.py's _INT_SENTINEL
// widths past which a row's sets and sort keys would outgrow 32-bit sizes
constexpr int WIDTH_MAX = 1 << 28;
constexpr uint32_t INF_KEY = 0xff800000u;  // dist_key(+inf)

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// torch.sort's order of float32 as an unsigned key: -0.0 and +0.0 equal,
// every NaN equal and after +inf
__device__ __forceinline__ uint32_t dist_key(float d) {
  if (d != d) return 0xffffffffu;
  uint32_t u = __float_as_uint(d);
  if ((u << 1) == 0) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t pack(uint32_t hi, uint32_t lo) {
  return (uint64_t(hi) << 32) | lo;
}

// ascending sort of a[0..n), n a power of two; every thread of the block
// calls it after the writes of a[] are visible, and a[] is sorted and
// visible when it returns
template <typename T>
__device__ void bitonic_sort(T* a, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += THREADS) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo | j;
        const T x = a[lo], y = a[hi];
        if ((x > y) == ((lo & k) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// entries of a[0..n) (ascending) below x / at most x
template <typename T>
__device__ int count_below(const T* a, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}
template <typename T>
__device__ int count_at_most(const T* a, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// composite keys sorted ascending: how many have a high word below / at most hi
__device__ __forceinline__ int keys_below(const uint64_t* a, int n, uint32_t hi) {
  return count_below(a, n, pack(hi, 0));
}
__device__ __forceinline__ int keys_at_most(const uint64_t* a, int n, uint32_t hi) {
  return hi == 0xffffffffu ? n : count_below(a, n, pack(hi + 1, 0));
}

// exclusive prefix sum of v over the block, in thread order; `total` gets
// the sum. Every thread calls it.
__device__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sum[WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < WARPS ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    if (lane < WARPS) warp_sum[lane] = t;
  }
  __syncthreads();
  total = warp_sum[WARPS - 1];
  const int out = (w ? warp_sum[w - 1] : 0) + x - v;
  __syncthreads();
  return out;
}

template <bool WS>
__global__ void __launch_bounds__(THREADS)
select_kernel(const int* __restrict__ beam_i, uint8_t* __restrict__ beam_e,
              int* __restrict__ hist, int ef, int E, int W,
              int* __restrict__ cur_ids, uint8_t* __restrict__ sel_valid,
              unsigned long long* __restrict__ hops, unsigned char* scratch,
              size_t scratch_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = WS ? scratch + blockIdx.x * scratch_row : smem;
  const int pe = pow2_at_least(E);
  int* hs = reinterpret_cast<int*>(base);  // [W] the row's history
  int* nv = hs + W;                        // [pe] this hop's values, sorted
  int* pos = nv + pe;                      // [E] the selected positions
  const size_t row = blockIdx.x;
  const int* bi = beam_i + row * ef;
  uint8_t* be = beam_e + row * ef;
  int* h = hist + row * W;

  // a thread counts the unexpanded entries of its run of positions; the
  // scan gives each its rank among the row's
  const int per = (ef + THREADS - 1) / THREADS;
  const int p0 = min(int(threadIdx.x) * per, ef), p1 = min(p0 + per, ef);
  int n = 0;
  for (int p = p0; p < p1; ++p) n += !be[p];
  int total;
  int r = block_exclusive_scan(n, total);
  for (int p = p0; p < p1 && r < E; ++p)
    if (!be[p]) pos[r++] = p;
  for (int i = threadIdx.x; i < W; i += THREADS) hs[i] = h[i];
  __syncthreads();

  const int nsel = min(total, E);
  for (int j = threadIdx.x; j < pe; j += THREADS) {
    int v = INT_SENTINEL;
    if (j < E) {
      const bool ok = j < nsel;
      const int id = ok ? bi[pos[j]] : 0;
      cur_ids[row * E + j] = id;
      sel_valid[row * E + j] = ok;
      v = ok ? id : -1;
    }
    nv[j] = v;
  }
  for (int j = threadIdx.x; j < nsel; j += THREADS) be[pos[j]] = 1;
  if (threadIdx.x == 0 && nsel) atomicAdd(hops, (unsigned long long)nsel);
  __syncthreads();
  bitonic_sort(nv, pe);

  // the history without E of its -1 entries (at lb...lb + E), merged with
  // nv[0..E): the old first on ties
  const int lb = count_below(hs, W, -1);
  for (int k = threadIdx.x; k < W - E; k += THREADS) {
    const int x = hs[k < lb ? k : k + E];
    h[k + count_below(nv, E, x)] = x;
  }
  for (int j = threadIdx.x; j < E; j += THREADS) {
    const int x = nv[j];
    h[j + count_at_most(hs, W, x) - (x >= -1 ? E : 0)] = x;
  }
}

// Open-addressing sets in shared memory, probed linearly from a
// multiplicative hash. A slot holds a value itself; EMPTY marks a free
// slot, so the one value that equals it is noted beside the set.
constexpr int EMPTY = int(0x80000000);

__device__ __forceinline__ int slot_of(int x, int bits) {
  return int((uint32_t(x) * 2654435761u) >> (32 - bits));
}

// adds x (not EMPTY) to the set -> the slot that holds it, where every
// other add of x lands too (an occupied slot never changes)
__device__ int set_add(int* slot, int bits, int x) {
  const int mask = (1 << bits) - 1;
  for (int h = slot_of(x, bits);; h = (h + 1) & mask) {
    int q = slot[h];
    if (q == EMPTY) q = atomicCAS(&slot[h], EMPTY, x);
    if (q == EMPTY || q == x) return h;
  }
}

// whether x (not EMPTY) is in the set
__device__ bool set_has(const int* slot, int bits, int x) {
  const int mask = (1 << bits) - 1;
  for (int h = slot_of(x, bits);; h = (h + 1) & mask) {
    const int q = slot[h];
    if (q == x) return true;
    if (q == EMPTY) return false;
  }
}

__host__ __device__ inline int log2_of(int pow2) {
  int b = 0;
  while ((1 << b) < pow2) ++b;
  return b;
}

// sets of at least twice their entries
__host__ __device__ inline int set_bits(int entries) { return log2_of(pow2_at_least(2 * entries)); }

template <bool WS>
__global__ void __launch_bounds__(THREADS)
membership_kernel(const float* __restrict__ beam_d, const int* __restrict__ beam_i,
                  const int* __restrict__ hist, const int* __restrict__ nbrs,
                  const uint8_t* __restrict__ sel_valid, int ef, int W, int C, int E,
                  int M, int CC, uint8_t* __restrict__ fresh,
                  int* __restrict__ nbrs_out, unsigned char* scratch, size_t scratch_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int known_empty, first_empty;  // EMPTY's own entries
  unsigned char* base = WS ? scratch + blockIdx.x * scratch_row : smem;
  const int kb = set_bits(ef + W), cb = set_bits(C);
  int* known = reinterpret_cast<int*>(base);  // [1 << kb] beam and history ids
  int* cset = known + (1 << kb);              // [1 << cb] the candidates' ids
  int* first = cset + (1 << cb);              // [1 << cb] lowest position of each
  int* at = first + (1 << cb);                // [C] the slot of each position
  uint8_t* fl = reinterpret_cast<uint8_t*>(at + C);  // [C] fresh, by position
  const size_t row = blockIdx.x;
  const uint8_t* sv = sel_valid + row * E;
  const int* nb = nbrs + row * C;

  int any = 0;
  for (int j = threadIdx.x; j < E; j += THREADS) any |= sv[j];
  if (__syncthreads_or(any)) {
    for (int i = threadIdx.x; i < (1 << kb); i += THREADS) known[i] = EMPTY;
    for (int i = threadIdx.x; i < (1 << cb); i += THREADS) {
      cset[i] = EMPTY;
      first[i] = INT_SENTINEL;
    }
    if (threadIdx.x == 0) known_empty = 0, first_empty = INT_SENTINEL;
    __syncthreads();
    // known: the ids of finite-distance beam entries, the sentinel for the
    // others (once), the history's distinct values
    int other = 0;
    for (int i = threadIdx.x; i < ef; i += THREADS) {
      if (!isfinite(beam_d[row * ef + i])) {
        other = 1;
        continue;
      }
      const int x = beam_i[row * ef + i];
      if (x == EMPTY) known_empty = 1; else set_add(known, kb, x);
    }
    if (__syncthreads_or(other) && threadIdx.x == 0) set_add(known, kb, INT_SENTINEL);
    for (int i = threadIdx.x; i < W; i += THREADS) {
      const int x = hist[row * W + i];
      if (i > 0 && hist[row * W + i - 1] == x) continue;
      if (x == EMPTY) known_empty = 1; else set_add(known, kb, x);
    }
    for (int p = threadIdx.x; p < C; p += THREADS) {
      const int x = nb[p];
      if (x == EMPTY) {
        at[p] = -1;
        atomicMin(&first_empty, p);
      } else {
        const int h = set_add(cset, cb, x);
        at[p] = h;
        atomicMin(&first[h], p);
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < C; p += THREADS) {
      const int x = nb[p], h = at[p];
      const bool is_first = (h < 0 ? first_empty : first[h]) == p;
      const bool is_known = x == EMPTY ? known_empty != 0 : set_has(known, kb, x);
      fl[p] = is_first & (sv[p / M] != 0) & !is_known;
    }
  } else {  // no source selected: nothing is fresh
    for (int p = threadIdx.x; p < C; p += THREADS) fl[p] = 0;
  }
  __syncthreads();

  if (CC == 0) {
    for (int p = threadIdx.x; p < C; p += THREADS) fresh[row * C + p] = fl[p];
    return;
  }
  const int per = (C + THREADS - 1) / THREADS;
  const int p0 = min(int(threadIdx.x) * per, C), p1 = min(p0 + per, C);
  int n = 0;
  for (int p = p0; p < p1; ++p) n += fl[p];
  int nf;
  int r = block_exclusive_scan(n, nf);  // fresh entries before p0
  for (int p = p0; p < p1; ++p) {
    const int f = fl[p];
    const int to = f ? r : nf + p - r;
    r += f;
    if (to < CC) {
      nbrs_out[row * CC + to] = nb[p];
      fresh[row * CC + to] = f;
    }
  }
}

template <bool WS>
__global__ void __launch_bounds__(THREADS)
merge_kernel(float* __restrict__ beam_d, int* __restrict__ beam_i,
             uint8_t* __restrict__ beam_e, const float* __restrict__ scores,
             const int* __restrict__ nbrs, const uint8_t* __restrict__ fresh, int ef,
             int C, unsigned long long* __restrict__ dcomp, int* __restrict__ flag,
             int stamp, unsigned char* scratch, size_t scratch_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_fresh, n_new;
  unsigned char* base = WS ? scratch + blockIdx.x * scratch_row : smem;
  const int pc = pow2_at_least(C), pf = pow2_at_least(ef);
  uint64_t* nk = reinterpret_cast<uint64_t*>(base);  // [pc] new: (key, position)
  uint64_t* bk = nk + pc;                             // [pf] beam: (key, index)
  float* sd = reinterpret_cast<float*>(bk + pf);      // [ef] the beam as it was
  int* si = reinterpret_cast<int*>(sd + ef);
  uint8_t* se = reinterpret_cast<uint8_t*>(si + ef);
  const size_t row = blockIdx.x;
  float* bd = beam_d + row * ef;
  int* bi = beam_i + row * ef;
  uint8_t* be = beam_e + row * ef;
  const float* s = scores + row * C;
  const int* nb = nbrs + row * C;
  const uint8_t* fr = fresh + row * C;

  if (threadIdx.x == 0) n_fresh = n_new = 0;
  for (int i = threadIdx.x; i < pf; i += THREADS) {
    uint64_t k = ~0ull;
    if (i < ef) {
      const float d = bd[i];
      sd[i] = d;
      si[i] = bi[i];
      se[i] = be[i];
      k = pack(dist_key(d), i);
    }
    bk[i] = k;
  }
  __syncthreads();
  // whether the beam is in key order and holds no NaN, as the chain's
  // merges leave it
  bool ok = threadIdx.x != 0 || uint32_t(bk[ef - 1] >> 32) <= INF_KEY;
  for (int i = threadIdx.x + 1; i < ef; i += THREADS) ok &= (bk[i - 1] >> 32) <= (bk[i] >> 32);
  const bool ordered = __syncthreads_and(ok);

  // In an ordered beam, a new entry enters only below the beam's last key:
  // at that key or above, ef beam entries precede it. So only fresh entries
  // below it are sorted; the others (every one not fresh: +inf) stay out.
  // Otherwise every new entry is sorted, and the beam too.
  const uint32_t cut = ordered ? uint32_t(bk[ef - 1] >> 32) : 0xffffffffu;
  int n = 0;
  for (int p = threadIdx.x; p < C; p += THREADS) {
    const bool f = fr[p];
    n += f;
    const uint32_t key = f ? dist_key(s[p]) : INF_KEY;
    if (!ordered || key < cut) nk[atomicAdd(&n_new, 1)] = pack(key, p);
  }
  if (n) atomicAdd(&n_fresh, n);
  __syncthreads();
  const int nn = n_new;
  if (threadIdx.x == 0 && n_fresh) atomicAdd(dcomp, (unsigned long long)n_fresh);
  if (nn == 0) {  // the merge keeps the beam as it is
    bool unexp = false;
    for (int i = threadIdx.x; i < ef; i += THREADS) unexp |= !se[i];
    if (__syncthreads_or(unexp) && threadIdx.x == 0) *flag = stamp;
    return;
  }
  const int pn = pow2_at_least(nn);
  for (int j = nn + threadIdx.x; j < pn; j += THREADS) nk[j] = ~0ull;
  __syncthreads();
  bitonic_sort(nk, pn);
  if (!ordered) bitonic_sort(bk, pf);

  bool unexp = false;
  for (int i = threadIdx.x; i < ef; i += THREADS) {
    const uint64_t k = bk[i];
    const int at = i + keys_below(nk, nn, uint32_t(k >> 32));
    if (at < ef) {
      const int src = int(uint32_t(k));
      bd[at] = sd[src];
      bi[at] = si[src];
      be[at] = se[src];
      unexp |= !se[src];
    }
  }
  for (int j = threadIdx.x; j < min(nn, ef); j += THREADS) {
    const uint64_t k = nk[j];
    const int at = j + keys_at_most(bk, ef, uint32_t(k >> 32));
    if (at < ef) {
      const int p = int(uint32_t(k));
      const bool f = fr[p];
      bd[at] = f ? s[p] : __int_as_float(0x7f800000);
      bi[at] = nb[p];
      be[at] = !f;
      unexp |= f;
    }
  }
  if (__syncthreads_or(unexp) && threadIdx.x == 0) *flag = stamp;
}

// a row's working memory in each stage, in bytes (ops/beam_hop.stage_bytes
// mirrors these)
size_t select_bytes(int E, int W) { return size_t(W + pow2_at_least(E) + E) * 4; }
size_t membership_bytes(int ef, int W, int C) {
  return size_t((1 << set_bits(ef + W)) + 2 * (1 << set_bits(C)) + C) * 4 + size_t(C);
}
size_t merge_bytes(int ef, int C) {
  return size_t(pow2_at_least(C) + pow2_at_least(ef)) * 8 + size_t(ef) * 9;
}

constexpr int MAX_DEVICES = 64;
std::atomic<int> smem_limits[MAX_DEVICES];  // 0: the card not asked yet

// the dynamic shared memory a block of these kernels may take on the current
// card; the first call on a card asks for it and raises each kernel's limit
// to it, so a launch is only its <<<>>>
int smem_limit(int& out) {
  int dev;
  if (const cudaError_t rc = cudaGetDevice(&dev)) return int(rc);
  if (dev < MAX_DEVICES && (out = smem_limits[dev].load(std::memory_order_relaxed))) return 0;
  int optin;
  if (const cudaError_t rc =
          cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return int(rc);
  const void* kernels[] = {reinterpret_cast<const void*>(select_kernel<false>),
                           reinterpret_cast<const void*>(membership_kernel<false>),
                           reinterpret_cast<const void*>(merge_kernel<false>)};
  int lim = optin;
  for (const void* k : kernels) {
    cudaFuncAttributes a;
    if (const cudaError_t rc = cudaFuncGetAttributes(&a, k)) return int(rc);
    lim = std::min(lim, optin - int(a.sharedSizeBytes));
  }
  for (const void* k : kernels)
    if (const cudaError_t rc =
            cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, lim))
      return int(rc);
  if (dev < MAX_DEVICES) smem_limits[dev].store(lim, std::memory_order_relaxed);
  out = lim;
  return 0;
}

// Launches a stage's kernel for B rows with `args`: the instantiation on
// shared memory where a row's `need` bytes fit the card's, else the one on
// the row's slice of the workspace `ws` (ws_row bytes a row), which must then
// hold them. The shared-memory one takes its working set's address space
// from its template argument, so its accesses stay shared-memory ones.
template <typename... P, typename... A>
int launch(void (*in_smem)(P...), void (*in_ws)(P...), size_t need, int B, void* ws,
           size_t ws_row, void* stream, A... args) {
  int lim;
  if (const int rc = smem_limit(lim)) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need <= size_t(lim)) {
    in_smem<<<B, THREADS, need, s>>>(args..., nullptr, 0);
  } else {
    if (!ws || ws_row < need || ws_row % 16) return int(cudaErrorInvalidValue);
    in_ws<<<B, THREADS, 0, s>>>(args..., static_cast<unsigned char*>(ws), ws_row);
  }
  return int(cudaGetLastError());
}

}  // namespace

// The dynamic shared memory a block of these kernels may take on the
// current card, in bytes: a stage whose row needs more runs on the workspace.
extern "C" int beam_hop_smem_limit(int* out) { return smem_limit(*out); }

// Each launcher below takes the workspace `ws` (null where every stage fits
// shared memory) and its bytes a row, `ws_row`, a multiple of 16 (ops/beam_hop.py
// sizes it from the same layouts).

// beam_i [B, ef] int32; beam_e [B, ef] bool (updated); hist [B, W] int32,
// ascending, with at least E entries -1 (updated); cur_ids [B, E] int32 and
// sel_valid [B, E] bool out; hops: an int64 counter, added to.
extern "C" int beam_select_launch(const void* beam_i, void* beam_e, void* hist, int B,
                                  int ef, int E, int W, void* cur_ids, void* sel_valid,
                                  void* hops, void* ws, size_t ws_row, void* stream) {
  if (B == 0) return 0;
  if (ef < 1 || ef > WIDTH_MAX || E < 1 || E > ef || W < E || W > WIDTH_MAX)
    return int(cudaErrorInvalidValue);
  return launch(select_kernel<false>, select_kernel<true>, select_bytes(E, W), B, ws, ws_row,
                stream, static_cast<const int*>(beam_i), static_cast<uint8_t*>(beam_e),
                static_cast<int*>(hist), ef, E, W, static_cast<int*>(cur_ids),
                static_cast<uint8_t*>(sel_valid), static_cast<unsigned long long*>(hops));
}

// beam_d [B, ef] float32, beam_i [B, ef] int32, hist [B, W] int32 (sorted),
// nbrs [B, C = E*M] int32, sel_valid [B, E] bool. CC = 0: fresh [B, C] bool
// out. 0 < CC < C: nbrs_out and fresh [B, CC] out, fresh first.
extern "C" int beam_membership_launch(const void* beam_d, const void* beam_i,
                                      const void* hist, const void* nbrs,
                                      const void* sel_valid, int B, int ef, int W, int C,
                                      int E, int M, int CC, void* fresh, void* nbrs_out,
                                      void* ws, size_t ws_row, void* stream) {
  if (B == 0) return 0;
  if (ef < 1 || ef > WIDTH_MAX || W < 1 || W > WIDTH_MAX || E < 1 || M < 1 ||
      C != E * M || C > WIDTH_MAX || CC < 0 || CC >= C)
    return int(cudaErrorInvalidValue);
  return launch(membership_kernel<false>, membership_kernel<true>,
                membership_bytes(ef, W, C), B, ws, ws_row, stream,
                static_cast<const float*>(beam_d), static_cast<const int*>(beam_i),
                static_cast<const int*>(hist), static_cast<const int*>(nbrs),
                static_cast<const uint8_t*>(sel_valid), ef, W, C, E, M, CC,
                static_cast<uint8_t*>(fresh), static_cast<int*>(nbrs_out));
}

// beam_d [B, ef] float32, beam_i [B, ef] int32, beam_e [B, ef] bool (all
// updated); scores [B, C] float32, nbrs [B, C] int32, fresh [B, C] bool;
// dcomp: an int64 counter, added to; flag: an int32 set to `stamp` where a
// row's new beam holds an unexpanded entry.
extern "C" int beam_merge_launch(void* beam_d, void* beam_i, void* beam_e,
                                 const void* scores, const void* nbrs, const void* fresh,
                                 int B, int ef, int C, void* dcomp, void* flag, int stamp,
                                 void* ws, size_t ws_row, void* stream) {
  if (B == 0) return 0;
  if (ef < 1 || ef > WIDTH_MAX || C < 1 || C > WIDTH_MAX) return int(cudaErrorInvalidValue);
  return launch(merge_kernel<false>, merge_kernel<true>, merge_bytes(ef, C), B, ws, ws_row,
                stream, static_cast<float*>(beam_d), static_cast<int*>(beam_i),
                static_cast<uint8_t*>(beam_e), static_cast<const float*>(scores),
                static_cast<const int*>(nbrs), static_cast<const uint8_t*>(fresh), ef, C,
                static_cast<unsigned long long*>(dcomp), static_cast<int*>(flag), stamp);
}
