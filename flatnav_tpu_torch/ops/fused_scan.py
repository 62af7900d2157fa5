"""Two-phase kNN scan with the matmul and a bucket minimum fused (kernel K1).

Counterpart of flatnav_tpu/ops/fused_scan.py. Phase A scores every row
against every query with one bf16 product (f32 accumulation) and reduces
each row tile's T columns into S = T/L strided buckets in the same pass
(`scan_buckets`), so the [B, N] key matrix never reaches device memory:
only a [B, N/L] f32 minimum + i32 id summary does. Phase B takes the
`rerank` smallest buckets per query, and the shortlist is reranked by exact
distances (or, with `exact_rerank=False`, ranked by the kernel's own keys).

On a CUDA tensor `scan_buckets` launches the hand-written kernel
`csrc/fused_scan.cu` (it replaces the Pallas TPU kernel
flatnav_tpu/ops/fused_scan.py:_scan_kernel); on a CPU tensor it runs
`scan_buckets_plain`. The kernel has eight variants, chosen by shape and
type alone (`scan_variant`): "wgmma_narrow" (TMA-fed wgmma on 64-byte
rows, bf16 with d % 8 == 0 and d <= 32), "wgmma" (the same on 128-byte
rows, bf16 with d % 8 == 0 and d <= 384; TMA reads the columns of a box
past d as zeros), "wgmma_wide" (the same for 384 < d <= 1024, in clusters
of two blocks that share each row load), "wgmma_deep" (bf16 with d % 8 ==
0 past d = 1024: queries and rows both stream through the ring, depth
chunk by depth chunk), "wgmma_int8" (integer wgmma,
8-bit rows and queries of one type, d % 16 == 0), "wgmma_int8_packed"
(its consumers on 8-bit rows TMA cannot stride, d % 4 == 0, copied into
shared memory by the block's producer warps; MS SPACEV's d = 100),
"wgmma_mixed" (8-bit rows against bf16 queries, d % 4 == 0, d <= 256: the
TPU kernel's own form for 8-bit tables; the rows are widened to bf16 in
registers and fed to wgmma from there) and "mma" (mma.sync; every other
shape). `fused_knn` pads a bf16 copy whose d is not a multiple of 8 with
zero columns, hands 8-bit queries of an 8-bit table to the kernel as they
are, and other queries of an 8-bit table as bf16.
A true neighbor is lost only if another row of its L-bucket scores better,
or if bf16 rounding pushes its bucket past the shortlist; both are measured
against the exact oracle in the tests.
"""

from __future__ import annotations

import ctypes

import torch

from flatnav_tpu_torch import _build
from flatnav_tpu_torch.ops.distances import (
    MetricType,
    query_block_distances,
    smallest_k,
    squared_norms,
)
from flatnav_tpu_torch.utils.profiling import count, span, traced

#: defaults: queries per chunk granule / rows per tile / bucket width.
#: S = T/L must be a multiple of 128 (the binning matches the JAX package's
#: for the same L and T).
_QB = 512
_TILE = 2048
_L = 16

#: each block streams its 128-bucket share of a [T, d] row tile from L2, once
#: for every query block (128 queries for the single-block wgmma variants
#: and "wgmma_mixed", a
#: cluster of 2 x 64 for "wgmma_wide", of 2 x 128 for "wgmma_deep", 64 for
#: "mma"); 4 MiB per tile keeps
#: the tiles of the blocks in flight inside the 50 MB L2. Keys and the running
#: min/argmin live in registers, and the kernel's shared memory holds the
#: block's query tile and 128- or 64-byte-wide slices of 128 rows (an 8-stage
#: ring for the single-block wgmma variants, two 3-stage rings for
#: "wgmma_wide", a 6-stage ring of query and row boxes for "wgmma_deep", one
#: buffer for "mma"), none of which grows with T, so no
#: other budget bounds T.
_ROWS_BYTES = 4 << 20

#: bound on the phase-A [qc, N/L] f32+i32 bucket summary. Past it L grows
#: while the tile allows, then the query batch is processed in chunks.
_SUMMARY_BYTES = 2 << 30

#: the native 8-bit path's keys are exact only while the f32 accumulation
#: is: d * 255^2 < 2^24  =>  d <= 257
_NATIVE_INT_MAX_D = 257

#: element type -> its number in the C interface (rows and queries)
_ROW_TYPES = {torch.bfloat16: 0, torch.uint8: 1, torch.int8: 2}
_INT8 = (torch.uint8, torch.int8)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tile_request(tile_size: int, bucket_l: int | None) -> int:
    """The row tile `fused_knn` asks `_pick_shapes` for: at the default
    tile and a given L, at least 128*L rows (one 128-bucket tile)."""
    if bucket_l is None or tile_size != _TILE:
        return tile_size
    return max(_TILE, 128 * bucket_l)


def _pick_shapes(
    n: int, b: int, d: int, itemsize: int,
    tile_req: int, qb_req: int, l_req: int | None,
    summary_bytes: int,
):
    """Pick (L, t, qb, qc): bucket width, row tile, query granule and query
    chunk. Same rules as the JAX package's, with the row-tile cap taken
    from L2 residency instead of VMEM; the query granule only rounds the
    chunk (the kernel's own query sub-tile is fixed)."""
    t_cap = max(128, 128 * ((_ROWS_BYTES // (d * itemsize)) // 128))
    l_cap = max(1, t_cap // 128)

    if l_req is not None:
        L = l_req
    else:
        # shrink for tiny tables (>= ~4096 buckets keeps top-k bucket
        # collisions rare), then grow for the summary bound
        L = _L
        while L > 1 and n // L < 4096:
            L //= 2
        b_eff = _round_up(max(b, 1), 8)
        while (
            8 * b_eff * (n // L) > summary_bytes
            and n // (2 * L) >= 4096
            and 2 * L <= l_cap
        ):
            L *= 2

    t = max(128 * L, min(tile_req, _round_up(n, 128 * L)))
    if t % (128 * L):
        raise ValueError(f"tile_size {t} must be a multiple of 128*L")
    t = min(t, max(128 * L, 128 * L * (t_cap // (128 * L))))

    qb = min(qb_req, _round_up(max(b, 1), 8))
    n_tiles = -(-n // t)
    nb = n_tiles * (t // L)
    b_pad = _round_up(max(b, 1), qb)
    qc_max = max(qb, (summary_bytes // (8 * nb)) // qb * qb)
    if qc_max >= b_pad:
        qc = b_pad
    else:
        chunks = -(-b_pad // qc_max)
        qc = _round_up(-(-b_pad // chunks), qb)
    return L, t, qb, qc


def scan_operands(dataset: torch.Tensor, queries: torch.Tensor):
    """(rows, queries) as `fused_knn` hands them to `scan_buckets`.

    uint8/int8 tables at d <= 257 stay as they are, at any d (a width TMA
    cannot stride takes "wgmma_int8_packed", which copies the rows itself);
    their queries too where they have the table's type (else bf16, exact for
    8-bit values). Other tables go through one bf16 copy, and so do their
    queries; where d is not a multiple of 8 that copy carries zero columns
    up to the next multiple, which add exactly 0 to every product (TMA reads
    rows of a multiple of 16 bytes). No wider copy is made for d < 64: the
    kernel's boxes read the columns past d as zeros."""
    n, d = dataset.shape
    if dataset.dtype in _INT8 and d <= _NATIVE_INT_MAX_D:
        q = queries if queries.dtype == dataset.dtype else queries.to(torch.bfloat16)
        return dataset, q
    dp = _round_up(d, 8)
    if dp == d:
        return dataset.to(torch.bfloat16), queries.to(torch.bfloat16)
    rows = torch.zeros((n, dp), dtype=torch.bfloat16, device=dataset.device)
    rows[:, :d] = dataset
    q = torch.zeros((queries.shape[0], dp), dtype=torch.bfloat16, device=queries.device)
    q[:, :d] = queries
    return rows, q


def scan_buckets_plain(
    q_bf: torch.Tensor, rows: torch.Tensor, pen: torch.Tensor,
    nlim: int, t: int, L: int,
):
    """Plain version of the kernel: per row tile, the [qc, T] keys, then the
    strided bucket min over the L slices (first minimum wins ties). The
    queries are bf16 or 8-bit; both are exact in f32."""
    qc = q_bf.shape[0]
    n = rows.shape[0]
    s = t // L
    n_tiles = -(-n // t)
    dev = rows.device
    qf = q_bf.to(torch.float32)
    out_min = torch.empty((qc, n_tiles * s), dtype=torch.float32, device=dev)
    out_id = torch.empty((qc, n_tiles * s), dtype=torch.int32, device=dev)
    iota_t = torch.arange(t, device=dev)
    iota_s = torch.arange(s, dtype=torch.int32, device=dev)
    for j in range(n_tiles):
        r0 = j * t
        tile = rows[r0 : r0 + t].to(torch.float32)
        pen_t = pen[r0 : r0 + t]
        if tile.shape[0] < t:  # the last tile's rows past the table are zeros
            tile = torch.nn.functional.pad(tile, (0, 0, 0, t - tile.shape[0]))
            pen_t = torch.nn.functional.pad(pen_t, (0, t - pen_t.shape[0]))
        dots = qf @ tile.T
        key = torch.where(r0 + iota_t < nlim, pen_t[None, :] - 2.0 * dots,
                          float("inf"))
        bmin, argl = key.view(qc, L, s).min(dim=1)
        out_min[:, j * s : (j + 1) * s] = bmin
        out_id[:, j * s : (j + 1) * s] = r0 + argl.to(torch.int32) * s + iota_s
    return out_min, out_id


def exact_keys(q: torch.Tensor, rows: torch.Tensor) -> bool:
    """Whether the kernel's minima and ids must be bit-equal to
    `scan_buckets_plain`'s: 8-bit rows against 8-bit or integer-valued
    queries small enough that every partial sum is an integer of at most
    2^24 (d * 255 * max |q| <= 2^24: |q| <= 256 at d = 256), so the order
    of the sums does not matter. Other keys may differ in the last bits of
    the f32 sums. Reads the queries back to the host (a device sync); for
    the tests and the bench, not the scan's path."""
    if rows.dtype not in _INT8:
        return False
    if q.numel() == 0:
        return True
    if q.dtype not in _INT8 and not bool(torch.equal(q, q.round())):
        return False
    return rows.shape[1] * 255 * float(q.float().abs().amax()) <= 2**24


def _lib():
    fn = _build.load("fused_scan").fused_scan_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, i, i, i, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


#: kernel variant -> its number in the C interface
VARIANTS = {"mma": 0, "wgmma": 1, "wgmma_wide": 2, "wgmma_int8": 3, "wgmma_int8_packed": 4,
            "wgmma_narrow": 5, "wgmma_deep": 6, "wgmma_mixed": 7}
#: variants that take bf16 queries of an 8-bit table (`scan_buckets` widens
#: 8-bit queries of the other type for them)
_BF16_QUERIES = ("mma", "wgmma_mixed")


def scan_variant(q: torch.Tensor, rows: torch.Tensor, pen: torch.Tensor, t: int, L: int) -> str:
    """The kernel variant `scan_buckets` launches for these (contiguous)
    arguments, by shape and type alone. Every variant but "mma" needs L <=
    256 slices (packed eight bits each), S = T/L a multiple of its
    128-bucket tile, 16-byte-aligned rows and queries and 8-byte-aligned
    penalties (read in pairs):
      "wgmma_narrow"       bf16 rows and queries, d % 8 == 0, d <= 32;
      "wgmma"              the same with 32 < d <= 384;
      "wgmma_wide"         the same with 384 < d <= 1024;
      "wgmma_deep"         the same with d > 1024 (OpenAI's 1536 and 3072);
      "wgmma_int8"         uint8 or int8 rows with queries of the same type,
                           d % 16 == 0, d <= 256;
      "wgmma_int8_packed"  the same with d % 4 == 0 and d % 16 != 0 (rows
                           TMA cannot stride: MS SPACEV's d = 100);
      "wgmma_mixed"        uint8 or int8 rows with bf16 queries (or 8-bit
                           ones of the other type, widened to bf16), d % 4
                           == 0, d <= 256;
      "mma"                everything else.
    The C entry refuses a launch outside the rule of the variant it names."""
    d = rows.shape[1]
    common = (
        L <= 256 and t % L == 0 and (t // L) % 128 == 0
        and rows.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
        and pen.data_ptr() % 8 == 0
    )
    if not common:
        return "mma"
    if rows.dtype == q.dtype == torch.bfloat16 and d % 8 == 0:
        if d <= 32:
            return "wgmma_narrow"
        if d <= 384:
            return "wgmma"
        if d <= 1024:
            return "wgmma_wide"
        return "wgmma_deep"
    if rows.dtype in _INT8 and d <= 256 and d % 4 == 0:
        if q.dtype != rows.dtype:
            return "wgmma_mixed"
        return "wgmma_int8" if d % 16 == 0 else "wgmma_int8_packed"
    return "mma"


def launch_as(variant: str, q: torch.Tensor, rows: torch.Tensor, pen: torch.Tensor, nlim: int,
              t: int, L: int, out_min: torch.Tensor, out_id: torch.Tensor) -> int:
    """K1's C entry launched as `variant` on CUDA operands as `scan_buckets`
    passes them (nlim <= N; out_min / out_id [qc, nb]) -> the entry's
    code: 0, or 1 (cudaErrorInvalidValue) where the variant's rule refuses
    the launch. Counts nothing: `scan_buckets` is the counted path, and the
    bench times other variants through this."""
    return _lib()(
        q.data_ptr(), _ROW_TYPES[q.dtype], rows.data_ptr(), _ROW_TYPES[rows.dtype],
        pen.data_ptr(), q.shape[0], rows.shape[0], rows.shape[1], nlim, t, L, out_min.shape[1],
        VARIANTS[variant], out_min.data_ptr(), out_id.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream,
    )


def scan_buckets(
    q_bf: torch.Tensor, rows: torch.Tensor, pen: torch.Tensor,
    nlim: int, t: int, L: int,
):
    """Phase A: ([qc, nb] f32 bucket minima, [qc, nb] i32 global ids), with
    nb = ceil(N / t) * (t / L).

    q_bf [qc, d] bf16, or 8-bit with 8-bit rows; rows [N, d] bf16, uint8
    or int8; pen [N] f32 (the L2 ||row||^2 term, zeros for IP); rows at or
    past `nlim` score +inf. 8-bit queries that take "mma" or "wgmma_mixed"
    are widened to bf16 (exact). `scan_buckets.launches` counts kernel
    launches, and `scan_buckets.variants` the launches of each variant."""
    if rows.device.type == "cpu":
        return scan_buckets_plain(q_bf, rows, pen, nlim, t, L)
    q_types = (torch.bfloat16, *_INT8) if rows.dtype in _INT8 else (torch.bfloat16,)
    if rows.dtype not in _ROW_TYPES or q_bf.dtype not in q_types:
        raise TypeError(
            f"scan_buckets: unsupported dtypes rows={rows.dtype} q={q_bf.dtype}"
        )
    if t % L or (t // L) % 128:
        raise ValueError(f"tile {t} must be a multiple of 128*L (L={L})")
    qc, d = q_bf.shape
    n = rows.shape[0]
    nb = -(-n // t) * (t // L)
    rows = rows.contiguous()
    q_bf = q_bf.contiguous()
    pen = pen.to(torch.float32).contiguous()
    if pen.shape != (n,) or rows.shape[1] != d:
        raise ValueError("scan_buckets: rows, queries and pen disagree in shape")
    if not (q_bf.device == pen.device == rows.device):
        raise ValueError("scan_buckets: tensors are on different devices")
    variant = scan_variant(q_bf, rows, pen, t, L)
    if variant in _BF16_QUERIES:
        q_bf = q_bf.to(torch.bfloat16)
    out_min = torch.empty((qc, nb), dtype=torch.float32, device=rows.device)
    out_id = torch.empty((qc, nb), dtype=torch.int32, device=rows.device)
    _build.check(launch_as(variant, q_bf, rows, pen, min(int(nlim), n), t, L, out_min, out_id),
                 "scan_buckets")
    scan_buckets.launches += 1
    scan_buckets.variants[variant] += 1
    return out_min, out_id


scan_buckets.launches = 0
scan_buckets.variants = dict.fromkeys(VARIANTS, 0)


@traced("scan")
def fused_knn(
    dataset: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    metric: MetricType = MetricType.L2,
    rerank: int = 32,
    bucket_l: int | None = None,
    tile_size: int = _TILE,
    query_block: int = _QB,
    n_valid: int | None = None,
    exact_rerank: bool = True,
    summary_bytes: int | None = None,
):
    """Two-phase kNN scan -> (dists [B, k] ascending, ids [B, k] int32).

    Distances are exact (float32, or exact int32 for integer tables) after
    the rerank. uint8/int8 tables at d <= 257 ride the kernel unpromoted
    (and so do their queries where they have the table's type; other
    queries go as bf16, as the JAX package casts them), with exact keys for
    integer-valued queries; other tables are scanned through a bf16 copy,
    padded with zero columns to a multiple of 8 (`scan_operands`).
    `bucket_l`, `tile_size`, `query_block` override the automatic shapes
    and `summary_bytes` bounds the phase-A summary (the query batch is
    chunked past it). Phase B is an exact top-`rerank` (`smallest_k`:
    kernel K3 on the card) where the JAX package uses `approx_min_k`; its
    ties go to the lowest id.

    `exact_rerank=False` skips the rerank's row gather and ranks the
    shortlist by the kernel's keys, calibrated back to distances
    (key + ||q||^2 for L2, 1 + key/2 for IP): exact for bf16-rounded
    inputs, and exact outright on the native 8-bit path.

    Traced (`utils.profiling`) as `scan`, with the stages `scan.prepare`
    (the table's operands and norms, made every call), then per query
    chunk `scan.k1`, `scan.k3` and `scan.rerank`; counter `scan.queries`."""
    n, d = dataset.shape
    b = queries.shape[0]
    r = max(rerank, k)
    n_limit = n if n_valid is None else int(n_valid)
    count("scan.queries", b)
    with span("scan.prepare"):
        ds_bf, q_bf = scan_operands(dataset, queries)

        L, t, qb, qc = _pick_shapes(
            n, b, d, ds_bf.element_size(), _tile_request(tile_size, bucket_l),
            query_block, bucket_l,
            _SUMMARY_BYTES if summary_bytes is None else summary_bytes,
        )
        # the norms come from the bf16-ROUNDED rows the kernel's dots see, so
        # the key ranks distances to one consistent set of vectors
        if metric == MetricType.L2:
            pen = squared_norms(ds_bf[:, :d])
        else:
            pen = torch.zeros(n, dtype=torch.float32, device=dataset.device)
    nlim = min(n_limit, n)

    out_d, out_i = [], []
    for lo in range(0, b, qc):
        q_raw = queries[lo : lo + qc]
        with span("scan.k1"):
            bmin, bids = scan_buckets(q_bf[lo : lo + qc], ds_bf, pen, nlim, t, L)
        with span("scan.k3"):
            cand_key, cand_i = smallest_k(bmin, bids, min(r, bmin.shape[1]))
        with span("scan.rerank"):
            if not exact_rerank:
                kk, ids = cand_key[:, :k], cand_i[:, :k]
                if metric == MetricType.L2:
                    dist = kk + squared_norms(q_raw.to(torch.float32))[:, None]
                else:
                    dist = 1.0 + 0.5 * kk
                out_d.append(torch.where(torch.isinf(kk), float("inf"), dist))
                out_i.append(ids)
                continue
            # invalid winners carry an inf key: keep them inf, or their clipped
            # rows would re-score finitely and outrank real neighbors
            rows = dataset[cand_i.clamp(max=n - 1).long()]
            exact = query_block_distances(q_raw, rows, metric)
            exact = torch.where(torch.isinf(cand_key), float("inf"), exact)
            order = torch.argsort(exact, dim=1, stable=True)[:, :k]
            out_d.append(exact.gather(1, order))
            out_i.append(cand_i.gather(1, order))
    return torch.cat(out_d), torch.cat(out_i)


__all__ = ["fused_knn", "scan_buckets", "scan_buckets_plain", "scan_operands",
           "scan_variant"]
