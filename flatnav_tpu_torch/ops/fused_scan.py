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
`scan_buckets_plain`. The kernel has two variants, chosen by shape alone
(`scan_variant`): "wgmma" (TMA-fed wgmma, bf16 rows with d % 8 == 0 and
64 <= d <= 384) and "mma" (mma.sync; 8-bit rows and every other shape).
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

#: defaults: queries per chunk granule / rows per tile / bucket width.
#: S = T/L must be a multiple of 128 (the binning matches the JAX package's
#: for the same L and T).
_QB = 512
_TILE = 2048
_L = 16

#: each block streams its 128-bucket share of a [T, d] row tile from L2, once
#: for every query block (128 queries for "wgmma", 64 for "mma"); 4 MiB per
#: tile keeps the tiles of the blocks in flight inside the 50 MB L2. Keys and
#: the running min/argmin live in registers, and the kernel's shared memory
#: holds the block's query tile and 64-column slices of 128 rows (an 8-stage
#: ring for "wgmma", one buffer for "mma"), none of which grows with T, so no
#: other budget bounds T.
_ROWS_BYTES = 4 << 20

#: bound on the phase-A [qc, N/L] f32+i32 bucket summary. Past it L grows
#: while the tile allows, then the query batch is processed in chunks.
_SUMMARY_BYTES = 2 << 30

#: the native 8-bit path's keys are exact only while the f32 accumulation
#: is: d * 255^2 < 2^24  =>  d <= 257
_NATIVE_INT_MAX_D = 257

_ROW_TYPES = {torch.bfloat16: 0, torch.uint8: 1, torch.int8: 2}


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


def scan_buckets_plain(
    q_bf: torch.Tensor, rows: torch.Tensor, pen: torch.Tensor,
    nlim: int, t: int, L: int,
):
    """Plain version of the kernel: per row tile, the [qc, T] keys, then the
    strided bucket min over the L slices (first minimum wins ties)."""
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


def _lib():
    fn = _build.load("fused_scan").fused_scan_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, i, i, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


#: kernel variant -> its number in the C interface
VARIANTS = {"mma": 0, "wgmma": 1}


def scan_variant(q_bf: torch.Tensor, rows: torch.Tensor, pen: torch.Tensor, t: int, L: int) -> str:
    """The kernel variant `scan_buckets` launches for these (contiguous)
    arguments, by shape alone: "wgmma" takes bf16 rows whose 64 <= d <= 384
    and d % 8 == 0 (TMA reads rows of a multiple of 16 bytes, from
    16-byte-aligned tensors; penalties are read in 8-byte pairs) with
    L <= 256 slices (packed eight bits each) and S = T/L a multiple of its
    128-bucket tile; "mma" takes the rest, 8-bit rows included. The C entry
    only refuses a "wgmma" launch at a shape outside this rule."""
    d = rows.shape[1]
    ok = (
        rows.dtype == torch.bfloat16 and d % 8 == 0 and 64 <= d <= 384 and L <= 256
        and t % L == 0 and (t // L) % 128 == 0
        and rows.data_ptr() % 16 == 0 and q_bf.data_ptr() % 16 == 0
        and pen.data_ptr() % 8 == 0
    )
    return "wgmma" if ok else "mma"


def scan_buckets(
    q_bf: torch.Tensor, rows: torch.Tensor, pen: torch.Tensor,
    nlim: int, t: int, L: int,
):
    """Phase A: ([qc, nb] f32 bucket minima, [qc, nb] i32 global ids), with
    nb = ceil(N / t) * (t / L).

    q_bf [qc, d] bf16; rows [N, d] bf16, uint8 or int8; pen [N] f32 (the L2
    ||row||^2 term, zeros for IP); rows at or past `nlim` score +inf.
    `scan_buckets.launches` counts kernel launches, and
    `scan_buckets.variants` the launches of each variant."""
    if rows.device.type == "cpu":
        return scan_buckets_plain(q_bf, rows, pen, nlim, t, L)
    if rows.dtype not in _ROW_TYPES or q_bf.dtype != torch.bfloat16:
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
    out_min = torch.empty((qc, nb), dtype=torch.float32, device=rows.device)
    out_id = torch.empty((qc, nb), dtype=torch.int32, device=rows.device)
    rc = _lib()(
        q_bf.data_ptr(), rows.data_ptr(), _ROW_TYPES[rows.dtype],
        pen.data_ptr(), qc, n, d, min(int(nlim), n), t, L, nb, VARIANTS[variant],
        out_min.data_ptr(), out_id.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    _build.check(rc, "scan_buckets")
    scan_buckets.launches += 1
    scan_buckets.variants[variant] += 1
    return out_min, out_id


scan_buckets.launches = 0
scan_buckets.variants = dict.fromkeys(VARIANTS, 0)


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
    the rerank. uint8/int8 tables at d <= 257 ride the kernel unpromoted,
    with exact integer keys; other tables are scanned through a bf16 copy.
    `bucket_l`, `tile_size`, `query_block` override the automatic shapes
    and `summary_bytes` bounds the phase-A summary (the query batch is
    chunked past it). Phase B is an exact top-`rerank` where the JAX
    package uses `approx_min_k`; its ties go to the lowest id.

    `exact_rerank=False` skips the rerank's row gather and ranks the
    shortlist by the kernel's keys, calibrated back to distances
    (key + ||q||^2 for L2, 1 + key/2 for IP): exact for bf16-rounded
    inputs, and exact outright on the native 8-bit path."""
    n, d = dataset.shape
    b = queries.shape[0]
    r = max(rerank, k)
    n_limit = n if n_valid is None else int(n_valid)
    native_int = dataset.dtype in (torch.uint8, torch.int8) and d <= _NATIVE_INT_MAX_D
    ds_bf = dataset if native_int else dataset.to(torch.bfloat16)

    L, t, qb, qc = _pick_shapes(
        n, b, d, ds_bf.element_size(), _tile_request(tile_size, bucket_l),
        query_block, bucket_l,
        _SUMMARY_BYTES if summary_bytes is None else summary_bytes,
    )
    # the norms come from the bf16-ROUNDED rows the kernel's dots see, so
    # the key ranks distances to one consistent set of vectors
    if metric == MetricType.L2:
        pen = squared_norms(ds_bf)
    else:
        pen = torch.zeros(n, dtype=torch.float32, device=dataset.device)
    nlim = min(n_limit, n)
    q_bf = queries.to(torch.bfloat16)

    out_d, out_i = [], []
    for lo in range(0, b, qc):
        q_raw = queries[lo : lo + qc]
        bmin, bids = scan_buckets(q_bf[lo : lo + qc], ds_bf, pen, nlim, t, L)
        cand_key, cand_i = smallest_k(bmin, bids, min(r, bmin.shape[1]))
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


__all__ = ["fused_knn", "scan_buckets", "scan_buckets_plain", "scan_variant"]
