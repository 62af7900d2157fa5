"""The card's peaks and the least time each kernel's function could take.

A copy of the port's `bench/measure.py` peaks and bounds (K1 `scan_bound`,
K2 `gather_bound`, K3 `select_bound`), kept here so that the yardstick does
not move with the program. A bound is the larger of the bytes the function
must move (each input read once, each output written once) over the memory
rate and its operations over the peak rate for their type, in ms. It counts
what the function needs, not what an implementation does, so a roofline
share reads the same work whatever implements it.

`*_call` take the arguments of the wrapper call they bound, as the port's
callers pass them.
"""

from __future__ import annotations

import torch

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
F32_FLOP_PER_S = 67e12


def _bound(nbytes: float, flops: float, flop_per_s: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def gather_bound(vectors: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor):
    """-> (ms, "bytes" or "operations") of K2 at these arguments: the
    distinct rows the ids name, the ids, queries and [B, C] f32 output,
    each moved once; 3 f32 operations per gathered element."""
    b, c = ids.shape
    d = vectors.shape[1]
    uniq = int(torch.unique(ids).numel())
    nbytes = uniq * d * vectors.element_size() + ids.numel() * 4 + queries.numel() * 4 + b * c * 4
    return _bound(nbytes, 3 * b * c * d, F32_FLOP_PER_S)


def scan_bound(qc: int, n: int, d: int, nb: int, row_bytes: int = 2, q_bytes: int = 2):
    """-> (ms, "bytes" or "operations") of K1 over qc queries of `q_bytes`
    bytes an element and an [n, d] table of `row_bytes`-byte elements: the
    queries, table and penalties read once, the [qc, nb] f32 + i32 summary
    written once; 2 qc n d operations, at the int8 peak where rows and
    queries are both 8-bit and at the bf16 peak otherwise."""
    nbytes = qc * d * q_bytes + n * d * row_bytes + n * 4 + qc * nb * 8
    rate = INT8_OP_PER_S if row_bytes == q_bytes == 1 else BF16_FLOP_PER_S
    return _bound(nbytes, 2 * qc * n * d, rate)


def select_bound(b: int, w: int, k: int, ids: str = "implicit", prior: bool = False):
    """-> (ms, "bytes") of K3 over a [b, w] float32 key matrix -> k: each
    key read once (4 B), the [b, k] f32 + i32 result written once, a [b, k]
    prior of f32 + i32 read once where one is given, and the ids of the k
    pairs a row returns (4 B each) where the ids are a [b, w] tensor
    ("full") or one [1, w] row ("row"), none where they are implicit."""
    if ids not in ("full", "row", "implicit"):
        raise ValueError(f"select_bound: ids must be full, row or implicit, not {ids!r}")
    nbytes = b * w * 4 + b * k * (8 + (8 if prior else 0) + (0 if ids == "implicit" else 4))
    return _bound(nbytes, 0, BF16_FLOP_PER_S)


def gather_call(vectors, ids, queries, *args, **kwargs) -> float:
    """ms of `gather_distances(vectors, ids, queries, metric)`."""
    return gather_bound(vectors, ids, queries)[0]


def scan_call(q, rows, pen, nlim, t, L, *args, **kwargs) -> float:
    """ms of `scan_buckets(q, rows, pen, nlim, t, L)`. The width is the
    rows' own: a table whose bf16 copy carries padding columns (d not a
    multiple of 8) would count them."""
    n, d = rows.shape
    nb = -(-n // t) * (t // L)
    q_bytes = 1 if (q.element_size() == 1 and rows.element_size() == 1) else 2
    return scan_bound(q.shape[0], n, d, nb, rows.element_size(), q_bytes)[0]


def select_call(keys, k, ids=None, id_base=0, cols=None, prior=None) -> float:
    """ms of `select_k(keys, k, ids=, id_base=, cols=, prior=)`: an id
    tensor of one row, or expanded from one (stride 0), is one row."""
    b, w = keys.shape
    if ids is None:
        kind = "implicit"
    elif ids.dim() == 1 or ids.shape[0] == 1 or (b > 1 and ids.stride(0) == 0):
        kind = "row"
    else:
        kind = "full"
    return select_bound(b, w, k, kind, prior is not None)[0]
