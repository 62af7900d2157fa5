"""The plain reference that decides `correct`: exact k-NN and the distances of
given ids, in plain PyTorch on the benchmark's own copy of the data.

It imports nothing of the program (`flatnav_tpu_torch`), nothing of the JAX
package and no JAX, and takes nothing the program made: the harness hands it
the rows and queries it generated and the ids and distances the program
returned, which it only judges.

Metric names as the program's `create` takes them: `l2` is squared L2,
`angular` and `ip` are 1 - <q, x> (angular rows come unit length from
`synth.generate`); any other name raises.

float32 rows: float32 throughout, with TF32 off for the products
(`precision`): on an H100 a float32 matmul may otherwise run on TF32 tensor
cores. 8-bit rows (uint8, int8): every product in float64, blockwise, so the
distances are the exact integers (float64 holds every integer below 2^53;
d * 255^2 stays far below it at any width).

The control of the comparison runs the same k-NN one precision below the
rows' own (`lower=True`): for float32 rows the products' operands are rounded
to TF32's 10-bit mantissa (as the tensor cores round them, and the same on a
CPU, which has no TF32), and on the card TF32 is switched on; for 8-bit rows
the operands keep their top 4 bits (int4, `int4_round`).
"""

from __future__ import annotations

import contextlib

import torch

#: rows scored against a query block at a time (a [QB, ROW_BLOCK] f32 block)
ROW_BLOCK = 1 << 18
QUERY_BLOCK = 1024
#: answers whose distance is recomputed at a time ([A, k, d] f32 gathered)
ANSWER_ROWS = 1 << 22


@contextlib.contextmanager
def precision(tf32: bool):
    """Products in TF32 (`tf32=True`) or in float32, restored on exit."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away from
    zero), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def int4_round(x: torch.Tensor) -> torch.Tensor:
    """8-bit values -> the middle of their 16-wide bin (the top 4 bits kept:
    int4), as float64."""
    return torch.div(x.double(), 16, rounding_mode="floor") * 16 + 8


def _is_ip(metric: str) -> bool:
    """True for 1 - <q, x> (`angular`, `ip`), False for squared L2 (`l2`)."""
    if metric not in ("l2", "angular", "ip"):
        raise ValueError(f"unknown metric {metric!r}: the reference takes 'l2', 'angular', 'ip'")
    return metric != "l2"


#: rows' type -> the type their distances are computed in
_WORK_TYPES = {torch.float32: torch.float32, torch.uint8: torch.float64,
               torch.int8: torch.float64}


def _work_type(data: torch.Tensor, queries: torch.Tensor) -> torch.dtype:
    """The type the distances are computed in: float32 for float32 rows,
    float64 for 8-bit rows. Raises on any other type of rows or queries."""
    if data.dtype != queries.dtype or data.dtype not in _WORK_TYPES:
        raise ValueError(f"rows {data.dtype} and queries {queries.dtype}: the reference "
                         f"takes one of {list(_WORK_TYPES)} for both")
    return _WORK_TYPES[data.dtype]


def _operands(x: torch.Tensor, lower: bool) -> torch.Tensor:
    """Rows or queries as the products take them: as they are (8-bit in
    float64), or one precision lower where `lower`."""
    if x.dtype == torch.float32:
        return tf32_round(x) if lower else x
    return int4_round(x) if lower else x.double()


def _block_distances(q: torch.Tensor, rows: torch.Tensor, ip: bool,
                     lower: bool = False) -> torch.Tensor:
    """[QB, d] x [R, d] -> [QB, R] in the matmul form (squared L2, or 1 - dot
    for inner product), with the products' operands one precision lower
    where `lower`."""
    q0, r0 = _operands(q, False), _operands(rows, False)
    dots = _operands(q, True) @ _operands(rows, True).T if lower else q0 @ r0.T
    if ip:
        return 1.0 - dots
    return (q0 * q0).sum(1)[:, None] - 2.0 * dots + (r0 * r0).sum(1)[None, :]


def exact_knn(data: torch.Tensor, queries: torch.Tensor, k: int, metric: str = "l2",
              lower: bool = False):
    """-> (dists [B, k] ascending, ids [B, k] int64): the k rows of `data`
    nearest each query, by every distance, blocked over rows and queries.
    Distances are float32 for float32 rows, float64 for 8-bit rows."""
    n = data.shape[0]
    ip, work = _is_ip(metric), _work_type(data, queries)
    out_d, out_i = [], []
    with precision(lower):
        for qlo in range(0, queries.shape[0], QUERY_BLOCK):
            q = queries[qlo : qlo + QUERY_BLOCK]
            best_d = torch.full((q.shape[0], 0), float("inf"), dtype=work, device=q.device)
            best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
            for lo in range(0, n, ROW_BLOCK):
                dist = _block_distances(q, data[lo : lo + ROW_BLOCK], ip, lower)
                kk = min(k, dist.shape[1])
                bd, bi = torch.topk(dist, kk, dim=1, largest=False)
                cat_d = torch.cat([best_d, bd], 1)
                cat_i = torch.cat([best_i, bi + lo], 1)
                sel = torch.topk(cat_d, min(k, cat_d.shape[1]), dim=1, largest=False).indices
                best_d, best_i = cat_d.gather(1, sel), cat_i.gather(1, sel)
            order = torch.sort(best_d, dim=1, stable=True).indices
            out_d.append(best_d.gather(1, order))
            out_i.append(best_i.gather(1, order))
    return torch.cat(out_d), torch.cat(out_i)


def id_distances(data: torch.Tensor, queries: torch.Tensor, qidx: torch.Tensor,
                 ids: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Distance of query `qidx[a]` to each row `ids[a, j]`, in the direct
    form ((q - x)^2 summed, or 1 - q.x) -> [A, k], float32 for float32 rows
    and float64 (exact) for 8-bit rows. ids must lie in [0, n)."""
    k, d = ids.shape[1], data.shape[1]
    ip, work = _is_ip(metric), _work_type(data, queries)
    step = max(1, ANSWER_ROWS // max(k * d // 128, 1))
    out = []
    for lo in range(0, ids.shape[0], step):
        q = _operands(queries[qidx[lo : lo + step]][:, None, :], False)
        x = _operands(data[ids[lo : lo + step]], False)
        if ip:
            out.append(1.0 - (q * x).sum(-1))
        else:
            out.append(((q - x) ** 2).sum(-1))
    return torch.cat(out) if out else torch.empty((0, k), dtype=work, device=data.device)


def recall_hits(found: torch.Tensor, truth: torch.Tensor) -> int:
    """Number of true neighbours found: for each row, how many ids of
    `truth` [A, k] (distinct within a row) appear in `found` [A, k]. Divided
    by truth.numel() it is recall@k, the same count as the port's
    `bench/metrics.recall_at_k` set arithmetic."""
    return int((truth[:, :, None] == found[:, None, :]).any(-1).sum())
