"""The plain reference that decides `correct`: exact k-NN and the distances of
given ids, in plain PyTorch on the benchmark's own copy of the data.

It imports nothing of the program (`flatnav_tpu_torch`), nothing of the JAX
package and no JAX, and takes nothing the program made: the harness hands it
the rows and queries it generated and the ids and distances the program
returned, which it only judges.

float32 throughout, with TF32 off for the products (`precision`): on an H100
a float32 matmul may otherwise run on TF32 tensor cores. The control of the
comparison runs the same k-NN with `tf32=True`: the products' operands are
rounded to TF32's 10-bit mantissa (as the tensor cores round them, and the
same on a CPU, which has no TF32), and on the card TF32 is switched on.
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


def _block_distances(q: torch.Tensor, rows: torch.Tensor, metric: str,
                     tf32: bool = False) -> torch.Tensor:
    """[QB, d] x [R, d] -> [QB, R] in the matmul form (squared L2, or 1 - dot
    for inner product), with the products' operands rounded to TF32 where
    `tf32`."""
    dots = tf32_round(q) @ tf32_round(rows).T if tf32 else q @ rows.T
    if metric == "ip":
        return 1.0 - dots
    return (q * q).sum(1)[:, None] - 2.0 * dots + (rows * rows).sum(1)[None, :]


def exact_knn(data: torch.Tensor, queries: torch.Tensor, k: int, metric: str = "l2",
              tf32: bool = False):
    """-> (dists [B, k] ascending, ids [B, k] int64): the k rows of `data`
    nearest each query, by every distance, blocked over rows and queries."""
    n = data.shape[0]
    out_d, out_i = [], []
    with precision(tf32):
        for qlo in range(0, queries.shape[0], QUERY_BLOCK):
            q = queries[qlo : qlo + QUERY_BLOCK]
            best_d = torch.full((q.shape[0], 0), float("inf"), device=q.device)
            best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
            for lo in range(0, n, ROW_BLOCK):
                dist = _block_distances(q, data[lo : lo + ROW_BLOCK], metric, tf32)
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
    form ((q - x)^2 summed, or 1 - q.x), float32 -> [A, k]. ids must lie in
    [0, n)."""
    k, d = ids.shape[1], data.shape[1]
    step = max(1, ANSWER_ROWS // max(k * d // 128, 1))
    out = []
    for lo in range(0, ids.shape[0], step):
        q = queries[qidx[lo : lo + step]][:, None, :]
        x = data[ids[lo : lo + step]]
        if metric == "ip":
            out.append(1.0 - (q * x).sum(-1))
        else:
            out.append(((q - x) ** 2).sum(-1))
    return torch.cat(out) if out else torch.empty((0, k), device=data.device)


def recall_hits(found: torch.Tensor, truth: torch.Tensor) -> int:
    """Number of true neighbours found: for each row, how many ids of
    `truth` [A, k] (distinct within a row) appear in `found` [A, k]. Divided
    by truth.numel() it is recall@k, the same count as the port's
    `bench/metrics.recall_at_k` set arithmetic."""
    return int((truth[:, :, None] == found[:, None, :]).any(-1).sum())
