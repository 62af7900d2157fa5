"""Cluster-routed pruned scan (experimental).

Counterpart of flatnav_tpu/ops/routed_scan.py: an IVF-style scan that reads
only the blocks of the table a group of queries votes for, shaped so that
every hot operation stays a dense matmul or a copy of whole blocks.

  build (offline, once per table):
    1. k-means centroids on a sample (quantization/kmeans.py, the trainer
       the PQ layer uses), one centroid per `block` rows;
    2. BALANCED assignment: every row goes to its nearest centroid with
       spare capacity (capacity = block; a full cell passes the row on to
       its next-nearest cell). Each cell then IS one fixed-size block, so
       routing granularity equals layout granularity;
    3. the cells are laid out one after another (the routed analog of the
       reference's cache-locality reordering, util/Reordering.h:26-117),
       each padded to exactly `block` rows (pad slots carry id -1 and are
       masked at query time).

  search:
    1. route: [B, nb] query -> block-centroid distances (one matmul), the
       `probes` nearest blocks per query;
    2. sort the queries by their primary block, so that neighbors in
       routing space are batch neighbors too;
    3. per group of `group_size` queries: vote a UNION of `union_blocks`
       blocks, copy them out of the cell-ordered table as whole
       [block, d] slabs, and scan the union EXACTLY in float32
       ([G, d] x [d, U*block], one matmul).

Like fast_knn, the distances returned are exact float32; the only
approximation is which blocks are scanned. Two bounds shape its recall and
`bench/profile_routed_scan.py` measures both: the routing ceiling (the
share of true neighbors whose block is among a query's top-P routed blocks)
and the union capture (the share of a query's probe list that its group's
union holds; a group's secondary probes are query-specific, so a union of
U blocks drops many of them). Recall is therefore workload-shaped: callers
measure it and qualify the engine at their target, as the headline
benchmark does for the fast engine. Whether the scan beats `fast_knn` on a
given card is a measurement, not a property of the design; PERF.md records
it for the H100.

Every k-smallest selection here (the T nearest cells of a row, the routed
blocks, the union, the final k) breaks ties to the lowest index, by
`smallest_k`'s (key, id) ranking or a stable sort: `torch.topk` promises no
order among ties, and the union, and with it every result, must repeat.

There is no counterpart in the reference (its only scan is the
initializeSearch strided sample, Index.h:845-870).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from flatnav_tpu_torch.data_type import resolve_device
from flatnav_tpu_torch.ops.distances import MetricType, pairwise_distances, smallest_k


class RoutedScan(NamedTuple):
    """Cluster-sorted table + block summaries (built once, searched many).

    vectors:   [nb*block, d] table rows laid out cell by cell (original
               dtype; each cell padded to exactly ``block`` rows)
    ids:       [nb*block] int32 original row index per slot, -1 on pads
    block_centroids: [nb, d] float32 mean of each cell's real members
    n:         committed (real) rows
    block:     rows per block/cell
    metric:    distance metric the router and scanner use
    """

    vectors: torch.Tensor
    ids: torch.Tensor
    block_centroids: torch.Tensor
    n: int
    block: int
    metric: MetricType


def _balanced_assign(
    cand_ids: np.ndarray, cand_d: np.ndarray, nb: int, cap: int
) -> np.ndarray:
    """Capacity-constrained nearest-cell assignment (host, offline).

    cand_ids/cand_d: [n, T] each row's T nearest cells, ascending.
    Greedy in ascending best-distance order (rows that NEED their top
    cell most claim it first); a full cell falls through to the row's
    next candidate; rows whose whole candidate list is full go to the
    emptiest cell (rare: only under extreme imbalance).
    """
    n = cand_ids.shape[0]
    counts = np.zeros(nb, np.int64)
    assign = np.full(n, -1, np.int64)
    for i in np.argsort(cand_d[:, 0], kind="stable"):
        for c in cand_ids[i]:
            if counts[c] < cap:
                assign[i] = c
                counts[c] += 1
                break
        else:
            c = int(np.argmin(counts))
            assign[i] = c
            counts[c] += 1
    return assign


def build_routed_scan(
    vectors: np.ndarray,
    metric: MetricType = MetricType.L2,
    block: int = 2048,
    train_sample: int = 131072,
    n_iters: int = 20,
    seed: int = 0,
    device=None,
) -> RoutedScan:
    """One-time routing build: k-means -> balanced cells -> block layout,
    on the card unless `device` says otherwise.

    Keeps a second (cell-ordered) copy of the table: the price of turning
    per-row gathers into copies of whole blocks.
    """
    from flatnav_tpu_torch.quantization.kmeans import kmeans

    dev = resolve_device(device)
    vectors = np.asarray(vectors)
    n, d = vectors.shape
    block = int(max(128, min(block, n)))
    nb = max(1, -(-n // block))

    rng = np.random.default_rng(seed)
    if n > train_sample:
        sample = vectors[rng.choice(n, train_sample, replace=False)]
    else:
        sample = vectors
    cents, _ = kmeans(
        np.asarray(sample, np.float32), nb, n_iters=n_iters, seed=seed, device=dev
    )

    # each row's T nearest cells, computed on the device in tiles
    t_cand = min(nb, 8)
    tile = 16384
    dev_vecs = torch.from_numpy(np.ascontiguousarray(vectors)).to(dev)
    cell_ids = torch.arange(nb, dtype=torch.int32, device=dev)[None, :]
    cand_ids, cand_d = [], []
    for lo in range(0, n, tile):
        dists = pairwise_distances(
            dev_vecs[lo : lo + tile].to(torch.float32), cents, metric
        )
        top_d, top_i = smallest_k(dists, cell_ids, t_cand)
        cand_ids.append(top_i.cpu().numpy())
        cand_d.append(top_d.cpu().numpy())
    assign = _balanced_assign(
        np.concatenate(cand_ids), np.concatenate(cand_d), nb, block
    )

    # lay cells out one after another, each padded to exactly `block` rows
    slot_ids = np.full(nb * block, -1, np.int64)
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=nb)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    offsets = np.arange(n) - starts[assign[order]]
    slot_ids[assign[order] * block + offsets] = order
    # pad slots repeat a real row from their own cell, so the matmul stays
    # dense and finite (any row works: they are masked at query time);
    # empty cells fall back to row 0
    first_real = np.maximum(slot_ids.reshape(nb, block).max(axis=1), 0)
    row_src = np.where(
        slot_ids >= 0, np.maximum(slot_ids, 0), np.repeat(first_real, block)
    )
    layout = vectors[row_src]

    real = (slot_ids >= 0).reshape(nb, block)
    sums = np.where(
        real[:, :, None], np.asarray(layout, np.float32).reshape(nb, block, d), 0.0
    ).sum(axis=1)
    denom = np.maximum(real.sum(axis=1, keepdims=True), 1)
    block_cents = sums / denom

    return RoutedScan(
        vectors=torch.from_numpy(np.ascontiguousarray(layout)).to(dev),
        ids=torch.from_numpy(slot_ids.astype(np.int32)).to(dev),
        block_centroids=torch.from_numpy(block_cents.astype(np.float32)).to(dev),
        n=n,
        block=block,
        metric=metric,
    )


def routed_knn(
    rs: RoutedScan,
    queries: torch.Tensor,
    k: int,
    probes: int = 8,
    union_blocks: int = 32,
    group_size: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pruned exact-over-union kNN. Returns (dists [B, k], ids [B, k]),
    distances ascending and exact float32 (ties in block-layout order);
    only block SELECTION is approximate.

    probes:       blocks each query votes for (weighted by routing rank)
    union_blocks: blocks scanned per query group (the work knob:
                  fraction scanned ~= union_blocks * block / n)
    group_size:   queries per union (bigger amortizes the block copies,
                  smaller keeps unions tight)
    """
    nb = rs.block_centroids.shape[0]
    probes = min(probes, nb)
    union = min(union_blocks, nb)
    b_in, d = queries.shape
    group = max(8, min(group_size, b_in))

    # pad the query batch to a whole number of groups
    b_pad = -(-b_in // group) * group
    if b_pad != b_in:
        queries = torch.cat([queries, queries[:1].expand(b_pad - b_in, d)])

    return _routed_knn_padded(
        rs.vectors, rs.ids, rs.block_centroids, queries,
        k=k, metric=rs.metric, block=rs.block, probes=probes,
        union=union, group=group, b_in=b_in,
    )


def _routed_knn_padded(
    vectors, ids, block_cents, queries,
    *, k, metric, block, probes, union, group, b_in,
):
    """`routed_knn` over a batch already padded to whole groups; only the
    first `b_in` queries are real."""
    b_pad, d = queries.shape
    nb = block_cents.shape[0]
    dev = vectors.device
    blocks = vectors.view(nb, block, d)  # whole cells, no copy
    slot_blocks = ids.view(nb, block)

    # 1. route every query against every block centroid (one matmul;
    #    [B, nb] is tiny next to the table)
    route_d = pairwise_distances(queries.to(torch.float32), block_cents, metric)
    block_ids = torch.arange(nb, dtype=torch.int32, device=dev)[None, :]
    _, top_blocks = smallest_k(route_d, block_ids, probes)  # [B, P]

    # 2. sort queries by primary block so a group's unions stay tight
    order = torch.argsort(top_blocks[:, 0], stable=True)
    inv = torch.argsort(order, stable=True)
    q_sorted = queries[order]
    tb_sorted = top_blocks[order].long()
    # batch-padding copies of queries[0] must not vote: they would crowd
    # real queries' blocks out of the union
    vq_sorted = (torch.arange(b_pad, device=dev) < b_in).to(torch.float32)[order]

    # rank-weighted votes: a query's primary block outvotes `probes`
    # secondary picks, so primaries are evicted last under union pressure
    vote_w = (probes - torch.arange(probes, device=dev)).to(torch.float32)
    vote_w[0] = float(probes * probes)

    positions = torch.arange(union * block, dtype=torch.int32, device=dev)[None, :]
    d_k, i_k = [], []
    for lo in range(0, b_pad, group):
        q_g = q_sorted[lo : lo + group]
        tb_g = tb_sorted[lo : lo + group]
        vq_g = vq_sorted[lo : lo + group]
        # the votes are sums of small integers, exact in float32 whatever
        # the order, so this scatter-add gives the same votes every time
        votes = torch.zeros(nb, device=dev).index_add_(
            0, tb_g.reshape(-1), (vote_w[None, :] * vq_g[:, None]).reshape(-1)
        )
        # most-voted first, ties to the lowest block id
        keep = torch.argsort(-votes, stable=True)[:union]  # [U]

        rows = blocks[keep].reshape(union * block, d)  # U whole-block copies
        slot_ids = slot_blocks[keep].reshape(-1)  # -1 on pad slots

        dists = pairwise_distances(q_g, rows, metric)  # [group, U*block]
        dists = torch.where((slot_ids >= 0)[None, :], dists, float("inf"))
        top_d, pos = smallest_k(dists, positions, k)
        d_k.append(top_d)
        i_k.append(slot_ids[pos.long()])

    # unsort and drop padding
    return torch.cat(d_k)[inv][:b_in], torch.cat(i_k)[inv][:b_in]


__all__ = ["RoutedScan", "build_routed_scan", "routed_knn"]
