"""Node-table-sharded (tensor-parallel) beam search over a device mesh.

Counterpart of flatnav_tpu/parallel/sharded_graph.py. For tables larger
than one device's memory, vectors, links and labels split by rows over the
mesh's `model` axis (`ShardedGraph`). Queries split over `data`; the
members of a model group hold the same queries and the same beams, and
advance in lockstep through the single-device hop loop
(`index.search.beam_search_core`). Only the table's callbacks differ
(`shard_blocks`):

  * `score_block`: K2 (`gather_distances`) on the shard's own rows, for the
    candidates it owns (the ids mapped to local rows and clamped, since K2
    scores an id outside the table as NaN); a one-owner sum merges them.
  * `links_block`: the neighbour lists of the expanded nodes a shard owns,
    +1, merged by a one-owner sum, -1.
  * `entry_block`: the owned entry candidates' distances, merged likewise.

Every value has one owner and x + 0 == x, so the hop sees exactly the
single-device values and the search returns exactly the single-device
labels. The hop loop reads on the host whether any beam entry is left
unexpanded; the members of a model group agree on it because they hold
the same beams, so they run the same number of hops and meet at every sum.

The entry scan's matmul is computed for all queries of a dispatch and
sliced to this rank's: a matmul's rounding may depend on its batch width,
and this way it is the single-device matmul.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from flatnav_tpu_torch.index.search import (
    SearchResults,
    beam_search_core,
    safe_query_batch,
    table_blocks,
)
from flatnav_tpu_torch.ops.distances import MetricType
from flatnav_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    ShardedGraph,
    axis_range,
    axis_size,
    gather_slice,
    mesh_device,
    psum,
    shard_graph,
)


def shard_blocks(
    graph: ShardedGraph,
    mesh: DeviceMesh,
    queries: torch.Tensor,  # [B_local, d] this rank's queries
    entry_queries: torch.Tensor,  # [B_all, d] the dispatch's queries
    entry_rows: slice,  # this rank's rows of entry_queries
    metric: MetricType,
):
    """(score_block, links_block, entry_block) of `beam_search_core` over
    this rank's rows of a model-sharded table (see the module docstring)."""
    score_local, _ = table_blocks(graph.vectors, queries, metric)
    _, entry_local = table_blocks(graph.vectors, entry_queries, metric)
    m = graph.links.shape[1]

    def score_block(ids):
        local, own = graph.owned(ids)
        return psum(torch.where(own, score_local(local), 0.0), mesh, MODEL_AXIS)

    def links_block(ids):  # [B, E] -> [B, E*M] global neighbour ids
        local, own = graph.owned(ids)
        nbr = graph.links[local.reshape(-1).long()].reshape(*ids.shape, m)
        merged = psum(torch.where(own[..., None], nbr + 1, 0), mesh, MODEL_AXIS) - 1
        return merged.reshape(ids.shape[0], -1)

    def entry_block(cand):  # [NI] -> [B_local, NI]
        local, own = graph.owned(cand)
        pd = entry_local(local)[entry_rows]
        return psum(torch.where(own[None, :], pd, 0.0), mesh, MODEL_AXIS)

    return score_block, links_block, entry_block


def sharded_search(
    graph,
    queries,
    mesh: DeviceMesh,
    *,
    k: int,
    ef: int,
    metric: MetricType = MetricType.L2,
    num_initializations: int = 100,
    max_hops: int = 0,
    expand_factor: int = 1,
) -> SearchResults:
    """Top-K search over a row-sharded node table; every rank calls it with
    the same global `queries` ([B, d]; B must divide by the data axis) and
    gets the whole result. `graph` is this rank's `ShardedGraph`, or a full
    graph (on the host, say) whose rows this rank takes. Labels are the
    single-device `batched_search`'s; counters are summed over `data`."""
    if not isinstance(graph, ShardedGraph):
        graph = shard_graph(graph, mesh)
    n_data = axis_size(mesh, DATA_AXIS)
    queries = torch.as_tensor(queries)
    b = queries.shape[0]
    if b % n_data:
        raise ValueError(f"query batch {b} not divisible by data axis {n_data}")
    # memory guard at one rank's width: the beam, merge and score
    # intermediates are whole on every member of a model group; only the
    # table shrinks. Chunks of the global batch stay divisible by n_data.
    table_bytes = (
        graph.vectors.numel() * graph.vectors.element_size()
        + graph.links.numel() * 4 + graph.labels.numel() * 4
    )
    sub = n_data * safe_query_batch(
        max(b // n_data, 1), max(ef, k), m=graph.links.shape[1], d=graph.vectors.shape[1],
        expand_factor=expand_factor, table_bytes=table_bytes, max_hops=max_hops,
        device=graph.device,
    )
    dists, labels, counts = [], [], 0
    for lo in range(0, b, sub):
        d_, l_, c_ = _search_dispatch(
            graph, queries[lo : lo + sub], mesh, k=k, ef=max(ef, k), metric=metric,
            num_initializations=num_initializations, max_hops=max_hops,
            expand_factor=expand_factor,
        )
        dists.append(d_)
        labels.append(l_)
        counts = counts + c_
    return SearchResults(torch.cat(dists), torch.cat(labels), int(counts[0]), int(counts[1]))


def _search_dispatch(graph: ShardedGraph, q_all, mesh, *, k, ef, metric, **kw):
    q_all = q_all.to(mesh_device(mesh))
    b = q_all.shape[0]
    lo, hi = axis_range(mesh, DATA_AXIS, b)
    score, links_blk, entry = shard_blocks(graph, mesh, q_all[lo:hi], q_all, slice(lo, hi), metric)
    beam = beam_search_core(
        graph.links, graph.num_nodes, hi - lo, score, entry, ef=ef, links_block=links_blk, **kw
    )
    top_d, top_i = beam.dists[:, :k], beam.ids[:, :k]
    # label lookup: the owner contributes, a one-owner sum merges
    local, own = graph.owned(top_i)
    labs = psum(torch.where(own, graph.labels[local.long()] + 1, 0), mesh, MODEL_AXIS) - 1
    labs = torch.where(torch.isfinite(top_d), labs, -1)
    counts = psum(torch.stack([beam.dist_computations, beam.hops]), mesh, DATA_AXIS)
    return (
        gather_slice(top_d, b, lo, mesh, DATA_AXIS),
        gather_slice(labs, b, lo, mesh, DATA_AXIS),
        counts,
    )


__all__ = ["shard_blocks", "sharded_search"]
