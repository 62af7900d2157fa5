"""The mesh branch of `index.build.add_batch`: the wave build over a mesh.

Counterpart of the mesh branch of flatnav_tpu/index/build.py:add_batch
(:539-633). A wave's lanes split over the mesh's `data` axis; the table is
whole on every rank ("replicated") or split by rows over the `model` axis
("model", a `ShardedGraph`). Each rank searches and prunes its own lanes;
the kept neighbour ids and distances are gathered over `data`, and every
rank then commits the same forward and back edges (to the rows it owns,
under "model").

The graph is the single-device build's, bit for bit, because nothing a lane
computes depends on which lanes share its call: the entry scan's matmul and
the [W, W] intra-wave block are computed for the whole wave and sliced, the
prune takes the whole wave's form, and every merge across ranks is a
one-owner sum. Under "model" the hop's callbacks are `sharded_graph`'s, and
the rows of the prune's candidates and of the back-edge targets come from a
one-owner sum over `model`.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh

from flatnav_tpu_torch.index.build import (
    LocalWave,
    WaveSelection,
    back_edge_rows,
    forward_links,
    prune_wave,
)
from flatnav_tpu_torch.index.search import beam_search_core, table_blocks
from flatnav_tpu_torch.parallel.sharded_graph import shard_blocks
from flatnav_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    ShardedGraph,
    axis_range,
    gather_slice,
    mesh_device,
    psum,
    replicated,
    shard_graph,
)


class ReplicatedWave(LocalWave):
    """Wave steps with the whole table on every rank: only the search and
    prune split, over `data`."""

    def __init__(self, graph, mesh: DeviceMesh):
        if graph.device != mesh_device(mesh):  # a graph elsewhere is copied to the rank's device
            graph = dataclasses.replace(
                graph, **{f: replicated(getattr(graph, f), mesh) for f in ("vectors", "links", "labels")}
            )
        super().__init__(graph)
        self.mesh = mesh

    def _beam(self, new_vecs, lo, hi, metric, **kw):
        g = self.graph
        score, _ = table_blocks(g.vectors, new_vecs[lo:hi], metric)
        _, entry_all = table_blocks(g.vectors, new_vecs, metric)
        return beam_search_core(
            g.links, g.num_nodes, hi - lo, score, lambda c: entry_all(c)[lo:hi], graph_hop=False,
            **kw
        )

    def _rows(self, ids):
        return self.graph.vectors[ids.long()]

    def select(self, new_vecs, n_valid, *, ef_construction, m_sel, metric,
               num_initializations, intra_candidates, expand_factor) -> WaveSelection:
        w = new_vecs.shape[0]
        lo, hi = axis_range(self.mesh, DATA_AXIS, w)
        beam = self._beam(
            new_vecs, lo, hi, metric, ef=ef_construction,
            num_initializations=num_initializations, expand_factor=expand_factor,
        )
        kept_ids, kept_d = prune_wave(
            beam, new_vecs, self.graph.num_nodes, n_valid, self._rows, lanes=slice(lo, hi),
            m_sel=m_sel, metric=metric, intra_candidates=intra_candidates,
        )
        counts = psum(torch.stack([beam.dist_computations, beam.hops]), self.mesh, DATA_AXIS)
        return WaveSelection(
            gather_slice(kept_ids + 1, w, lo, self.mesh, DATA_AXIS) - 1,
            gather_slice(kept_d, w, lo, self.mesh, DATA_AXIS),
            counts[0],
            counts[1],
        )


class ModelWave(ReplicatedWave):
    """Wave steps over a table split by rows over `model`: each rank writes
    only the rows it owns and reads others' rows through one-owner sums."""

    def __init__(self, graph, mesh: DeviceMesh):
        if not isinstance(graph, ShardedGraph):
            graph = shard_graph(graph, mesh)
        LocalWave.__init__(self, graph)
        self.mesh = mesh

    def _owned_span(self, n0: int, n: int):
        """(wave rows, local rows) of the rows [n0, n0 + n) this rank owns."""
        g = self.graph
        lo = max(n0, g.offset)
        hi = min(n0 + n, g.offset + g.vectors.shape[0])
        hi = max(hi, lo)
        return slice(lo - n0, hi - n0), slice(lo - g.offset, hi - g.offset)

    def _beam(self, new_vecs, lo, hi, metric, **kw):
        g = self.graph
        score, links_blk, entry = shard_blocks(g, self.mesh, new_vecs[lo:hi], new_vecs, slice(lo, hi), metric)
        return beam_search_core(g.links, g.num_nodes, hi - lo, score, entry, links_block=links_blk, **kw)

    def _rows(self, ids):
        local, own = self.graph.owned(ids)
        rows = self.graph.vectors[local.long()]
        return psum(torch.where(own[..., None], rows, 0), self.mesh, MODEL_AXIS)

    def commit_vectors(self, new_vecs, new_labels):
        g = self.graph
        src, dst = self._owned_span(g.num_nodes, new_vecs.shape[0])
        g.vectors[dst] = new_vecs[src].to(g.vectors.dtype)
        g.labels[dst] = new_labels[src]

    def commit_links(self, kept_ids, n_valid):
        g = self.graph
        fwd = forward_links(kept_ids, g.num_nodes, n_valid, g.max_edges)
        src, dst = self._owned_span(g.num_nodes, kept_ids.shape[0])
        g.links[dst] = fwd[src]
        g.num_nodes += n_valid

    def back_edges(self, targets, requesters, metric):
        g = self.graph
        row_valid = targets >= 0
        # padding lanes name the single device's scratch row, which no rank writes
        safe = torch.where(row_valid, targets, g.rows)
        local, own = g.owned(safe)
        existing = psum(torch.where(own[:, None], g.links[local.long()] + 1, 0), self.mesh, MODEL_AXIS) - 1
        new_rows = back_edge_rows(self._rows, existing, safe, row_valid, requesters, metric)
        write = own & row_valid
        g.links[local[write].long()] = new_rows[write].to(g.links.dtype)


def mesh_wave(graph, mesh: DeviceMesh, table_spec: str):
    """The wave steps of `add_batch(mesh=mesh, table_spec=...)`."""
    if table_spec == "replicated":
        return ReplicatedWave(graph, mesh)
    if table_spec == "model":
        return ModelWave(graph, mesh)
    raise ValueError(f"table_spec must be 'replicated' or 'model', not {table_spec!r}")


__all__ = ["ModelWave", "ReplicatedWave", "mesh_wave"]
