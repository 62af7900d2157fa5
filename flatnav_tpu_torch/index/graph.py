"""Dense graph storage: three arrays in device memory.

Counterpart of flatnav_tpu/index/graph.py, with the same layout:

    vectors [capacity + pad, d]      storage dtype
    links   [capacity + pad + 1, M]  int32 (last row = scratch)
    labels  [capacity + pad]         int32

Memory per node is d*sizeof(dtype) + 4*M + 4 bytes, the reference's arena
math (Index.h:176-178). Unused link slots hold the node's own id (the
reference's self-loop convention, Index.h:269-270). Row arrays are
over-allocated by `wave_pad(capacity)` rows so that a construction wave
padded to a power of two always fits below the end, and the links array has
one scratch row that padding lanes of a back-edge commit write to; it is
never read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flatnav_tpu_torch.data_type import from_numpy, resolve_device

#: construction waves are padded to power-of-two buckets up to this size
MAX_WAVE = 8192


def wave_pad(capacity: int) -> int:
    """Rows to over-allocate so any padded wave fits below the boundary."""
    pow2 = 1 << max(0, (capacity - 1)).bit_length()
    return min(MAX_WAVE, max(64, pow2))


@dataclasses.dataclass
class GraphArrays:
    """Index state. `num_nodes` (the committed prefix) and `capacity` are
    host ints; construction updates the tensors in place."""

    vectors: torch.Tensor
    links: torch.Tensor
    labels: torch.Tensor
    num_nodes: int = 0
    capacity: int = 0

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def max_edges(self) -> int:
        return self.links.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def _self_loops(lo: int, hi: int, m: int, device) -> torch.Tensor:
    ids = torch.arange(lo, hi, dtype=torch.int32, device=device)
    return ids[:, None].expand(hi - lo, m).contiguous()


def make_empty_graph(
    capacity: int,
    dim: int,
    max_edges: int,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> GraphArrays:
    """Allocate the full-capacity arrays up front (Index.h:159-179), every
    link row already in the self-loop "all edges unused" state. On the card
    unless `device` says otherwise (`data_type.resolve_device`)."""
    device = resolve_device(device)
    rows = capacity + wave_pad(capacity)
    return GraphArrays(
        vectors=torch.zeros((rows, dim), dtype=dtype, device=device),
        links=_self_loops(0, rows + 1, max_edges, device),
        labels=torch.zeros(rows, dtype=torch.int32, device=device),
        num_nodes=0,
        capacity=capacity,
    )


def node_size_bytes(dim: int, dtype, max_edges: int) -> int:
    """Reference memory math: data + 4*M links + 4-byte label."""
    itemsize = dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize
    return dim * itemsize + 4 * max_edges + 4


def graph_from_numpy(
    vectors: np.ndarray,
    links: np.ndarray,
    labels: np.ndarray | None = None,
    num_nodes: int | None = None,
    capacity: int | None = None,
    dtype: torch.dtype | None = None,
    device=None,
) -> GraphArrays:
    """Build GraphArrays from the committed rows held on the host (a
    deserialized index, say). `dtype=torch.bfloat16` reads a uint16 array
    as bfloat16 bits. On the card unless `device` says otherwise."""
    device = resolve_device(device)
    n, d = vectors.shape
    cap = capacity or n
    if n > cap:
        raise ValueError(
            f"{n} committed rows exceed capacity {cap}; the rest of the "
            f"engine relies on num_nodes <= capacity"
        )
    m = links.shape[1]
    if labels is None:
        labels = np.arange(n, dtype=np.int32)
    vec = from_numpy(vectors, dtype)
    g = make_empty_graph(cap, d, m, vec.dtype, device)
    g.vectors[:n] = vec.to(device)
    g.links[:n] = torch.from_numpy(np.asarray(links, np.int32)).to(device)
    g.labels[:n] = torch.from_numpy(np.asarray(labels, np.int32)).to(device)
    g.num_nodes = n if num_nodes is None else int(num_nodes)
    return g


__all__ = [
    "GraphArrays",
    "MAX_WAVE",
    "graph_from_numpy",
    "make_empty_graph",
    "node_size_bytes",
    "wave_pad",
]
