"""Carry index state across from the JAX package.

Both packages store a graph as the same three arrays (vectors, links,
labels) with the same padding rules, so a JAX-built graph runs unchanged
in the port: this is the port's counterpart of loading a model's weights.
A product quantizer is its codebook array, and a PQ index its .npz file.
Everything crosses as numpy arrays; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from flatnav_tpu_torch.data_type import from_numpy, resolve_device
from flatnav_tpu_torch.index.api import Index, load_index
from flatnav_tpu_torch.index.graph import GraphArrays, wave_pad
from flatnav_tpu_torch.ops.distances import MetricType
from flatnav_tpu_torch.quantization.pq import PQCodebook, ProductQuantizer
from flatnav_tpu_torch.quantization.pq_index import PQIndex


def graph_from_jax_arrays(
    vectors: np.ndarray,
    links: np.ndarray,
    labels: np.ndarray,
    num_nodes: int,
    capacity: int,
    device=None,
) -> GraphArrays:
    """GraphArrays from the fields of a JAX `GraphArrays` (as numpy arrays:
    `np.asarray(g.vectors)` and so on), padding rows included, bit for bit.
    A bfloat16 table may come as an ml_dtypes array or as its uint16 bits."""
    rows = capacity + wave_pad(capacity)
    if vectors.shape[0] != rows or links.shape[0] != rows + 1 or labels.shape[0] != rows:
        raise ValueError(
            f"arrays do not have the padded layout of capacity {capacity}: "
            f"vectors {vectors.shape}, links {links.shape}, labels {labels.shape}"
        )
    dev = resolve_device(device)
    bf16 = vectors.dtype.name == "bfloat16"
    return GraphArrays(
        vectors=from_numpy(vectors, torch.bfloat16 if bf16 else None).to(dev),
        links=torch.from_numpy(np.array(links, np.int32)).to(dev),
        labels=torch.from_numpy(np.array(labels, np.int32)).to(dev),
        num_nodes=int(num_nodes),
        capacity=int(capacity),
    )


def index_from_jax_npz(path: str, device=None, **kwargs) -> Index:
    """Load an index saved by `flatnav_tpu` (`Index.save`). The two
    packages share the .npz format, so this is `load_index`."""
    return load_index(path, device=device, **kwargs)


def pq_from_jax_arrays(centroids: np.ndarray, metric, device=None) -> ProductQuantizer:
    """A trained ProductQuantizer from a JAX quantizer's codebook
    (`np.asarray(pq.codebook.centroids)`, [M_pq, 16 or 256, d_sub]) and its
    metric (either package's MetricType, or its value "l2" / "ip")."""
    centroids = np.asarray(centroids, dtype=np.float32)
    if centroids.ndim != 3 or centroids.shape[1] not in (16, 256):
        raise ValueError(
            f"centroids must be [M_pq, 16 or 256, d_sub], got {centroids.shape}"
        )
    m_pq, nc, dsub = centroids.shape
    pq = ProductQuantizer(
        dim=m_pq * dsub,
        num_subquantizers=m_pq,
        nbits=4 if nc == 16 else 8,
        metric=MetricType(getattr(metric, "value", metric)),
        device=device,
    )
    pq.codebook = PQCodebook(torch.from_numpy(centroids.copy()).to(pq.device))
    return pq


def pq_index_from_jax_npz(path: str, device=None) -> PQIndex:
    """Load a PQ index saved by `flatnav_tpu` (`PQIndex.save`). The two
    packages share the .npz format, so this is `PQIndex.load`."""
    return PQIndex.load(path, device=device)


__all__ = [
    "graph_from_jax_arrays",
    "index_from_jax_npz",
    "pq_from_jax_arrays",
    "pq_index_from_jax_npz",
]
