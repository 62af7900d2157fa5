"""Index save/load: the committed rows of the three arrays plus metadata.

Counterpart of flatnav_tpu/index/serialize.py, with the same `.npz` format
(version 1) written and read with numpy only, so an index saved by either
package loads in the other. Only the committed prefix is stored; the
capacity is recorded in the metadata and the self-loop padding is rebuilt
on load. bfloat16 vectors are stored as their uint16 bits, with
meta["dtype"] = "bfloat16".
"""

from __future__ import annotations

import json

import numpy as np
import torch

from flatnav_tpu_torch.data_type import to_numpy
from flatnav_tpu_torch.index.graph import GraphArrays, graph_from_numpy
from flatnav_tpu_torch.ops.distances import MetricType

_FORMAT_VERSION = 1


def save_index(
    path: str, graph: GraphArrays, metric: MetricType, extra: dict | None = None
) -> None:
    n = graph.num_nodes
    vecs = to_numpy(graph.vectors[:n])
    meta = {
        "format_version": _FORMAT_VERSION,
        "metric": metric.value,
        "dim": graph.dim,
        "max_edges": graph.max_edges,
        "capacity": graph.capacity,
        "num_nodes": n,
        "dtype": str(graph.vectors.dtype).removeprefix("torch."),
    }
    if extra:
        meta.update(extra)
    # an open handle: np.savez(path) would append ".npz" to a bare path
    with open(path, "wb") as f:
        np.savez(
            f,
            vectors=vecs,
            links=to_numpy(graph.links[:n]),
            labels=to_numpy(graph.labels[:n]),
            metadata=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
        )


def load_index(path: str, device=None):
    """Returns (GraphArrays, metric, metadata dict); the arrays go to the
    card unless `device` says otherwise (`graph_from_numpy`)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["metadata"]).decode("utf-8"))
        if meta.get("format_version", 0) > _FORMAT_VERSION:
            raise ValueError(
                f"Index file {path} has format version "
                f"{meta['format_version']} > supported {_FORMAT_VERSION}"
            )
        graph = graph_from_numpy(
            z["vectors"],
            z["links"],
            z["labels"],
            num_nodes=meta["num_nodes"],
            capacity=meta["capacity"],
            dtype=getattr(torch, meta["dtype"]),
            device=device,
        )
    return graph, MetricType(meta["metric"]), meta
