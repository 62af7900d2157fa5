"""User-facing Index API, mirroring the reference's Python bindings.

Counterpart of flatnav_tpu/index/api.py: the same `create` / `load_index`
signatures and validation, plus `device=`. The index lives on the CUDA
card unless the caller passes `device="cpu"`; without a card and without
that request, `create` and `load_index` raise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from flatnav_tpu_torch import data_type as dt
from flatnav_tpu_torch import native
from flatnav_tpu_torch import reorder as reorder_mod
from flatnav_tpu_torch.index import build as build_mod
from flatnav_tpu_torch.index import serialize as ser
from flatnav_tpu_torch.index.graph import GraphArrays, make_empty_graph, node_size_bytes
from flatnav_tpu_torch.index.search import batched_search
from flatnav_tpu_torch.ops.distances import MetricType, brute_force_knn, fast_knn
from flatnav_tpu_torch.ops.fused_scan import fused_knn

_DISTANCE_TYPES = {"l2": MetricType.L2, "angular": MetricType.IP, "ip": MetricType.IP}

class Index:
    """A flat navigable-small-world index (capacity fixed at creation,
    Index.h:159-179)."""

    def __init__(
        self,
        metric: MetricType,
        dim: int,
        dataset_size: int,
        max_edges_per_node: int,
        index_data_type: dt.DataType = dt.DataType.float32,
        verbose: bool = False,
        collect_stats: bool = False,
        _graph: Optional[GraphArrays] = None,
        device=None,
    ):
        if max_edges_per_node <= 0 or dim <= 0 or dataset_size <= 0:
            raise ValueError("dim, dataset_size, max_edges_per_node must be > 0")
        self._device = dt.resolve_device(device)
        self._metric = metric
        self._data_type = index_data_type
        self._collect_stats = collect_stats
        self._verbose = verbose
        self._num_threads = 1  # compat knob; batch size is what matters here
        self._query_batch_size = 1024
        self._expand_factor = 16  # beam entries expanded per hop
        self._distance_computations = 0
        self._build_stats: dict = {}
        self._graph = (
            _graph
            if _graph is not None
            else make_empty_graph(
                dataset_size, dim, max_edges_per_node,
                index_data_type.torch_dtype, self._device,
            )
        )
        if verbose:
            print(self.index_summary())

    # ------------------------------------------------------------------ info
    @property
    def max_edges_per_node(self) -> int:
        return self._graph.max_edges

    @property
    def dim(self) -> int:
        return self._graph.dim

    @property
    def num_nodes(self) -> int:
        return self._graph.num_nodes

    @property
    def capacity(self) -> int:
        return self._graph.capacity

    @property
    def metric(self) -> MetricType:
        return self._metric

    @property
    def data_type(self) -> dt.DataType:
        return self._data_type

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def graph(self) -> GraphArrays:
        return self._graph

    def index_memory_bytes(self) -> int:
        """Total index memory by the reference's arena math
        (Index.h:176-178, getTotalIndexMemory at 505-515)."""
        return (
            node_size_bytes(self.dim, self._data_type.torch_dtype, self.max_edges_per_node)
            * self.capacity
        )

    def index_summary(self) -> str:
        """Analog of getIndexSummary (Index.h:538-548)."""
        return (
            "\n----------------Index Parameters----------------\n"
            f"Metric: {self._metric.value}\n"
            f"Data type: {self._data_type.value}\n"
            f"Dimension: {self.dim}\n"
            f"Max edges per node (M): {self.max_edges_per_node}\n"
            f"Capacity (max node count): {self.capacity}\n"
            f"Current num nodes: {self.num_nodes}\n"
            f"Index memory: {self.index_memory_bytes() / 1e9:.3f} GB\n"
            f"Device: {self._device}\n"
            "-------------------------------------------------"
        )

    # -------------------------------------------------------------- setters
    def set_num_threads(self, num_threads: int) -> None:
        """Compat with the reference API; there is no host thread pool."""
        if num_threads <= 0:
            raise ValueError("num_threads must be > 0")
        self._num_threads = num_threads

    @property
    def num_threads(self) -> int:
        return self._num_threads

    def set_query_batch_size(self, batch_size: int) -> None:
        """How many queries run per device batch."""
        if batch_size <= 0:
            raise ValueError("batch_size must be > 0")
        self._query_batch_size = batch_size

    def set_expand_factor(self, expand_factor: int) -> None:
        """Beam entries expanded per hop (fewer, wider hops)."""
        if expand_factor <= 0:
            raise ValueError("expand_factor must be > 0")
        self._expand_factor = expand_factor

    # ------------------------------------------------------------------- add
    def add(
        self,
        data: np.ndarray,
        ef_construction: int,
        num_initializations: int = 100,
        labels: Optional[Sequence[int]] = None,
    ) -> None:
        """Insert a batch of vectors (bindings.cpp:64-119 addImpl +
        Index::addBatch). Default labels continue the global insertion
        order (num_nodes..num_nodes+n)."""
        if num_initializations <= 0:
            raise ValueError("num_initializations must be greater than 0.")
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[None, :]
        if data.ndim != 2 or data.shape[1] != self.dim:
            raise ValueError(
                f"Data has incorrect dimensions: {data.shape}; expected "
                f"[N, {self.dim}]"
            )
        n = data.shape[0]
        if labels is None:
            start = self.num_nodes
            labels_arr = np.arange(start, start + n, dtype=np.int32)
        else:
            labels_arr = np.asarray(labels, dtype=np.int32)
            if labels_arr.shape[0] != n:
                raise ValueError("labels must have the same length as data")
        build_mod.add_batch(
            self._graph,
            dt.host_tensor(data).to(self._data_type.torch_dtype),
            labels_arr,
            ef_construction=ef_construction,
            metric=self._metric,
            num_initializations=num_initializations,
            stats=self._build_stats if self._collect_stats else None,
        )

    # ---------------------------------------------------------------- search
    def _queries(self, queries: np.ndarray) -> torch.Tensor:
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(
                f"Queries have incorrect dimensions {queries.shape}; "
                f"expected [B, {self.dim}]"
            )
        # integer indexes keep integer queries so the exact int32 distance
        # path applies; others query in float32
        qdtype = (
            self._data_type.torch_dtype if self._data_type.is_integer else torch.float32
        )
        return dt.host_tensor(queries).to(self._device, qdtype)

    def search(
        self,
        queries: np.ndarray,
        K: int,
        ef_search: int,
        num_initializations: int = 100,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched kNN query -> (dists [B, K] float32, labels [B, K] int32)
        (searchImpl, bindings.cpp:161-228)."""
        if num_initializations <= 0:
            raise ValueError(
                "num_initializations must be greater than 0."
            )  # Index.h:846-849
        q = self._queries(queries)
        g = self._graph
        out_d, out_l = [], []
        for lo in range(0, q.shape[0], self._query_batch_size):
            res = batched_search(
                g.vectors, g.links, g.labels, g.num_nodes,
                q[lo : lo + self._query_batch_size],
                k=K,
                ef=max(ef_search, K),  # Index.h:390
                metric=self._metric,
                num_initializations=num_initializations,
                expand_factor=self._expand_factor,
            )
            out_d.append(res.dists)
            out_l.append(res.labels)
            if self._collect_stats:
                self._distance_computations += res.dist_computations
        return (
            torch.cat(out_d).cpu().numpy(),
            torch.cat(out_l).to(torch.int32).cpu().numpy(),
        )

    def search_single(
        self,
        query: np.ndarray,
        K: int,
        ef_search: int,
        num_initializations: int = 100,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Single-query search (bindings.cpp:121-159) -> (dists [K],
        labels [K])."""
        d, l = self.search(np.asarray(query)[None, :], K, ef_search, num_initializations)
        return d[0], l[0]

    def search_exact(
        self, queries: np.ndarray, K: int, rerank: int = 0,
        fused: bool = True, exact_rerank: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact batched kNN over the committed rows (ops.brute_force_knn).

        `rerank > 0` switches to the two-phase scan: a bf16 key pass keeps
        a `rerank`-wide shortlist that is reranked exactly. By default the
        shortlist comes from the fused kernel (ops.fused_knn, kernel K1);
        `fused=False` takes ops.fast_knn for float data and the exact scan
        for integers. 8-bit tables ride the fused kernel unpromoted.
        `exact_rerank=False` ranks by the kernel's calibrated keys; it
        needs the fused shortlist path and raises elsewhere."""
        if not exact_rerank and (rerank <= 0 or not fused):
            raise ValueError(
                "exact_rerank=False requires the fused shortlist path "
                "(rerank > 0 and fused=True); fast_knn and the exact "
                "scan always rank by exact distances"
            )
        q = self._queries(queries)
        g = self._graph
        int_q = self._data_type.is_integer
        out_d, out_l = [], []
        for lo in range(0, q.shape[0], self._query_batch_size):
            chunk = q[lo : lo + self._query_batch_size]
            if rerank > 0 and fused:
                dists, ids = fused_knn(
                    g.vectors, chunk, K, self._metric, rerank=rerank,
                    n_valid=g.num_nodes, exact_rerank=exact_rerank,
                )
            elif rerank > 0 and not int_q:
                dists, ids = fast_knn(
                    g.vectors, chunk, K, self._metric, rerank=rerank,
                    n_valid=g.num_nodes,
                )
            else:
                dists, ids = brute_force_knn(
                    g.vectors, chunk, K, self._metric, n_valid=g.num_nodes
                )
            # unbeaten slots (num_nodes < K) carry inf: label -1
            out_d.append(dists)
            out_l.append(torch.where(torch.isinf(dists), -1, g.labels[ids.long()]))
        if self._collect_stats:
            self._distance_computations += q.shape[0] * self.num_nodes
        return (
            torch.cat(out_d).cpu().numpy(),
            torch.cat(out_l).to(torch.int32).cpu().numpy(),
        )

    def get_query_distance_computations(self) -> int:
        """Read-and-reset distance-computation counter
        (bindings.cpp:270-274)."""
        total = self._distance_computations
        self._distance_computations = 0
        return total

    def get_build_stats(self) -> dict:
        return dict(self._build_stats)

    def get_graph_outdegree_table(self) -> List[List[int]]:
        """Outbound edges per node, excluding self-loop padding
        (Index::getGraphOutdegreeTable, Index.h:240-251)."""
        n = self.num_nodes
        links = self._graph.links[:n].cpu().numpy()
        return [row[row != i].tolist() for i, row in enumerate(links)]

    # ---------------------------------------------------------- persistence
    def save(self, filename: str) -> None:
        ser.save_index(
            filename,
            self._graph,
            self._metric,
            extra={"index_data_type": self._data_type.value},
        )

    # --------------------------------------------------------------- imports
    def allocate_nodes(
        self, data: np.ndarray, labels: Optional[Sequence[int]] = None
    ) -> "Index":
        """Allocate nodes without building edges (bindings.cpp:308-324),
        used with build_graph_links to import an externally built graph."""
        data = np.asarray(data)
        n = data.shape[0]
        n0 = self.num_nodes
        if n0 + n > self.capacity:
            raise RuntimeError("Maximum number of nodes reached.")
        if labels is None:
            labels_arr = np.arange(n0, n0 + n, dtype=np.int32)
        else:
            labels_arr = np.asarray(labels, dtype=np.int32)
        g = self._graph
        g.vectors[n0 : n0 + n] = dt.host_tensor(data).to(
            self._device, self._data_type.torch_dtype
        )
        g.labels[n0 : n0 + n] = dt.host_tensor(labels_arr).to(self._device)
        g.num_nodes = n0 + n
        return self

    def build_graph_links(self, mtx_filename: str) -> None:
        """Import edges from a MatrixMarket file (Index::buildGraphLinks,
        Index.h:187-238): each node's first outdegree slots get its
        neighbors; the rest stay self-loops."""
        n = self.num_nodes
        m = self.max_edges_per_node
        links = native.read_mtx(mtx_filename, n, m)
        if links is None:
            links = _read_mtx_python(mtx_filename, n, m)
        self._graph.links[:n] = torch.from_numpy(links).to(self._device)

    # ------------------------------------------------------------- reordering
    def reorder(self, strategies: Sequence[str]) -> None:
        """Graph reordering (doGraphReordering, Index.h:412-427): gorder and
        rcm permutations applied via relabel."""
        n = self.num_nodes
        for strategy in strategies:
            s = strategy.lower()
            links = self._graph.links[:n].cpu().numpy()
            if s == "gorder":
                perm = reorder_mod.gorder(links, n, window_size=5)
            elif s == "rcm":
                perm = reorder_mod.rcm_order(links, n)
            else:
                raise ValueError(
                    f"Invalid reordering method: {strategy}"
                )  # Index.h:421-422
            self._relabel(perm)

    def _relabel(self, perm: np.ndarray) -> None:
        """Apply permutation P (new id of old node i = perm[i]), the analog
        of Index::relabel (Index.h:872-926): a dense permute on the index's
        device instead of in-place cycle chasing."""
        n = self.num_nodes
        g = self._graph
        perm_t = torch.from_numpy(np.asarray(perm, dtype=np.int64)).to(self._device)
        inv = torch.empty_like(perm_t)
        inv[perm_t] = torch.arange(n, device=self._device)
        g.vectors[:n] = g.vectors[:n].index_select(0, inv)
        g.labels[:n] = g.labels[:n].index_select(0, inv)
        g.links[:n] = perm_t[g.links[:n].long()].index_select(0, inv).to(torch.int32)


def _read_mtx_python(mtx_filename: str, n: int, m: int) -> np.ndarray:
    """Dense [n, m] links (self-loop padded) of a MatrixMarket edge list:
    the pure-Python parser behind `Index.build_graph_links`, which also
    names the fault of a file the native parser refused."""
    adjacency: List[List[int]] = [[] for _ in range(n)]
    with open(mtx_filename) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("Invalid MatrixMarket header")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        rows, cols, _ = (int(x) for x in line.split())
        if rows != n or cols != n:
            raise ValueError(
                f"Matrix dimensions {rows}x{cols} do not match index "
                f"size {n}"
            )
        for line in f:
            if not line.strip():
                continue
            a, b_ = (int(x) for x in line.split()[:2])
            # 1-indexed per MatrixMarket
            if len(adjacency[a - 1]) < m:
                adjacency[a - 1].append(b_ - 1)
    links = np.repeat(np.arange(n, dtype=np.int32)[:, None], m, axis=1)
    for i, row in enumerate(adjacency):
        links[i, : len(row)] = row
    return links


def create(
    distance_type: str,
    dim: int,
    dataset_size: int,
    max_edges_per_node: int,
    verbose: bool = False,
    collect_stats: bool = False,
    index_data_type: dt.DataType = dt.DataType.float32,
    device=None,
) -> Index:
    """Factory mirroring flatnav.index.create (bindings.cpp:484-504)."""
    key = distance_type.lower()
    if key not in _DISTANCE_TYPES:
        raise ValueError(
            f"Invalid distance type: {distance_type}. Valid options are "
            "'l2' and 'angular'."
        )
    return Index(
        metric=_DISTANCE_TYPES[key],
        dim=dim,
        dataset_size=dataset_size,
        max_edges_per_node=max_edges_per_node,
        index_data_type=index_data_type,
        verbose=verbose,
        collect_stats=collect_stats,
        device=device,
    )


def load_index(
    filename: str, verbose: bool = False, collect_stats: bool = False, device=None
) -> Index:
    """Load a saved index (Index::loadIndex, Index.h:442-479); reads files
    written by either package."""
    dev = dt.resolve_device(device)
    graph, metric, meta = ser.load_index(filename, device=dev)
    return Index(
        metric=metric,
        dim=meta["dim"],
        dataset_size=meta["capacity"],
        max_edges_per_node=meta["max_edges"],
        index_data_type=dt.DataType(meta.get("index_data_type", meta["dtype"])),
        verbose=verbose,
        collect_stats=collect_stats,
        _graph=graph,
        device=dev,
    )
