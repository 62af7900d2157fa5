"""PQ-coded index: construction and search over codes (encode-on-insert).

Counterpart of flatnav_tpu/quantization/pq_index.py. Reference parity:
`Index<ProductQuantizer, int>` stores PQ codes instead of raw vectors:
`transformDataImpl` encodes each inserted point (developmental-features/
quantization/ProductQuantization.h:349-356) and all construction/search
distances go through the quantizer (asymmetric for query-vs-node, symmetric
for node-vs-node).

Two identities make the reference's distance tables unnecessary as separate
code paths:

  * ADC(q, code) == L2(q, decode(code)): the per-query table sum IS the
    distance to the reconstruction;
  * SDC(code_a, code_b) == L2(decode(code_a), decode(code_b)): the
    symmetric table sum IS the distance between reconstructions.

So the wave pipeline stores codes (M_pq bytes/node: this is where the
memory and gather-bandwidth savings come from), gathers codes in the hot
loops, and decodes small candidate sets on the fly to reuse the raw
diversity-prune and back-edge machinery unchanged.

Node memory: M_pq + 4*M + 4 bytes (vs d*4 + 4*M + 4 raw), e.g. 8x data
compression for d=128, M_pq=8 at some recall cost (PQ is lossy).

The state is a `GraphArrays` whose `vectors` field holds the code table:
the layout (wave padding, scratch link row) and the in-place commits are
the raw index's.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from flatnav_tpu_torch.data_type import host_tensor, resolve_device
from flatnav_tpu_torch.index.build import (
    _MIN_WAVE,
    _back_edge_core,
    _commit_back_edges,
    _next_pow2,
    _safe_wave_size,
    commit_links,
    commit_vectors,
    select_neighbors,
)
from flatnav_tpu_torch.index.graph import MAX_WAVE, make_empty_graph
from flatnav_tpu_torch.index.search import safe_query_batch
from flatnav_tpu_torch.ops.distances import MetricType, pairwise_distances, smallest_k
from flatnav_tpu_torch.quantization.pq import (
    PQCodebook,
    ProductQuantizer,
    _adc_tables_impl,
    _decode,
    _encode,
    pq_beam_search,
    pq_scan_knn,
)


class PQWaveSelection(NamedTuple):
    kept_ids: torch.Tensor
    kept_dists: torch.Tensor
    dist_computations: torch.Tensor
    hops: torch.Tensor


def back_edge_commit_pq(
    codes: torch.Tensor,  # [rows, M_pq] uint8
    centroids: torch.Tensor,  # [M_pq, nc, dsub]
    links: torch.Tensor,
    targets: torch.Tensor,
    requesters: torch.Tensor,
    *,
    metric: MetricType,
) -> None:
    """PQ back-edge insert/repair, in place: decodes ONLY the touched rows
    (targets + their links + requesters, O(T*(M+R)*d) scratch), never the
    full code table, which is the scale PQ exists to serve (reference
    decode: ProductQuantization.h:286-306). The scratch row id (one past
    the table) gathers a clamped row that only padding lanes see."""
    last = codes.shape[0] - 1

    def gather(ids):
        c = codes[ids.clamp(max=last).long()]
        return _decode(centroids, c.reshape(-1, c.shape[-1])).reshape(*ids.shape, -1)

    _back_edge_core(gather, links, targets, requesters, metric)


def _pq_wave_search_select(
    codes: torch.Tensor,  # [rows, M_pq] committed codes (wave rows included)
    links: torch.Tensor,
    num_nodes: int,
    centroids: torch.Tensor,  # [M_pq, nc, dsub]
    new_raw: torch.Tensor,  # [W, d] raw wave vectors (used for ADC tables only)
    n_valid: int,
    *,
    ef_construction: int,
    m_sel: int,
    metric: MetricType,
    num_initializations: int = 100,
    intra_candidates: int = 0,
) -> PQWaveSelection:
    """PQ analog of build.wave_search_select: ADC beam search over codes +
    exact intra-wave candidates against wave reconstructions + diversity
    prune over decoded candidates."""
    qf = new_raw.to(torch.float32)
    tables = _adc_tables_impl(centroids, qf, metric)
    beam = pq_beam_search(
        codes, links, num_nodes, tables, ef=ef_construction, metric=metric,
        num_initializations=num_initializations,
    )
    cand_d, cand_i = beam.dists, beam.ids

    w = new_raw.shape[0]
    c2 = min(intra_candidates, w) if intra_candidates else 0
    if c2 > 0:
        # intra-wave: ADC(q_i, code_j) == L2/IP(q_i, decode(code_j))
        decoded = _decode(centroids, codes[num_nodes : num_nodes + w])  # [W, d]
        intra = pairwise_distances(qf, decoded, metric)
        lane = torch.arange(w, dtype=torch.int32, device=codes.device)
        allowed = (lane[None, :] < lane[:, None]) & (lane[None, :] < n_valid)
        intra = torch.where(allowed, intra, float("inf"))
        intra_d, idx = smallest_k(intra, lane[None, :], c2)
        intra_ids = torch.where(torch.isfinite(intra_d), num_nodes + idx, -1)
        cand_d = torch.cat([cand_d, intra_d], dim=1)
        cand_i = torch.cat([cand_i, intra_ids.to(torch.int32)], dim=1)
        order = torch.argsort(cand_d, dim=1, stable=True)
        cand_d, cand_i = cand_d.gather(1, order), cand_i.gather(1, order)

    # prune over decoded candidates: the SDC identity makes this exactly the
    # reference's symmetric-distance pruning (ProductQuantization.h:395-411)
    cand_codes = codes[cand_i.clamp_min(0).long()]  # [W, C, M_pq]
    cand_vecs = _decode(
        centroids, cand_codes.reshape(-1, cand_codes.shape[-1])
    ).reshape(cand_codes.shape[0], cand_codes.shape[1], -1)
    kept_ids, _, kept_d = select_neighbors(cand_d, cand_i, cand_vecs, m_sel, metric)
    return PQWaveSelection(kept_ids, kept_d, beam.dist_computations, beam.hops)


class PQIndex:
    """A flat-NSW index over PQ codes (encode-on-insert, reference
    Index<ProductQuantizer> parity). API mirrors flatnav_tpu_torch.index.Index.
    The index lives on its quantizer's device."""

    def __init__(
        self,
        pq: ProductQuantizer,
        dataset_size: int,
        max_edges_per_node: int,
        collect_stats: bool = False,
        device=None,
    ):
        if not pq.is_trained:
            raise RuntimeError("ProductQuantizer must be trained first")
        if device is not None and resolve_device(device).type != pq.device.type:
            raise ValueError(
                f"the quantizer lives on {pq.device}; a PQIndex lives with its "
                f"quantizer, not on {device}"
            )
        self.pq = pq
        self._device = pq.device
        self._metric = pq.metric
        self._collect_stats = collect_stats
        self._build_stats: dict = {}
        self._distance_computations = 0
        # `vectors` holds the codes, one byte per subquantizer as `encode`
        # returns them (4-bit quantizers included)
        self._graph = make_empty_graph(
            dataset_size, pq.num_subquantizers, max_edges_per_node, torch.uint8,
            self._device,
        )

    # ------------------------------------------------------------------ info
    @property
    def _codes(self) -> torch.Tensor:
        return self._graph.vectors

    @property
    def _links(self) -> torch.Tensor:
        return self._graph.links

    @property
    def _labels(self) -> torch.Tensor:
        return self._graph.labels

    @property
    def num_nodes(self) -> int:
        return self._graph.num_nodes

    @property
    def capacity(self) -> int:
        return self._graph.capacity

    @property
    def max_edges_per_node(self) -> int:
        return self._graph.max_edges

    @property
    def device(self) -> torch.device:
        return self._device

    def index_memory_bytes(self) -> int:
        """codes + links + label per node (the PQ memory win)."""
        return (
            self.pq.code_size_bytes() + 4 * self.max_edges_per_node + 4
        ) * self.capacity

    def _table_bytes(self) -> int:
        return self._codes.numel() + self._links.numel() * 4

    # ------------------------------------------------------------------- add
    def add(
        self,
        data: np.ndarray,
        ef_construction: int,
        num_initializations: int = 100,
        labels=None,
        max_wave: int = MAX_WAVE,
    ) -> None:
        data = np.asarray(data, dtype=np.float32)
        n = data.shape[0]
        g = self._graph
        dev = self._device
        if self.num_nodes + n > self.capacity:
            raise RuntimeError("Maximum number of nodes reached.")
        # the graph arrays over-allocate wave_pad rows sized for MAX_WAVE
        # (graph.py): a wider wave's padded commit would write past `rows`
        max_wave = min(max_wave, MAX_WAVE)
        # same memory guard as the raw path (build.add_batch): the prune
        # decodes a [W, ef+intra, d] f32 candidate block, the working-set
        # shape _safe_wave_size models
        m = self.max_edges_per_node
        m_sel = max(m // 2, 1)
        max_wave = _safe_wave_size(
            max_wave,
            ef_construction=ef_construction,
            m=m,
            d=self.pq.dim,
            expand_factor=1,
            intra_candidates=2 * m_sel,
            table_bytes=self._table_bytes(),
            device=dev,
        )
        if labels is None:
            labels = np.arange(self.num_nodes, self.num_nodes + n, dtype=np.int32)
        labels = np.asarray(labels, dtype=np.int32)
        if labels.shape[0] != n:
            raise ValueError(
                f"labels length {labels.shape[0]} != data rows {n}"
            )
        if n == 0:
            return
        centroids = self.pq.codebook.centroids
        data_dev = host_tensor(data).to(dev)
        labels_dev = torch.from_numpy(labels).to(dev)
        committed = self.num_nodes
        pos = 0

        # the very first node gets no edges (Index.h:369-371)
        if committed == 0:
            commit_vectors(g, _encode(centroids, data_dev[:1]), labels_dev[:1])
            g.num_nodes = committed = pos = 1

        bucket_used = 0
        while pos < n:
            w = int(min(max_wave, n - pos))
            # one wave width for the whole build: the tail wave is padded
            bucket = max(_next_pow2(w), _MIN_WAVE, bucket_used)
            bucket_used = bucket
            wave_raw = data_dev[pos : pos + w]
            wave_labels = labels_dev[pos : pos + w]
            if w < bucket:  # pad lanes with the first row; masked out by n_valid
                pad = bucket - w
                wave_raw = torch.cat([wave_raw, wave_raw[:1].expand(pad, -1)])
                wave_labels = torch.cat(
                    [wave_labels, torch.zeros(pad, dtype=torch.int32, device=dev)]
                )
            commit_vectors(g, _encode(centroids, wave_raw), wave_labels)
            sel = _pq_wave_search_select(
                g.vectors, g.links, g.num_nodes, centroids, wave_raw, w,
                ef_construction=ef_construction, m_sel=m_sel, metric=self._metric,
                num_initializations=num_initializations,
                intra_candidates=2 * m_sel,
            )
            if self._collect_stats:
                self._build_stats["distance_computations"] = (
                    self._build_stats.get("distance_computations", 0)
                    + int(sel.dist_computations)
                )
            commit_links(g, sel.kept_ids, w)
            # back edges: decode only the touched rows (back_edge_commit_pq)
            kept = sel.kept_ids[:w].cpu().numpy()
            kept_d = sel.kept_dists[:w].cpu().numpy()
            src = committed + np.arange(w, dtype=np.int32)
            tgt = kept.reshape(-1)
            src_rep = np.repeat(src, m_sel)
            dist_rep = kept_d.reshape(-1)
            mask = tgt >= 0
            if mask.any():
                _commit_back_edges(
                    lambda t_, r_: back_edge_commit_pq(
                        g.vectors, centroids, g.links, t_, r_, metric=self._metric
                    ),
                    tgt[mask], src_rep[mask], dist_rep[mask], device=dev,
                )
            committed += w
            pos += w

    # ---------------------------------------------------------------- search
    def _queries(self, queries) -> np.ndarray:
        queries = np.asarray(queries, dtype=np.float32)
        return queries[None, :] if queries.ndim == 1 else queries

    def search(self, queries, K: int, ef_search: int, num_initializations: int = 100):
        """ADC beam search -> (dists [B, K] float32, labels [B, K] int32)."""
        queries = self._queries(queries)
        b = queries.shape[0]
        # same memory guard as the raw path (search.safe_query_batch): chunk
        # the dispatch when the hop working set would overflow the device
        # (conservative: models the decoded f32 width, wider than codes)
        sub = safe_query_batch(
            b, max(ef_search, K), m=self.max_edges_per_node, d=self.pq.dim,
            table_bytes=self._table_bytes(), device=self._device,
        )
        outs_d, outs_l = [], []
        for lo in range(0, b, sub):
            tables = self.pq.adc_tables(queries[lo : lo + sub])
            beam = pq_beam_search(
                self._codes, self._links, self.num_nodes, tables,
                ef=max(ef_search, K), metric=self._metric,
                num_initializations=num_initializations,
            )
            top_d = beam.dists[:, :K]
            top_i = beam.ids[:, :K]
            outs_d.append(top_d)
            outs_l.append(
                torch.where(torch.isfinite(top_d), self._labels[top_i.long()], -1)
            )
            if self._collect_stats:
                self._distance_computations += int(beam.dist_computations)
        return (
            torch.cat(outs_d).cpu().numpy(),
            torch.cat(outs_l).to(torch.int32).cpu().numpy(),
        )

    def search_scan(
        self, queries, K: int, rerank: int = 32, tile_size: int = 32768
    ):
        """ADC full-table scan (pq.pq_scan_knn): graph-free engine scoring
        every committed code via a one-hot contraction, the counterpart of
        Index.search_exact for tables whose raw vectors do not fit (codes
        are S bytes/node vs d*dtype for raw vectors). Returns
        (dists [B, K] f32 exact-ADC, labels [B, K] int32)."""
        tables = self.pq.adc_tables(self._queries(queries))
        d, ids = pq_scan_knn(
            self._codes, tables, K, metric=self._metric, tile_size=tile_size,
            rerank=rerank, n_valid=self.num_nodes,
        )
        labels = torch.where(torch.isfinite(d), self._labels[ids.long()], -1)
        return d.cpu().numpy(), labels.to(torch.int32).cpu().numpy()

    def get_query_distance_computations(self) -> int:
        total = self._distance_computations
        self._distance_computations = 0
        return total

    # ------------------------------------------------------------------ save
    def save(self, path: str) -> None:
        """Write the committed rows and the codebook as one .npz, the layout
        both packages read."""
        n = self.num_nodes
        # versioned JSON metadata like index/serialize.py (the legacy
        # positional `meta` array is kept so older readers still work)
        meta = {
            "format_version": 1,
            "metric": self._metric.value,
            "capacity": self.capacity,
            "max_edges": self.max_edges_per_node,
            "num_nodes": n,
        }
        # Open the file ourselves: np.savez(path) appends ".npz" to bare
        # paths, but save must honor the literal filename (reference
        # saveIndex accepts arbitrary names, Index.h:481-490).
        with open(path, "wb") as f:
            np.savez(
                f,
                codes=self._codes[:n].cpu().numpy(),
                links=self._links[:n].cpu().numpy(),
                labels=self._labels[:n].cpu().numpy(),
                centroids=self.pq.codebook.centroids.cpu().numpy(),
                meta=np.asarray(
                    [self.capacity, self.max_edges_per_node,
                     1 if self._metric == MetricType.IP else 0]
                ),
                metadata=np.frombuffer(
                    json.dumps(meta).encode("utf-8"), dtype=np.uint8
                ),
            )

    @classmethod
    def load(cls, path: str, device=None) -> "PQIndex":
        """Load a PQ index saved by either package, onto `device` (the card
        unless the caller asks for "cpu")."""
        dev = resolve_device(device)
        with np.load(path) as z:
            if "metadata" in z.files:
                meta = json.loads(bytes(z["metadata"]).decode("utf-8"))
                if meta.get("format_version", 0) > 1:
                    raise ValueError(
                        f"PQ index file {path} has format version "
                        f"{meta['format_version']} > supported 1"
                    )
                cap, m = int(meta["capacity"]), int(meta["max_edges"])
                is_ip = meta["metric"] == MetricType.IP.value
            else:  # legacy positional metadata
                cap, m, is_ip = (int(x) for x in z["meta"])
            centroids = z["centroids"]
            codes, links, labels = z["codes"], z["links"], z["labels"]
        m_pq, nc, dsub = centroids.shape
        pq = ProductQuantizer(
            dim=m_pq * dsub,
            num_subquantizers=m_pq,
            nbits=int(nc - 1).bit_length(),  # 16 -> 4, 256 -> 8
            metric=MetricType.IP if is_ip else MetricType.L2,
            device=dev,
        )
        pq.codebook = PQCodebook(torch.from_numpy(centroids.astype(np.float32)).to(dev))
        idx = cls(pq, cap, m)
        n = codes.shape[0]
        g = idx._graph
        g.vectors[:n] = torch.from_numpy(codes).to(dev)
        g.links[:n] = torch.from_numpy(links.astype(np.int32)).to(dev)
        g.labels[:n] = torch.from_numpy(labels.astype(np.int32)).to(dev)
        g.num_nodes = n
        return idx
