"""Wave-based graph construction: Index::add/addBatch in insertion waves.

Counterpart of flatnav_tpu/index/build.py. A wave of W new points runs the
batched beam search against the committed prefix (plus exact candidates
among earlier points of the same wave), a batched diversity prune
(selectNeighbors, Index.h:714-763) picks each point's neighbors, and edges
are committed wave-synchronously: forward edges first, then back edges
grouped by target on the host, each target re-pruned when its links
overflow (connectNeighbors, Index.h:765-834). The pipeline is deterministic:
two builds of the same data give bit-identical graphs.

The port updates the graph's tensors in place (the JAX package returns new
arrays), which keeps one copy of the table in device memory.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from flatnav_tpu_torch.data_type import host_tensor
from flatnav_tpu_torch.index.graph import MAX_WAVE, GraphArrays
from flatnav_tpu_torch.index.search import (
    _device_mem_limit,
    _search_temp_bytes,
    beam_search,
)
from flatnav_tpu_torch.ops.distances import (
    MetricType,
    _is_int,
    pairwise_distances,
    query_block_distances,
    smallest_k,
)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _prune_itemsize(dtype: torch.dtype) -> int:
    """Bytes an element of the prune's candidate rows takes: 8-bit rows are
    promoted to float64 (exact products, see `select_neighbors`), every
    other table to float32."""
    return 8 if dtype in (torch.uint8, torch.int8) else 4


def _precomputes(w: int, c: int, itemsize: int = 4) -> bool:
    """Whether `select_neighbors` takes the [W, C, C] product of `itemsize`
    -byte elements (`_prune_itemsize`): it fits 1 GiB. For 8-bit rows both
    forms are exact, so the choice changes no result there."""
    return w * c * c * itemsize <= (1 << 30)


def select_neighbors(
    cand_dists: torch.Tensor,  # [W, C] ascending, +inf invalid
    cand_ids: torch.Tensor,  # [W, C]
    cand_vecs: torch.Tensor,  # [W, C, d]
    m: int,
    metric: MetricType,
    precompute: bool | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched HNSW diversity pruning (Index.h:714-763 `selectNeighbors`).

    Scans candidates in ascending distance order and keeps c_i iff fewer
    than `m` are kept and no kept c_j has dist(c_j, c_i) < dist(q, c_i).
    Returns (kept_ids [W, m] -1 padded, kept_count [W], kept_dists [W, m]).
    The [W, C, C] candidate distances are one batched product when they fit
    1 GiB (`precompute=None`, `_precomputes`); the two forms round
    differently, so a caller that prunes a slice of a wave passes the whole
    wave's choice. The scan itself is sequential by nature."""
    w, c = cand_dists.shape
    if precompute is None:
        precompute = _precomputes(w, c, _prune_itemsize(cand_vecs.dtype))
    is_int = _is_int(cand_vecs)
    if is_int:
        # float64 products of 8-bit values are exact (see ops/distances.py)
        cv = cand_vecs.to(torch.float64)
    else:
        cv = cand_vecs.to(torch.float32)

    if precompute:
        dots = torch.bmm(cv, cv.transpose(1, 2))
        if metric == MetricType.IP:
            pair_d = 1.0 - dots.to(torch.float32)
        else:
            sq = (cv * cv).sum(-1)
            pair_d = (sq[:, :, None] - 2 * dots + sq[:, None, :]).clamp_min(0)
            pair_d = pair_d.to(torch.float32)

        def col_dist(i):
            return pair_d[:, :, i]
    else:
        def col_dist(i):
            vec_i = cv[:, i]
            if metric == MetricType.IP:
                return 1.0 - torch.einsum("wcd,wd->wc", cv, vec_i).to(torch.float32)
            diff = cv - vec_i[:, None, :]
            return (diff * diff).sum(-1).to(torch.float32)

    kept_mask = torch.zeros((w, c), dtype=torch.bool, device=cand_dists.device)
    count = torch.zeros(w, dtype=torch.int32, device=cand_dists.device)
    finite = torch.isfinite(cand_dists)
    for i in range(c):
        dq_i = cand_dists[:, i]
        closer = kept_mask & (col_dist(i) < dq_i[:, None])
        take = finite[:, i] & (count < m) & ~closer.any(dim=1)
        kept_mask[:, i] = take
        count += take.to(torch.int32)
    # with at most m candidates keep them all, unpruned (Index.h:715-717)
    valid_count = finite.sum(dim=1, dtype=torch.int32)
    few = valid_count <= m
    kept_mask = torch.where(few[:, None], finite, kept_mask)
    count = torch.where(few, valid_count, count)
    # kept entries to the front, in ascending-distance order
    order = torch.argsort((~kept_mask).to(torch.int8), dim=1, stable=True)[:, :m]
    sorted_ids = cand_ids.gather(1, order)
    sorted_d = cand_dists.gather(1, order)
    if c < m:  # fewer candidate slots than the edge budget
        sorted_ids = torch.nn.functional.pad(sorted_ids, (0, m - c), value=-1)
        sorted_d = torch.nn.functional.pad(sorted_d, (0, m - c), value=float("inf"))
    slot = torch.arange(m, device=cand_dists.device)[None, :]
    keep = slot < count[:, None]
    kept_ids = torch.where(keep, sorted_ids, -1).to(torch.int32)
    kept_dists = torch.where(keep, sorted_d, float("inf"))
    return kept_ids, count, kept_dists


class WaveSelection(NamedTuple):
    kept_ids: torch.Tensor  # [W, m_sel], -1 padded
    kept_dists: torch.Tensor  # [W, m_sel], +inf padded
    dist_computations: torch.Tensor
    hops: torch.Tensor


def wave_search_select(
    vectors: torch.Tensor,
    links: torch.Tensor,
    num_nodes: int,
    new_vecs: torch.Tensor,  # [W, d] (storage dtype)
    n_valid: int,  # real (unpadded) wave length
    *,
    ef_construction: int,
    m_sel: int,
    metric: MetricType,
    num_initializations: int = 100,
    intra_candidates: int = 0,
    expand_factor: int = 16,
) -> WaveSelection:
    """Phase 1 of a wave: beam search + diversity prune for W new points
    (beamSearch(ef_construction) + selectNeighbors(M/2), Index.h:368-377).
    Each lane also gets its `intra_candidates` exact nearest EARLIER lanes
    of the wave (ids num_nodes + lane), so a wave sees what a sequential
    insert would have seen."""
    beam = beam_search(
        vectors, links, num_nodes, new_vecs, ef=ef_construction, metric=metric,
        num_initializations=num_initializations, expand_factor=expand_factor,
    )
    kept_ids, kept_d = prune_wave(
        beam, new_vecs, num_nodes, n_valid, lambda ids: vectors[ids.long()],
        lanes=slice(0, new_vecs.shape[0]), m_sel=m_sel, metric=metric,
        intra_candidates=intra_candidates,
    )
    return WaveSelection(kept_ids, kept_d, beam.dist_computations, beam.hops)


def prune_wave(
    beam,
    new_vecs: torch.Tensor,  # [W, d] the whole (padded) wave
    num_nodes: int,
    n_valid: int,
    gather_rows,
    *,
    lanes: slice,
    m_sel: int,
    metric: MetricType,
    intra_candidates: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The intra-wave candidates and the prune of wave_search_select for the
    lanes `lanes` of the wave, whose beams `beam` holds. -> (kept_ids,
    kept_dists) [lanes, m_sel].

    The [W, W] intra-wave block is computed for the whole wave and its rows
    sliced, and the prune takes the whole wave's form, so a lane's result
    does not depend on which lanes share the call. `gather_rows(ids)` returns
    the table rows of node ids (storage dtype)."""
    cand_d, cand_i = beam.dists, beam.ids
    w = new_vecs.shape[0]
    c2 = min(intra_candidates, w) if intra_candidates else 0
    if c2 > 0:
        intra = pairwise_distances(new_vecs, new_vecs, metric)[lanes]  # [lanes, W]
        lane = torch.arange(w, dtype=torch.int32, device=new_vecs.device)
        mine = lane[lanes]
        allowed = (lane[None, :] < mine[:, None]) & (lane[None, :] < n_valid)
        intra = torch.where(allowed, intra, float("inf"))
        intra_d, idx = smallest_k(intra, lane[None, :], c2)
        intra_ids = torch.where(torch.isfinite(intra_d), num_nodes + idx, -1)
        cand_d = torch.cat([cand_d, intra_d], dim=1)
        cand_i = torch.cat([cand_i, intra_ids.to(torch.int32)], dim=1)
        order = torch.argsort(cand_d, dim=1, stable=True)
        cand_d, cand_i = cand_d.gather(1, order), cand_i.gather(1, order)

    cand_vecs = gather_rows(cand_i.clamp_min(0))  # storage dtype
    kept_ids, _, kept_d = select_neighbors(
        cand_d, cand_i, cand_vecs, m_sel, metric,
        precompute=_precomputes(w, cand_d.shape[1], _prune_itemsize(new_vecs.dtype)),
    )
    return kept_ids, kept_d


def commit_vectors(graph: GraphArrays, new_vecs: torch.Tensor, new_labels: torch.Tensor):
    """Allocate node data for a whole padded wave (allocateNode,
    Index.h:262-267), before the wave search, so intra-wave candidate ids
    are gatherable. Padding-lane rows are rewritten by the next wave."""
    n0 = graph.num_nodes
    graph.vectors[n0 : n0 + new_vecs.shape[0]] = new_vecs.to(graph.vectors.dtype)
    graph.labels[n0 : n0 + new_labels.shape[0]] = new_labels


def forward_links(kept_ids: torch.Tensor, n0: int, n_valid: int, m: int) -> torch.Tensor:
    """The wave's link rows [wave, m]: each new node's kept neighbours, then
    its own id in the unused slots (Index.h:269-270, 776-779); padding
    lanes get self-loops only."""
    wave, m_sel = kept_ids.shape
    lane = torch.arange(wave, dtype=torch.int32, device=kept_ids.device)
    node_ids = (n0 + lane)[:, None]
    padded = torch.nn.functional.pad(kept_ids, (0, m - m_sel), value=-1)
    fwd = torch.where(padded >= 0, padded, node_ids)
    return torch.where((lane < n_valid)[:, None], fwd, node_ids)


def commit_links(graph: GraphArrays, kept_ids: torch.Tensor, n_valid: int):
    """Forward edges; advances the committed count."""
    n0 = graph.num_nodes
    graph.links[n0 : n0 + kept_ids.shape[0]] = forward_links(
        kept_ids, n0, n_valid, graph.max_edges
    )
    graph.num_nodes = n0 + n_valid


def _back_edge_core(
    gather_vecs,
    links: torch.Tensor,
    targets: torch.Tensor,  # [T] node ids, -1 padded
    requesters: torch.Tensor,  # [T, R] new-node ids, -1 padded
    metric: MetricType,
) -> None:
    """Back-edge insert/repair for all touched targets of a wave, in place.

    Free self-loop slots absorb requesters closest-first (Index.h:783-790);
    on overflow the target's links are re-pruned with the diversity
    heuristic over {existing links} + {requesters} (Index.h:792-825).
    `gather_vecs(ids)` returns distance-ready vectors for any id array.
    Padding lanes address the scratch row (links' last row)."""
    row_valid = targets >= 0
    safe_targets = torch.where(row_valid, targets, links.shape[0] - 1)
    existing = links[safe_targets.long()]  # [T, M]
    new_rows = back_edge_rows(gather_vecs, existing, safe_targets, row_valid, requesters, metric)
    # duplicate indices only hit the scratch row, always with its own row
    links[safe_targets.long()] = new_rows.to(links.dtype)


def back_edge_rows(
    gather_vecs,
    existing: torch.Tensor,  # [T, M] the targets' current links
    safe_targets: torch.Tensor,  # [T] target ids, padding lanes on a scratch id
    row_valid: torch.Tensor,  # [T] false on padding lanes
    requesters: torch.Tensor,  # [T, R] new-node ids, -1 padded
    metric: MetricType,
) -> torch.Tensor:
    """The targets' new link rows [T, M] (see _back_edge_core); a row's
    result depends on that row's inputs alone."""
    m = existing.shape[1]
    exist_valid = existing != safe_targets[:, None]
    req_valid = requesters >= 0
    cand_ids = torch.cat([existing, requesters], dim=1)  # [T, M+R]
    cand_valid = torch.cat([exist_valid, req_valid], dim=1)
    total = cand_valid.sum(dim=1)
    overflow = total > m

    # fill path: valid candidates compressed to the front
    order = torch.argsort((~cand_valid).to(torch.int8), dim=1, stable=True)
    packed = cand_ids.gather(1, order)[:, :m]
    slot = torch.arange(m, device=existing.device)[None, :]
    filled = torch.where(slot < total[:, None], packed, safe_targets[:, None])

    # prune path
    tgt_vecs = gather_vecs(safe_targets)
    cand_vecs = gather_vecs(torch.where(cand_valid, cand_ids, 0))
    dists = query_block_distances(tgt_vecs, cand_vecs, metric)
    dists = torch.where(cand_valid, dists, float("inf"))
    order = torch.argsort(dists, dim=1, stable=True)
    sd = dists.gather(1, order)
    si = torch.where(cand_valid, cand_ids, -1).gather(1, order)
    sv = cand_vecs.gather(1, order[:, :, None].expand_as(cand_vecs))
    kept_ids, _, _ = select_neighbors(sd, si, sv, m, metric)
    pruned = torch.where(kept_ids >= 0, kept_ids, safe_targets[:, None])

    new_rows = torch.where(overflow[:, None], pruned, filled)
    return torch.where(row_valid[:, None], new_rows, existing)


def back_edge_commit(
    vectors: torch.Tensor,
    links: torch.Tensor,
    targets: torch.Tensor,
    requesters: torch.Tensor,
    *,
    metric: MetricType,
) -> None:
    """Back-edge insert/repair over a raw vector table, in place. The
    scratch row id (one past the table) gathers a clamped row that only
    padding lanes see."""
    last = vectors.shape[0] - 1
    _back_edge_core(
        lambda ids: vectors[ids.clamp(max=last).long()],
        links, targets, requesters, metric,
    )


#: canonical back-edge batch shapes (rows, requester width)
_BE_T_SMALL = 256
_BE_T_CHUNK = 16384
_BE_R_SMALL = 8
#: requesters kept per target per wave, closest first: a target keeps at
#: most M edges after re-pruning, so 32 (a typical M) loses nothing real
_BE_R_CAP = 32


def _commit_back_edges(commit_fn, tgt, src_rep, dist_rep, device):
    """Group (target <- source) requests by target on the host and apply
    `commit_fn(targets, requesters)` in canonical shape buckets. Past
    _BE_R_CAP requesters per target the farthest are dropped (by
    dist(source, target), then source id)."""
    order = np.lexsort((src_rep, dist_rep, tgt))  # target, then distance
    tgt, src_rep = tgt[order], src_rep[order]
    uniq, start_idx, counts = np.unique(tgt, return_index=True, return_counts=True)
    r_bucket = _BE_R_SMALL if int(counts.max()) <= _BE_R_SMALL else _BE_R_CAP
    col = np.arange(len(tgt)) - np.repeat(start_idx, counts)
    rowi = np.repeat(np.arange(len(uniq)), counts)
    keep = col < r_bucket
    req = np.full((len(uniq), r_bucket), -1, np.int32)
    req[rowi[keep], col[keep]] = src_rep[keep]

    t_chunk = _BE_T_SMALL if len(uniq) <= _BE_T_SMALL else _BE_T_CHUNK
    for lo in range(0, len(uniq), t_chunk):
        hi = min(lo + t_chunk, len(uniq))
        tgt_arr = np.full(t_chunk, -1, np.int32)
        tgt_arr[: hi - lo] = uniq[lo:hi]
        req_arr = np.full((t_chunk, r_bucket), -1, np.int32)
        req_arr[: hi - lo] = req[lo:hi]
        commit_fn(torch.from_numpy(tgt_arr).to(device), torch.from_numpy(req_arr).to(device))


_MIN_WAVE = 64
_MAX_WAVE = MAX_WAVE


def _safe_wave_size(
    max_wave: int,
    *,
    ef_construction: int,
    m: int,
    d: int,
    expand_factor: int,
    intra_candidates: int,
    table_bytes: int,
    device="cpu",
    prune_itemsize: int = 4,
) -> int:
    """Largest wave whose estimated working set fits the card (read from
    `torch.cuda.mem_get_info`); the build-side analog of
    search.safe_query_batch. Narrower waves only trade occupancy: wave
    members get exact intra-wave candidates at any width.
    `prune_itemsize` is the bytes of a candidate-row element in the prune
    (`_prune_itemsize`: 8 for 8-bit tables)."""
    limit = _device_mem_limit(device)
    if not limit:
        return max_wave
    avail = 0.85 * (limit - table_bytes)
    e_f = max(min(expand_factor, ef_construction), 1)
    cand = ef_construction + intra_candidates

    def temp(w: int) -> int:
        w = max(_next_pow2(w), _MIN_WAVE)  # the dispatch pads to pow2
        return (
            _search_temp_bytes(w, ef_construction, e_f, m, d)
            + w * w * 4  # intra-wave pairwise block
            + 2 * w * cand * d * prune_itemsize  # candidate-row gather + prune scratch
        )

    w = max_wave
    while w > _MIN_WAVE and temp(w) > avail:
        w //= 2
    if temp(w) > avail:
        raise ValueError(
            f"build config cannot fit device memory even at the minimum "
            f"{_MIN_WAVE}-point wave: ef_construction={ef_construction}, "
            f"expand_factor={expand_factor}, d={d} needs "
            f"~{temp(w) / 1e9:.2f} GB of wave working set against "
            f"~{avail / 1e9:.2f} GB available beside the "
            f"{table_bytes / 1e9:.2f} GB table. Reduce ef_construction or "
            f"expand_factor."
        )
    return w


def _wave_size(committed: int, remaining: int, max_wave: int) -> int:
    """Every wave uses the full width: wave members get exact intra-wave
    candidates, so graph quality does not depend on the wave/committed
    ratio."""
    del committed
    return int(min(max_wave, remaining))


class LocalWave:
    """The steps of a wave where this device holds the whole table. The
    mesh build (`flatnav_tpu_torch.parallel.sharded_build`) supplies the
    same steps over a mesh; `add_batch`'s wave loop drives either."""

    def __init__(self, graph: GraphArrays):
        self.graph = graph

    def commit_vectors(self, new_vecs, new_labels):
        commit_vectors(self.graph, new_vecs, new_labels)

    def select(self, new_vecs, n_valid, **kw) -> WaveSelection:
        g = self.graph
        return wave_search_select(g.vectors, g.links, g.num_nodes, new_vecs, n_valid, **kw)

    def commit_links(self, kept_ids, n_valid):
        commit_links(self.graph, kept_ids, n_valid)

    def back_edges(self, targets, requesters, metric):
        back_edge_commit(self.graph.vectors, self.graph.links, targets, requesters, metric=metric)


def add_batch(
    graph: GraphArrays,
    data: np.ndarray,
    labels: np.ndarray,
    *,
    ef_construction: int,
    metric: MetricType,
    num_initializations: int = 100,
    max_wave: int = _MAX_WAVE,
    intra_candidates: int | None = None,
    stats: dict | None = None,
    mesh=None,
    table_spec: str = "replicated",
    expand_factor: int = 32,
) -> GraphArrays:
    """Insert `data` ([n, d], numpy or tensor) with `labels` ([n]) into the
    index, in place (Index::addBatch, Index.h:300-329). Returns the graph.

    With `mesh` (`flatnav_tpu_torch.parallel.make_mesh`; every rank calls
    this with the same arguments), a wave's lanes split over the mesh's
    `data` axis, the multi-device analog of the reference's insert thread
    pool. `table_spec` picks the table's layout:

      * "replicated": every rank holds the whole graph, and `graph` is
        updated in place.
      * "model": the rows of vectors, links and labels shard over the
        mesh's `model` axis; a rank holds only its own rows. `graph` is
        either a full graph (on the host, say), whose rows this rank takes
        (`parallel.shard_graph`), or such a shard; the shard is returned.

    Every rank commits the same edges, and every merge across ranks has one
    owner per value, so both layouts build the graph the single device
    builds, bit for bit. The wave width's memory guard counts the table
    bytes this rank holds: 1/n_model of the table under "model"."""
    if mesh is None:
        steps = LocalWave(graph)
    else:
        from flatnav_tpu_torch.parallel.sharded_build import mesh_wave

        steps = mesh_wave(graph, mesh, table_spec)
    graph = steps.graph
    dev = graph.device
    n = data.shape[0]
    cap = graph.capacity
    m = graph.max_edges
    m_sel = max(m // 2, 1)  # Index.h:374
    if intra_candidates is None:
        intra_candidates = 2 * m_sel
    max_wave = _safe_wave_size(
        min(max_wave, _MAX_WAVE),
        ef_construction=ef_construction,
        m=m,
        d=graph.dim,
        expand_factor=expand_factor,
        intra_candidates=intra_candidates,
        table_bytes=graph.vectors.numel() * graph.vectors.element_size()
        + graph.links.numel() * 4,
        device=dev,
        prune_itemsize=_prune_itemsize(graph.vectors.dtype),
    )
    committed = graph.num_nodes
    if committed + n > cap:
        raise RuntimeError(
            "Maximum number of nodes reached. Consider increasing the "
            "`max_node_count` parameter to create a larger index."
        )  # message parity with Index.h:356-359
    if n == 0:
        return graph

    data = host_tensor(data)
    labels = host_tensor(np.asarray(labels, dtype=np.int32))
    pos = 0
    # the very first node gets no edges (Index.h:369-371)
    if committed == 0:
        steps.commit_vectors(data[:1].to(dev), labels[:1].to(dev))
        graph.num_nodes = committed = pos = 1

    bucket_used = 0
    while pos < n:
        w = _wave_size(committed, n - pos, max_wave)
        # one wave width for the whole build: the tail wave is padded
        bucket = max(_next_pow2(w), _MIN_WAVE, bucket_used)
        bucket_used = bucket
        wave_data = data[pos : pos + w].to(dev)
        wave_labels = labels[pos : pos + w].to(dev)
        if w < bucket:  # pad lanes with the first row; masked out by n_valid
            pad = bucket - w
            wave_data = torch.cat([wave_data, wave_data[:1].expand(pad, -1)])
            wave_labels = torch.cat(
                [wave_labels, torch.zeros(pad, dtype=torch.int32, device=dev)]
            )
        new_vecs = wave_data.to(graph.vectors.dtype)
        steps.commit_vectors(new_vecs, wave_labels)
        sel = steps.select(
            new_vecs, w, ef_construction=ef_construction, m_sel=m_sel, metric=metric,
            num_initializations=num_initializations,
            intra_candidates=intra_candidates, expand_factor=expand_factor,
        )
        if stats is not None:
            stats["distance_computations"] = stats.get(
                "distance_computations", 0
            ) + int(sel.dist_computations)
            stats["hops"] = stats.get("hops", 0) + int(sel.hops)
        steps.commit_links(sel.kept_ids, w)

        # back edges: host grouping, device compute
        kept = sel.kept_ids[:w].cpu().numpy()  # [w, m_sel]
        kept_d = sel.kept_dists[:w].cpu().numpy()  # dist(src, tgt)
        src = committed + np.arange(w, dtype=np.int32)
        tgt = kept.reshape(-1)
        src_rep = np.repeat(src, m_sel)
        dist_rep = kept_d.reshape(-1)
        mask = tgt >= 0
        if mask.any():
            _commit_back_edges(
                lambda t_, r_: steps.back_edges(t_, r_, metric),
                tgt[mask], src_rep[mask], dist_rep[mask], device=dev,
            )
        committed += w
        pos += w
    return graph
