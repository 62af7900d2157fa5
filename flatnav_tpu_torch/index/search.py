"""Batched greedy beam search over the flat navigable-small-world graph.

Counterpart of flatnav_tpu/index/search.py. A whole batch of queries
advances in lockstep: each hop expands the best `expand_factor` unexpanded
entries of every query's sorted ef-wide beam, scores their neighbors and
merges the fresh ones back (the reference's beamSearch +
processCandidateNode, Index.h:606-707). A query is done when its beam holds
no unexpanded entry; the loop ends when every query is done or the hop cap
is reached.

The port keeps the JAX package's default behaviour and only that:

  * visited state is the "history" dedup: a candidate is fresh unless it is
    in the beam or was expanded before. Nodes evicted from the beam
    unexpanded can be scored again, so `distance_computations` reads a
    little higher than the reference's.
  * membership tests run as sorted lookups (`torch.searchsorted`) and the
    in-hop dedup is sort based; the JAX package's compare forms give the
    same masks. The beam merge is a stable sort with beam entries first on
    ties, which is bit-identical to its rank-and-gather merge.
  * the entry scan ("initializeSearch", Index.h:845-870) scores the
    `num_initializations` strided rows with one matmul (ENTRY_IMPL
    "matmul"). Its rounding differs from the hop's direct form, so the
    entry point can differ from the JAX package's on a near tie.

The search options are the JAX package's: `max_hops` (the hop cap),
`m_search` (only the first links of every node), `compact_width` (score only
the first fresh candidates of a hop) and, on `beam_search_core`,
`links_block` (who resolves neighbor lists: the table gather by default, a
sharded table's gather otherwise).

The hop's scorer is `gather_distances` (kernel K2) for float tables; integer
tables keep the exact int32 path.

Two routes run the rest of the hop, with the same results bit for bit. On a
CUDA card (`ops.beam_hop.engages`), at every shape, select, membership and
merge are one hand-written kernel each (`csrc/beam_hop.cu`), the history is
kept sorted, and the end test reads one flag the merge writes. On the CPU
the hop is the PyTorch chain `_select`, `_membership`, `_merge`, which is
the kernels' plain version.

Tracing (`utils.profiling`): `search` around a batched search, under it
`search.guard` (the memory guard, which asks the card for its memory),
`search.entry` and one `search.hop` a lockstep hop with its stages
(`.select`, `.links`, `.membership`, `.score`, `.merge`) and the end test
(`search.hop.end`, a wait: the host reads whether any beam holds an
unexpanded entry), and `search.counts` (the wait for the batch's counters);
counters `search.queries`, `search.hops`, `search.dist_computations`, and
`search.hops_fused` (one a hop that the kernels ran).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flatnav_tpu_torch.ops.distances import (
    MetricType,
    _is_int,
    pairwise_distances,
    query_block_distances,
)
from flatnav_tpu_torch.ops import beam_hop
from flatnav_tpu_torch.ops.gather_distance import gather_distances
from flatnav_tpu_torch.utils.profiling import count, span, traced, wait

_INT_SENTINEL = 2**31 - 1


class BeamResults(NamedTuple):
    dists: torch.Tensor  # [B, ef] ascending, +inf padding
    ids: torch.Tensor  # [B, ef] node ids (meaningless where dist == +inf)
    dist_computations: torch.Tensor  # scalar int64
    hops: torch.Tensor  # scalar int64: total expansions across the batch


class SearchResults(NamedTuple):
    dists: torch.Tensor  # [B, K]
    labels: torch.Tensor  # [B, K]
    dist_computations: int
    hops: int


# ---------------------------------------------------------------------------
# Device-memory guard: batched_search estimates the hop working set from
# the shapes and splits the query batch when it would not fit the card
# (queries are independent, so results are unchanged). A configuration that
# cannot fit one query raises ValueError before anything launches.
# ---------------------------------------------------------------------------


def _device_mem_limit(device) -> int | None:
    """Bytes of the card's memory; None on the CPU, which pages."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]


def _hop_cap(ef: int, e_f: int) -> int:
    """Hops a search runs at most: enough to expand every beam entry of a
    wide beam; a query stops earlier once its beam holds no unexpanded
    entry."""
    return max((2 * ef + 128) // e_f, 16)


def _search_temp_bytes(
    b: int, ef: int, e_f: int, m: int, d: int, compact_width: int = 0, max_hops: int = 0
) -> int:
    """Estimated bytes of per-hop intermediates for a B-query dispatch that
    expands `e_f` entries of `m` links a hop (the JAX package's accounting,
    kept as a conservative bound): the scoring block twice ([B, C, d], with
    C = `compact_width` where that is set and below E*M), the merge, the
    expanded-id history and the sorts. A `max_hops` above the default cap
    widens the history, and the hop's membership test against it is charged
    for the excess."""
    em = e_f * m
    c = compact_width if 0 < compact_width < em else em
    default_hist = _hop_cap(ef, e_f) * e_f
    hist_width = max_hops * e_f if max_hops else default_hist
    score = 2 * b * c * d * 4
    merge = b * ef * min(c, ef) * 4
    hist = b * hist_width * 4
    member_excess = b * c * max(hist_width - default_hist, 0) * 4
    sorts = 3 * b * (ef + c) * 4
    return score + merge + hist + member_excess + sorts


def safe_query_batch(
    b: int,
    ef: int,
    *,
    m: int,
    d: int,
    expand_factor: int = 1,
    compact_width: int = 0,
    table_bytes: int = 0,
    max_hops: int = 0,
    device="cpu",
) -> int:
    """Largest per-dispatch query sub-batch whose estimated working set fits
    the card (`torch.cuda.mem_get_info`); `b` unchanged on the CPU. Raises
    ValueError when even a single query cannot fit."""
    limit = _device_mem_limit(device)
    if not limit:
        return b
    avail = 0.85 * (limit - table_bytes)
    e_f = max(min(expand_factor, ef), 1)
    em = e_f * m

    def need(sub):
        return _search_temp_bytes(sub, ef, e_f, m, d, compact_width, max_hops)

    sub = b
    while sub > 1 and need(sub) > avail:
        sub //= 2
    if need(sub) > avail:
        raise ValueError(
            f"search config cannot fit device memory even at batch=1: "
            f"ef={ef}, expand_factor={expand_factor} (E*M={em}), d={d} "
            f"needs ~{need(1)/1e9:.2f} GB of hop working set per query "
            f"against ~{avail/1e9:.2f} GB available beside the "
            f"{table_bytes/1e9:.2f} GB table. Reduce ef or expand_factor, "
            f"or set compact_width."
        )
    return sub


def _first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """Mask of the first occurrence of each value per row ([B, C] -> bool):
    a stable sort makes duplicates adjacent, lowest position first."""
    order = torch.argsort(ids, dim=1, stable=True)
    sorted_ids = ids.gather(1, order)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    return torch.empty_like(first).scatter_(1, order, first)


def _sorted_member(sorted_tab: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row-wise membership of x [B, C] in sorted_tab [B, W] (ascending)."""
    w = sorted_tab.shape[1]
    pos = torch.searchsorted(sorted_tab, x.contiguous())
    hit = sorted_tab.gather(1, pos.clamp(max=w - 1))
    return (pos < w) & (hit == x)


def _merge_sorted(beam, new, ef: int):
    """Merge the sorted beam [B, ef] with sorted new entries [B, M] into a
    sorted [B, ef] beam (the top-k eviction of Index.h:693-704); ties keep
    beam entries first."""
    all_d, all_i, all_e = (torch.cat(p, dim=1) for p in zip(beam, new))
    order = torch.argsort(all_d, dim=1, stable=True)[:, :ef]
    return all_d.gather(1, order), all_i.gather(1, order), all_e.gather(1, order)


def _unexpanded_left(beam_e: torch.Tensor) -> bool:
    """The hop loop's end test: whether any beam still holds an unexpanded
    entry. The host waits for the card here, once a hop."""
    with wait("search.hop.end"):
        return bool((~beam_e).any())


def _flag_at(flag: torch.Tensor, stamp: int) -> bool:
    """The end test of a hop the kernels ran: whether its merge stamped the
    flag, i.e. some beam still holds an unexpanded entry (one scalar copy)."""
    with wait("search.hop.end"):
        return int(flag) == stamp


def _select(beam_i, beam_e, e_f: int, pos):
    """The hop's select: the first `e_f` unexpanded positions of each beam
    (`pos`: arange(ef)), marked expanded. -> (beam_e, cur_ids [B, e_f], 0
    where not valid, sel_valid [B, e_f])."""
    ef = beam_e.shape[1]
    unexp = ~beam_e
    if e_f == 1:
        sel = unexp.to(torch.int8).argmax(dim=1, keepdim=True)
        sel_valid = unexp.any(dim=1, keepdim=True)
    else:
        cand_pos = torch.where(unexp, pos, ef)
        sel = torch.topk(cand_pos, e_f, dim=1, largest=False).values
        sel_valid = sel < ef
    sel = sel.clamp(max=ef - 1)
    cur_ids = torch.where(sel_valid, beam_i.gather(1, sel), 0)
    hit = ((pos[None, :, None] == sel[:, None, :]) & sel_valid[:, None, :]).any(2)
    return beam_e | hit, cur_ids, sel_valid


def _membership(beam_d, beam_i, visited, it: int, cur_ids, nbrs, sel_valid, m: int,
                compact_width: int):
    """The hop's membership test: records this hop's expansions in slots
    it*E.. of the history `visited` (in place), then marks the fresh
    candidates: selected source, not in the beam (finite entries), not in
    the history, first occurrence in the row. -> (nbrs, fresh), the first
    `compact_width` fresh-first where that is below E*M."""
    e_f = sel_valid.shape[1]
    valid_src = sel_valid.repeat_interleave(m, dim=1)
    visited[:, it * e_f : (it + 1) * e_f] = torch.where(sel_valid, cur_ids, -1)
    beam_tab = torch.where(torch.isfinite(beam_d), beam_i, _INT_SENTINEL)
    in_beam = _sorted_member(beam_tab.sort(dim=1).values, nbrs)
    in_hist = _sorted_member(visited.sort(dim=1).values, nbrs)
    fresh = ~(in_beam | in_hist) & valid_src & _first_occurrence(nbrs)
    if 0 < compact_width < nbrs.shape[1]:
        # fresh-first: a stable sort on "not fresh" keeps both groups
        # in their order, so the kernel below scores CC rows, not E*M
        order = torch.argsort((~fresh).to(torch.int8), dim=1, stable=True)
        order = order[:, :compact_width]
        nbrs = nbrs.gather(1, order)
        fresh = fresh.gather(1, order)
    return nbrs, fresh


def _merge(beam, nbrs, fresh, nd, ef: int):
    """The hop's merge: sort the new entries (`nd`, +inf where not fresh),
    keep at most ef of them, merge them into the beam. -> the new beam
    (dists, ids, expanded)."""
    order = torch.argsort(nd, dim=1, stable=True)[:, :ef]
    new = (nd.gather(1, order), nbrs.gather(1, order), (~fresh).gather(1, order))
    return _merge_sorted(beam, new, ef)


def beam_search_core(
    links: torch.Tensor,
    num_nodes: int,
    batch: int,
    score_block,
    entry_block,
    *,
    ef: int,
    num_initializations: int = 100,
    max_hops: int = 0,
    expand_factor: int = 1,
    compact_width: int = 0,
    links_block=None,
) -> BeamResults:
    """Distance-backend-agnostic beam search loop.

    `score_block(ids [B, C] int32) -> [B, C] float32` scores node ids[b, c]
    against query b; `entry_block(cand [NI]) -> [B, NI]` scores the entry
    candidates that every query shares.

    `links_block(ids [B, E] int32) -> [B, E*M] int32` resolves neighbor
    lists; None is a gather from `links`. A row-sharded table supplies its
    own, and the hop loop, the visited state and the merge stay shared.

    `max_hops` (0 = the default cap) bounds the hops and sizes the
    expanded-id history.

    `compact_width` (CC, 0 = off): after the fresh mask, keep the first CC
    candidates of the hop with the fresh ones moved to the front (in their
    order), and score only those. Fresh candidates past CC are dropped for
    this hop; duplicates and visited ids go first. A no-op at CC >= E*M.
    Results repeat but are not those of the uncompacted hop."""
    m = links.shape[1]
    b = batch
    dev = links.device
    e_f = max(min(expand_factor, ef), 1)
    em = e_f * m
    hop_cap = max_hops if max_hops else _hop_cap(ef, e_f)
    if links_block is None:
        # one buffer for every hop's neighbour lists: a hop's reads of them
        # are queued before the next hop's gather
        nbr_rows = torch.empty((b * e_f, m), dtype=links.dtype, device=dev)

        def links_block(ids):
            return torch.index_select(links, 0, ids.view(-1), out=nbr_rows).view(b, em)

    ni = num_initializations
    step = max(num_nodes // ni, 1)
    with span("search.entry"):
        cand = torch.arange(ni, dtype=torch.int32, device=dev) * step
        cand_valid = cand < num_nodes
        cand = torch.where(cand_valid, cand, 0)
        d0 = torch.where(cand_valid[None, :], entry_block(cand), float("inf"))
        best = torch.argmin(d0, dim=1)
        beam_d = torch.full((b, ef), float("inf"), device=dev)
        beam_d[:, 0] = d0.gather(1, best[:, None])[:, 0]
        beam_i = torch.zeros((b, ef), dtype=torch.int32, device=dev)
        beam_i[:, 0] = cand[best]
        beam_e = torch.ones((b, ef), dtype=torch.bool, device=dev)
        beam_e[:, 0] = False
        # expanded-id history, -1 padded: the chain appends to it hop by hop,
        # the kernels keep it sorted
        visited = torch.full((b, hop_cap * e_f), -1, dtype=torch.int32, device=dev)

        # the reference counts num_initializations up front (Index.h:857-859)
        # plus 1 for the entry node (Index.h:619)
        dcomp = torch.tensor(b * (ni + 1), dtype=torch.int64, device=dev)
        hops = torch.zeros((), dtype=torch.int64, device=dev)
        if beam_hop.engages(dev):
            hop = beam_hop.BeamHop(beam_d, beam_i, beam_e, visited, dcomp, hops, e_f=e_f, m=m,
                                   compact_width=compact_width)
        else:
            hop, pos = None, torch.arange(ef, device=dev)
        it = 0
        more = it < hop_cap and _unexpanded_left(beam_e)

    while more:
        with span("search.hop"):
            with span("search.hop.select"):
                if hop:
                    cur_ids, sel_valid = hop.select()
                else:
                    beam_e, cur_ids, sel_valid = _select(beam_i, beam_e, e_f, pos)
            with span("search.hop.links"):
                nbrs = links_block(cur_ids)  # [B, E*M]
            with span("search.hop.membership"):
                if hop:
                    nbrs, fresh = hop.membership(nbrs)
                else:
                    nbrs, fresh = _membership(
                        beam_d, beam_i, visited, it, cur_ids, nbrs, sel_valid, m,
                        compact_width)
            with span("search.hop.score"):
                nd = score_block(nbrs)
                if not hop:
                    nd = torch.where(fresh, nd, float("inf"))
            with span("search.hop.merge"):
                if hop:
                    hop.merge(nd, nbrs, it + 1)
                else:
                    dcomp = dcomp + fresh.sum()
                    hops = hops + sel_valid.sum()
                    beam_d, beam_i, beam_e = _merge((beam_d, beam_i, beam_e), nbrs, fresh, nd, ef)
            it += 1
            if hop:
                count("search.hops_fused", 1)
                more = it < hop_cap and _flag_at(hop.flag, it)
            else:
                more = it < hop_cap and _unexpanded_left(beam_e)
    return BeamResults(beam_d, beam_i, dcomp, hops)


def table_blocks(vectors: torch.Tensor, queries: torch.Tensor, metric: MetricType):
    """(score_block, entry_block) of `beam_search_core` over a raw table:
    the hop scores ids through K2 (`gather_distances`) on float tables and
    exactly in int32 on integer ones; the entry scan is one [NI, d] gather
    and one matmul for all B x NI distances. Integer queries against an
    integer table keep the int32 path; other queries are widened to
    float32."""
    if not (_is_int(queries) and _is_int(vectors)):
        queries = queries.to(torch.float32)

    if _is_int(vectors):
        def score_block(ids):
            return query_block_distances(queries, vectors[ids.long()], metric)
    else:
        def score_block(ids):
            return gather_distances(vectors, ids, queries, metric)

    def entry_block(cand):
        return pairwise_distances(queries, vectors[cand.long()], metric)

    return score_block, entry_block


def beam_search(
    vectors: torch.Tensor,
    links: torch.Tensor,
    num_nodes: int,
    queries: torch.Tensor,
    *,
    ef: int,
    metric: MetricType = MetricType.L2,
    num_initializations: int = 100,
    max_hops: int = 0,
    expand_factor: int = 1,
    compact_width: int = 0,
    m_search: int = 0,
) -> BeamResults:
    """Batched beam search over raw stored vectors; returns the ef-wide
    beam per query.

    `m_search` (0 = all): follow only the first m_search links of a node. A
    node's committed links are sorted by distance (the prune's output
    order), so the prefix is a lower-degree view of the same graph. The
    slice is a view; the hop gathers its rows from it."""
    if 0 < m_search < links.shape[1]:
        links = links[:, :m_search]
    score_block, entry_block = table_blocks(vectors, queries, metric)
    return beam_search_core(
        links,
        num_nodes,
        queries.shape[0],
        score_block,
        entry_block,
        ef=ef,
        num_initializations=num_initializations,
        max_hops=max_hops,
        expand_factor=expand_factor,
        compact_width=compact_width,
    )


@traced("search")
def batched_search(
    vectors: torch.Tensor,
    links: torch.Tensor,
    labels: torch.Tensor,
    num_nodes: int,
    queries: torch.Tensor,
    *,
    k: int,
    ef: int,
    metric: MetricType = MetricType.L2,
    num_initializations: int = 100,
    max_hops: int = 0,
    expand_factor: int = 1,
    compact_width: int = 0,
    m_search: int = 0,
) -> SearchResults:
    """Top-K search: Index::search (Index.h:387-409) over a query batch,
    split into sub-batches where the memory guard asks for it."""
    b = queries.shape[0]
    ef = max(ef, k)
    m_eff = m_search if 0 < m_search < links.shape[1] else links.shape[1]
    table_bytes = (
        vectors.numel() * vectors.element_size() + links.numel() * 4 + labels.numel() * 4
    )
    with span("search.guard"):
        sub = safe_query_batch(
            b, ef, m=m_eff, d=vectors.shape[1], expand_factor=expand_factor,
            compact_width=compact_width, table_bytes=table_bytes, max_hops=max_hops,
            device=vectors.device,
        )
    dists, labs, dcomp, hops = [], [], 0, 0
    for lo in range(0, b, sub):
        beam = beam_search(
            vectors, links, num_nodes, queries[lo : lo + sub], ef=ef,
            metric=metric, num_initializations=num_initializations,
            max_hops=max_hops, expand_factor=expand_factor,
            compact_width=compact_width, m_search=m_search,
        )
        top_d, top_i = beam.dists[:, :k], beam.ids[:, :k]
        dists.append(top_d)
        labs.append(torch.where(torch.isfinite(top_d), labels[top_i.long()], -1))
        with wait("search.counts"):
            n_dc, n_hops = int(beam.dist_computations), int(beam.hops)
        count("search.queries", top_d.shape[0])
        count("search.hops", n_hops)
        count("search.dist_computations", n_dc)
        dcomp += n_dc
        hops += n_hops
    return SearchResults(torch.cat(dists), torch.cat(labs), dcomp, hops)


__all__ = [
    "BeamResults",
    "SearchResults",
    "batched_search",
    "beam_search",
    "beam_search_core",
    "safe_query_batch",
    "table_blocks",
]
