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
tables keep the exact int32 path. The scorer is handed only the hop's
fresh candidates: -1 in every other slot, for which K2 loads no row (the
merge reads no score of a slot that is not fresh). The merge keeps the
candidates' own ids.

Select, membership and merge are the hop engine's (`ops.beam_hop.make_hop`:
the kernels of `csrc/beam_hop.cu` on a CUDA card, their plain PyTorch
version elsewhere, with the same results bit for bit), which holds the
search's state; the loop calls its stages, the links gather and the scorer.

One loop runs every search (`_late_hops`): it reads hop n's end flag after
hop n + 1 is queued, so one hop past the end is issued. A hop issued after
the beams have converged selects nothing, hands the scorer no fresh
candidate and leaves the beams and counters as they are; the hops issued
depend on the data alone. Two issuers drive it. `_EagerHops` issues each
stage and reads the engine's flag, which waits for the card. Where the
engine is the kernels' and the links gather is the table's own
(`links_block` None), a shape that a card searches twice in a row is
captured as CUDA graphs (`_HopGraphs`: select, the links gather,
membership and merge, over state kept for the next search of that shape on
that card) and replayed, one replay a hop beside one eager call of the
scorer; the flag reaches pinned host memory, and the host waits for hop n
alone, so the card does not drain at every hop. A card keeps one captured
shape: a shape searched once in between runs eagerly and leaves it kept,
and a search that keeps nothing (`graph_hop=False`, the build's waves)
frees it.

Tracing (`utils.profiling`): `search` around a batched search, under it
`search.guard` (the memory guard, which asks the card for its memory),
`search.entry` and one `search.hop` a lockstep hop, and `search.counts`
(the wait for the batch's counters). A hop holds `.score` (the scorer),
then its merge and the next hop's select, links gather and membership:
issued stage by stage, their spans (`.merge`, `.select`, `.links`,
`.membership`); replayed, one `.graph`; then the end test (`search.hop.end`,
a wait: the host reads whether the hop before left any beam with an
unexpanded entry). `search.entry` holds the first hop's select, links
gather and membership (or its replay's `.graph`). Counters
`search.queries`, `search.hops`, `search.dist_computations`,
`search.hops_fused` (one a hop that the kernels ran), `search.hops_graphed`
(hops issued as a replay), `search.hops_spare` (hops issued after the
beams had converged; at the hop cap counted only while tracing),
`search.hop_captures` (graphs captured),
`search.hop_capped` (queries whose beam still held an unexpanded entry when
the loop stopped at the hop cap; counted for every sub-batch, 0 included,
and only while tracing: it reads the final beam once more) and
`search.k2_slots` (the slots the hops handed the scorer, B x C a hop,
counted on the host). The fresh ones among them are
`search.dist_computations` less the entry scan's `search.queries` x
(num_initializations + 1), so 1 - that / k2_slots is the share of K2's
slots that load no row.
"""

from __future__ import annotations

import inspect
import threading
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
from flatnav_tpu_torch.utils.profiling import count, is_tracing, span, traced, wait


class BeamResults(NamedTuple):
    dists: torch.Tensor  # [B, ef] ascending, +inf padding
    ids: torch.Tensor  # [B, ef] node ids (meaningless where dist == +inf)
    dist_computations: torch.Tensor  # scalar int64
    hops: torch.Tensor  # scalar int64: total expansions across the batch
    expanded: torch.Tensor  # [B, ef] bool: the final beam's expanded marks
    slots: int  # candidate slots handed to the scorer, B x C a hop


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


def _capped_queries(beam: BeamResults) -> int:
    """Queries of a finished search whose beam still holds an unexpanded
    entry: the loop ends for want of one unless the hop cap stops it first,
    so these are the queries the cap cut short. Reads the card."""
    return int((~beam.expanded).any(1).sum())


def _empty_state(b: int, ef: int, hist_width: int, device) -> tuple:
    """Uninitialised tensors of a search's state, as `entry_beam` fills them."""
    return (torch.empty((b, ef), device=device),
            torch.empty((b, ef), dtype=torch.int32, device=device),
            torch.empty((b, ef), dtype=torch.bool, device=device),
            torch.empty((b, hist_width), dtype=torch.int32, device=device),
            torch.empty((), dtype=torch.int64, device=device),
            torch.empty((), dtype=torch.int64, device=device))


def entry_beam(entry_block, num_nodes: int, b: int, ef: int, hist_width: int, ni: int, device,
               out=None):
    """The state a search starts from: `entry_block` scores `ni` candidates
    at a stride of the `num_nodes` ids, and each query's beam holds its best
    one, unexpanded. -> (beam_d [B, ef], beam_i, beam_e, the expanded-id
    history [B, hist_width] of -1, dcomp, hops), as the hop engine takes
    them: written into `out`, six tensors of those shapes, where it is given."""
    step = max(num_nodes // ni, 1)
    cand = torch.arange(ni, dtype=torch.int32, device=device) * step
    cand_valid = cand < num_nodes
    cand = torch.where(cand_valid, cand, 0)
    d0 = torch.where(cand_valid[None, :], entry_block(cand), float("inf"))
    best = torch.argmin(d0, dim=1)
    out = _empty_state(b, ef, hist_width, device) if out is None else out
    beam_d, beam_i, beam_e, hist, dcomp, hops = out
    beam_d.fill_(float("inf"))
    beam_d[:, 0] = d0.gather(1, best[:, None])[:, 0]
    beam_i.zero_()
    beam_i[:, 0] = cand[best]
    beam_e.fill_(True)
    beam_e[:, 0] = False
    hist.fill_(-1)
    # the reference counts num_initializations up front (Index.h:857-859)
    # plus 1 for the entry node (Index.h:619)
    dcomp.fill_(b * (ni + 1))
    hops.zero_()
    return out


def _open_hop(hop, links_block) -> torch.Tensor:
    """A hop's select, links gather and membership -> the candidates its
    merge takes; the scorer's ids are then `hop.score_ids`."""
    with span("search.hop.select"):
        cur_ids, _ = hop.select()
    with span("search.hop.links"):
        nbrs = links_block(cur_ids)  # [B, E*M]
    with span("search.hop.membership"):
        return hop.membership(nbrs)[0]


def _close_hop(hop, scores: torch.Tensor, nbrs: torch.Tensor) -> None:
    """A hop's merge of its scored candidates."""
    with span("search.hop.merge"):
        hop.merge(scores, nbrs)


def _late_hops(hops, hop_cap: int) -> int:
    """A search's hops, from hop 1, which `hops` has opened (select, links
    gather, membership), with the end test one hop late. `hops.score()`
    scores the open hop; `hops.step(last)` closes it (merge) and, unless
    `last`, opens the next; `hops.unexpanded_after(n)` says whether hop n
    left a beam with an unexpanded entry. After issuing hop n the host reads
    hop n - 1's flag, so one hop past the end is issued (a spare, a no-op),
    and none past the cap. -> the hops issued."""
    n = 0
    while True:
        n += 1
        last = n == hop_cap
        with span("search.hop"):
            with span("search.hop.score"):
                hops.score()
            hops.step(last)
            if last:
                if is_tracing():
                    count("search.hops_spare", int(n > 1 and not hops.unexpanded_after(n - 1)))
                return n
            if n > 1:  # the start beams hold an unexpanded entry
                with wait("search.hop.end"):
                    more = hops.unexpanded_after(n - 1)
                if not more:
                    count("search.hops_spare", 1)
                    return n


class _EagerHops:
    """A search's hops for `_late_hops`, issued stage by stage: the engine's
    stages, the caller's links gather and scorer, and the engine's flag for
    the end test (a read that waits for all that is queued). Opens hop 1."""

    def __init__(self, hop, links_block, score_block):
        self.hop, self.links_block, self.score_block = hop, links_block, score_block
        self.slots = 0
        self.nbrs = _open_hop(hop, links_block)

    def score(self) -> None:
        self.slots += self.hop.score_ids.numel()
        self.scores = self.score_block(self.hop.score_ids)

    def step(self, last: bool) -> None:
        _close_hop(self.hop, self.scores, self.nbrs)
        if not last:
            self.nbrs = _open_hop(self.hop, self.links_block)

    def unexpanded_after(self, n: int) -> bool:
        return self.hop.unexpanded_after(n)


def _takes_out(score_block) -> bool:
    """Whether `score_block` takes `out=`, the tensor to write its scores
    into (`table_blocks`' K2 does)."""
    try:
        return "out" in inspect.signature(score_block).parameters
    except (TypeError, ValueError):
        return False


def _capture(fn, pool, hop) -> tuple[torch.cuda.CUDAGraph, int]:
    """`fn`'s launches on the current (side) stream as a CUDA graph, and
    the engine `hop`'s launches it captured. Not `torch.cuda.graph`, which
    collects garbage and empties the allocator's cache at every capture."""
    before = hop.captured
    g = torch.cuda.CUDAGraph()
    g.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        fn()
    finally:
        g.capture_end()
    count("search.hop_captures", 1)
    return g, hop.captured - before


class _HopGraphs:
    """One search shape's hop on a card as CUDA graphs over state that
    every search of that shape reuses, and the issuer of `_late_hops` that
    replays them: the search's state (beams, history, counters), the engine
    (`BeamHop`: its buffers, hop number, flag), the links gather's rows, the
    scores, which the scorer writes (K2 in place; others copied in), and a
    pinned host int32 that the merges also stamp (`BeamHop.mirror`). `head`
    is hop 1's select, links gather and membership; `step` a hop's merge,
    then the next hop's select, links gather and membership; `tail` the
    merge alone. The graphs are captured on a side stream (the engine's
    launches take the stream current when it is built) and replayed on the
    current one. A replay adds to `BeamHop.launches` the engine's launches
    that its graph captured."""

    def __init__(self, key, links: torch.Tensor, b: int, ef: int, e_f: int, hist_width: int,
                 cc: int):
        dev, m = links.device, links.shape[1]
        self.key, self.issued, self.slots, self.score_block = key, 0, 0, None
        self.state = _empty_state(b, ef, hist_width, dev)
        self.nbr_rows = torch.empty((b * e_f, m), dtype=links.dtype, device=dev)
        self.seen = torch.zeros((), dtype=torch.int32, pin_memory=True)
        self.done = (torch.cuda.Event(), torch.cuda.Event())
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.hop = beam_hop.make_hop(*self.state, e_f=e_f, m=m, compact_width=cc)
            if not isinstance(self.hop, beam_hop.BeamHop):
                return
            self.scores = torch.empty(self.hop.fresh.shape, device=dev)
            self.hop.mirror(self.seen)

            def links_block(ids):
                return torch.index_select(links, 0, ids.view(-1), out=self.nbr_rows).view(b, -1)

            def open_hop():
                self.cand = _open_hop(self.hop, links_block)

            def close_hop():
                _close_hop(self.hop, self.scores, self.cand)

            pool = torch.cuda.graph_pool_handle()
            self.graphs = {"head": _capture(open_hop, pool, self.hop),
                           "step": _capture(lambda: (close_hop(), open_hop()), pool, self.hop),
                           "tail": _capture(close_hop, pool, self.hop)}
        main.wait_stream(side)

    def _replay(self, name: str) -> None:
        graph, launches = self.graphs[name]
        with span("search.hop.graph"):
            graph.replay()
        beam_hop.BeamHop.launches += launches

    def head(self) -> None:
        self._replay("head")

    def score(self) -> None:
        """The scorer, called eagerly on the engine's score ids: K2 writes
        into the scores the merge reads; another scorer's result is copied
        there."""
        ids, buf = self.hop.score_ids, self.scores
        self.slots += ids.numel()
        got = self.score_block(ids, out=buf) if self.takes_out else self.score_block(ids)
        if got.data_ptr() != buf.data_ptr():
            buf.copy_(got)

    def step(self, last: bool) -> None:
        self._replay("tail" if last else "step")
        self.issued += 1
        self.done[self.issued % 2].record()
        count("search.hops_graphed", 1)
        count("search.hops_fused", 1)

    def unexpanded_after(self, n: int) -> bool:
        """Waits for hop n (one of the last two issued) alone: the flag only
        grows (the last hop that left an unexpanded entry), so read after hop
        n, or a later one, has stamped it, it says whether hop n left one."""
        self.done[n % 2].synchronize()
        return int(self.seen) >= n

    def start(self, score_block, entry_block, num_nodes: int, ni: int) -> None:
        """Writes a search's start state into the kept state and opens hop
        1; the host's flag is zeroed once the last search's merges can no
        longer stamp it."""
        if self.issued:
            self.done[self.issued % 2].synchronize()
        self.seen.zero_()
        beam_d = self.state[0]
        entry_beam(entry_block, num_nodes, *beam_d.shape, self.state[3].shape[1], ni,
                   beam_d.device, out=self.state)
        self.hop.restart()
        self.issued, self.slots = 0, 0
        self.score_block, self.takes_out = score_block, _takes_out(score_block)
        self.head()

    def results(self) -> BeamResults:
        """The search's results, copied out of the kept state (the next
        search of this shape overwrites it); the scorer, which holds the
        table and the queries, is let go."""
        beam_d, beam_i, beam_e, _, dcomp, hops = self.state
        self.score_block = None
        return BeamResults(beam_d.clone(), beam_i.clone(), dcomp.clone(), hops.clone(),
                           beam_e.clone(), self.slots)


#: the captured hop of each card (at most one), the key of the last search
#: on each card that could take one, and the lock a search holds while it
#: uses the captured hop
_GRAPHED: dict[int, _HopGraphs] = {}
_LAST_KEY: dict[int, tuple] = {}
_GRAPHED_LOCK = threading.RLock()


def release_hop_graphs(device=None) -> None:
    """Frees the captured hop of `device` (default: every card) once the
    card has run what was queued on it."""
    if device is not None and torch.device(device).type != "cuda":
        return
    with _GRAPHED_LOCK:
        for idx in list(_GRAPHED) if device is None else [torch.device(device).index or 0]:
            if idx in _GRAPHED:
                torch.cuda.synchronize(idx)
                del _GRAPHED[idx]


def _hop_graphs(links: torch.Tensor, b: int, ef: int, e_f: int, hist_width: int,
                cc: int) -> _HopGraphs | None:
    """The card's captured hop for this shape and links table. A shape is
    captured (and the old one freed) the second time in a row that the card
    searches it; a shape searched once runs eagerly and leaves the kept one
    as it is: None. None also where `beam_hop.make_hop` does not give the
    kernels' `BeamHop`."""
    key = (beam_hop.make_hop, b, ef, e_f, hist_width, cc, links.data_ptr(),
           tuple(links.shape), links.stride(), links.dtype)
    idx = links.device.index or 0
    last, _LAST_KEY[idx] = _LAST_KEY.get(idx), key
    g = _GRAPHED.get(idx)
    if g is not None and g.key == key:
        return g
    if last != key:
        return None
    release_hop_graphs(links.device)
    g = _HopGraphs(key, links, b, ef, e_f, hist_width, cc)
    if not isinstance(g.hop, beam_hop.BeamHop):
        return None
    _GRAPHED[idx] = g
    return g


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
    graph_hop: bool = True,
) -> BeamResults:
    """Distance-backend-agnostic beam search loop.

    `score_block(ids [B, C] int32) -> [B, C] float32` scores node ids[b, c]
    against query b; `entry_block(cand [NI]) -> [B, NI]` scores the entry
    candidates that every query shares. `score_block` gets -1 in place of
    each candidate that is not fresh, whose score the merge does not read.
    Where it takes `out=` (`table_blocks`' K2), a captured hop hands it the
    [B, C] float32 tensor that its merge reads.

    `links_block(ids [B, E] int32) -> [B, E*M] int32` resolves neighbor
    lists; None is a gather from `links`. A row-sharded table supplies its
    own, and the hop loop, the visited state and the merge stay shared.

    `max_hops` (0 = the default cap) bounds the hops and sizes the
    expanded-id history.

    `graph_hop`: replay the hop from state kept on the card for the next
    search of its shape, where it can be captured (module docstring). False
    issues each stage, and frees the card's captured hop: the build's
    waves, each followed by a prune whose peak kept state would raise, and
    whose hops the card, not the host, sets the pace of (B = 8,192), so a
    capture each wave would only cost time.

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
    if graph_hop and links_block is None and b > 0 and dev.type == "cuda":
        cc = compact_width if 0 < compact_width < em else 0
        with _GRAPHED_LOCK:
            g = _hop_graphs(links, b, ef, e_f, hop_cap * e_f, cc)
            if g is not None:
                with span("search.entry"):
                    g.start(score_block, entry_block, num_nodes, num_initializations)
                _late_hops(g, hop_cap)
                return g.results()
    elif not graph_hop:
        release_hop_graphs(dev)
    if links_block is None:
        def links_block(ids):
            return torch.index_select(links, 0, ids.view(-1)).view(b, em)

    with span("search.entry"):
        hop = beam_hop.make_hop(
            *entry_beam(entry_block, num_nodes, b, ef, hop_cap * e_f, num_initializations, dev),
            e_f=e_f, m=m, compact_width=compact_width)
        hops = _EagerHops(hop, links_block, score_block) if b else None  # no query, no hop
    if hops is not None:
        _late_hops(hops, hop_cap)
    return BeamResults(hop.beam_d, hop.beam_i, hop.dcomp, hop.hops, hop.beam_e,
                       hops.slots if hops else 0)


def table_blocks(vectors: torch.Tensor, queries: torch.Tensor, metric: MetricType):
    """(score_block, entry_block) of `beam_search_core` over a raw table:
    the hop scores ids through K2 (`gather_distances`, which writes into the
    `out` it is handed) on float tables and exactly in int32 on integer
    ones; the entry scan is one [NI, d] gather and one matmul for all
    B x NI distances. Integer queries against an integer table keep the
    int32 path; other queries are widened to float32."""
    if not (_is_int(queries) and _is_int(vectors)):
        queries = queries.to(torch.float32)

    if _is_int(vectors):
        def score_block(ids):
            return query_block_distances(queries, vectors[ids.long()], metric)
    else:
        def score_block(ids, out=None):
            if out is None:
                return gather_distances(vectors, ids, queries, metric)
            return gather_distances(vectors, ids, queries, metric, out=out)

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
    graph_hop: bool = True,
) -> BeamResults:
    """Batched beam search over raw stored vectors; returns the ef-wide
    beam per query (`graph_hop`: `beam_search_core`'s).

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
        graph_hop=graph_hop,
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
            if is_tracing():
                count("search.hop_capped", _capped_queries(beam))
        count("search.queries", top_d.shape[0])
        count("search.hops", n_hops)
        count("search.dist_computations", n_dc)
        count("search.k2_slots", beam.slots)
        dcomp += n_dc
        hops += n_hops
    return SearchResults(torch.cat(dists), torch.cat(labs), dcomp, hops)


__all__ = [
    "BeamResults",
    "SearchResults",
    "batched_search",
    "beam_search",
    "beam_search_core",
    "entry_beam",
    "release_hop_graphs",
    "safe_query_batch",
    "table_blocks",
]
