"""The beam-search hop's PyTorch chain (ops/beam_hop.py: `ChainHop`), which
the hop's CUDA kernels (csrc/beam_hop.cu, `BeamHop`) reproduce bit for bit on
the card, held to the JAX package's hop on the CPU.

Both packages search the same synthetic graph with the same per-query
distance table (tests/beam_hop_cases.py), built to reach the hop's corner
cases: ties among new distances and between beam and new entries,
duplicate neighbours in a row, neighbours already in the beam or the
history, ids outside [0, N) that score NaN, -0.0 beside +0.0, one and four
expansions a hop (rows with fewer unexpanded entries than that select
invalid sources), and compaction on and off. A hop cap of 1 or 2 stops
both after that many hops, 0 runs them to the end: beams (distances by
their bits), ids, distance computations and hops must be equal.

The JAX package's default merge ("gather", by ranks) assumes no NaN
distances; the NaN cases run its stable-sort merge, which its docstring
gives as bit-identical.

The search hands its scorer -1 in place of every candidate that is not
fresh (K2 loads no row for it); each case also runs with a scorer that
scores every candidate instead, as the search did before ("_every_candidate"):
both must give the JAX hop's beams. The integer table's and PQ's searches
are held, on recorded hops, to the same searches scoring every candidate.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beam_hop_cases as cases
import flatnav_tpu.index.search as jsearch
from flatnav_tpu_torch.index import search as search_mod
from flatnav_tpu_torch.index.search import batched_search, beam_search_core, table_blocks
from flatnav_tpu_torch.ops import MetricType, beam_hop
from flatnav_tpu_torch.quantization import pq as pq_mod
from flatnav_tpu_torch.utils import profiling

EF, NI, CW = 8, 8, 5


def _jax_blocks(table):
    n = table.shape[1]

    def score_block(ids):
        ok = (ids >= 0) & (ids < n)
        got = jnp.take_along_axis(table, jnp.clip(ids, 0, n - 1), axis=1)
        return jnp.where(ok, got, jnp.nan)

    def entry_block(cand):
        return table[:, cand]

    return score_block, entry_block


@pytest.mark.parametrize("max_hops", [1, 2, 0], ids=["hop1", "hop2", "to_the_end"])
@pytest.mark.parametrize("compact_width", [0, CW], ids=["uncompacted", "compacted"])
@pytest.mark.parametrize("expand", [1, 4], ids=["E1", "E4"])
@pytest.mark.parametrize("kind,handed", [
    *(pytest.param(k, "score_ids", id=k) for k in cases.KINDS),
    *(pytest.param(k, "every_candidate", id=f"{k}_every_candidate") for k in cases.KINDS),
])
def test_chain_matches_jax_hop(kind, handed, expand, compact_width, max_hops, monkeypatch):
    links, table = cases.make(kind)
    kw = dict(ef=EF, num_initializations=NI, max_hops=max_hops, expand_factor=expand,
              compact_width=compact_width)
    if kind == "out_of_range":
        monkeypatch.setattr(jsearch, "MERGE_IMPL", "sort")
    score, entry = _jax_blocks(jnp.asarray(table))
    want = jsearch.beam_search_core(
        jnp.asarray(links), jnp.asarray(cases.N, jnp.int32), cases.B, cases.N, score,
        entry_block=entry, **kw)
    score, entry = cases.torch_blocks(torch.from_numpy(table))
    hops, scored, record, every_candidate = _recorded_hops(monkeypatch)
    score = record(score) if handed == "score_ids" else every_candidate(score)
    got = beam_search_core(torch.from_numpy(links), cases.N, cases.B, score, entry, **kw)
    if handed == "score_ids":  # -1 at exactly the slots that are not fresh
        # a search run to its end opens one hop past it (a no-op, never scored)
        assert len(scored) > 0 and len(hops) == len(scored) + (max_hops == 0)
        assert not any(f.any() for _, f in hops[len(scored):])
        for (nbrs, fresh), ids in zip(hops, scored):
            assert torch.equal(ids, torch.where(fresh, nbrs, -1))
    np.testing.assert_array_equal(got.dists.view(torch.int32).numpy(),
                                  np.asarray(want.dists).view(np.int32))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert int(got.dist_computations) == int(want.dist_computations)
    assert int(got.hops) == int(want.hops)


@pytest.mark.parametrize("kind", cases.KINDS)
def test_cases_reach_their_corner(kind):
    # each kind holds what it is named for, and every kind revisits nodes
    links, table = cases.make(kind)
    if kind == "dups":
        assert all(len(set(r)) < len(r) for r in links.tolist())
    if kind == "out_of_range":
        assert {-1, cases.N, cases.N + 5} <= set(links.ravel().tolist())
    if kind == "signed_zero":
        zeros = table[table == 0]
        assert np.signbit(zeros).any() and (~np.signbit(zeros)).any()
    assert len(np.unique(table[0])) <= 7  # ties
    score, entry = cases.torch_blocks(torch.from_numpy(table))
    got = beam_search_core(torch.from_numpy(links), cases.N, cases.B, score, entry,
                           ef=EF, num_initializations=NI, expand_factor=4)
    scored = int(got.dist_computations) - cases.B * (NI + 1)
    # some neighbours of the expanded nodes were not fresh
    assert 0 < scored < int(got.hops) * cases.M


#: an H100's dynamic shared memory a block, less the kernels' static 40 bytes
H100_SMEM = 227 * 1024 - 40


@pytest.mark.parametrize("shape,fits", [
    ((512, 64, 32, 18 * 64), True),  # sift1m.graph: ef 512, E 64, M 32
    ((192, 16, 32, 32 * 16), True),  # gist1m.graph: ef 192, E 16
    ((100, 16, 32, 20 * 16), True),  # the wave build: efc 100, E 16
    ((12_000, 16, 32, 1508 * 16), False),  # ef past shared memory (the merge's keys)
    ((512, 256, 32, 16 * 256), False),  # E*M past shared memory (membership's sets)
    ((512, 64, 32, 400 * 64), False),  # a history past shared memory (max_hops 400)
])
def test_kernels_engage_on_the_card_within_their_plan(shape, fits, monkeypatch):
    # the kernels run every shape on the card: a row's working set in shared
    # memory where it fits, else in a global-memory workspace. `make_hop`
    # picks them by the beam's device (the kernels' engine stood in for
    # here, since it wants a card), the chain elsewhere
    ef, e_f, m, hist = shape
    state = search_mod.entry_beam(lambda cand: torch.zeros((2, cand.shape[0])), 1000, 2, ef,
                                  hist, 8, "cpu")
    assert type(beam_hop.make_hop(*state, e_f=e_f, m=m)) is beam_hop.ChainHop
    monkeypatch.setattr(beam_hop, "BeamHop", lambda *state, **kw: ("kernels", kw))
    on_card = SimpleNamespace(device=torch.device("cuda"))
    assert beam_hop.make_hop(*[on_card] * 6, e_f=e_f, m=m) == (
        "kernels", dict(e_f=e_f, m=m, compact_width=0))
    row = beam_hop.scratch_row(ef, e_f, m, hist, H100_SMEM)
    assert (row == 0) is fits
    if not fits:
        assert row % 16 == 0 and row == -(-max(beam_hop.stage_bytes(ef, e_f, m, hist).values())
                                          // 16) * 16


def test_kernels_refuse_cpu_tensors():
    count = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        beam_hop.BeamHop(torch.zeros((2, 8)), torch.zeros((2, 8), dtype=torch.int32),
                         torch.ones((2, 8), dtype=torch.bool),
                         torch.full((2, 16), -1, dtype=torch.int32), count, count, e_f=4, m=2)


def _recorded_hops(monkeypatch):
    """Records each hop's candidates and fresh flags as `ChainHop.membership`
    gives them. -> (hops [(nbrs, fresh)], scored [ids], record, every_candidate):
    `record(score)` records the ids the search hands `score`;
    `every_candidate(score)` scores the hop's candidates themselves in
    their place, as the search did before it handed its scorer -1."""
    hops, scored = [], []
    membership = beam_hop.ChainHop.membership

    def recording(self, nbrs):
        nbrs, fresh = membership(self, nbrs)
        hops.append((nbrs.clone(), fresh.clone()))
        return nbrs, fresh

    monkeypatch.setattr(beam_hop.ChainHop, "membership", recording)

    def record(score):
        def rec(ids):
            scored.append(ids.clone())
            return score(ids)

        return rec

    def every_candidate(score):
        def full(ids):
            nbrs, _ = hops[-1]
            assert nbrs.shape == ids.shape
            return score(nbrs)

        return full

    return hops, scored, record, every_candidate


@pytest.mark.parametrize("compact_width", [0, CW], ids=["uncompacted", "compacted"])
def test_chain_hop_stepped_by_hand_gives_the_search(compact_width):
    # the engine's interface as bench/kernel_ab.hop_lockstep drives it: the
    # entry state, then select, the links gather, membership, scoring the
    # score ids and merge until the end test fails, give `beam_search_core`'s
    # results bit for bit; the search, which reads its end test a hop late,
    # hands the scorer one spare hop's slots more
    links, table = cases.make("dups")
    links = torch.from_numpy(links)
    score, entry = cases.torch_blocks(torch.from_numpy(table))
    e_f, hop_cap = 4, search_mod._hop_cap(EF, 4)
    hop = beam_hop.ChainHop(
        *search_mod.entry_beam(entry, cases.N, cases.B, EF, hop_cap * e_f, NI, "cpu"),
        e_f=e_f, m=cases.M, compact_width=compact_width)
    it = slots = 0
    while it < hop_cap and hop.unexpanded_after(it):
        cur_ids, _ = hop.select()
        nbrs, _ = hop.membership(links[cur_ids.reshape(-1).long()].reshape(cases.B, -1))
        slots += hop.score_ids.numel()
        hop.merge(score(hop.score_ids), nbrs)
        it += 1
    want = beam_search_core(links, cases.N, cases.B, score, entry, ef=EF, num_initializations=NI,
                            expand_factor=e_f, compact_width=compact_width)
    assert 1 < it < hop_cap and torch.equal(hop.hist, hop.hist.sort(dim=1).values)
    assert torch.equal(hop.beam_d.view(torch.int32), want.dists.view(torch.int32))
    assert torch.equal(hop.beam_i, want.ids) and torch.equal(hop.beam_e, want.expanded)
    assert (int(hop.dcomp), int(hop.hops), slots + hop.score_ids.numel()) == (
        int(want.dist_computations), int(want.hops), want.slots)


def _graph(rng, n=300, m=8):
    return torch.from_numpy(rng.integers(0, n, (n, m)).astype(np.int32))


@pytest.mark.parametrize("table", ["float32", "int8", "pq"])
def test_searches_unchanged_by_score_ids(table, monkeypatch):
    # every scorer is handed -1 at exactly the slots that are not fresh; the
    # float table's, the integer table's exact scorer and PQ's ADC scorer
    # give the same beams, bit for bit, and counters as when they score
    # every candidate (the integer and PQ scorers read a real row for -1)
    rng = np.random.default_rng(21)
    n, d, b = 300, 16, 12
    links = _graph(rng, n)
    hops, scored, record, every_candidate = _recorded_hops(monkeypatch)
    kw = dict(ef=16, num_initializations=8, expand_factor=4)
    if table == "pq":
        codes = torch.from_numpy(rng.integers(0, 16, (n, 4)).astype(np.uint8))
        tables = torch.from_numpy(rng.random((b, 4, 16), dtype=np.float32))
        core = search_mod.beam_search_core
        monkeypatch.setattr(pq_mod, "beam_search_core",
                            lambda lk, nn, bb, score, entry, **k: core(lk, nn, bb, wrap(score),
                                                                       entry, **k))

        def search():
            return pq_mod.pq_beam_search(codes, links, n, tables, **kw)
    else:
        dtype = np.float32 if table == "float32" else np.int8
        vectors = torch.from_numpy((rng.standard_normal((n, d)) * 20).astype(dtype))
        queries = torch.from_numpy((rng.standard_normal((b, d)) * 20).astype(np.float32))
        score, entry = table_blocks(vectors, queries, MetricType.L2)

        def search():
            return beam_search_core(links, n, b, wrap(score), entry, **kw)

    wrap = record
    got = search()
    # the hop the search opens past the end (a no-op) is never scored
    assert len(hops) == len(scored) + 1 and len(scored) > 1 and not hops[-1][1].any()
    fresh_all = torch.cat([f.flatten() for _, f in hops])
    assert fresh_all.any() and not fresh_all.all()  # both kinds of slot were there
    for (nbrs, fresh), ids in zip(hops, scored):
        assert torch.equal(ids, torch.where(fresh, nbrs, -1))
    wrap = every_candidate
    want = search()
    assert torch.equal(got.dists.view(torch.int32), want.dists.view(torch.int32))
    assert torch.equal(got.ids, want.ids) and torch.equal(got.expanded, want.expanded)
    assert (int(got.dist_computations), int(got.hops)) == (int(want.dist_computations),
                                                         int(want.hops))


@pytest.mark.parametrize("dtype", [np.float32, np.int8], ids=["float32", "int8"])
def test_k2_slot_counters(dtype, monkeypatch):
    # search.k2_slots counts the slots the hops hand the scorer; the fresh
    # ones among them are the distance computations less the entry scan's
    rng = np.random.default_rng(22)
    n, d, b, ni = 300, 16, 12, 8
    links = _graph(rng, n)
    vectors = torch.from_numpy((rng.standard_normal((n, d)) * 20).astype(dtype))
    queries = torch.from_numpy((rng.standard_normal((b, d)) * 20).astype(dtype))
    labels = torch.arange(n, dtype=torch.int32)
    hops, _, _, _ = _recorded_hops(monkeypatch)
    profiling.snapshot(reset=True)
    with profiling.tracing():
        res = batched_search(vectors, links, labels, n, queries, k=5, ef=16,
                             num_initializations=ni, expand_factor=4)
    counters = profiling.snapshot(reset=True)["counters"]
    live = counters["search.dist_computations"] - counters["search.queries"] * (ni + 1)
    # the hop the search opens past the end (a no-op) is never scored
    assert not hops[-1][1].any()
    assert counters["search.k2_slots"] == sum(f.numel() for _, f in hops[:-1])
    assert live == sum(int(f.sum()) for _, f in hops) == res.dist_computations - b * (ni + 1)
    assert 0 < live < counters["search.k2_slots"]


def _converged(kind, expand, compact_width):
    """A chain searched until no beam holds an unexpanded entry, with the
    loop's links gather and scorer."""
    links, table = cases.make(kind)
    links = torch.from_numpy(links)
    score, entry = cases.torch_blocks(torch.from_numpy(table))
    hop_cap = 4 * search_mod._hop_cap(EF, expand)
    hop = beam_hop.ChainHop(
        *search_mod.entry_beam(entry, cases.N, cases.B, EF, hop_cap * expand, NI, "cpu"),
        e_f=expand, m=cases.M, compact_width=compact_width)

    def links_block(ids):
        return links[ids.reshape(-1).long()].reshape(cases.B, -1)

    it = 0
    while it < hop_cap and hop.unexpanded_after(it):
        nbrs = search_mod._open_hop(hop, links_block)
        search_mod._close_hop(hop, score(hop.score_ids), nbrs)
        it += 1
    assert it < hop_cap
    return hop, links_block, score, it


@pytest.mark.parametrize("compact_width", [0, CW], ids=["uncompacted", "compacted"])
@pytest.mark.parametrize("expand", [1, 4], ids=["E1", "E4"])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_a_hop_after_the_end_changes_nothing(kind, expand, compact_width):
    # the search reads its end test a hop late, so one hop runs on beams
    # with no unexpanded entry: it selects nothing, hands the scorer no
    # fresh candidate (-1 in every slot) and leaves the state, the counters
    # and the end flag as they were
    hop, links_block, score, it = _converged(kind, expand, compact_width)
    flag = int(hop.flag)
    state = [t.clone() for t in (hop.beam_d, hop.beam_i, hop.beam_e, hop.hist, hop.dcomp, hop.hops)]
    nbrs = search_mod._open_hop(hop, links_block)
    assert not hop.sel_valid.any() and bool((hop.score_ids == -1).all())
    search_mod._close_hop(hop, score(hop.score_ids), nbrs)
    after = (hop.beam_d, hop.beam_i, hop.beam_e, hop.hist, hop.dcomp, hop.hops)
    assert torch.equal(after[0].view(torch.int32), state[0].view(torch.int32))
    assert all(torch.equal(a, s) for a, s in zip(after[1:], state[1:]))
    assert int(hop.flag) == flag < it and not hop.unexpanded_after(it + 1)


@pytest.mark.parametrize("max_hops", [1, 2, 0], ids=["hop1", "hop2", "to_the_end"])
@pytest.mark.parametrize("expand", [1, 4], ids=["E1", "E4"])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_end_test_a_hop_late_gives_the_search(kind, expand, max_hops):
    # the search's loop (`_late_hops`) reads hop n's end flag after issuing
    # hop n + 1; it gives the results of a loop that tests the end before
    # each hop, bit for bit, with one spare hop where the beams converged
    # before the cap and none where the cap stopped it
    links, table = cases.make(kind)
    links = torch.from_numpy(links)
    score, entry = cases.torch_blocks(torch.from_numpy(table))
    hop_cap = max_hops or search_mod._hop_cap(EF, expand)
    hop = beam_hop.ChainHop(
        *search_mod.entry_beam(entry, cases.N, cases.B, EF, hop_cap * expand, NI, "cpu"),
        e_f=expand, m=cases.M)
    it = 0
    while it < hop_cap and hop.unexpanded_after(it):
        nbrs = search_mod._open_hop(hop, lambda ids: links[ids.reshape(-1).long()].reshape(
            cases.B, -1))
        search_mod._close_hop(hop, score(hop.score_ids), nbrs)
        it += 1
    profiling.snapshot(reset=True)
    with profiling.tracing():
        got = beam_search_core(links, cases.N, cases.B, score, entry, ef=EF,
                               num_initializations=NI, expand_factor=expand, max_hops=max_hops)
    snap = profiling.snapshot(reset=True)
    issued = snap["spans"]["search.hop"]["calls"]
    spare = snap["counters"].get("search.hops_spare", 0)
    assert issued == it + spare and spare == int(it < hop_cap)
    assert torch.equal(hop.beam_d.view(torch.int32), got.dists.view(torch.int32))
    assert torch.equal(hop.beam_i, got.ids) and torch.equal(hop.beam_e, got.expanded)
    assert (int(hop.dcomp), int(hop.hops)) == (int(got.dist_computations), int(got.hops))
