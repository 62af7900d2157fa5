"""The port's search options (`max_hops`, `m_search`, `compact_width`,
`links_block`) against flatnav_tpu's, on the CPU, and the repaired device
defaults of the graph and serialize entry points.

One JAX-built graph is carried across with `convert.graph_from_jax_arrays`
and searched by both packages with the same options. Every hop scores with
the same fixed-order sums, so the only expected difference is the entry
scan's matmul rounding (it can pick another entry point on a near tie):
labels equal in >= 99% of the rows, distances of those rows within 1e-5
relative, and the counters equal on the rows that agree.
"""

import numpy as np
import pytest
import torch

import flatnav_tpu
import flatnav_tpu.index.search as jsearch
import flatnav_tpu.quantization as jq
import jax.numpy as jnp
from flatnav_tpu.ops import MetricType as JMetric
from flatnav_tpu_torch import convert
from flatnav_tpu_torch.index import graph as graph_mod
from flatnav_tpu_torch.index import search as search_mod
from flatnav_tpu_torch.index import serialize
from flatnav_tpu_torch.index.search import batched_search, beam_search, beam_search_core
from flatnav_tpu_torch.ops import MetricType, pairwise_distances
from flatnav_tpu_torch.ops.gather_distance import gather_distances
from flatnav_tpu_torch.quantization.pq import pq_beam_search

N, D, M, EFC, K, EF, E, NQ = 2000, 32, 16, 64, 10, 32, 4, 64


@pytest.fixture(scope="module")
def carried():
    rng = np.random.default_rng(0x0F71)
    data = rng.standard_normal((N, D), dtype=np.float32)
    queries = rng.standard_normal((NQ, D), dtype=np.float32)
    jx = flatnav_tpu.index.create("l2", dim=D, dataset_size=N, max_edges_per_node=M)
    jx.add(data, ef_construction=EFC)
    g = jx.graph
    pg = convert.graph_from_jax_arrays(
        np.asarray(g.vectors), np.asarray(g.links), np.asarray(g.labels),
        int(g.num_nodes), g.capacity, device="cpu",
    )
    return data, queries, g, pg


def _both(carried, queries, **opts):
    _, _, g, pg = carried
    kw = dict(k=K, ef=EF, expand_factor=E, **opts)
    jres = jsearch.batched_search(
        g.vectors, g.links, g.labels, g.num_nodes, jnp.asarray(queries),
        metric=JMetric.L2, **kw)
    pres = batched_search(
        pg.vectors, pg.links, pg.labels, pg.num_nodes, torch.from_numpy(queries),
        metric=MetricType.L2, **kw)
    return jres, pres


@pytest.mark.parametrize("opts", [
    dict(),
    dict(m_search=M // 2),
    dict(max_hops=8),
    dict(compact_width=E * M),  # >= E*M: a no-op
    dict(compact_width=EF),
    dict(m_search=M // 2, max_hops=8, compact_width=EF // 2),
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "defaults")
def test_options_match_jax(carried, opts):
    _, queries, _, _ = carried
    jres, pres = _both(carried, queries, **opts)
    jl, pl = np.asarray(jres.labels), pres.labels.numpy()
    same = (jl == pl).all(axis=1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(
        pres.dists.numpy()[same], np.asarray(jres.dists)[same], rtol=1e-5)
    # the counters are sums over the batch: compare them on the agreeing
    # rows, in a batch of the same shape (the others replaced by row 0)
    if not same.all():
        agree = np.where(same[:, None], queries, queries[:1])
        jres, pres = _both(carried, agree, **opts)
        assert (np.asarray(jres.labels) == pres.labels.numpy()).all()
    assert pres.dist_computations == int(jres.dist_computations)
    assert pres.hops == int(jres.hops)


def test_options_do_what_they_say(carried):
    _, queries, _, pg = carried
    q = torch.from_numpy(queries)

    def run(**opts):
        return batched_search(pg.vectors, pg.links, pg.labels, pg.num_nodes, q,
                              k=K, ef=EF, expand_factor=E, **opts)

    base = run()
    for noop in (dict(compact_width=E * M), dict(compact_width=10 * E * M),
                 dict(m_search=M), dict(m_search=M + 5)):
        got = run(**noop)
        assert torch.equal(got.labels, base.labels) and torch.equal(got.dists, base.dists)
        assert (got.dist_computations, got.hops) == (base.dist_computations, base.hops)
    assert run(max_hops=3).hops <= 3 * E * NQ < base.hops
    assert run(m_search=M // 2).dist_computations < base.dist_computations
    cw = run(compact_width=EF // 2)
    assert cw.dist_computations < base.dist_computations
    assert bool(torch.isfinite(cw.dists).all())
    assert bool((cw.dists[:, 1:] >= cw.dists[:, :-1]).all())


def test_compact_width_sets_the_scored_width(carried, monkeypatch):
    # the hop's scorer (kernel K2 on the card) is called with C = CC columns
    _, queries, _, pg = carried
    widths = set()

    def spy(vectors, ids, q, metric):
        widths.add(ids.shape[1])
        return gather_distances(vectors, ids, q, metric)

    monkeypatch.setattr(search_mod, "gather_distances", spy)
    kw = dict(k=K, ef=EF, expand_factor=E)
    batched_search(pg.vectors, pg.links, pg.labels, pg.num_nodes,
                   torch.from_numpy(queries), compact_width=24, **kw)
    assert widths == {24}
    widths.clear()
    batched_search(pg.vectors, pg.links, pg.labels, pg.num_nodes,
                   torch.from_numpy(queries), m_search=M // 2, **kw)
    assert widths == {E * M // 2}


def test_m_search_view_is_gathered_without_a_table_copy(carried):
    _, _, _, pg = carried
    view = pg.links[:, : M // 2]
    assert not view.is_contiguous() and view.data_ptr() == pg.links.data_ptr()
    rows = torch.tensor([3, 1, 3, 7])
    assert torch.equal(view[rows], pg.links[rows][:, : M // 2])


def test_links_block_that_gathers_from_the_table_is_the_default(carried):
    _, queries, _, pg = carried
    q = torch.from_numpy(queries)
    calls = []

    def links_block(ids):
        calls.append(tuple(ids.shape))
        return pg.links[ids.reshape(-1).long()].reshape(ids.shape[0], -1)

    def core(**kw):
        return beam_search_core(
            pg.links, pg.num_nodes, NQ,
            lambda ids: gather_distances(pg.vectors, ids, q, MetricType.L2),
            lambda cand: pairwise_distances(q, pg.vectors[cand.long()], MetricType.L2),
            ef=EF, expand_factor=E, **kw)

    hooked, default = core(links_block=links_block), core()
    assert calls and set(calls) == {(NQ, E)}
    for a, b in zip(hooked, default):
        assert torch.equal(a, b)
    via_api = beam_search(pg.vectors, pg.links, pg.num_nodes, q, ef=EF, expand_factor=E)
    assert torch.equal(via_api.ids, default.ids) and torch.equal(via_api.dists, default.dists)


@pytest.mark.parametrize("kw", [
    dict(m=32, d=128, expand_factor=16),
    dict(m=32, d=128, expand_factor=16, max_hops=20_000),
    dict(m=32, d=128, expand_factor=64, compact_width=512),
    dict(m=16, d=960, expand_factor=1, max_hops=4),
    dict(m=32, d=128, expand_factor=64, compact_width=4096),  # >= E*M: not counted
])
def test_guard_accounts_for_max_hops_and_compact_width(monkeypatch, kw):
    # a fake memory limit of 2 GB, in both packages
    monkeypatch.setenv("FLATNAV_TPU_MEM_LIMIT", "2e9")
    monkeypatch.setattr(search_mod, "_device_mem_limit", lambda device: int(2e9))
    for ef in (128, 512):
        want = jsearch.safe_query_batch(
            4096, ef, table_rows=1_000_000, table_bytes=512_000_000, **kw)
        got = search_mod.safe_query_batch(4096, ef, table_bytes=512_000_000, **kw)
        assert got == want
    plain = dict(kw, max_hops=0, compact_width=0)
    base = search_mod.safe_query_batch(4096, 128, table_bytes=512_000_000, **plain)
    got = search_mod.safe_query_batch(4096, 128, table_bytes=512_000_000, **kw)
    if kw.get("max_hops", 0) > 1000:
        assert got < base
    if 0 < kw.get("compact_width", 0) < kw["expand_factor"] * kw["m"]:
        assert got > base
    with pytest.raises(ValueError, match="compact_width"):
        search_mod.safe_query_batch(1, 10**6, m=64, d=4096, expand_factor=64)


def test_guard_splits_the_batch_with_the_options_set(carried, monkeypatch):
    _, queries, _, pg = carried
    q = torch.from_numpy(queries)
    kw = dict(k=K, ef=EF, expand_factor=E, max_hops=8, compact_width=EF, m_search=M // 2)
    whole = batched_search(pg.vectors, pg.links, pg.labels, pg.num_nodes, q, **kw)
    seen = []
    real = search_mod.safe_query_batch

    def guard(b, ef, **g):
        seen.append(g)
        return min(real(b, ef, **g), 24)

    monkeypatch.setattr(search_mod, "safe_query_batch", guard)
    split = batched_search(pg.vectors, pg.links, pg.labels, pg.num_nodes, q, **kw)
    assert seen[0]["m"] == M // 2 and seen[0]["max_hops"] == 8
    assert seen[0]["compact_width"] == EF
    assert torch.equal(split.labels, whole.labels) and torch.equal(split.dists, whole.dists)
    assert (split.dist_computations, split.hops) == (whole.dist_computations, whole.hops)


@pytest.mark.parametrize("max_hops", [0, 6])
def test_pq_beam_search_max_hops_matches_jax(carried, max_hops):
    data, queries, g, pg = carried
    jpq = jq.ProductQuantizer(dim=D, num_subquantizers=8).train(data[:1000], n_iters=5)
    jcodes = jpq.encode(data)
    pq = convert.pq_from_jax_arrays(np.asarray(jpq.codebook.centroids), jpq.metric, device="cpu")
    codes = torch.from_numpy(np.array(jcodes))
    kw = dict(ef=EF, max_hops=max_hops, expand_factor=2)
    jb = jq.pq.pq_beam_search(
        jcodes, g.links[: N], jnp.asarray(N, jnp.int32),
        jpq.adc_tables(jnp.asarray(queries)), metric=JMetric.L2, **kw)
    pb = pq_beam_search(codes, pg.links[:N], N, pq.adc_tables(queries),
                        metric=MetricType.L2, **kw)
    if max_hops:
        assert int(pb.hops) <= max_hops * 2 * NQ
    # the ADC tables differ by float rounding; codes shared by several nodes
    # tie exactly, and both packages keep such ties in beam order
    same = (np.asarray(jb.ids) == pb.ids.numpy()).all(axis=1)
    assert same.mean() >= 0.95
    np.testing.assert_allclose(
        pb.dists.numpy()[same], np.asarray(jb.dists)[same], rtol=1e-4, atol=1e-4)
    if same.all():
        assert int(pb.hops) == int(jb.hops)
        assert int(pb.dist_computations) == int(jb.dist_computations)


# ---------------------------------------------------------------------------
# the repaired device defaults: on the card unless the caller says otherwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["make_empty_graph", "graph_from_numpy", "load_index"])
def test_graph_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vecs = np.ones((5, 8), np.float32)
    links = np.tile(np.arange(5, dtype=np.int32)[:, None], (1, 4))
    path = str(tmp_path / "g.npz")
    serialize.save_index(
        path, graph_mod.graph_from_numpy(vecs, links, device="cpu"), MetricType.L2)

    def call(**kw):
        if entry == "make_empty_graph":
            return graph_mod.make_empty_graph(5, 8, 4, **kw)
        if entry == "graph_from_numpy":
            return graph_mod.graph_from_numpy(vecs, links, **kw)
        return serialize.load_index(path, **kw)[0]

    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    g = call(device="cpu")
    assert g.device.type == "cpu" and g.links.shape[1] == 4
