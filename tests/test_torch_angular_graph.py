"""The benchmark's `glove-100-angular` configuration on the port's graph path,
at a small size on the CPU, against the benchmark's plain reference
(`annbench/reference.py`): `index.create("angular", ...)` -> `add` ->
`search` on seeded unit rows in the configuration's form, at its M, its
ef_construction and its operating point. Also the counter
`search.hop_capped` (index/search.py) and its reader,
`annbench/metrics/search.hop_capped_pct.py`.

Imports no JAX, as the reference imports none."""

from __future__ import annotations

import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import flatnav_tpu_torch
from annbench import program, reference, synth
from annbench.registry import Registry, cell_params, form, index_args
from annbench.run import Context
from annbench.spans import SpanStats
from flatnav_tpu_torch.index.search import batched_search
from flatnav_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
CONFIG, CELL = "glove-100-angular", "glove100.graph"
N, NQ, K = 4096, 64, 10
SEED = 2**31 + 1907
#: the beam and expand factor of the CPU searches: a 4,096-row graph needs
#: neither the cell's 1,536-wide beam nor its E of 64 (1.18M rows), and the
#: CPU chain's sorts grow with both
EF, E = 128, 16
#: a 4,096-row graph searched so finds nearly every true neighbour: the
#: seeded build read 0.9953 here; 0.98 leaves room for a tie ordered
#: otherwise on another CPU, and a graph without its back edges or a beam
#: cut at its first hop reads far below it
RECALL_FLOOR = 0.98
#: `correct`'s limit on the gap between a returned distance and the
#: reference's distance of that id, over the query's true 10th distance
#: (the traffic mix's `dist_gap`): float32 arithmetic in another order reads
#: ~3e-7 (K2's tree against the reference's sum), bf16 rows ~1e-3
DIST_GAP = 1e-5
#: the per-layer metrics the graph cells report
GRAPH_METRICS = {"build_s", "search.hops_per_query", "search.ms_per_hop", "k2_roofline",
                 "device.idle_pct", "search.launches_per_hop", "search.host_ms_per_hop",
                 "search.hop_idle_pct", "search.dist_comps_per_query", "search.hop_capped_pct"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The CPU searches are many small operations: with several test workers
    on one host, a pool of threads each only competes for cores (the
    benchmark's run sets one thread for the same reason)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def reg():
    return Registry(REPO)


@pytest.fixture(scope="module")
def small(reg):
    """The configuration at N rows and NQ queries: (cfg, data, queries) in
    its form, drawn on the CPU."""
    cfg = dict(reg.config(CONFIG), n=N, num_queries=NQ)
    data, queries = synth.generate(cfg, SEED, "cpu")
    return cfg, data, queries


@pytest.fixture(scope="module")
def index(small):
    cfg, data, _ = small
    ix = flatnav_tpu_torch.index.create(**index_args(cfg), device="cpu")
    ix.add(data.numpy(), ef_construction=cfg["ef_construction"])
    return ix


@pytest.fixture(scope="module")
def truth(small):
    _, data, queries = small
    return reference.exact_knn(data, queries, K, "angular")


def _search(reg, cfg, ix, queries):
    """The graph mix's call (`Index.search`), at a beam of EF and E."""
    ix.set_expand_factor(E)
    args = cell_params(cfg, reg.traffic("graph-r1000"))["args"]
    return ix.search(queries.numpy(), **{**args, "ef_search": EF})


def _gap(dists, ids, data, queries, truth_d) -> float:
    ref = reference.id_distances(data, queries, torch.arange(len(ids)),
                                 torch.from_numpy(ids).long(), "angular")
    return float(((torch.from_numpy(dists) - ref).abs() / truth_d[:, K - 1 : K]).max())


def test_the_configuration_is_glove_100_angular_at_its_published_size(reg):
    cfg = reg.config(CONFIG)
    assert form(cfg) == ("angular", "float32")
    assert (cfg["n"], cfg["dim"], cfg["num_queries"]) == (1_183_514, 100, 10_000)
    assert (cfg["max_edges_per_node"], cfg["ef_construction"], cfg["reduced"]) == (32, 100, [])
    assert index_args(cfg)["distance_type"] == "angular"
    entry = next(c for c in reg.bench["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == [] and entry["file"] == f"annbench/configs/{CONFIG}.json"


def test_the_cell_runs_the_graph_mix_and_reports_the_graph_metrics(reg):
    cell = reg.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "graph-r1000", 1)
    per_layer = {m["name"] for m in reg.metrics(CELL, "per_layer")}
    assert per_layer == GRAPH_METRICS
    for name in per_layer:
        assert (REPO / "annbench" / "metrics" / f"{name}.py").exists()
    e2e = {m["name"] for m in reg.metrics(CELL, "end_to_end")}
    assert {"qps", "recall_at_10", "peak_gib", "setup_s"} <= e2e
    # the request tail is reported once: end to end or per layer
    assert ("p95_ms" in e2e) != ("request.p95_ms" in per_layer)
    capped = next(m for m in reg.bench["per_layer"] if m["name"] == "search.hop_capped_pct")
    assert capped["moves"] == "recall_at_10" and capped["source"] == "program_counter"
    assert capped["workloads"] == ["sift1m.graph", "gist1m.graph", CELL]


def test_angular_rows_are_unit_rows_and_queries_too(small):
    _, data, queries = small
    for x in (data, queries):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(torch.linalg.vector_norm(x, dim=1).numpy(), 1.0, atol=1e-6)


def test_the_graph_path_matches_the_plain_reference(reg, small, index, truth):
    cfg, data, queries = small
    dists, ids = _search(reg, cfg, index, queries)
    assert ids.shape == (NQ, K) and (np.diff(dists, axis=1) >= 0).all()
    truth_d, truth_i = truth
    recall = reference.recall_hits(torch.from_numpy(ids).long(), truth_i) / truth_i.numel()
    assert recall >= RECALL_FLOOR
    assert _gap(dists, ids, data, queries, truth_d) <= DIST_GAP


def test_a_bf16_table_fails_the_distance_limit(small, index, truth):
    # the same search over the same graph with its rows held one precision
    # lower than the configuration states: its distances leave the limit
    cfg, data, queries = small
    g = index.graph
    res = batched_search(g.vectors.bfloat16(), g.links, g.labels, g.num_nodes, queries, k=K,
                         ef=EF, expand_factor=E, metric=index.metric)
    dists, ids = res.dists.numpy(), res.labels.numpy()
    assert _gap(dists, ids, data, queries, truth[0]) > 10 * DIST_GAP


def _counted(ix, queries, **kw):
    g = ix.graph
    profiling.snapshot(reset=True)
    with profiling.tracing():
        res = batched_search(g.vectors, g.links, g.labels, g.num_nodes, queries, k=K,
                             metric=ix.metric, **kw)
    return res, profiling.snapshot(reset=True)["counters"]


def test_hop_capped_counts_every_query_cut_at_the_cap(small, index):
    _, _, queries = small
    res, counters = _counted(index, queries, ef=256, expand_factor=4, max_hops=1)
    # the first hop expands the entry node alone and leaves its fresh
    # neighbours unexpanded in every beam
    assert int(res.hops) == NQ
    assert counters["search.hop_capped"] == counters["search.queries"] == NQ


def test_hop_capped_counts_the_queries_that_need_more_hops_than_the_cap(small, index,
                                                                       monkeypatch):
    from flatnav_tpu_torch.index import search

    _, _, queries = small
    g = index.graph
    # with E = 1 a hop expands one entry of each beam that holds one, and
    # each beam moves on its own: a query is cut iff, searched alone with
    # one hop more, it expands more entries than the cap has hops
    cap = 20
    need = [int(search.beam_search(g.vectors, g.links, g.num_nodes, queries[i : i + 1], ef=16,
                                   metric=index.metric, max_hops=cap + 1).hops)
            for i in range(NQ)]
    monkeypatch.setattr(search, "safe_query_batch", lambda b, ef, **kw: 16)  # 4 sub-batches
    _, counters = _counted(index, queries, ef=16, max_hops=cap)
    cut = sum(n > cap for n in need)
    assert counters["search.queries"] == NQ
    assert counters["search.hop_capped"] == cut and 0 < cut < NQ


def test_hop_capped_reads_0_for_a_search_that_converges(small, index):
    _, _, queries = small
    res, counters = _counted(index, queries, ef=32, expand_factor=4)
    assert "search.hop_capped" in counters and counters["search.hop_capped"] == 0
    assert counters["search.queries"] == NQ and int(res.hops) > NQ


def test_hop_capped_is_not_recorded_with_the_tracer_off(small, index, monkeypatch):
    from flatnav_tpu_torch.index import search

    _, _, queries = small
    g = index.graph
    reads = []
    monkeypatch.setattr(search, "_capped_queries", lambda beam: reads.append(beam) or 0)
    profiling.snapshot(reset=True)
    batched_search(g.vectors, g.links, g.labels, g.num_nodes, queries, k=K, ef=64, max_hops=1,
                   metric=index.metric)
    assert not reads and "search.hop_capped" not in profiling.snapshot(reset=True)["counters"]


def _ctx(counters):
    """A run whose program phase recorded `counters` (annbench/program.py)."""
    st = SpanStats(counts=collections.Counter({("counter", k): v for k, v in counters.items()}))
    return Context(spans={"trace": {program.UNPROFILED.name: st}})


@pytest.mark.parametrize("counters,want", [
    ({"search.queries": 2000}, None),  # the parent's program: no counter
    ({"search.queries": 2000, "search.hop_capped": 0}, 0.0),  # never cut
    ({"search.queries": 2000, "search.hop_capped": 30}, 1.5),
    ({}, None),  # a scan run: no search at all
], ids=["unrecorded", "none_cut", "some_cut", "no_search"])
def test_the_reader_gives_the_share_of_queries_cut(reg, counters, want):
    got = reg.reader("search.hop_capped_pct").read(_ctx(counters))
    assert got == (None if want is None else pytest.approx(want))


def test_the_benchmark_file_is_within_its_limits():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for entry in bench["configs"] + bench["workloads"]:
        assert 1 <= len(entry["why"]) <= 200
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
