"""The port's profiling utilities (flatnav_tpu_torch.utils.profiling) on the
CPU: the memory pieces against flatnav_tpu.utils.profiling (the device
pieces report nothing without a card), and the tracer: off, it does nothing
at all; on, its table, counters and request records, its profiler ranges,
and the span tree that `Index.search`, `search_exact` and `add` make, with
results bit-equal either way."""

import json
import threading
import time

import numpy as np
import pytest
import torch

import flatnav_tpu.utils.profiling as jprof
import flatnav_tpu_torch
from flatnav_tpu_torch.index.search import batched_search
from flatnav_tpu_torch.utils import profiling as prof

def test_host_memory_stats_match_jax():
    got, want = prof.host_memory_stats(), jprof.host_memory_stats()
    assert set(got) == set(want) == {"vmrss_kb", "vmhwm_kb", "vmsize_kb"}
    assert got["vmrss_kb"] > 0 and got["vmhwm_kb"] >= got["vmrss_kb"] * 0.5


def test_device_memory_stats_is_empty_without_a_card(monkeypatch):
    assert prof.device_memory_stats("cpu") == {}
    assert prof.device_memory_stats(torch.device("cpu")) == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert prof.device_memory_stats() == {}
    assert prof.device_memory_stats("cuda") == {}


def test_device_memory_stats_keys_from_torch_counters(monkeypatch):
    # the keys the monitor and the JAX package's callers read, from torch's
    # allocator counters (faked: there is no card here)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "allocated_bytes.all.current": 1000, "reserved_bytes.all.current": 4096})
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda dev: 3000)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (10, 80 * 2**30))
    assert prof.device_memory_stats() == {
        "bytes_in_use": 1000, "peak_bytes_in_use": 3000,
        "bytes_reserved": 4096, "bytes_limit": 80 * 2**30,
    }


def test_memory_monitor_writes_jsonl_and_tracks_peaks(tmp_path, monkeypatch):
    monkeypatch.setattr(prof, "device_memory_stats", lambda: {"bytes_in_use": 123})
    path = tmp_path / "mem.jsonl"
    with prof.MemoryMonitor(str(path), interval_s=0.01) as mon:
        time.sleep(0.1)
    assert not mon._thread.is_alive()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(lines) >= 2
    assert all(set(ln) == {"t", "host", "device"} for ln in lines)
    assert lines[0]["device"] == {"bytes_in_use": 123} and lines[0]["host"]["vmrss_kb"] > 0
    assert lines[-1]["t"] >= lines[0]["t"]
    peak = mon.peak()
    assert peak["device_bytes_in_use"] == 123 and peak["host_rss_bytes"] > 0
    assert set(peak) == set(jprof.MemoryMonitor(str(path)).peak())


def test_memory_monitor_survives_a_failing_device_probe(tmp_path, monkeypatch):
    def boom():
        raise RuntimeError("no device")

    monkeypatch.setattr(prof, "device_memory_stats", boom)
    path = tmp_path / "mem.jsonl"
    with prof.MemoryMonitor(str(path), interval_s=0.01) as mon:
        time.sleep(0.05)
    assert json.loads(path.read_text().splitlines()[0])["device"] == {}
    assert mon.peak()["device_bytes_in_use"] == 0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with prof.device_trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((log_dir / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n or "matmul" in n for n in names)


# --------------------------------------------------------------- the tracer


@pytest.fixture(autouse=True)
def _fresh_table():
    assert not prof.is_tracing()
    prof.snapshot(reset=True)
    yield
    prof.snapshot(reset=True)


class _Clock:
    """Stands in for the tracer's clock: each read advances by `step` ns."""

    def __init__(self, step=10):
        self.t, self.step = 0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _boom(*a, **kw):
    raise AssertionError("called while tracing is off")


def test_off_records_nothing_and_returns_the_null_object(monkeypatch):
    monkeypatch.setattr(prof, "_now", _boom)
    a, b = prof.span("x"), prof.wait("y")
    assert a is b and not prof.is_tracing()
    with prof.span("x"), prof.wait("y"):
        prof.count("c", 5)
    snap = prof.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {} and snap["requests"] == []


def test_nesting_gives_self_and_wait_times(monkeypatch):
    monkeypatch.setattr(prof, "_now", _Clock())
    with prof.tracing():
        with prof.span("a"):  # enter 10
            with prof.span("b"):  # 20
                with prof.wait("w"):  # 30, exit 40
                    pass
            # b exits at 50: total 30, w 10 inside
            with prof.span("b"):  # 60, exit 70
                pass
        # a exits at 80: total 70
    spans = prof.snapshot()["spans"]
    assert spans["a"] == {"calls": 1, "total_ns": 70, "self_ns": 30, "wait_ns": 10}
    assert spans["a/b"] == {"calls": 2, "total_ns": 40, "self_ns": 30, "wait_ns": 10}
    assert spans["a/b/w"] == {"calls": 1, "total_ns": 10, "self_ns": 10, "wait_ns": 10}


def test_counters_add_host_values_and_refuse_tensors():
    with prof.tracing():
        prof.count("n", 3)
        prof.count("n", 4)
        prof.count("m", 1)
        with pytest.raises(TypeError):
            prof.count("n", torch.tensor(1))
    prof.count("n", 100)  # off again
    assert prof.snapshot()["counters"] == {"n": 7, "m": 1}


def test_top_level_spans_are_numbered_requests(monkeypatch):
    monkeypatch.setattr(prof, "_now", _Clock())
    seq0 = prof.snapshot()["seq"]
    with prof.tracing():
        with prof.span("index.search"):  # 10
            with prof.wait("index.results_out"):  # 20, exit 30
                pass
        # exit 40
        with prof.span("index.add"):  # 50, exit 60
            pass
    snap = prof.snapshot()
    assert snap["seq"] == seq0 + 2
    assert snap["requests"] == [
        {"seq": seq0 + 1, "name": "index.search", "start_ns": 10, "dur_ns": 30,
         "wait_ns": 10, "host_ns": 20},
        {"seq": seq0 + 2, "name": "index.add", "start_ns": 50, "dur_ns": 10,
         "wait_ns": 0, "host_ns": 10},
    ]


@pytest.mark.parametrize("reset", [True, False])
def test_snapshot_reset(reset):
    with prof.tracing():
        with prof.span("a"):
            prof.count("c", 1)
    first = prof.snapshot(reset=reset)
    second = prof.snapshot()
    assert set(first["spans"]) == {"a"} and first["counters"] == {"c": 1}
    assert len(first["requests"]) == 1 and second["seq"] == first["seq"]
    assert (second["spans"], second["counters"], second["requests"]) == (
        ({}, {}, []) if reset else (first["spans"], first["counters"], first["requests"]))


def test_tracing_blocks_nest_and_threads_keep_their_own_stacks():
    done = threading.Event()

    def worker():
        with prof.span("t"):
            done.wait(5)

    with prof.tracing():
        with prof.tracing():
            th = threading.Thread(target=worker)
            with prof.span("main"):
                th.start()
            done.set()
            th.join(5)
        assert prof.is_tracing() and not th.is_alive()
    assert not prof.is_tracing()
    spans = prof.snapshot()["spans"]
    assert set(spans) == {"main", "t"}  # neither nests in the other


def test_ranges_appear_only_while_a_profiler_records(monkeypatch):
    made = []
    real = prof._Range

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(prof, "_Range", counting)
    with prof.tracing():
        with prof.span("outer"):
            pass
        assert made == []
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            with prof.span("outer"):
                with prof.wait("inner"):
                    torch.ones(8) + 1
    assert made == ["flatnav.outer", "flatnav.inner"]
    ev = {e.name: e for e in p.events() if e.name.startswith("flatnav.")}
    outer, inner = ev["flatnav.outer"].time_range, ev["flatnav.inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    assert any(e.name == "aten::add" and inner.start <= e.time_range.start <= inner.end
               for e in p.events())


def test_device_trace_shows_the_program_ranges(tmp_path):
    with prof.device_trace(str(tmp_path)):
        with prof.span("stage"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    names = {e.get("name", "") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert "flatnav.stage" in names and not prof.is_tracing()


def test_traced_keeps_the_function_and_spans_it():
    @prof.traced("f")
    def f(x, *, y=1):
        """doc"""
        return x + y

    assert f.__name__ == "f" and f.__doc__ == "doc" and f(1, y=2) == 3
    with prof.tracing():
        assert f(1) == 2
    assert prof.snapshot()["spans"]["f"]["calls"] == 1


# ------------------------------------------------------ the program's spans

_RNG = np.random.default_rng(7)
_DATA = _RNG.standard_normal((500, 12)).astype(np.float32)
_Q = _RNG.standard_normal((40, 12)).astype(np.float32)


def _index():
    return flatnav_tpu_torch.index.create(
        "l2", dim=12, dataset_size=500, max_edges_per_node=8, device="cpu")


@pytest.fixture(scope="module")
def built():
    idx = _index()
    idx.add(_DATA, ef_construction=32)
    return idx


def _calls(idx):
    return {
        "search": lambda: idx.search(_Q, K=5, ef_search=32),
        "search_exact": lambda: idx.search_exact(_Q, K=5, rerank=16),
    }


HOP = ["search.hop", "search.hop.select", "search.hop.links", "search.hop.membership",
       "search.hop.score", "search.hop.merge", "search.hop.end"]
TREES = {
    "search": ["index.search", "index.queries_in", "index.results_out", "search",
               "search.guard", "search.entry", "search.counts", *HOP],
    "search_exact": ["index.search_exact", "index.queries_in", "index.results_out", "scan",
                     "scan.prepare", "scan.k1", "scan.k3", "scan.rerank"],
    "add": ["index.add", "build.wave", "build.commit_vectors", "build.select",
            "build.commit_links", "build.kept_out", "build.back_edges", "search.entry", *HOP],
}


@pytest.mark.parametrize("call", ["search", "search_exact", "add"])
def test_index_calls_make_the_span_tree(built, call):
    with prof.tracing():
        if call == "add":
            _index().add(_DATA, ef_construction=32)
        else:
            _calls(built)[call]()
    snap = prof.snapshot()
    paths = set(snap["spans"])
    assert {p.rsplit("/", 1)[-1] for p in paths} == set(TREES[call])
    top = "index." + call
    assert all(p == top or p.startswith(top + "/") for p in paths)
    assert [r["name"] for r in snap["requests"]] == [top]
    if call == "search":
        hop = snap["spans"]["index.search/search/search.hop"]
        # the end test reads the hop before, from hop 2 on
        assert snap["spans"]["index.search/search/search.hop/search.hop.end"]["calls"] == (
            hop["calls"] - 1)
        assert hop["wait_ns"] == snap["spans"]["index.search/search/search.hop/search.hop.end"]["total_ns"]
    if call == "add":
        assert snap["counters"]["build.nodes"] == len(_DATA) - 1  # the first node takes no wave
        assert snap["counters"]["build.hops"] > 0 and snap["counters"]["build.dist_computations"] > 0
    if call == "search_exact":
        assert snap["counters"] == {"scan.queries": len(_Q)}


def test_search_counters_equal_search_results(built):
    g = built.graph
    q = torch.from_numpy(_Q)
    with prof.tracing():
        res = batched_search(g.vectors, g.links, g.labels, g.num_nodes, q, k=5, ef=32,
                             expand_factor=4)
    snap = prof.snapshot()
    c = snap["counters"]
    # the toy search converges well before its hop cap, so it issues one
    # spare hop; K2 is handed B x E*M slots a hop
    hop_calls = snap["spans"]["search/search.hop"]["calls"]
    assert c == {"search.queries": len(_Q), "search.hops": res.hops,
                 "search.dist_computations": res.dist_computations, "search.hop_capped": 0,
                 "search.hops_spare": 1,
                 "search.k2_slots": hop_calls * len(_Q) * 4 * g.links.shape[1]}


@pytest.mark.parametrize("call", ["search", "search_exact", "add"])
def test_results_are_bit_equal_with_tracing_on_and_off(built, call):
    def run():
        if call == "add":
            idx = _index()
            idx.add(_DATA, ef_construction=32)
            return idx.graph.links.clone(), idx.graph.vectors.clone()
        return tuple(torch.from_numpy(a) for a in _calls(built)[call]())

    off = run()
    with prof.tracing():
        on = run()
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_off_path_makes_no_torch_call_and_reads_no_clock(built, monkeypatch):
    want = [tuple(c()) for c in _calls(built).values()]
    monkeypatch.setattr(prof, "_now", _boom)
    monkeypatch.setattr(prof, "_profiler_on", _boom)
    monkeypatch.setattr(prof, "_Range", _boom)
    got = [tuple(c()) for c in _calls(built).values()]
    assert all(np.array_equal(a, b) for w, g in zip(want, got) for a, b in zip(w, g))
    _index().add(_DATA[:100], ef_construction=16)


def _under(event, name) -> bool:
    while event is not None:
        if event.name == name:
            return True
        event = event.cpu_parent
    return False


def test_profiler_sees_the_same_operations_on_and_off(built, monkeypatch):
    # the tracer's one read of the program's state, the hop cap's count (one
    # a search sub-batch), runs inside a range of this test's, so that its
    # operations can be set apart
    from flatnav_tpu_torch.index import search

    mark, real = "test.capped_read", search._capped_queries

    def capped_queries(beam):
        with torch.profiler.record_function(mark):
            return real(beam)

    monkeypatch.setattr(search, "_capped_queries", capped_queries)

    def ops():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            for c in _calls(built).values():
                c()
        reads = sum(e.name == mark for e in p.events())
        return [e.name for e in p.events() if not _under(e, mark)], reads

    off, off_reads = ops()
    with prof.tracing():
        on, on_reads = ops()
    assert (off_reads, on_reads) == (0, 1)  # one search of one sub-batch
    assert not any(n.startswith("flatnav.") for n in off)
    assert {n for n in on if n.startswith("flatnav.")} >= {"flatnav.search.hop", "flatnav.scan.prepare"}
    assert [n for n in on if not n.startswith("flatnav.")] == off
