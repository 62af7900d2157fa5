"""The readers of the program's own tracer (`annbench/program.py`): on a toy
run on the CPU, the program phase's spans and counters, with the harness's
own phases run with the tracer off; on synthetic profiler events, the
program's ranges, which change none of the harness's trace numbers, and the
launches and idle gaps put down to the innermost program span. A program
without the tracer gives none of the new metrics, and no error."""

from __future__ import annotations

import collections
import types

import pytest
import torch

from annbench import program
from annbench import trace as trace_mod
from annbench.registry import Registry
from annbench.run import Context, run_cell
from annbench.spans import SpanStats
from conftest import REPO

SEED = 2**31 + 99
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
NEW = {"search.launches_per_hop", "search.host_ms_per_hop", "search.hop_idle_pct",
       "search.dist_comps_per_query", "scan.prepare_ms"}


class Ev:
    """A profiler event as `trace.summarize` reads it."""

    def __init__(self, name, s, t, dev=False, corr=0, linked=0, tid=1, annotation=False):
        self._v = name, s, t, dev, corr, linked, tid, annotation

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return CUDA if self._v[3] else CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: list(events))))


HARNESS = [
    Ev("annbench.request", 0, 1000), Ev("annbench.search", 10, 900),
    Ev("cudaLaunchKernel", 210, 212, corr=1), Ev("cudaLaunchKernel", 150, 152, corr=2),
    Ev("cudaLaunchKernel", 50, 52, corr=3), Ev("cudaLaunchKernel", 950, 952, corr=4),
    Ev("k_score", 220, 320, dev=True, corr=1), Ev("k_select", 160, 200, dev=True, corr=2),
    Ev("k_entry", 60, 90, dev=True, corr=3), Ev("k_copy", 955, 990, dev=True, corr=4),
]
PROGRAM = [
    Ev("flatnav.search", 20, 880), Ev("flatnav.search.hop", 100, 500),
    Ev("flatnav.search.hop.score", 200, 300), Ev("flatnav.search.hop.end", 400, 500),
    # the card-side mirror of a range: not device work
    Ev("flatnav.search.hop", 160, 320, dev=True, annotation=True),
]


def test_program_ranges_change_none_of_the_harness_numbers():
    before, after = trace_mod.summarize(_prof(HARNESS)), trace_mod.summarize(_prof(HARNESS + PROGRAM))
    assert after.busy_s == before.busy_s == 205e-9 and after.window_s == before.window_s
    assert after.device_ops == before.device_ops
    assert after.span_device_ms == before.span_device_ms == {"search": 170e-6}
    assert after.span_device_ops == before.span_device_ops == {"search": 3}
    # the same gaps; the ones that open inside a program range take its name
    assert sum(v for _, v in after.idle_gaps) == pytest.approx(sum(v for _, v in before.idle_gaps))
    assert dict(after.idle_gaps)["flatnav.search.hop"] == pytest.approx(635e-9)


def test_launches_and_idle_go_to_the_innermost_program_span():
    found = program.read_ranges(_prof(HARNESS + PROGRAM))
    assert found["busy_s"] == 205e-9 and found["window_s"] == 1e-6 and found["requests"] == 1
    assert found["ranges.search.hop"] == 1 and found["ops.search.hop"] == 2
    assert found["ops.search.hop.score"] == 1 and found["ms.search.hop.score"] == pytest.approx(1e-4)
    assert found["ops.search"] == 3 and "ops.search.hop.end" not in found
    idle = {k[7:]: v for k, v in found.items() if k.startswith("idle_s.")}
    assert idle == pytest.approx({"python": 70e-9, "search": 70e-9, "search.hop.score": 20e-9,
                                  "search.hop": 635e-9})
    assert program.hop_idle_s(found) == pytest.approx(655e-9)
    assert (found["search_ops"], found["search_ops_in_program"]) == (3, 3)
    assert (found["request_ops"], found["request_ops_in_program"]) == (4, 3)
    assert found["search_idle_named_s"] == found["search_idle_s"] == pytest.approx(725e-9)
    assert program.read_ranges(_prof(HARNESS))["request_ops_in_program"] == 0


def _ctx(events, phase="replay"):
    found = program.read_ranges(_prof(events))
    st = SpanStats(counts=collections.Counter({("trace", k): v for k, v in found.items()}))
    return Context(spans={phase: {program.TRACE.name: st}})


@pytest.mark.parametrize("metric,want", [
    ("search.launches_per_hop", 2.0),
    ("search.hop_idle_pct", 65.5),
])
def test_device_readers_on_synthetic_events(metric, want):
    assert Registry(REPO).reader(metric).read(_ctx(HARNESS + PROGRAM)) == pytest.approx(want)
    assert Registry(REPO).reader(metric).read(_ctx(HARNESS)) is None


def test_scan_prepare_ms_on_synthetic_events():
    events = [
        Ev("annbench.request", 0, 100), Ev("annbench.request", 200, 300),
        Ev("flatnav.scan", 5, 95), Ev("flatnav.scan.prepare", 10, 40),
        Ev("cudaLaunchKernel", 20, 21, corr=1), Ev("cudaLaunchKernel", 50, 51, corr=2),
        Ev("square", 25, 45, dev=True, corr=1), Ev("scan_kernel", 55, 90, dev=True, corr=2),
    ]
    got = Registry(REPO).reader("scan.prepare_ms").read(_ctx(events, "trace"))
    assert got == pytest.approx(20e-6 / 2)


def _run(reg, cell):
    r = run_cell(reg, cell, SEED, 0.4, True, device="cpu")
    from flatnav_tpu_torch.utils import profiling

    assert r["correct"] and not profiling.is_tracing()
    return r


def test_graph_readers_on_a_toy_run(toy_reg, capsys):
    r = _run(toy_reg, "toy.graph")
    got = {k: v["value"] for k, v in r["metrics"].items()}
    # no device on the CPU: the device_trace readers find nothing
    assert set(got) & NEW == {"search.host_ms_per_hop", "search.dist_comps_per_query"}
    assert 0 < got["search.host_ms_per_hop"] <= got["search.ms_per_hop"] * 1.5
    err = capsys.readouterr().err
    line = next(ln for ln in err.splitlines() if ln.startswith("program search.hops / search.queries"))
    ours, theirs = (float(x.split()[-1]) for x in line.split(","))
    assert ours == theirs and ours == pytest.approx(got["search.hops_per_query"], rel=0.05)
    assert "index.search/search/search.hop/search.hop.score" in err
    assert "program stall tail" in err and "program tracing on: median request" in err
    # every query scored at least its entry scan (100 rows) and the entry node
    assert got["search.dist_comps_per_query"] > 101


def test_the_harness_phases_run_with_the_tracer_off(toy_reg, monkeypatch):
    import flatnav_tpu_torch.index.api as api
    from flatnav_tpu_torch.utils import profiling

    real, seen = api.batched_search, []

    def batched_search(*a, **kw):
        seen.append((profiling.is_tracing(), torch.autograd._profiler_enabled()))
        return real(*a, **kw)
    monkeypatch.setattr(api, "batched_search", batched_search)
    r = _run(toy_reg, "toy.graph")
    n = 3  # the toy mix's trace_requests
    # warm-up and window untraced; then, before any profiler has recorded,
    # the program phase's n pairs, on first and off first in turn; the
    # harness's profiled requests untraced; the program's profiled ones on
    first = seen.index((True, False))
    assert first > 0 and set(seen[:first]) == {(False, False)}
    assert seen[first:] == ([(True, False), (False, False), (False, False), (True, False),
                             (True, False), (False, False)]
                            + [(False, True)] * n + [(False, False)] * n + [(True, True)] * n)
    assert {"search.host_ms_per_hop", "search.dist_comps_per_query"} <= set(r["metrics"])


def test_scan_run_reports_its_spans(toy_reg, capsys):
    r = _run(toy_reg, "toy.scan")
    assert not set(r["metrics"]) & NEW
    err = capsys.readouterr().err
    assert "index.search_exact/scan/scan.prepare" in err and "scan.queries" in err


def test_a_program_without_the_tracer_gives_none_of_them(toy_reg, monkeypatch):
    monkeypatch.setattr(program, "_profiling", lambda: None)
    r = _run(toy_reg, "toy.graph")
    assert not set(r["metrics"]) & NEW
    assert {"build_s", "search.hops_per_query", "search.ms_per_hop"} <= set(r["metrics"])
