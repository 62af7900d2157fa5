"""The port's profiling utilities (flatnav_tpu_torch.utils.profiling) against
flatnav_tpu.utils.profiling, on the CPU: the host-side pieces behave alike
(same counters from the same records, exactly), and the device pieces report
nothing without a card."""

import json
import time

import pytest
import torch

import flatnav_tpu.utils.profiling as jprof
from flatnav_tpu_torch.utils import profiling as prof

RECORDS = [(64, 12_800, 900, 0.25), (1, 7, 3, 0.0), (1000, 10**9, 10**6, 1.5)]


@pytest.mark.parametrize("upto", [0, 1, 2, 3])
def test_search_stats_match_jax(upto):
    ps, js = prof.SearchStats(), jprof.SearchStats()
    for rec in RECORDS[:upto]:
        ps.record(*rec)
        js.record(*rec)
    for name in ("queries", "distance_computations", "hops", "seconds",
                 "distance_computations_per_query", "hops_per_query", "qps"):
        assert getattr(ps, name) == getattr(js, name), name
    snap = ps.reset()
    assert snap.queries == js.queries and ps.queries == 0 and ps.seconds == 0.0
    assert ps.qps == 0.0 and ps.hops_per_query == 0.0


def test_timed_measures_the_block():
    with prof.timed() as cell:
        time.sleep(0.02)
        assert cell["seconds"] == 0.0  # filled on exit
    assert 0.02 <= cell["seconds"] < 2.0
    with pytest.raises(KeyError):
        with prof.timed() as cell:
            raise KeyError("x")
    assert cell["seconds"] > 0  # also when the block raises


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
