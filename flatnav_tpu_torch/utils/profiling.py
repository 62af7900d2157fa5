"""Tracing / profiling utilities.

Counterpart of flatnav_tpu/utils/profiling.py. The reference's
observability surface is: opt-in atomic counters `_distance_computations` /
`_metric_hops` (include/flatnav/index/Index.h:83-84, 689-691, 857-859)
drained by get_query_distance_computations (bindings.cpp:270-274), plus
wall-clock timing in the harness. Here the counters come back with each
search batch (index/search.py); this module adds the host-side pieces: a
stats aggregator, timing helpers, device memory counters from
`torch.cuda`, and `torch.profiler` trace capture for device-level analysis
(the analog of the reference's cAdvisor/Prometheus container profiling,
bin/memory-profiling/).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch


@dataclasses.dataclass
class SearchStats:
    """Aggregated per-batch engine counters."""

    queries: int = 0
    distance_computations: int = 0
    hops: int = 0
    seconds: float = 0.0

    def record(self, num_queries: int, dist_comps: int, hops: int, secs: float):
        self.queries += num_queries
        self.distance_computations += int(dist_comps)
        self.hops += int(hops)
        self.seconds += secs

    @property
    def distance_computations_per_query(self) -> float:
        return self.distance_computations / max(self.queries, 1)

    @property
    def hops_per_query(self) -> float:
        return self.hops / max(self.queries, 1)

    @property
    def qps(self) -> float:
        return self.queries / self.seconds if self.seconds else 0.0

    def reset(self) -> "SearchStats":
        snapshot = dataclasses.replace(self)
        self.queries = self.distance_computations = self.hops = 0
        self.seconds = 0.0
        return snapshot


@contextlib.contextmanager
def timed():
    """Context manager yielding a mutable [start, elapsed] cell."""
    cell = {"seconds": 0.0}
    t0 = time.perf_counter()
    try:
        yield cell
    finally:
        cell["seconds"] = time.perf_counter() - t0


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the host and, where there is a
    card, the device into `log_dir/trace.json` (Chrome trace format: open in
    chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device=None) -> dict:
    """Device memory of `device` (default: the current CUDA card) from
    torch's caching allocator, under the keys the JAX package's device
    reports: `bytes_in_use` (allocated now), `peak_bytes_in_use` (the most
    allocated since `torch.cuda.reset_peak_memory_stats`), plus
    `bytes_reserved` and `bytes_limit` (the card's total). {} for a CPU
    device or without a card (the analog of the reference's
    getTotalIndexMemory/visitedSetPoolAllocatedMemory printers,
    Index.h:505-515)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(torch.cuda.mem_get_info(dev)[1]),
    }


def host_memory_stats() -> dict:
    """Host RSS/VM of this process from /proc (no psutil dependency)."""
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(("VmRSS", "VmHWM", "VmSize")):
                    key, val = line.split(":", 1)
                    out[key.lower() + "_kb"] = int(val.strip().split()[0])
    except OSError:
        pass
    return out


class MemoryMonitor:
    """Background host+device memory sampler -> JSONL.

    The analog of the reference's container monitoring stack
    (experiments/metrics/docker-compose.yml: cAdvisor + Prometheus +
    Grafana sampling container memory during benchmark runs): a daemon
    thread samples host RSS (/proc) and the device's memory counters every
    `interval_s` into a JSONL file that plotting or CI can consume.

        with MemoryMonitor("mem.jsonl", interval_s=1.0):
            run_benchmark()

    Each line: {"t": <s since start>, "host": {...}, "device": {...}}.
    `peak()` returns the max host RSS and device bytes_in_use seen.
    """

    def __init__(self, path: str, interval_s: float = 1.0):
        import threading

        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._peak_host = 0
        self._peak_dev = 0

    def _run(self):
        import json

        t0 = time.perf_counter()
        with open(self.path, "w") as f:
            while not self._stop.is_set():
                host = host_memory_stats()
                try:
                    dev = device_memory_stats()
                except Exception:
                    dev = {}
                self._peak_host = max(
                    self._peak_host, host.get("vmrss_kb", 0) * 1024
                )
                self._peak_dev = max(
                    self._peak_dev, dev.get("bytes_in_use", 0)
                )
                f.write(json.dumps({
                    "t": round(time.perf_counter() - t0, 3),
                    "host": host,
                    "device": dev,
                }) + "\n")
                f.flush()
                self._stop.wait(self.interval_s)

    def peak(self) -> dict:
        return {
            "host_rss_bytes": self._peak_host,
            "device_bytes_in_use": self._peak_dev,
        }

    def __enter__(self) -> "MemoryMonitor":
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)
        return False
