"""Tracing and profiling of the port.

Counterpart of flatnav_tpu/utils/profiling.py. The reference's
observability surface is: opt-in atomic counters `_distance_computations` /
`_metric_hops` (include/flatnav/index/Index.h:83-84, 689-691, 857-859)
drained by get_query_distance_computations (bindings.cpp:270-274), plus
wall-clock timing in the harness. Here the counters come back with each
search batch (index/search.py), and this module adds:

* the tracer: `span` (host work of a layer or stage), `wait` (a point where
  the host blocks on the card: `bool(t)`, `int(t)`, `.cpu()`) and `count`
  (a counter of host values) at the layer boundaries of search, scan and
  build. All three do nothing, and cost one shared null context, unless
  `tracing()` is on. On, spans nest on a per-thread stack and `snapshot()`
  returns calls, total, self and wait nanoseconds by span path
  (`search/search.hop/search.hop.merge`), the counters, and one record per
  top-level span (a request: `index.search`, `index.search_exact`,
  `index.add`). While a `torch.profiler` records, each span is also a
  `flatnav.<name>` range on the trace's own host timeline, so the kernels
  it launched line up with it without any conversion between clocks;
* device memory counters from `torch.cuda`, a host memory sampler, and
  `torch.profiler` trace capture for device-level analysis (the analog of
  the reference's cAdvisor/Prometheus container profiling,
  bin/memory-profiling/).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time
from time import perf_counter_ns as _now

import torch

_profiler_on = torch.autograd._profiler_enabled  # whether a torch.profiler records
#: a span's range on the profiler's host timeline: torch's fast form where it
#: has one (a host event without the dispatcher's op call and without a
#: device-side mirror; under a recording profiler about a tenth of
#: `record_function`'s cost), else `record_function`
_Range = (getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast", None)
          or torch.profiler.record_function)

#: prefix of the program's ranges in a profiler trace
PREFIX = "flatnav."
#: request records kept between snapshots; the oldest go first
MAX_RECORDS = 4096


class _Null:
    """What `span` and `wait` return while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("_part", "_name", "_is_wait", "_path", "_seq", "_t0", "_child", "_waited",
                 "_range")

    def __init__(self, part: "_Part", name: str, is_wait: bool):
        self._part, self._name, self._is_wait = part, name, is_wait

    def __enter__(self):
        stack = self._part.stack
        if stack:
            parent = stack[-1]
            self._path, self._seq = parent._path + "/" + self._name, parent._seq
        else:
            self._path, self._seq = self._name, self._part.tracer._next_seq()
        self._child = self._waited = 0
        if _profiler_on():
            self._range = _Range(PREFIX + self._name)
            self._range.__enter__()
        else:
            self._range = None
        stack.append(self)
        self._t0 = _now()
        return self

    def __exit__(self, *exc):
        dur = _now() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        part = self._part
        stack = part.stack
        stack.pop()
        waited = dur if self._is_wait else self._waited
        if stack:
            parent = stack[-1]
            parent._child += dur
            parent._waited += waited
        else:
            part.tracer._record(self._seq, self._name, self._t0, dur, waited)
        row = part.spans.get(self._path)
        if row is None:
            row = part.spans[self._path] = [0, 0, 0, 0]
        row[0] += 1
        row[1] += dur
        row[2] += dur - self._child
        row[3] += waited
        return False


class _Part:
    """One thread's open spans and its share of the table: a thread adds only
    to its own, so a span takes no lock."""

    __slots__ = ("tracer", "stack", "spans", "counters")

    def __init__(self, tracer: "_Tracer"):
        self.tracer = tracer
        self.stack: list = []
        self.spans: dict = {}
        self.counters: collections.Counter = collections.Counter()


class _Local(threading.local):
    def __init__(self, tracer: "_Tracer"):  # once in each thread, at its first span
        self.part = _Part(tracer)
        with tracer._lock:
            tracer._parts.append(self.part)


class _Tracer:
    """The table that spans and counters add to: by span path, calls and
    total / self / wait nanoseconds (self: not inside a child span; wait:
    inside `wait` spans, the span's own duration if it is one); counters by
    name; a record per top-level span, numbered in the order they began."""

    def __init__(self):
        self._lock = threading.Lock()
        self._parts: list[_Part] = []  # one a thread that ever traced
        self._local = _Local(self)
        self._seq = 0
        self._records: collections.deque = collections.deque(maxlen=MAX_RECORDS)

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _record(self, seq: int, name: str, t0: int, dur: int, waited: int):
        with self._lock:
            self._records.append((seq, name, t0, dur, waited))

    def count(self, name: str, n: int):
        if isinstance(n, torch.Tensor):
            raise TypeError(f"count({name!r}) takes a host value, not a tensor")
        self._local.part.counters[name] += n

    def snapshot(self, reset: bool = True) -> dict:
        spans, counters = {}, collections.Counter()
        with self._lock:
            for part in self._parts:
                for path, row in part.spans.items():
                    have = spans.setdefault(path, [0, 0, 0, 0])
                    for i, v in enumerate(row):
                        have[i] += v
                counters.update(part.counters)
                if reset:
                    part.spans, part.counters = {}, collections.Counter()
            records = list(self._records)
            if reset:
                self._records.clear()
            seq = self._seq
        return {
            "spans": {path: dict(zip(("calls", "total_ns", "self_ns", "wait_ns"), row))
                      for path, row in spans.items()},
            "counters": dict(counters),
            "requests": [
                {"seq": seq_, "name": name, "start_ns": t0, "dur_ns": dur,
                 "wait_ns": waited, "host_ns": dur - waited}
                for seq_, name, t0, dur, waited in records],
            "seq": seq,
        }


_TRACER = _Tracer()
_active: _Tracer | None = None  # _TRACER while `tracing()` is on
_depth = 0  # `tracing()` blocks open


def span(name: str):
    """Context manager around host work of a layer or stage; the shared null
    context while tracing is off."""
    t = _active
    return _NULL if t is None else _Span(t._local.part, name, False)


def wait(name: str):
    """`span` for a point where the host blocks on the card (`bool(t)`,
    `int(t)`, `.item()`, `.cpu()`): its time counts as the enclosing spans'
    wait time."""
    t = _active
    return _NULL if t is None else _Span(t._local.part, name, True)


def count(name: str, n: int) -> None:
    """Adds `n`, a value already on the host, to counter `name` while
    tracing is on."""
    t = _active
    if t is not None:
        t.count(name, n)


def traced(name: str):
    """Decorator: the function runs inside `span(name)`."""

    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            t = _active
            if t is None:
                return fn(*args, **kwargs)
            with _Span(t._local.part, name, False):
                return fn(*args, **kwargs)

        return run

    return deco


def is_tracing() -> bool:
    return _active is not None


@contextlib.contextmanager
def tracing():
    """Turns `span`, `wait` and `count` on for the extent of the block (in
    every thread); blocks may nest."""
    global _active, _depth
    with _TRACER._lock:
        _depth += 1
        _active = _TRACER
    try:
        yield
    finally:
        with _TRACER._lock:
            _depth -= 1
            if _depth == 0:
                _active = None


def snapshot(reset: bool = True) -> dict:
    """The tracer's table: `spans` (path -> calls, total_ns, self_ns,
    wait_ns), `counters` (name -> total), `requests` (one record per
    top-level span: seq, name, start_ns and dur_ns on `time.perf_counter_ns`,
    wait_ns, host_ns = dur_ns - wait_ns; at most `MAX_RECORDS`) and `seq`
    (the number of top-level spans begun so far). `reset` clears all but
    `seq`."""
    return _TRACER.snapshot(reset)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the host and, where there is a
    card, the device into `log_dir/trace.json` (Chrome trace format: open in
    chrome://tracing or Perfetto), with tracing on, so that it shows the
    program's `flatnav.` ranges."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing(), torch.profiler.profile(activities=activities) as prof:
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
