"""Reads a `torch.profiler` run of the profiled requests: the device's busy
time, its idle gaps and what the host was doing in them, the device
operations that took most time, and the device time of the kernels launched
inside each of the benchmark's spans.

A device operation (kernel, copy or set) is tied to the host moment that
launched it: the runtime call with its CUPTI correlation id or, where the
trace has none, the PyTorch operation it is linked to. It belongs to a span when
that moment lies inside one of the span's ranges, so it counts every kernel
the call launched, through nested operations too.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

PREFIX = "annbench."
REQUEST = PREFIX + "request"


@dataclasses.dataclass
class TraceSummary:
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: list = dataclasses.field(default_factory=list)  # [[name, s]], most first
    idle_gaps: list = dataclasses.field(default_factory=list)  # [[host op, s]], most first
    span_device_ms: dict = dataclasses.field(default_factory=dict)  # span -> ms
    span_device_ops: dict = dataclasses.field(default_factory=dict)  # span -> count


def _is_device(e) -> bool:
    """A kernel, copy or set on the card; not the card-side mirror of a host
    range (a user annotation), which some torch versions also return."""
    if e.device_type() != torch.autograd.DeviceType.CUDA or e.name().startswith(PREFIX):
        return False
    kind = getattr(e, "activity_type", None)
    annotation = getattr(e, "is_user_annotation", None)
    return not ((kind and "annotation" in str(kind())) or (annotation and annotation()))


def _is_runtime(e) -> bool:
    """A CUDA runtime or driver call (`cudaLaunchKernel`, `cuLaunchKernelEx`,
    `cudaMemcpyAsync`, ...): it carries the CUPTI correlation id of the work
    it launched. Kernels the port launches through its own libraries link to
    no PyTorch operation, so their runtime calls are found by name."""
    name = e.name()
    return e.linked_correlation_id() > 0 or name.startswith("cuda") or (
        name.startswith("cu") and name[2:3].isupper())


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(ops, times):
    """For each time (ascending), the name of the innermost host operation
    open at it, or "python" where none is: `ops` are (start, end, name) of
    one thread, properly nested."""
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    stack, names, j = [], [], 0
    for t in times:
        while j < len(ops) and ops[j][0] <= t:
            while stack and stack[-1][1] <= ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        names.append(stack[-1][2] if stack else "python")
    return names


def summarize(prof, top: int = 10) -> TraceSummary:
    events = prof.profiler.kineto_results.events()
    host, device, launch_at, op_start = [], [], {}, {}
    for e in events:
        if _is_device(e):
            device.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id(),
                           e.linked_correlation_id()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            if _is_runtime(e):
                launch_at[e.correlation_id()] = e.start_ns()
            else:
                host.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()))
                op_start[e.correlation_id()] = e.start_ns()

    requests = sorted((s, t) for s, t, name, _ in host if name == REQUEST)
    out = TraceSummary()
    if not requests:
        return out
    w0, w1 = requests[0][0], max(t for _, t in requests)
    out.window_s = (w1 - w0) / 1e9

    busy = _merge([max(s, w0), min(t, w1)] for s, t, *_ in device if t > w0 and s < w1)
    out.busy_s = sum(t - s for s, t in busy) / 1e9

    by_name = collections.Counter()
    for s, t, name, *_ in device:
        by_name[name] += (t - s) / 1e9
    out.device_ops = [[n, v] for n, v in by_name.most_common(top)]

    main = collections.Counter(tid for _, _, name, tid in host if name == REQUEST).most_common(1)[0][0]
    main_ops = [(s, t, name) for s, t, name, tid in host if tid == main]
    gaps, edge = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    gap_names = _innermost(main_ops, [s for s, _ in gaps])
    idle = collections.Counter()
    for (s, t), name in zip(gaps, gap_names):
        idle[name] += (t - s) / 1e9
    out.idle_gaps = [[n, v] for n, v in idle.most_common(top)]

    ranges = collections.defaultdict(list)
    for s, t, name, _ in host:
        if name.startswith(PREFIX) and name != REQUEST:
            ranges[name[len(PREFIX):]].append((s, t))
    for span, iv in ranges.items():
        iv.sort()
        starts = [s for s, _ in iv]
        ms, count = 0.0, 0
        for s, t, name, corr, linked in device:
            at = launch_at.get(corr, op_start.get(linked))
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= iv[i][1]:
                ms += (t - s) / 1e6
                count += 1
        out.span_device_ms[span] = ms
        out.span_device_ops[span] = count
    return out
