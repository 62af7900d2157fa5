"""Timing and bounds shared by the port's measurement scripts.

`chip_smoke.py`, `bench/profile_fused_stages.py`, `bench/kernel_ab.py` and
the north-star runners take the card's peaks, their CUDA-event timer, the
card's name line, the bound of each kernel and `CallRecorder` (a kernel's
arguments kept from a call on a module's path) from here, so every script
states the same numbers.
A bound is the larger of the bytes the function must move (each input read
once, each output written once) over the memory rate and its operations
over the peak rate for their type.
"""

from __future__ import annotations

import subprocess

import torch

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def timed(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events around `reps` calls that
    follow `warmup` untimed ones."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, flops: float, flop_per_s: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def gather_bound(vectors: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor):
    """-> (ms, "bytes" or "operations") of K2 at these arguments: the
    distinct rows the ids name, the ids, queries and [B, C] f32 output,
    each moved once; 3 f32 operations per gathered element."""
    b, c = ids.shape
    d = vectors.shape[1]
    uniq = int(torch.unique(ids).numel())
    nbytes = uniq * d * vectors.element_size() + ids.numel() * 4 + queries.numel() * 4 + b * c * 4
    return _bound(nbytes, 3 * b * c * d, F32_FLOP_PER_S)


def scan_bound(qc: int, n: int, d: int, nb: int, row_bytes: int = 2):
    """-> (ms, "bytes" or "operations") of K1 over qc bf16 queries and an
    [n, d] table of `row_bytes`-byte rows: the queries, table and
    penalties read once, the [qc, nb] f32 + i32 summary written once;
    2 qc n d operations at the bf16 peak."""
    nbytes = qc * d * 2 + n * d * row_bytes + n * 4 + qc * nb * 8
    return _bound(nbytes, 2 * qc * n * d, BF16_FLOP_PER_S)


class CallRecorder:
    """Stands in for a kernel wrapper where a module calls it and keeps the
    arguments of the `nth` call that `keep(*args)` accepts since the last
    reset (tensors cloned, except the positions `shared` names, which are
    kept by reference); the wrapper it calls counts its own launches."""

    def __init__(self, fn, keep=lambda *args: True, nth=1, shared=()):
        self.fn, self.keep, self.nth, self.shared = fn, keep, nth, shared
        self.reset()

    def reset(self):
        self.seen, self.args = 0, None

    # the wrapper counts its launches through its module's name, which
    # names this recorder while it stands in
    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __getattr__(self, name):  # the wrapper's other counters
        if name == "fn":
            raise AttributeError(name)
        return getattr(self.fn, name)

    def __call__(self, *args):
        if self.keep(*args):
            self.seen += 1
            if self.seen == self.nth:
                self.args = tuple(a.clone() if hasattr(a, "clone") and i not in self.shared else a
                                  for i, a in enumerate(args))
        return self.fn(*args)
