"""Timing and bounds shared by the port's measurement scripts.

`chip_smoke.py`, `bench/profile_fused_stages.py`, `bench/kernel_ab.py` and
the north-star runners take the card's peaks, their CUDA-event timer, the
card's name line, the bound of each kernel (K1 `scan_bound`, K2
`gather_bound`, K3 `select_bound`) and `CallRecorder` (a kernel's arguments
kept from a call on a module's path) from here, so every script states the
same numbers.
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
INT8_OP_PER_S = 1979e12
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


def scan_bound(qc: int, n: int, d: int, nb: int, row_bytes: int = 2, q_bytes: int = 2):
    """-> (ms, "bytes" or "operations") of K1 over qc queries of `q_bytes`
    bytes an element and an [n, d] table of `row_bytes`-byte elements: the
    queries, table and penalties read once, the [qc, nb] f32 + i32 summary
    written once; 2 qc n d operations, at the int8 peak where rows and
    queries are both 8-bit and at the bf16 peak otherwise (8-bit rows
    against bf16 queries are bf16 products). d is the table's own width:
    columns a kernel pads on (a bf16 copy's multiple of 8, a box's zeros
    past d) are work the function does not need."""
    nbytes = qc * d * q_bytes + n * d * row_bytes + n * 4 + qc * nb * 8
    rate = INT8_OP_PER_S if row_bytes == q_bytes == 1 else BF16_FLOP_PER_S
    return _bound(nbytes, 2 * qc * n * d, rate)


def select_bound(b: int, w: int, k: int, ids: str = "implicit", prior: bool = False):
    """-> (ms, "bytes") of K3 over a [b, w] float32 key matrix -> k: each
    key read once (4 B), the [b, k] f32 + i32 result written once, a [b, k]
    prior of f32 + i32 read once where one is given, and the ids that the
    function must read: those of the k pairs a row returns (4 B each) where
    the ids are a [b, w] tensor ("full") or one [1, w] row ("row"), none
    where they are implicit (start + column). The rest of an id tensor need
    not be read. The selection does no arithmetic the peak rates count."""
    if ids not in ("full", "row", "implicit"):
        raise ValueError(f"select_bound: ids must be full, row or implicit, not {ids!r}")
    nbytes = b * w * 4 + b * k * (8 + (8 if prior else 0) + (0 if ids == "implicit" else 4))
    return _bound(nbytes, 0, BF16_FLOP_PER_S)


def hop_stage_bounds(b: int, ef: int, e_f: int, m: int, hist_width: int,
                     compact_width: int = 0) -> dict[str, tuple[float, str]]:
    """-> {"select", "membership", "merge": (ms, "bytes")}: each stage of a
    hop's bookkeeping (`csrc/beam_hop.cu`) for b queries, the bytes its
    function needs read once and written once. Select reads the expanded
    marks and the E selected ids, and writes the marks it sets, the ids,
    their valid flags and the E ids it adds to the history (the kernel also
    reads and rewrites the rest of the sorted history: its design's traffic,
    not counted); membership reads the beam's distances and ids, the
    history, the E*M candidates and the valid flags, and writes the fresh
    flags (and the compacted candidates); merge reads the beam (9 B an
    entry), the C scored candidates' distances, ids and fresh flags, and
    writes the beam. No arithmetic the peak rates count."""
    em = e_f * m
    c = compact_width if 0 < compact_width < em else em
    select = ef + e_f * 4 + e_f + e_f * 4 + e_f + e_f * 4
    member = ef * 8 + hist_width * 4 + em * 4 + e_f + c + (c * 4 if c < em else 0)
    merge = ef * 9 + c * 9 + ef * 9
    return {name: _bound(b * n, 0, BF16_FLOP_PER_S)
            for name, n in (("select", select), ("membership", member), ("merge", merge))}


def hop_bound(b: int, ef: int, e_f: int, m: int, hist_width: int, compact_width: int = 0):
    """-> (ms, "bytes") of a whole hop's bookkeeping: the sum of
    `hop_stage_bounds`."""
    stages = hop_stage_bounds(b, ef, e_f, m, hist_width, compact_width)
    return sum(ms for ms, _ in stages.values()), "bytes"


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
