"""The beam-search hop's bookkeeping on the card: select, membership and merge
(`csrc/beam_hop.cu`), one launch each for the whole batch.

`index/search.py`'s `beam_search_core` takes these wherever its tensors are
on a CUDA card (`engages`), at every shape: a row's working set stays in
shared memory where it fits, and in a global-memory workspace of the same
layout where it does not (ef past ~8,000, or a history of tens of
thousands of ids). On the CPU it runs its PyTorch chain (`_select`,
`_membership`, `_merge` there), which is these kernels' plain version: each
kernel gives its stage's results bit for bit
(tests/test_torch_kernels_gpu.py). The kernels take CUDA tensors only.

A `BeamHop` binds the kernels to one search's state: the beam, the
expanded-id history and the two counters, which the kernels update in
place (the chain makes new tensors), and the outputs that every hop
reuses. The history differs from the chain's in one way: it is kept sorted
(`select` merges each hop's ids into it), where the chain keeps it in hop
order and sorts it in every hop's membership test. Both start as all -1.
The host's work a hop is one ctypes call a stage with pointers taken once.

Membership also writes the hop's candidates as the scorer gets them, the
score ids: the id where fresh, -1 elsewhere (K2 loads no row for -1). The
candidates keep their ids for the merge.
"""

from __future__ import annotations

import ctypes

import torch

from flatnav_tpu_torch import _build


def engages(device: torch.device) -> bool:
    """Whether `beam_search_core` runs its hops through these kernels: on a
    CUDA card, at any shape."""
    return device.type == "cuda"


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def stage_bytes(ef: int, e_f: int, m: int, hist_width: int) -> dict[str, int]:
    """A query row's working memory in each stage, in bytes: the layouts of
    `csrc/beam_hop.cu` (select: the history, this hop's ids and positions;
    membership: hash sets of twice their entries for the beam and history
    and for the candidates, each candidate's slot and flag; merge: the
    sort keys of the candidates and the beam, and a copy of the beam)."""
    c = e_f * m
    return {"select": (hist_width + _pow2(e_f) + e_f) * 4,
            "membership": (_pow2(2 * (ef + hist_width)) + 2 * _pow2(2 * c) + c) * 4 + c,
            "merge": (_pow2(c) + _pow2(ef)) * 8 + ef * 9}


def scratch_row(ef: int, e_f: int, m: int, hist_width: int, smem_limit: int) -> int:
    """The global-memory workspace a row needs, in bytes (a multiple of 16):
    the largest stage that `smem_limit` bytes of shared memory cannot hold,
    0 where every stage fits."""
    over = [n for n in stage_bytes(ef, e_f, m, hist_width).values() if n > smem_limit]
    return -(-max(over) // 16) * 16 if over else 0


def _lib():
    lib = _build.load("beam_hop")
    if not lib.beam_select_launch.argtypes:
        p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        for fn, args in (
            (lib.beam_hop_smem_limit, [ctypes.POINTER(i)]),
            (lib.beam_select_launch, [p, p, p, i, i, i, i, p, p, p, p, z, p]),
            (lib.beam_membership_launch, [p, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, z, p]),
            (lib.beam_merge_launch, [p, p, p, p, p, p, i, i, i, p, p, i, p, z, p]),
        ):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


class BeamHop:
    """The three kernels over one search's state.

    beam_d [B, ef] float32, beam_i [B, ef] int32, beam_e [B, ef] bool: the
    beams; hist [B, W] int32: the expanded-id history, ascending (all -1 at
    the start; a search of hop_cap hops of `e_f` has W = hop_cap * e_f);
    dcomp, hops: int64 counters. All contiguous, on one card, and updated
    in place. `workspace` is the global-memory stand-in for shared memory
    (None where every stage fits shared memory). `membership` also fills
    `score_ids`. `BeamHop.launches` counts the kernels' launches."""

    launches = 0

    def __init__(self, beam_d, beam_i, beam_e, hist, dcomp, hops, *, e_f: int, m: int,
                 compact_width: int = 0):
        for t, dtype in ((beam_d, torch.float32), (beam_i, torch.int32), (beam_e, torch.bool),
                         (hist, torch.int32), (dcomp, torch.int64), (hops, torch.int64)):
            if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
                raise ValueError(f"BeamHop: wants contiguous CUDA {dtype} tensors, got {t.dtype} "
                                 f"on {t.device}")
        b, ef = beam_i.shape
        em = e_f * m
        cc = compact_width if 0 < compact_width < em else 0
        dev = beam_i.device
        self.b, self.ef, self.e_f, self.m, self.em, self.cc = b, ef, e_f, m, em, cc
        self.cur_ids = torch.empty((b, e_f), dtype=torch.int32, device=dev)
        self.sel_valid = torch.empty((b, e_f), dtype=torch.bool, device=dev)
        self.fresh = torch.empty((b, cc or em), dtype=torch.bool, device=dev)
        self.nbrs_out = torch.empty((b, cc), dtype=torch.int32, device=dev) if cc else None
        #: the candidates as the scorer gets them: the id where fresh, -1 elsewhere
        self.score_ids = torch.empty((b, cc or em), dtype=torch.int32, device=dev)
        #: set to a hop's stamp by its merge where a beam holds an unexpanded entry
        self.flag = torch.zeros((), dtype=torch.int32, device=dev)
        self._state = (beam_d, beam_i, beam_e, hist, dcomp, hops)  # the pointers' owners
        lib = _lib()
        w = hist.shape[1]
        with torch.cuda.device(dev):
            limit = ctypes.c_int()
            _build.check(lib.beam_hop_smem_limit(ctypes.byref(limit)), "BeamHop shared memory")
        row = scratch_row(ef, e_f, m, w, limit.value)
        self.workspace = torch.empty(b * row, dtype=torch.uint8, device=dev) if row else None
        ws = (self.workspace.data_ptr(), row) if row else (0, 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        d, i, e, h, dc, hp = (t.data_ptr() for t in self._state)
        cur, sv, fr = self.cur_ids.data_ptr(), self.sel_valid.data_ptr(), self.fresh.data_ptr()
        self._select = (lib.beam_select_launch, (i, e, h, b, ef, e_f, w, cur, sv, hp, *ws, stream))
        self._member = (lib.beam_membership_launch, (d, i, h), (
            sv, b, ef, w, em, e_f, m, cc, fr, self.nbrs_out.data_ptr() if cc else 0,
            self.score_ids.data_ptr(), *ws, stream))
        self._merge = (lib.beam_merge_launch, (d, i, e), (fr, b, ef, cc or em, dc,
                       self.flag.data_ptr()), (*ws, stream))

    def select(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The first e_f unexpanded positions of each beam (ascending),
        marked expanded; their ids join the history (-1 for a selection
        past the row's unexpanded entries) and `hops` adds the valid ones.
        The history must hold at least e_f entries -1. -> (cur_ids
        [B, e_f] int32, 0 where not valid; sel_valid [B, e_f] bool),
        overwritten by the next hop."""
        fn, args = self._select
        _build.check(fn(*args), "BeamHop.select")
        BeamHop.launches += 1
        return self.cur_ids, self.sel_valid

    def membership(self, nbrs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Which candidates `nbrs` [B, E*M] (int32) are fresh: selected
        source, first occurrence in the row, not in the beam (finite
        entries), not in the history. -> (nbrs, fresh [B, E*M] bool), or
        with a compact width CC < E*M the first CC candidates fresh-first
        ([B, CC] each); overwritten by the next hop, as is `score_ids`."""
        if nbrs.dtype != torch.int32 or not nbrs.is_contiguous():
            nbrs = nbrs.to(torch.int32).contiguous()
        if nbrs.shape != (self.b, self.em) or not nbrs.is_cuda:
            raise ValueError(f"BeamHop.membership: candidates {tuple(nbrs.shape)} on "
                             f"{nbrs.device}, want [{self.b}, {self.em}] on the card")
        fn, head, tail = self._member
        _build.check(fn(*head, nbrs.data_ptr(), *tail), "BeamHop.membership")
        BeamHop.launches += 1
        return (self.nbrs_out if self.cc else nbrs), self.fresh

    def merge(self, scores: torch.Tensor, nbrs: torch.Tensor, stamp: int) -> None:
        """Merges the scored candidates (`scores` where `fresh`, +inf
        elsewhere; `nbrs` and `fresh` as `membership` returned them) into
        the beams: the first ef of beam and new entries by distance, beam
        entries first on ties, new ones by position. `dcomp` adds the fresh
        count; `flag` is set to `stamp` where a new beam holds an
        unexpanded entry."""
        if scores.dtype != torch.float32 or not scores.is_contiguous():
            scores = scores.to(torch.float32).contiguous()
        if scores.shape != self.fresh.shape or nbrs.shape != self.fresh.shape:
            raise ValueError(f"BeamHop.merge: scores {tuple(scores.shape)}, candidates "
                             f"{tuple(nbrs.shape)}, want {tuple(self.fresh.shape)}")
        fn, head, tail, last = self._merge
        rc = fn(*head, scores.data_ptr(), nbrs.data_ptr(), *tail, stamp, *last)
        _build.check(rc, "BeamHop.merge")
        BeamHop.launches += 1


__all__ = ["BeamHop", "engages", "scratch_row", "stage_bytes"]
