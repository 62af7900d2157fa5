"""The beam-search hop's bookkeeping: select, membership and merge, behind one
interface with two engines.

`make_hop` binds one search's state to an engine: `BeamHop` where the beam
is on a CUDA card, `ChainHop` elsewhere (the kernel wrappers' rule: on a
CUDA tensor a wrapper always launches its kernel). `index/search.py`'s
`beam_search_core` runs one loop over either, at every shape.

`BeamHop` runs each stage as one hand-written kernel for the whole batch
(`csrc/beam_hop.cu`): a row's working set stays in shared memory where it
fits, and in a global-memory workspace of the same layout where it does not
(ef past ~8,000, or a history of tens of thousands of ids). The host's work
a hop is one ctypes call a stage with pointers taken once. `ChainHop` is its
plain version, a chain of PyTorch ops on any device; each kernel gives its
stage's results bit for bit (tests/test_torch_kernels_gpu.py).

Both engines update one search's state in place: the beams, the expanded-id
history, kept ascending (all -1 at the start; each select puts its ids, -1
where not valid, into E of the row's -1 slots), and the counters of
distance computations and expansions. After every stage the two hold equal
tensors. Membership also writes the hop's candidates as the scorer gets
them, the score ids: the id where fresh, -1 elsewhere (K2 loads no row for
-1). The candidates keep their ids for the merge.

The loop's end test is a flag: select advances the hop's number and the
merge sets the flag to it where a beam holds an unexpanded entry (0 for the
start beams). The flag only grows, so read once hop n or a later one has
run, it says whether hop n left an unexpanded entry (flag >= n):
`unexpanded_after(n)`, where the host waits for the card. `BeamHop` keeps
both on the card and no host value that a hop changes, so a hop's launches
can be captured once in a CUDA graph and replayed at every hop
(`index/search.py`). After `mirror(host)` its merges also write the flag
into `host`, pinned host memory, which the host reads once an event after
hop n has completed.
"""

from __future__ import annotations

import ctypes

import torch

from flatnav_tpu_torch import _build
from flatnav_tpu_torch.utils.profiling import count

_INT_SENTINEL = 2**31 - 1


def make_hop(beam_d, beam_i, beam_e, hist, dcomp, hops, *, e_f: int, m: int,
             compact_width: int = 0):
    """The hop's engine over one search's state: `BeamHop` where the beam is
    on a CUDA card, `ChainHop` elsewhere."""
    engine = BeamHop if beam_i.device.type == "cuda" else ChainHop
    return engine(beam_d, beam_i, beam_e, hist, dcomp, hops, e_f=e_f, m=m,
                  compact_width=compact_width)


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
            (lib.beam_select_launch, [p, p, p, i, i, i, i, p, p, p, p, p, z, p]),
            (lib.beam_membership_launch, [p, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, z, p]),
            (lib.beam_merge_launch, [p, p, p, p, p, p, i, i, i, p, p, p, p, p, z, p]),
            (lib.beam_host_mapped, [p, ctypes.POINTER(p)]),
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
    `score_ids`. The kernels launch on the stream that is current when the
    engine is built. `BeamHop.launches` counts the kernels' launches;
    counter `search.hops_fused` one a merge. Neither counts a launch that a
    CUDA graph captures: the engine's `captured` counts those, and a replay
    adds to `launches` what its graph captured."""

    launches = 0

    def __init__(self, beam_d, beam_i, beam_e, hist, dcomp, hops, *, e_f: int, m: int,
                 compact_width: int = 0):
        state = (beam_d, beam_i, beam_e, hist, dcomp, hops)
        for t, dtype in zip(state, (torch.float32, torch.int32, torch.bool, torch.int32,
                                    torch.int64, torch.int64)):
            if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
                raise ValueError(f"BeamHop: wants contiguous CUDA {dtype} tensors, got {t.dtype} "
                                 f"on {t.device}")
        self.beam_d, self.beam_i, self.beam_e, self.hist, self.dcomp, self.hops = state
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
        #: [the hop's number, advanced by select; the flag, set to that
        #: number by the merge where a beam holds an unexpanded entry]; number
        #: 0 stands for the beams the search starts from
        self.marks = torch.stack([torch.zeros((), dtype=torch.int32, device=dev),
                                  torch.where((~beam_e).any(), 0, -1).to(torch.int32)])
        self.hop_no, self.flag = self.marks[0], self.marks[1]
        self.captured = 0  # launches captured into CUDA graphs
        lib = _lib()
        w = hist.shape[1]
        with torch.cuda.device(dev):
            limit = ctypes.c_int()
            _build.check(lib.beam_hop_smem_limit(ctypes.byref(limit)), "BeamHop shared memory")
        row = scratch_row(ef, e_f, m, w, limit.value)
        self.workspace = torch.empty(b * row, dtype=torch.uint8, device=dev) if row else None
        ws = (self.workspace.data_ptr(), row) if row else (0, 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        d, i, e, h, dc, hp = (t.data_ptr() for t in state)
        cur, sv, fr = self.cur_ids.data_ptr(), self.sel_valid.data_ptr(), self.fresh.data_ptr()
        no, fl = self.hop_no.data_ptr(), self.flag.data_ptr()
        self._select = (lib.beam_select_launch,
                        (i, e, h, b, ef, e_f, w, cur, sv, hp, no, *ws, stream))
        self._member = (lib.beam_membership_launch, (d, i, h), (
            sv, b, ef, w, em, e_f, m, cc, fr, self.nbrs_out.data_ptr() if cc else 0,
            self.score_ids.data_ptr(), *ws, stream))
        self._merge = (lib.beam_merge_launch, (d, i, e), (fr, b, ef, cc or em, dc, fl),
                       (no, *ws, stream))
        self._mirror = None  # the pinned host int32 the merges also stamp, and its device pointer

    def restart(self) -> None:
        """Starts a new search over the same tensors, which the caller has
        filled with its start state (`index.search.entry_beam`), whose beams
        hold an unexpanded entry: hop number and flag 0."""
        self.marks.zero_()

    def select(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The first e_f unexpanded positions of each beam (ascending),
        marked expanded; their ids join the history (-1 for a selection
        past the row's unexpanded entries) and `hops` adds the valid ones.
        The history must hold at least e_f entries -1. -> (cur_ids
        [B, e_f] int32, 0 where not valid; sel_valid [B, e_f] bool),
        overwritten by the next hop."""
        fn, args = self._select
        _build.check(fn(*args), "BeamHop.select")
        self._launched()
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
        self._launched()
        return (self.nbrs_out if self.cc else nbrs), self.fresh

    def merge(self, scores: torch.Tensor, nbrs: torch.Tensor) -> None:
        """Merges the scored candidates (`scores`, read where `fresh`; `nbrs`
        and `fresh` as `membership` returned them) into the beams: the first
        ef of beam and new entries by distance, beam entries first on ties,
        new ones by position. `dcomp` adds the fresh count; `flag` is set to
        the hop's number (the selects so far) where a new beam holds an
        unexpanded entry."""
        if scores.dtype != torch.float32 or not scores.is_contiguous():
            scores = scores.to(torch.float32).contiguous()
        if scores.shape != self.fresh.shape or nbrs.shape != self.fresh.shape:
            raise ValueError(f"BeamHop.merge: scores {tuple(scores.shape)}, candidates "
                             f"{tuple(nbrs.shape)}, want {tuple(self.fresh.shape)}")
        fn, head, mid, tail = self._merge
        mirror = self._mirror[1] if self._mirror else 0
        rc = fn(*head, scores.data_ptr(), nbrs.data_ptr(), *mid, mirror, *tail)
        _build.check(rc, "BeamHop.merge")
        if self._launched():
            count("search.hops_fused", 1)

    def mirror(self, host: torch.Tensor) -> None:
        """Makes the merges that follow also write the flag into `host`, a
        pinned int32 on the host, which the host reads once an event after
        the merge has completed: a captured hop hands the host its flag with
        no copy."""
        if not (host.is_pinned() and host.dtype == torch.int32 and host.numel() == 1):
            raise ValueError("BeamHop.mirror: wants one pinned int32 on the host")
        ptr = ctypes.c_void_p()
        _build.check(_lib().beam_host_mapped(host.data_ptr(), ctypes.byref(ptr)),
                     "BeamHop.mirror")
        self._mirror = (host, ptr.value)

    def unexpanded_after(self, n: int) -> bool:
        """Whether hop n left a beam with an unexpanded entry (n = 0: the
        start beams), read once hop n's merge is queued: one scalar copy
        from the card, which waits for all that is queued."""
        return int(self.flag) >= n

    def _launched(self) -> bool:
        """Counts a launch in `launches`, or in `captured` where a CUDA
        graph is capturing it -> whether `launches` counted it."""
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
            return False
        BeamHop.launches += 1
        return True


def _first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """Mask of the first occurrence of each value per row ([B, C] -> bool):
    a stable sort makes duplicates adjacent, lowest position first."""
    order = torch.argsort(ids, dim=1, stable=True)
    sorted_ids = ids.gather(1, order)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    return torch.empty_like(first).scatter_(1, order, first)


def _sorted_member(sorted_tab: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row-wise membership of x [B, C] in sorted_tab [B, W] (ascending)."""
    w = sorted_tab.shape[1]
    pos = torch.searchsorted(sorted_tab, x.contiguous())
    hit = sorted_tab.gather(1, pos.clamp(max=w - 1))
    return (pos < w) & (hit == x)


class ChainHop:
    """The plain version of `BeamHop`: the same state, methods and results,
    as a chain of PyTorch ops on any device. Membership tests run as sorted
    lookups (`torch.searchsorted`) and the in-hop dedup is sort based; the
    merge is a stable sort with beam entries first on ties (the JAX
    package's compare forms and rank-and-gather merge give the same bits)."""

    def __init__(self, beam_d, beam_i, beam_e, hist, dcomp, hops, *, e_f: int, m: int,
                 compact_width: int = 0):
        self.beam_d, self.beam_i, self.beam_e, self.hist = beam_d, beam_i, beam_e, hist
        self.dcomp, self.hops = dcomp, hops
        self.e_f, self.m = e_f, m
        self.cc = compact_width if 0 < compact_width < e_f * m else 0
        self.pos = torch.arange(beam_i.shape[1], device=beam_i.device)
        self.new_slots = torch.arange(e_f, device=beam_i.device)
        self.sel_valid = self.fresh = self.score_ids = None
        #: `BeamHop`'s flag; the hop's number is counted on the host
        self.flag = torch.where((~beam_e).any(), 0, -1).to(torch.int32)
        self.hop_no = 0

    def select(self) -> tuple[torch.Tensor, torch.Tensor]:
        """`BeamHop.select`: the history's E slots of -1 that follow any
        lower ids take this hop's ids, and the row is sorted again."""
        ef, e_f, pos = self.pos.shape[0], self.e_f, self.pos
        unexp = ~self.beam_e
        if e_f == 1:
            sel = unexp.to(torch.int8).argmax(dim=1, keepdim=True)
            sel_valid = unexp.any(dim=1, keepdim=True)
        else:
            cand_pos = torch.where(unexp, pos, ef)
            sel = torch.topk(cand_pos, e_f, dim=1, largest=False).values
            sel_valid = sel < ef
        sel = sel.clamp(max=ef - 1)
        cur_ids = torch.where(sel_valid, self.beam_i.gather(1, sel), 0)
        self.beam_e |= ((pos[None, :, None] == sel[:, None, :]) & sel_valid[:, None, :]).any(2)
        first_free = (self.hist < -1).sum(dim=1, keepdim=True)
        self.hist.scatter_(1, first_free + self.new_slots, torch.where(sel_valid, cur_ids, -1))
        self.hist.copy_(self.hist.sort(dim=1).values)
        self.hops += sel_valid.sum()
        self.sel_valid = sel_valid
        self.hop_no += 1
        return cur_ids, sel_valid

    def membership(self, nbrs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """`BeamHop.membership`; the compact width's fresh-first order is a
        stable sort on "not fresh"."""
        valid_src = self.sel_valid.repeat_interleave(self.m, dim=1)
        beam_tab = torch.where(torch.isfinite(self.beam_d), self.beam_i, _INT_SENTINEL)
        in_beam = _sorted_member(beam_tab.sort(dim=1).values, nbrs)
        in_hist = _sorted_member(self.hist, nbrs)
        fresh = ~(in_beam | in_hist) & valid_src & _first_occurrence(nbrs)
        if self.cc:
            order = torch.argsort((~fresh).to(torch.int8), dim=1, stable=True)[:, : self.cc]
            nbrs = nbrs.gather(1, order)
            fresh = fresh.gather(1, order)
        self.fresh = fresh
        self.score_ids = torch.where(fresh, nbrs, -1)
        return nbrs, fresh

    def merge(self, scores: torch.Tensor, nbrs: torch.Tensor) -> None:
        """`BeamHop.merge`: the new entries (+inf where not fresh) sorted
        stably, ef of them kept and merged into the beams."""
        ef = self.pos.shape[0]
        nd = torch.where(self.fresh, scores, float("inf"))
        order = torch.argsort(nd, dim=1, stable=True)[:, :ef]
        new = (nd.gather(1, order), nbrs.gather(1, order), (~self.fresh).gather(1, order))
        beam = (self.beam_d, self.beam_i, self.beam_e)
        all_d, all_i, all_e = (torch.cat(p, dim=1) for p in zip(beam, new))
        order = torch.argsort(all_d, dim=1, stable=True)[:, :ef]
        for t, a in zip(beam, (all_d, all_i, all_e)):
            t.copy_(a.gather(1, order))
        self.dcomp += self.fresh.sum()
        self.flag.masked_fill_((~self.beam_e).any(), self.hop_no)

    def unexpanded_after(self, n: int) -> bool:
        """`BeamHop.unexpanded_after`."""
        return int(self.flag) >= n


__all__ = ["BeamHop", "ChainHop", "make_hop", "scratch_row", "stage_bytes"]
