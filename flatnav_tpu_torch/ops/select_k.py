"""Exact row-wise k smallest (key, id) pairs (kernel K3).

The port's counterpart of the TPU's hardware top-k, `jax.lax.approx_min_k`,
which the JAX package calls for every scan's shortlist
(flatnav_tpu/ops/fused_scan.py:385, flatnav_tpu/ops/distances.py:368,
flatnav_tpu/quantization/pq.py:496). Unlike it, the selection here is exact
and its order total: the k smallest (key, id) pairs of each row, ascending,
ties to the lowest id. A pair ranks as one int64 word, (order-preserving
bits of key + 0.0) << 32 | id, so -0.0 and +0.0 tie, a positive NaN ranks
after +inf and a negative one before -inf, and the key that comes back is
key + 0.0. Ids are non-negative int32.

On a CUDA tensor `select_k` launches the hand-written kernel
`csrc/select_k.cu` (a threshold filter over keys brought into shared memory
by bulk copies, in front of a radix select, or a warp a row with its list in
registers for short rows; see the source); on a CPU tensor it runs
`select_k_plain`, which ranks the int64 words with `torch.topk`. The two are
bit-equal on every input. The ids of a row are a [B, W] int32 tensor, one
[1, W] row shared by every row, or implicit (`id_base` + column), so a scan
never builds an id matrix; `cols` keeps a window of columns and ranks every
other key as +inf, so a scan never writes a masked copy of its keys; and
`prior=(keys [B, k], ids [B, k])` adds a shortlist to every row, so a scan
merges a tile into its running k in the same launch that selects it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from flatnav_tpu_torch import _build

#: the largest k K3 takes (csrc/select_k.cu: KMAX)
K_MAX = 2048
#: a row is cut into slices of at least this many columns (and 4 k) when the
#: batch alone does not fill the card ...
MIN_SLICE = 4096
#: ... with about this many blocks (132 SMs, 8 blocks of 256 threads each)
TARGET_BLOCKS = 1056
#: the warp route (a warp a row, its list in registers) takes k up to this
#: (csrc/select_k.cu: a warp's list holds 32 or 64 words, and the C entry
#: refuses a warp launch past them) ...
WARP_K = 64
#: ... and slices up to this many columns; the block route takes the rest
WARP_MAX_W = 8192
ROUTES = {"block": 0, "warp": 1}
#: the C entry's parameters, in its order (csrc/select_k.cu: select_k_launch)
PARAMS = ("keys", "ids", "id_rows", "id_base", "pairs", "prior_d", "prior_i", "B", "W", "k",
          "col_lo", "col_hi", "slice", "route", "out_d", "out_i", "out_pairs", "stream")
_ID_LIMIT = 1 << 31


def _rank_key(dists: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 key ordered by (dist, id): the float's bits made monotone as a
    signed int32 (negative floats have their low 31 bits flipped), shifted
    above a non-negative 32-bit id. Adding +0.0 turns -0.0 into +0.0, so
    the two zeros tie and go to the lower id."""
    bits = (dists + 0.0).contiguous().view(torch.int32).to(torch.int64)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits << 32) | ids.to(torch.int64)


def _unrank_key(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    bits = key >> 32
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    dists = bits.to(torch.int32).view(torch.float32)
    return dists, (key & 0xFFFFFFFF).to(torch.int32)


def _window(w: int, cols) -> Tuple[int, int]:
    lo, hi = (0, w) if cols is None else cols
    return max(0, min(int(lo), w)), max(0, min(int(hi), w))


def _id_rows(ids: torch.Tensor | None) -> torch.Tensor | None:
    """ids as a 2-D [B, W] or [1, W] tensor: a 1-D [W], or a row expanded
    to [B, W] (stride 0 between rows), is one row."""
    if ids is None:
        return None
    if ids.dim() == 1:
        return ids[None, :]
    return ids[:1] if ids.dim() == 2 and ids.shape[0] > 1 and ids.stride(0) == 0 else ids


def _check(keys, k, ids, id_base, prior=None):
    if keys.dtype != torch.float32 or keys.dim() != 2:
        raise TypeError(f"select_k: keys must be a 2-D float32 tensor, got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    b, w = keys.shape
    if prior is not None:
        _check_prior(prior, keys, k)
        if w == 0 and k > 0:
            raise ValueError("select_k: a prior needs keys of at least one column")
    elif not 0 <= k <= min(w, K_MAX):
        raise ValueError(f"select_k: k={k} must lie in [0, min(W={w}, K_MAX={K_MAX})]")
    if ids is None:
        if not (0 <= id_base and id_base + w <= _ID_LIMIT):
            raise ValueError(f"select_k: implicit ids {id_base} + [0, {w}) leave [0, 2^31)")
        return
    if ids.dtype != torch.int32:
        raise TypeError(f"select_k: ids must be int32, got {ids.dtype}")
    if ids.dim() != 2 or ids.shape[1] != w or ids.shape[0] not in (1, b):
        raise ValueError(f"select_k: ids {tuple(ids.shape)} are not [{b}, {w}] or [1, {w}]")
    if ids.device != keys.device:
        raise ValueError("select_k: keys and ids are on different devices")


def _check_prior(prior, keys, k):
    """prior: (keys [B, k] float32, ids [B, k] int32) on the keys' device;
    k <= K_MAX (and may pass W: the prior alone holds k pairs)."""
    if not (isinstance(prior, (tuple, list)) and len(prior) == 2):
        raise TypeError("select_k: prior must be a pair (keys [B, k], ids [B, k])")
    pd, pi = prior
    b = keys.shape[0]
    if pd.dtype != torch.float32 or pi.dtype != torch.int32:
        raise TypeError(f"select_k: prior must be (float32, int32), got ({pd.dtype}, {pi.dtype})")
    if tuple(pd.shape) != (b, k) or tuple(pi.shape) != (b, k):
        raise ValueError(f"select_k: prior {tuple(pd.shape)}, {tuple(pi.shape)} are not "
                         f"[{b}, {k}]")
    if not 0 <= k <= K_MAX:
        raise ValueError(f"select_k: k={k} must lie in [0, K_MAX={K_MAX}]")
    if pd.device != keys.device or pi.device != keys.device:
        raise ValueError("select_k: keys and prior are on different devices")


def select_k_plain(
    keys: torch.Tensor,
    k: int,
    ids: torch.Tensor | None = None,
    id_base: int = 0,
    cols: Tuple[int, int] | None = None,
    prior: Tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: rank the int64 words with `torch.topk` (with a prior,
    over the prior's words and the row's, concatenated).
    -> (keys [B, k] float32, ids [B, k] int32)."""
    b, w = keys.shape
    lo, hi = _window(w, cols)
    if (lo, hi) != (0, w):
        col = torch.arange(w, device=keys.device)
        keys = torch.where((col >= lo) & (col < hi), keys, float("inf"))
    ids = _id_rows(ids)
    if ids is None:
        ids = torch.arange(id_base, id_base + w, dtype=torch.int32, device=keys.device)[None, :]
    key = _rank_key(keys, ids.expand_as(keys))
    if prior is not None:
        key = torch.cat([_rank_key(*prior), key], 1)
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return _unrank_key(top)


def _plan(b: int, w: int, k: int) -> list[Tuple[int, int]]:
    """K3's rounds for a [b, w] -> k selection: [(width, slice)], the first
    over the keys, each later one over the [b, slices * k] words of the one
    before; the last has one slice a row. A block streams a slice of any
    length; rows are cut (into slices of at least max(MIN_SLICE, 4k)) only
    while the batch alone gives fewer than TARGET_BLOCKS blocks."""
    rounds = []
    while True:
        n = max(min(-(-w // max(MIN_SLICE, 4 * k)), -(-TARGET_BLOCKS // max(b, 1))), 1)
        sl = -(-w // n)
        rounds.append((w, sl))
        if n == 1:
            return rounds
        w = -(-w // sl) * k


def _route(k: int, sl: int) -> str:
    """K3's route for slices of `sl` columns -> k: "warp" (a warp a row, its
    list of 32 or 64 words in registers) for k <= WARP_K and sl <=
    WARP_MAX_W, else "block" (a block a slice, bulk copies into a ring,
    radix select)."""
    return "warp" if k <= WARP_K and sl <= WARP_MAX_W else "block"


def _lib():
    fn = _build.load("select_k").select_k_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, p, p, p, i, i, i, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def select_k(
    keys: torch.Tensor,
    k: int,
    ids: torch.Tensor | None = None,
    id_base: int = 0,
    cols: Tuple[int, int] | None = None,
    prior: Tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise k smallest (key + 0.0, id) pairs of `keys` [B, W] float32,
    ascending, ties to the lowest id -> (keys [B, k] float32, ids [B, k]
    int32).

    ids: a [B, W] int32 tensor, one [1, W] row for every row, or None for
    `id_base` + column (all below 2^31). cols=(lo, hi): keys of the columns
    outside [lo, hi) rank as +inf. prior=(keys [B, k] float32, ids [B, k]
    int32): pairs each row's selection includes, as if concatenated before
    its columns (a scan's running k); then k may pass W. k <= min(W, K_MAX)
    otherwise. Raises on anything else, on either device.
    `select_k.launches` counts kernel launches, `select_k.routes` them by
    route."""
    ids = _id_rows(ids)
    _check(keys, k, ids, id_base, prior)
    if keys.device.type == "cpu":
        return select_k_plain(keys, k, ids, id_base, cols, prior)
    if keys.device.type != "cuda":
        raise ValueError(f"select_k: no kernel for device {keys.device}")
    if (not keys.is_contiguous() or (ids is not None and not ids.is_contiguous())
            or (prior is not None and not all(x.is_contiguous() for x in prior))):
        raise ValueError("select_k: keys, ids and prior must be contiguous")
    def launch(route, args):
        _build.check(_lib()(*(args[p] for p in PARAMS)), "select_k")
        select_k.launches += 1
        select_k.routes[route] += 1

    stream = torch.cuda.current_stream(keys.device).cuda_stream
    return run_rounds(launch, stream, keys, k, ids, id_base, cols, prior)


def run_rounds(launch, stream, keys, k, ids=None, id_base=0, cols=None, prior=None):
    """K3's rounds (`_plan`) over contiguous tensors that `_check`
    accepted: each round is one `launch(route, args)`, with `route` as
    `_route` picks it and `args` the C entry's arguments by name (`PARAMS`)
    on `stream`; each round past the first merges the k words a slice of
    the one before. -> (keys [B, k], ids [B, k])."""
    ids = _id_rows(ids)
    b, w = keys.shape
    dev = keys.device
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or k == 0:
        return out_d, out_i
    lo, hi = _window(w, cols)
    pairs = None
    for width, sl in _plan(b, w, k):
        nsl = -(-width // sl)
        last = nsl == 1
        out_p = None if last else torch.empty((b, nsl * k), dtype=torch.int64, device=dev)
        first, route = pairs is None, _route(k, sl)
        seeded = prior is not None and first
        launch(route, {
            "keys": keys.data_ptr() if first else None,
            "ids": ids.data_ptr() if (ids is not None and first) else None,
            "id_rows": int(ids is not None and ids.shape[0] == b and b > 1),
            "id_base": int(id_base), "pairs": None if first else pairs.data_ptr(),
            "prior_d": prior[0].data_ptr() if seeded else None,
            "prior_i": prior[1].data_ptr() if seeded else None,
            "B": b, "W": width, "k": k, "col_lo": lo, "col_hi": hi, "slice": sl,
            "route": ROUTES[route], "out_d": out_d.data_ptr() if last else None,
            "out_i": out_i.data_ptr() if last else None,
            "out_pairs": None if last else out_p.data_ptr(), "stream": stream,
        })
        pairs, lo, hi = out_p, 0, (0 if last else out_p.shape[1])
    return out_d, out_i


select_k.launches = 0
#: launches by route
select_k.routes = dict.fromkeys(ROUTES, 0)

__all__ = ["K_MAX", "WARP_K", "WARP_MAX_W", "select_k", "select_k_plain"]
