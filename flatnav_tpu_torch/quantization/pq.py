"""Product Quantization: codebooks, codes, ADC/SDC distances, graph search.

Counterpart of flatnav_tpu/quantization/pq.py, after the reference's
experimental PQ layer (developmental-features/quantization/
ProductQuantization.h): the dim is split into `num_subquantizers`
subspaces, each with a 2^nbits codebook trained by k-means (train at
210-276). A PQ'd index stores codes instead of raw vectors
(`transformDataImpl` encodes on insert, 349-356); search uses the
asymmetric distance (per-query table over centroids, 367-385) and pruning
uses the symmetric code-to-code distance via precomputed tables (395-411,
built at 475-494).

In PyTorch: training is k-means per subspace on the device; encode, the ADC
tables and the SDC tables are one batched matmul over the subspaces each;
ADC search plugs into the shared `beam_search_core` through a table-lookup
`score_block`, so the hop gathers [B, C, M_pq] uint8 code rows instead of
float vectors (4*d/num_subquantizers times fewer bytes a hop).

Differences from the JAX package, all stated where they occur: the scan's
shortlist is exact (`smallest_k`) where JAX takes `approx_min_k`; its bf16
keys are accumulated in float32 by the route `_scan_keys` documents; the
contract checks that are bare `assert`s there raise ValueError here; a
lane-packed table needs no unpacking here (it is a view).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from flatnav_tpu_torch.data_type import host_tensor, resolve_device
from flatnav_tpu_torch.index.search import BeamResults, SearchResults, beam_search_core
from flatnav_tpu_torch.ops.distances import (
    MetricType,
    _is_int,
    query_block_distances,
    smallest_k,
)
from flatnav_tpu_torch.ops.gather_distance import gather_distances
from flatnav_tpu_torch.quantization.kmeans import _lloyd, kmeans

#: rows encoded per batched product: bounds the [M_pq, rows, nc] float32
#: distance block (1 GiB at M_pq=16, nc=256)
_ENCODE_ROWS = 65536
#: elements of the [b, M_pq, n] lookup block `asymmetric_distances` forms
#: per query chunk (1 GiB of float32)
_ADC_BLOCK_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class PQCodebook:
    """centroids: [M_pq, ncentroids, d_sub] float32."""

    centroids: torch.Tensor

    @property
    def num_subquantizers(self) -> int:
        return self.centroids.shape[0]

    @property
    def num_centroids(self) -> int:
        return self.centroids.shape[1]

    @property
    def subdim(self) -> int:
        return self.centroids.shape[2]


def _split(data: torch.Tensor, m_pq: int) -> torch.Tensor:
    n, d = data.shape
    return data.reshape(n, m_pq, d // m_pq).transpose(0, 1)  # [M_pq, n, dsub]


def _sub_l2(pts: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """[M_pq, n, dsub] x [M_pq, nc, dsub] -> [M_pq, n, nc] squared L2 in the
    matmul form, unclamped (it only ranks, or fills a lookup table)."""
    return (
        (pts * pts).sum(2, keepdim=True)
        - 2.0 * torch.bmm(pts, cents.transpose(1, 2))
        + (cents * cents).sum(2)[:, None, :]
    )


def _encode(centroids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """codes [n, M_pq] uint8 (computePQCode, ProductQuantization.h:159-202)."""
    m_pq = centroids.shape[0]
    data = data.to(centroids.device, torch.float32)
    codes = [
        torch.argmin(_sub_l2(_split(data[lo : lo + _ENCODE_ROWS], m_pq), centroids), dim=2)
        for lo in range(0, data.shape[0], _ENCODE_ROWS)
    ]
    if not codes:
        return torch.zeros((0, m_pq), dtype=torch.uint8, device=centroids.device)
    return torch.cat(codes, dim=1).T.contiguous().to(torch.uint8)


def _decode(centroids: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[n, d] float32 reconstruction (decode, ProductQuantization.h:286-306)."""
    m_pq = centroids.shape[0]
    sub = torch.arange(m_pq, device=centroids.device)[None, :]
    return centroids[sub, codes.long()].reshape(codes.shape[0], -1)


def _adc_tables_impl(
    centroids: torch.Tensor, queries: torch.Tensor, metric: MetricType
) -> torch.Tensor:
    """Per-query distance tables [B, M_pq, ncentroids]
    (computeDistanceTable, ProductQuantization.h:367-385).

    For IP, table entries are -<q_sub, c> so that sum_m table = -<q, x>;
    the caller adds the constant 1 to match `1 - <q, x>`.
    """
    qs = _split(queries.to(centroids.device, torch.float32), centroids.shape[0])
    if metric == MetricType.IP:
        t = -torch.bmm(qs, centroids.transpose(1, 2))
    else:
        t = _sub_l2(qs, centroids)
    return t.transpose(0, 1).contiguous()  # [B, M_pq, nc]


def _sdc_tables(centroids: torch.Tensor) -> torch.Tensor:
    """Symmetric tables [M_pq, nc, nc] (ProductQuantization.h:475-494)."""
    c = centroids.to(torch.float32)
    return _sub_l2(c, c)


class ProductQuantizer:
    """FAISS-style product quantizer (ProductQuantization.h:91-571).

    Train types DEFAULT / HOT_START / SHARED / HYPERCUBE
    (ProductQuantization.h:534-543) map to the `train_type` argument. The
    codebook lives on `device`: the card unless the caller asks for "cpu".
    """

    def __init__(
        self,
        dim: int,
        num_subquantizers: int = 8,
        nbits: int = 8,
        metric: MetricType = MetricType.L2,
        device=None,
    ):
        if dim % num_subquantizers:
            raise ValueError(
                f"dim {dim} not divisible by {num_subquantizers} subquantizers"
            )
        if nbits not in (4, 8):
            raise ValueError(
                "nbits must be 8 (256 centroids, the reference's layout) or "
                "4 (16 centroids, the fast-scan point: the one-hot ADC "
                "contraction's operations scale with 2^nbits, so nc=16 cuts "
                "the matmul work 16x per scanned code)"
            )
        if nbits == 4 and num_subquantizers % 2:
            raise ValueError("nbits=4 requires an even num_subquantizers "
                             "(two codes pack per byte)")
        self.device = resolve_device(device)
        self.dim = dim
        self.num_subquantizers = num_subquantizers
        self.nbits = nbits
        self.num_centroids = 1 << nbits
        self.metric = metric
        self.codebook: Optional[PQCodebook] = None

    @property
    def is_trained(self) -> bool:
        return self.codebook is not None

    def code_size_bytes(self) -> int:
        return self.num_subquantizers * self.nbits // 8

    def train(
        self,
        data: np.ndarray,
        n_iters: int = 62,
        train_type: str = "default",
        seed: int = 0,
    ) -> "ProductQuantizer":
        """Per-subspace k-means (train, ProductQuantization.h:210-276).

        train_type (ProductQuantization.h:534-543):
          default   - fresh k-means per subspace
          hot_start - continue Lloyd iterations from the existing codebook
          shared    - one codebook shared across subspaces
          hypercube - hypercube initialization
        """
        data = np.asarray(data, dtype=np.float32)
        init = "hypercube" if train_type == "hypercube" else "default"
        subs = data.reshape(data.shape[0], self.num_subquantizers, -1)
        if train_type == "hot_start":
            if not self.is_trained:
                raise RuntimeError("hot_start requires an existing codebook")
            all_c = []
            for m in range(self.num_subquantizers):
                cents, _ = _lloyd(
                    torch.from_numpy(np.ascontiguousarray(subs[:, m])).to(self.device),
                    self.codebook.centroids[m],
                    n_iters,
                )
                all_c.append(cents)
            self.codebook = PQCodebook(torch.stack(all_c))
            return self
        if train_type == "shared":
            # one codebook shared across subspaces
            flat = subs.reshape(-1, subs.shape[2])
            cents, _ = kmeans(flat, self.num_centroids, n_iters, init, seed, self.device)
            centroids = cents[None].expand(self.num_subquantizers, -1, -1).contiguous()
        else:
            all_c = []
            for m in range(self.num_subquantizers):
                cents, _ = kmeans(
                    subs[:, m], self.num_centroids, n_iters, init, seed + m, self.device
                )
                all_c.append(cents)
            centroids = torch.stack(all_c)
        self.codebook = PQCodebook(centroids)
        return self

    def _require_trained(self):
        if not self.is_trained:
            raise RuntimeError("ProductQuantizer must be trained first")

    def _tensor(self, x) -> torch.Tensor:
        return host_tensor(x).to(self.device)

    def encode(self, data) -> torch.Tensor:
        self._require_trained()
        return _encode(self.codebook.centroids, self._tensor(data))

    def decode(self, codes) -> torch.Tensor:
        self._require_trained()
        return _decode(self.codebook.centroids, self._tensor(codes))

    def adc_tables(self, queries) -> torch.Tensor:
        """Per-query asymmetric distance tables [B, M_pq, ncentroids]."""
        self._require_trained()
        return _adc_tables_impl(
            self.codebook.centroids, self._tensor(queries), self.metric
        )

    def sdc_tables(self) -> torch.Tensor:
        self._require_trained()
        return _sdc_tables(self.codebook.centroids)

    def asymmetric_distances(self, queries, codes) -> torch.Tensor:
        """[B, n] distances query -> code (getAsymmetricDistance path). The
        codes are shared by all queries, so each chunk of queries looks its
        tables up at one [M_pq, n] index block."""
        tables = self.adc_tables(queries)  # [B, M_pq, nc]
        codes = self._tensor(codes)
        b, s, _ = tables.shape
        chunk = max(_ADC_BLOCK_ELEMS // max(s * codes.shape[0], 1), 1)
        d = torch.cat(
            [tables.new_zeros((0, codes.shape[0]))]
            + [score_shared_codes(tables[lo : lo + chunk], codes) for lo in range(0, b, chunk)]
        )
        if self.metric == MetricType.IP:
            d = 1.0 + d
        return d


def pack_codes_lanes(codes: np.ndarray, tile: int = 32768):
    """Host-side lane packing for huge code tables: [N, g] uint8 ->
    ([N_pad*g//128, 128] uint8, N_pad).

    The JAX package stores huge code tables as the row-major byte stream in
    rows of 128 bytes, because a TPU array pads a narrow minor dimension to
    128 lanes. A CUDA tensor has no such padding, so here the layout is only
    an input format kept for files and callers shared with that package:
    `pq_scan_knn(..., lane_packed=True)` reads it as the [N_pad, g] view it
    is. Rows are padded host-side (numpy) to a whole number of scan tiles;
    pass the true row count as n_valid.

    Requires 128 % g == 0 (g = bytes/row: num_subquantizers for 8-bit
    codes, num_subquantizers//2 for nibble-packed 4-bit codes).
    """
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n, g = codes.shape
    if 128 % g:
        raise ValueError(f"lane packing requires 128 %% bytes/row == 0 "
                         f"(got {g})")
    if (tile * g) % 128:
        raise ValueError(f"tile {tile} x {g} B/row must fill whole lanes")
    n_pad = -(-n // tile) * tile
    flat = np.zeros((n_pad * g // 128, 128), np.uint8)
    flat.reshape(-1)[: n * g] = codes.reshape(-1)
    return flat, n_pad


def pack_codes_4bit(codes) -> torch.Tensor:
    """[N, S] 4-bit values -> [N, S//2] uint8 (even subspace in the low
    nibble). Halves the scanned bytes for nbits=4 quantizers."""
    codes = torch.as_tensor(codes)
    n, s = codes.shape
    if s % 2:
        raise ValueError(f"pack_codes_4bit needs an even number of subspaces, got {s}")
    c = codes.to(torch.uint8).reshape(n, s // 2, 2)
    return c[..., 0] | (c[..., 1] << 4)


def unpack_codes_4bit(packed: torch.Tensor) -> torch.Tensor:
    """[N, S//2] uint8 -> [N, S] values in [0, 16) (pack_codes_4bit inverse)."""
    lo = packed & 0x0F
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)


def score_codes(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC scoring: tables [B, M_pq, nc], codes [B, C, M_pq] -> [B, C].

    sum over subquantizers of table[b, m, codes[b, c, m]]. `torch.gather`
    wants int64 indices, so the [B, M_pq, C] index block is 8 bytes an
    entry; callers keep C small (a hop's E*M links, a scan's shortlist).
    """
    idx = codes.transpose(1, 2).long()  # [B, M_pq, C]
    return tables.gather(2, idx).sum(dim=1)


def score_shared_codes(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """`score_codes` where every query scores the same codes [C, M_pq]:
    one [M_pq, C] index block serves the whole batch."""
    s = tables.shape[1]
    sub = torch.arange(s, device=tables.device)[:, None]
    return tables[:, sub, codes.T.long()].sum(dim=1)  # [B, M_pq, C] -> [B, C]


def pq_beam_search(
    codes: torch.Tensor,  # [cap(+pad), M_pq] uint8
    links: torch.Tensor,
    num_nodes: int,
    tables: torch.Tensor,  # [B, M_pq, nc] ADC tables for this query batch
    *,
    ef: int,
    metric: MetricType = MetricType.L2,
    num_initializations: int = 100,
    max_hops: int = 0,
    expand_factor: int = 1,
) -> BeamResults:
    """Beam search over PQ codes with ADC scoring: the PQ analog of
    beam_search (Index<ProductQuantizer> in the reference plugs PQ in as a
    DistanceInterface; here it plugs in as a score_block). The entry
    candidates, which every query shares, are scored by the same table
    lookup."""
    offset = 1.0 if metric == MetricType.IP else 0.0

    def score_block(ids: torch.Tensor) -> torch.Tensor:
        return score_codes(tables, codes[ids.long()]) + offset  # [B, C, M_pq] gather

    def entry_block(cand: torch.Tensor) -> torch.Tensor:
        return score_shared_codes(tables, codes[cand.long()]) + offset

    return beam_search_core(
        links,
        num_nodes,
        tables.shape[0],
        score_block,
        entry_block,
        ef=ef,
        num_initializations=num_initializations,
        max_hops=max_hops,
        expand_factor=expand_factor,
    )


def _scan_keys_f32(t_bf: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """[B, S*nc] bf16 tables x [tile, S*nc] bf16 one-hot -> [B, tile] f32
    keys by a float32 matmul of the bf16-rounded operands: the one-hot is
    exact and TF32 is off (ops/distances.py), so each key is the float32 sum
    of its S rounded table entries."""
    return t_bf.to(torch.float32) @ onehot.to(torch.float32).T


def _scan_keys_bf16(t_bf: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """The same keys by one bf16 tensor-core product with a float32 result
    (`out_dtype`; CUDA only). A plain bf16 `torch.matmul` would return bf16
    and round every key a second time."""
    return torch.mm(t_bf, onehot.T, out_dtype=torch.float32)


def _scan_keys(t_bf: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """The scan's keys: the float32 sum of the bf16-rounded table entries a
    code row selects. On the card the bf16 product with float32 output; on
    the CPU, where torch has no such product, the float32 matmul of the same
    rounded operands. Both give the same sums up to their order."""
    if t_bf.is_cuda:
        return _scan_keys_bf16(t_bf, onehot)
    return _scan_keys_f32(t_bf, onehot)


def pq_scan_knn(
    codes: torch.Tensor,  # [N, S] uint8 (or [N, S//2] when packed_4bit; or
    #                       lane-packed [N_pad*g//128, 128], see pack_codes_lanes)
    tables: torch.Tensor,  # [B, S, nc] f32 ADC tables (pq.adc_tables)
    k: int,
    metric: MetricType = MetricType.L2,
    tile_size: int = 32768,
    rerank: int = 32,
    n_valid: int | None = None,
    vectors: torch.Tensor | None = None,
    queries: torch.Tensor | None = None,
    packed_4bit: bool = False,
    lane_packed: bool = False,
):
    """ADC full-table scan as a matmul: the engine for tables whose raw
    vectors do not fit the device.

    The per-node ADC score sum_s T[b, s, code[n, s]] is a gather in its
    natural form. Re-expressed as a ONE-HOT CONTRACTION it is a matmul for
    the tensor cores: for a tile of nodes, onehot(codes) [tile, S*nc]
    (query-independent, built once per tile) contracts with the flattened
    tables [B, S*nc] in one bf16 product with float32 accumulation
    (`_scan_keys`), the same structure as fast_knn's phase 1 with S*nc as
    the feature dimension. An exact `rerank`-wide shortlist (ties to the
    lowest id) is carried across the tiles and reranked at the end.

    The scan's operation count is 2*N*S*nc per query, so 2^nbits is the
    lever: a 4-bit quantizer (nc=16) cuts the work 16x per code, and with
    `packed_4bit=True` the codes array holds two codes per byte
    ([N, S//2]), halving the bytes read as well; the raw-vector rerank
    below recovers the recall the coarser codes give up.

    The one-hot operand is built per tile, [tile, S*nc] bf16, never for the
    whole table; `tile_size` is clamped to max(min(tile_size, N), 128).

    Rerank modes:
    - `vectors` + `queries` given: RAW-VECTOR rerank. The [B, r] shortlist's
      raw rows are gathered and ranked by exact distance (float tables
      through `gather_distances`, kernel K2 on the card). Recall is then
      shortlist-bounded, not PQ-bounded; only the r-row rerank touches raw
      data. The right mode whenever the raw table fits the device.
    - otherwise: exact-f32 ADC rerank (`score_codes` on the float32
      tables); recall bounded by PQ quantization error; the only mode once
      raw vectors exceed device memory.

    vs the reference: ProductQuantization.h scores one code at a time
    through the per-query distance table (getAsymmetricDistance,
    ProductQuantization.h:367-385); this is that operation batched over
    [B x N]. ADC-mode distances are exact-f32 ADC values (+1 offset for IP,
    matching asymmetric_distances); raw-mode distances are exact.

    `lane_packed=True` takes codes from `pack_codes_lanes` (and the true row
    count as n_valid). The table is never copied in any mode (the last tile
    clamps and masks instead of padding; only a table under 128 rows pads).
    """
    b, s, nc = tables.shape
    g = (s // 2) if packed_4bit else s  # code bytes per row
    if packed_4bit and nc > 16:
        raise ValueError(
            f"packed_4bit requires a 4-bit quantizer (got {nc} centroids)"
        )
    if lane_packed:
        if codes.shape[1] != 128:
            raise ValueError(
                f"lane_packed codes must have 128 bytes a row, got {tuple(codes.shape)}"
            )
        if 128 % g:
            raise ValueError(f"lane packing requires 128 % bytes/row == 0 (got {g})")
        if n_valid is None:
            raise ValueError(
                "lane_packed scans the host-padded row count; pass the true "
                "count as n_valid"
            )
        codes = codes.reshape(-1, g)  # a view: the packing is the byte stream
    elif codes.shape[1] != g:
        raise ValueError(
            f"codes have {codes.shape[1]} bytes a row; tables of {s} subspaces "
            f"{'(packed_4bit) ' if packed_4bit else ''}need {g}"
        )
    n = codes.shape[0]
    dev = codes.device
    r = max(rerank, k)
    n_limit = min(n if n_valid is None else int(n_valid), n)
    if not lane_packed and n < 128:
        # tables below one minimum tile still pad (a <16 KB copy); every
        # larger table is consumed in place via the clamped last tile
        codes = torch.cat([codes, codes.new_zeros((128 - n, g))])
        n = 128
    tile = max(min(tile_size, n), 128)
    if lane_packed and ((tile * g) % 128 or n % tile):
        raise ValueError(
            f"lane_packed needs whole tiles of whole 128-byte rows: tile {tile}, "
            f"{g} bytes a row, {n} padded rows"
        )
    offset = 1.0 if metric == MetricType.IP else 0.0
    t_bf = tables.reshape(b, s * nc).to(torch.bfloat16)
    sub_base = torch.arange(s, device=dev) * nc
    onehot = torch.empty((tile, s * nc), dtype=torch.bfloat16, device=dev)
    iota = torch.arange(tile, dtype=torch.int32, device=dev)
    best_key = torch.full((b, r), float("inf"), device=dev)
    best_i = torch.zeros((b, r), dtype=torch.int32, device=dev)
    for start0 in range(0, n, tile):
        # the last tile CLAMPS into range instead of padding the table;
        # re-scanned overlap rows are masked below (ids < start0)
        start = min(start0, n - tile)
        rows = codes[start : start + tile]
        if packed_4bit:
            rows = unpack_codes_4bit(rows)
        onehot.zero_().scatter_(1, rows.long() + sub_base, 1.0)
        key = _scan_keys(t_bf, onehot)
        ids = start + iota
        key = torch.where((ids >= start0) & (ids < n_limit), key, float("inf"))
        # exact where the JAX package takes approx_min_k per tile
        best_key, best_i = smallest_k(
            torch.cat([best_key, key], 1),
            torch.cat([best_i, ids.expand(b, tile)], 1),
            r,
        )
    if vectors is not None and queries is not None:
        # raw-vector rerank: r gathered rows/query vs n scanned codes
        if _is_int(vectors):
            exact = query_block_distances(queries, vectors[best_i.long()], metric)
        else:
            exact = gather_distances(vectors, best_i, queries, metric)
    else:
        # exact-f32 ADC rerank of the [B, r] shortlist
        cand_codes = codes[best_i.long()]  # [B, r, g]
        if packed_4bit:
            cand_codes = unpack_codes_4bit(cand_codes.reshape(b * r, g)).reshape(b, r, s)
        exact = score_codes(tables, cand_codes) + offset
    # shortlist slots never filled by a valid row carry an inf scan key
    # (rows past n_valid, or r > valid candidates): the rerank must not
    # resurrect them with a finite re-score
    exact = torch.where(torch.isinf(best_key), float("inf"), exact)
    order = torch.argsort(exact, dim=1, stable=True)[:, :k]
    return exact.gather(1, order), best_i.gather(1, order)


def pq_search(
    pq: ProductQuantizer,
    codes: torch.Tensor,
    links: torch.Tensor,
    labels: torch.Tensor,
    num_nodes: int,
    queries,
    *,
    k: int,
    ef: int,
    num_initializations: int = 100,
) -> SearchResults:
    """Top-K ADC search over a PQ-coded graph index."""
    tables = pq.adc_tables(queries)
    beam = pq_beam_search(
        codes,
        links,
        num_nodes,
        tables,
        ef=max(ef, k),
        metric=pq.metric,
        num_initializations=num_initializations,
    )
    top_d = beam.dists[:, :k]
    top_i = beam.ids[:, :k]
    top_labels = torch.where(torch.isfinite(top_d), labels[top_i.long()], -1)
    return SearchResults(top_d, top_labels, int(beam.dist_computations), int(beam.hops))
