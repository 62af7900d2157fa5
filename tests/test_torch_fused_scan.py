"""Kernel K1 and `fused_knn` (flatnav_tpu_torch/ops/fused_scan.py) against
the JAX package's fused scan, run in Pallas interpret mode on the CPU with
the same explicit bucket_l / tile_size / query_block / rerank.

uint8 tables have exact integer keys in both, so ids and distances must be
identical. Float tables go through bf16 keys whose f32 sums are taken in
another order, and phase B is an exact top-k where JAX uses approx_min_k, so
ids agree on >= 99% of (query, rank) slots, distances of shared ids within
rtol 1e-6, and the port's recall is at least JAX's minus 0.005.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flatnav_tpu.ops import MetricType as JMetric
from flatnav_tpu.ops import fused_knn as jax_fused
from flatnav_tpu_torch.bench.synth import clustered
from flatnav_tpu_torch.ops import MetricType, brute_force_knn, fused_knn
from flatnav_tpu_torch.ops.distances import squared_norms
from flatnav_tpu_torch.ops.fused_scan import (
    _L, _QB, _ROWS_BYTES, _SUMMARY_BYTES, _TILE, _pick_shapes, _round_up, exact_keys,
    scan_buckets, scan_buckets_plain, scan_operands, scan_variant,
)

SHAPES = dict(bucket_l=4, tile_size=2048, query_block=8, rerank=32)


def _recall(found, want):
    found, want = np.asarray(found), np.asarray(want)
    k = want.shape[1]
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(found, want)]))


def _near_duplicates(rng):
    # near-duplicate rows CONTIGUOUS in id space (tests/test_fused_scan.py)
    base = rng.standard_normal((64, 32)).astype(np.float32) * 8
    data = np.repeat(base, 64, axis=0) + 0.1 * rng.standard_normal((4096, 32)).astype(np.float32)
    q = base[:16] + 0.05 * rng.standard_normal((16, 32)).astype(np.float32)
    return data, q


def _clustered(rng):
    return clustered(8000, 32, 48)


def _both(data, q, k, metric=MetricType.L2, **kw):
    jm = JMetric(metric.value)
    nv = kw.pop("n_valid", None)
    jd, ji = jax_fused(jnp.asarray(data), jnp.asarray(q), k, jm, interpret=True,
                       n_valid=None if nv is None else jnp.int32(nv), **kw)
    td, ti = fused_knn(torch.from_numpy(data), torch.from_numpy(q), k, metric,
                       n_valid=nv, **kw)
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


@pytest.mark.parametrize("make", [_near_duplicates, _clustered])
def test_float_table_matches_jax(rng, make):
    data, q = make(rng)
    k = 10
    (jd, ji), (td, ti) = _both(data, q, k, **SHAPES)
    _, truth = brute_force_knn(torch.from_numpy(data), torch.from_numpy(q), k)
    assert (ti == ji).mean() >= 0.99
    shared = ti == ji
    np.testing.assert_allclose(td[shared], jd[shared], rtol=1e-6)
    assert _recall(ti, truth) >= _recall(ji, truth) - 0.005


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_8bit_table_identical_to_jax(rng, dtype, metric):
    lo, hi = (0, 256) if dtype == np.uint8 else (-128, 128)
    data = rng.integers(lo, hi, (3000, 37)).astype(dtype)
    q = rng.integers(lo, hi, (8, 37)).astype(dtype)
    (jd, ji), (td, ti) = _both(data, q, 5, metric, **SHAPES)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("d", [37, 100, 128])
@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_8bit_table_with_float_queries_matches_jax(rng, dtype, d, metric):
    # float32 queries of an 8-bit table: both packages keep the table
    # unpromoted and cast the queries to bf16 ("wgmma_mixed" on the card
    # where d % 4 == 0), then rerank with the float queries. The queries are
    # table rows plus normal noise, so not integers: the keys' sums run in
    # another order than JAX's, and phase B is exact where JAX's is
    # approximate
    lo, hi = (0, 256) if dtype == np.uint8 else (-128, 128)
    data = rng.integers(lo, hi, (3000, d)).astype(dtype)
    q = data[rng.choice(3000, 16, replace=False)] + 8 * rng.standard_normal((16, d))
    q = q.astype(np.float32)
    k = 10
    (jd, ji), (td, ti) = _both(data, q, k, metric, **SHAPES)
    _, truth = brute_force_knn(torch.from_numpy(data), torch.from_numpy(q), k, metric)
    assert (ti == ji).mean() >= 0.99
    shared = ti == ji
    np.testing.assert_allclose(td[shared], jd[shared], rtol=1e-6)
    assert _recall(ti, truth) >= _recall(ji, truth) - 0.005


def test_no_rerank_mode_matches_jax(rng):
    data, q = clustered(6000, 64, 32)
    k = 10
    (jd, ji), (td, ti) = _both(data, q, k, exact_rerank=False, **SHAPES)
    assert (ti == ji).mean() >= 0.99
    shared = ti == ji
    np.testing.assert_allclose(td[shared], jd[shared], rtol=1e-6, atol=1e-4)
    assert np.all(np.diff(td, axis=1) >= 0)


def test_n_valid_and_unpadded_tail(rng):
    # n far from a tile multiple; the true neighbours sit in the partial last
    # tile; n_valid cuts into it
    n, d, k = 2048 + 37, 24, 5
    data = rng.standard_normal((n, d)).astype(np.float32) + 10.0
    q = data[-7:] + 1e-3 * rng.standard_normal((7, d)).astype(np.float32)
    (jd, ji), (td, ti) = _both(data, q, k, rerank=64)
    np.testing.assert_array_equal(ti, ji)
    assert np.isfinite(td).all() and ti.max() < n
    nv = n - 17
    (_, ji), (_, ti) = _both(data, q, k, rerank=64, n_valid=nv)
    np.testing.assert_array_equal(ti, ji)
    assert ti.max() < nv


def test_tiny_table_returns_every_row(rng):
    data = rng.standard_normal((20, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    (jd, ji), (td, ti) = _both(data, q, 10, rerank=32)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6)


def test_query_chunking_is_not_semantic(rng):
    data = torch.from_numpy(rng.standard_normal((6000, 64)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((96, 64)).astype(np.float32))
    d1, i1 = fused_knn(data, q, 10)
    d2, i2 = fused_knn(data, q, 10, summary_bytes=8 * 32 * (6144 // 4))
    assert torch.equal(i1, i2) and torch.equal(d1, d2)


@pytest.mark.parametrize("n,b,d,isz", [
    (10_000_000, 4096, 128, 1), (100_000_000, 8192, 128, 1),
    (1_000_000, 8192, 128, 2), (100_000, 8192, 128, 2),
    (100_000, 1, 128, 2), (2048, 64, 128, 2), (1_000_000, 8192, 960, 2),
])
def test_auto_shapes_bound_every_footprint(n, b, d, isz):
    L, t, qb, qc = _pick_shapes(n, b, d, isz, _TILE, _QB, None, _SUMMARY_BYTES)
    assert t % (128 * L) == 0
    assert t * d * isz <= _ROWS_BYTES or t == 128 * L
    nb = -(-n // t) * (t // L)
    assert 8 * qc * nb <= _SUMMARY_BYTES
    assert qc % qb == 0 and _round_up(b, qc) >= b
    if n >= 4096 * _L:
        assert nb >= 4096


def _bucket_min_numpy(q, rows, pen, nlim, t, L):
    """The binning by its definition, one bucket at a time."""
    qc, n = q.shape[0], rows.shape[0]
    s = t // L
    n_tiles = -(-n // t)
    keys = np.full((qc, n_tiles * t), np.inf, np.float64)
    keys[:, :nlim] = pen[None, :nlim] - 2.0 * (q.astype(np.float64) @ rows[:nlim].T.astype(np.float64))
    out_min = np.empty((qc, n_tiles * s))
    out_id = np.empty((qc, n_tiles * s), np.int64)
    for j in range(n_tiles):
        for b in range(s):
            cols = j * t + b + s * np.arange(L)
            arg = np.argmin(keys[:, cols], axis=1)  # first minimum = lowest id
            out_min[:, j * s + b] = keys[np.arange(qc), cols[arg]]
            out_id[:, j * s + b] = cols[arg]
    return out_min, out_id


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
def test_plain_scan_is_the_strided_bucket_min(rng, metric):
    n, d, nlim, t, L = 700, 9, 650, 256, 2  # 3 tiles, the last partial
    rows = rng.integers(0, 4, (n, d)).astype(np.uint8)  # many exact ties
    q = torch.from_numpy(rng.integers(0, 4, (5, d)).astype(np.float32)).to(torch.bfloat16)
    r = torch.from_numpy(rows)
    pen = squared_norms(r) if metric == MetricType.L2 else torch.zeros(n)
    got_min, got_id = scan_buckets(q, r, pen, nlim, t, L)
    want_min, want_id = _bucket_min_numpy(q.float().numpy(), rows, pen.numpy(), nlim, t, L)
    np.testing.assert_array_equal(got_min.numpy(), want_min.astype(np.float32))
    np.testing.assert_array_equal(got_id.numpy(), want_id)


@pytest.mark.parametrize("dtype,d,L,want", [
    (torch.bfloat16, 128, 16, "wgmma"), (torch.bfloat16, 64, 16, "wgmma"),
    (torch.bfloat16, 384, 16, "wgmma"), (torch.bfloat16, 136, 16, "wgmma"),
    (torch.bfloat16, 37, 16, "mma"), (torch.bfloat16, 56, 16, "wgmma"),
    (torch.bfloat16, 32, 16, "wgmma_narrow"), (torch.bfloat16, 8, 32, "wgmma_narrow"),
    (torch.bfloat16, 40, 32, "wgmma"), (torch.bfloat16, 36, 16, "mma"),
    (torch.bfloat16, 392, 16, "wgmma_wide"), (torch.bfloat16, 132, 16, "mma"),
    (torch.bfloat16, 128, 512, "mma"), (torch.bfloat16, 128, 1, "wgmma"),
    (torch.uint8, 128, 16, "wgmma_mixed"), (torch.int8, 128, 16, "wgmma_mixed"),
    (torch.bfloat16, 960, 16, "wgmma_wide"), (torch.bfloat16, 1024, 16, "wgmma_wide"),
    (torch.bfloat16, 1032, 16, "wgmma_deep"), (torch.bfloat16, 964, 16, "mma"),
    (torch.bfloat16, 104, 16, "wgmma"), (torch.bfloat16, 960, 512, "mma"),
])
@pytest.mark.parametrize("s_blocks", [1, 3])
def test_scan_variant_is_chosen_by_shape(dtype, d, L, want, s_blocks):
    # the main path (bf16, d=128) and the 1M scan take the TMA/wgmma
    # variant, gist's d=960 its clustered wide form, d past 1024 the form
    # that streams queries and rows, widths up to 32 the 64-byte form and
    # 40 to 56 "wgmma" (its boxes read zeros past d), 8-bit rows against
    # bf16 queries "wgmma_mixed"; widths TMA cannot stride and L past eight
    # bits take the mma.sync one. T = 128 * s_blocks * L: S = T/L is whole
    # 128-bucket tiles
    t = 128 * s_blocks * L
    rows = torch.zeros((4 * t, d), dtype=dtype)
    q = torch.zeros((8, d), dtype=torch.bfloat16)
    assert scan_variant(q, rows, torch.zeros(rows.shape[0]), t, L) == want


@pytest.mark.parametrize("t,L", [(2048, 32), (2000, 16), (64 * 16, 16)])
def test_scan_variant_needs_whole_bucket_tiles(t, L):
    # S = T/L of 64 buckets, or T not a multiple of L: not the wgmma
    # variant's 128-bucket tile
    rows = torch.zeros((4096, 128), dtype=torch.bfloat16)
    q = torch.zeros((8, 128), dtype=torch.bfloat16)
    assert scan_variant(q, rows, torch.zeros(rows.shape[0]), t, L) == "mma"


@pytest.mark.parametrize("dtype,qdtype,d,L,want", [
    (torch.uint8, torch.uint8, 128, 16, "wgmma_int8"), (torch.int8, torch.int8, 128, 16, "wgmma_int8"),
    (torch.uint8, torch.uint8, 64, 256, "wgmma_int8"), (torch.int8, torch.int8, 256, 1, "wgmma_int8"),
    (torch.uint8, torch.uint8, 16, 16, "wgmma_int8"),
    # rows of 136 bytes: TMA cannot stride them, the producer warps copy them
    (torch.uint8, torch.uint8, 136, 16, "wgmma_int8_packed"),
    (torch.int8, torch.int8, 100, 256, "wgmma_int8_packed"),  # MS SPACEV
    (torch.uint8, torch.uint8, 100, 16, "wgmma_int8_packed"),
    (torch.uint8, torch.uint8, 36, 1, "wgmma_int8_packed"),
    (torch.int8, torch.int8, 4, 16, "wgmma_int8_packed"),
    (torch.int8, torch.int8, 252, 16, "wgmma_int8_packed"),
    (torch.uint8, torch.uint8, 37, 16, "mma"),    # rows of d % 4 != 0 bytes
    (torch.int8, torch.int8, 102, 16, "mma"),
    # bf16 queries (or 8-bit ones of the other type): the rows are widened
    (torch.uint8, torch.bfloat16, 100, 16, "wgmma_mixed"),
    (torch.int8, torch.bfloat16, 100, 256, "wgmma_mixed"),
    (torch.uint8, torch.bfloat16, 256, 1, "wgmma_mixed"),
    (torch.int8, torch.bfloat16, 4, 16, "wgmma_mixed"),
    (torch.uint8, torch.bfloat16, 37, 16, "mma"),   # rows of d % 4 != 0 bytes
    (torch.int8, torch.bfloat16, 102, 16, "mma"),
    (torch.uint8, torch.bfloat16, 128, 512, "mma"),  # L past eight bits
    (torch.int8, torch.bfloat16, 260, 16, "mma"),   # past d = 256
    (torch.int8, torch.int8, 100, 512, "mma"),
    (torch.uint8, torch.uint8, 264, 16, "mma"),   # past d = 256 the sums may leave 2^24
    (torch.int8, torch.int8, 260, 16, "mma"),
    (torch.uint8, torch.uint8, 128, 512, "mma"),  # L past eight bits
    (torch.uint8, torch.int8, 128, 16, "wgmma_mixed"),  # queries of another 8-bit type
    (torch.int8, torch.uint8, 128, 16, "wgmma_mixed"),
])
def test_scan_variant_takes_integer_wgmma_for_8bit_queries(dtype, qdtype, d, L, want):
    t = 128 * L
    rows = torch.zeros((4 * t, d), dtype=dtype)
    q = torch.zeros((8, d), dtype=qdtype)
    assert scan_variant(q, rows, torch.zeros(rows.shape[0]), t, L) == want


@pytest.mark.parametrize("rdtype,queries,want", [
    (torch.uint8, torch.tensor([[3, 250]], dtype=torch.uint8), True),
    (torch.int8, torch.tensor([[-128, 127]], dtype=torch.uint8), True),
    (torch.uint8, torch.tensor([[-3.0, 255.0]], dtype=torch.bfloat16), True),
    (torch.int8, torch.tensor([[0.5, 2.0]], dtype=torch.bfloat16), False),
    (torch.bfloat16, torch.tensor([[1.0, 2.0]], dtype=torch.bfloat16), False),
])
def test_exact_keys_are_8bit_rows_against_integer_queries(rdtype, queries, want):
    # the tier of correctness the card's K1 is held to: bit-equal where
    # every partial sum is an integer, within a tolerance otherwise
    assert exact_keys(queries, torch.zeros((4, 2), dtype=rdtype)) is want


@pytest.mark.parametrize("d,value,want", [
    (256, 256.0, True),     # 256 * 255 * 256 < 2^24
    (256, 512.0, False),
    (2, -32768.0, True),
    (128, -1024.0, False),
])
def test_exact_keys_need_partial_sums_within_2_24(d, value, want):
    # integer-valued queries are bit-exact only while every partial sum of
    # d products with 8-bit rows stays an integer of at most 2^24
    q = torch.full((3, d), value, dtype=torch.bfloat16)
    assert exact_keys(q, torch.zeros((4, d), dtype=torch.uint8)) is want


@pytest.mark.parametrize("d", [100, 132, 960, 64, 25, 50])
def test_scan_operands_pad_a_bf16_copy_to_a_multiple_of_8(rng, d):
    data = torch.from_numpy(rng.standard_normal((300, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((7, d)).astype(np.float32))
    rows, qb = scan_operands(data, q)
    dp = _round_up(d, 8)
    assert rows.dtype == qb.dtype == torch.bfloat16
    assert rows.shape == (300, dp) and qb.shape == (7, dp)
    assert torch.equal(rows[:, :d], data.to(torch.bfloat16)) and not rows[:, d:].any()
    assert torch.equal(qb[:, :d], q.to(torch.bfloat16)) and not qb[:, d:].any()


@pytest.mark.parametrize("qdtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_scan_operands_keep_8bit_tables_and_their_own_queries(rng, dtype, qdtype):
    data = torch.from_numpy(rng.integers(0, 100, (300, 128))).to(dtype)
    q = torch.from_numpy(rng.integers(0, 100, (7, 128))).to(qdtype)
    rows, qk = scan_operands(data, q)
    assert rows is data
    assert qk.dtype == (qdtype if qdtype == dtype else torch.bfloat16)
    assert torch.equal(qk.to(torch.float32), q.to(torch.float32))


@pytest.mark.parametrize("d,want", [(25, "wgmma_narrow"), (50, "wgmma"), (100, "wgmma"),
                                    (8, "wgmma_narrow")])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_fused_knn_operands_of_narrow_tables_take_wgmma(rng, dtype, d, want):
    # GloVe-25 / -50 (and angular's d=100): the bf16 copy fused_knn hands K1,
    # at the shapes it picks for 1.18M rows and 4,096 queries
    data = torch.from_numpy(rng.standard_normal((300, d)).astype(dtype))
    q = torch.from_numpy(rng.standard_normal((7, d)).astype(dtype))
    rows, qb = scan_operands(data, q)
    L, t, _, _ = _pick_shapes(1_183_514, 4096, rows.shape[1], 2, _TILE, _QB, None, _SUMMARY_BYTES)
    assert (L, t) == (32, 4096)
    assert scan_variant(qb, rows, torch.zeros(rows.shape[0]), t, L) == want


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_fused_knn_operands_of_spacev_take_the_packed_variant(rng, dtype):
    # MS SPACEV: an 8-bit table at d=100 with queries of its type, at the
    # shapes fused_knn picks for 10M rows and 4,096 queries
    data = torch.from_numpy(rng.integers(0, 100, (300, 100))).to(dtype)
    q = torch.from_numpy(rng.integers(0, 100, (7, 100))).to(dtype)
    rows, qk = scan_operands(data, q)
    assert rows is data and qk.dtype == dtype
    L, t, _, _ = _pick_shapes(10_000_000, 4096, 100, 1, _TILE, _QB, None, _SUMMARY_BYTES)
    assert scan_variant(qk, rows, torch.zeros(rows.shape[0]), t, L) == "wgmma_int8_packed"
    # float queries reach K1 as bf16: the rows are widened in registers
    assert scan_variant(qk.to(torch.bfloat16), rows, torch.zeros(rows.shape[0]), t, L) == "wgmma_mixed"


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("d", [100, 132, 25, 50])
def test_padded_width_matches_jax(rng, d, metric):
    # angular's d=100 (and 132), GloVe's 25 and 50: the bf16 copy is padded
    # to a multiple of 8
    data, q = clustered(4000, d, 24)
    if metric == MetricType.IP:
        data = data / np.linalg.norm(data, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    k = 10
    (jd, ji), (td, ti) = _both(data, q, k, metric, **SHAPES)
    _, truth = brute_force_knn(torch.from_numpy(data), torch.from_numpy(q), k, metric)
    assert (ti == ji).mean() >= 0.99
    shared = ti == ji
    np.testing.assert_allclose(td[shared], jd[shared], rtol=1e-6, atol=1e-6)
    assert _recall(ti, truth) >= _recall(ji, truth) - 0.005


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("dtype,d", [(np.uint8, 128), (np.int8, 128), (np.uint8, 64), (np.int8, 256),
                                     (np.uint8, 100), (np.int8, 100)])
def test_8bit_queries_of_an_8bit_table_identical_to_jax(rng, dtype, d, metric):
    # the "wgmma_int8" shapes and MS SPACEV's d=100 ("wgmma_int8_packed"):
    # queries keep the table's type
    lo, hi = (0, 256) if dtype == np.uint8 else (-128, 128)
    data = rng.integers(lo, hi, (3000, d)).astype(dtype)
    q = rng.integers(lo, hi, (8, d)).astype(dtype)
    (jd, ji), (td, ti) = _both(data, q, 5, metric, **SHAPES)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    (jd, ji), (td, ti) = _both(data, q, 5, metric, exact_rerank=False, **SHAPES)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_plain_scan_with_8bit_queries_equals_bf16_queries(rng, dtype, metric):
    n, d, nlim, t, L = 2000, 128, 1900, 512, 4
    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
    rows = torch.from_numpy(rng.integers(lo, hi, (n, d))).to(dtype)
    q = torch.from_numpy(rng.integers(lo, hi, (9, d))).to(dtype)
    pen = squared_norms(rows) if metric == MetricType.L2 else torch.zeros(n)
    m8, i8 = scan_buckets_plain(q, rows, pen, nlim, t, L)
    mb, ib = scan_buckets_plain(q.to(torch.bfloat16), rows, pen, nlim, t, L)
    assert torch.equal(m8, mb) and torch.equal(i8, ib)
    assert torch.equal(scan_buckets(q, rows, pen, nlim, t, L)[0], m8)  # the CPU wrapper


@pytest.mark.parametrize("rdtype,qdtype,d,L,want", [
    (torch.bfloat16, torch.bfloat16, 1024, 16, "wgmma_wide"),
    (torch.bfloat16, torch.bfloat16, 1032, 16, "wgmma_deep"),
    (torch.bfloat16, torch.bfloat16, 1536, 16, "wgmma_deep"),  # OpenAI ada-002, 3-small
    (torch.bfloat16, torch.bfloat16, 3072, 16, "wgmma_deep"),  # OpenAI 3-large
    (torch.bfloat16, torch.bfloat16, 8192, 1, "wgmma_deep"),
    (torch.bfloat16, torch.bfloat16, 3072, 256, "wgmma_deep"),
    (torch.bfloat16, torch.bfloat16, 1540, 16, "mma"),  # rows TMA cannot stride
    (torch.bfloat16, torch.bfloat16, 1536, 512, "mma"),  # L past eight bits
    (torch.uint8, torch.bfloat16, 1536, 16, "mma"),  # 8-bit rows with bf16 queries past 256
    (torch.uint8, torch.bfloat16, 128, 16, "wgmma_mixed"),
    (torch.int8, torch.bfloat16, 100, 16, "wgmma_mixed"),
])
def test_scan_variant_takes_wgmma_deep_past_1024(rdtype, qdtype, d, L, want):
    t = 128 * L
    rows = torch.zeros((2 * t, d), dtype=rdtype)
    q = torch.zeros((8, d), dtype=qdtype)
    assert scan_variant(q, rows, torch.zeros(rows.shape[0]), t, L) == want


@pytest.mark.parametrize("dtype,d", [(np.float32, 1536), (np.float32, 3072), (np.float16, 1536),
                                     (np.float32, 1028), (np.uint8, 1536), (np.int8, 3072)])
def test_fused_knn_operands_of_openai_widths_take_wgmma_deep(rng, dtype, d):
    # OpenAI's widths through the bf16 copy fused_knn makes (8-bit tables
    # past d = 257 are promoted to it; d = 1028 is padded to 1032), at the
    # shapes it picks for 1M rows and 4,096 queries
    if dtype in (np.uint8, np.int8):
        data = torch.from_numpy(rng.integers(0, 100, (300, d)).astype(dtype))
        q = torch.from_numpy(rng.integers(0, 100, (7, d)).astype(dtype))
    else:
        data = torch.from_numpy(rng.standard_normal((300, d)).astype(dtype))
        q = torch.from_numpy(rng.standard_normal((7, d)).astype(dtype))
    rows, qb = scan_operands(data, q)
    assert rows.dtype == qb.dtype == torch.bfloat16 and rows.shape[1] == _round_up(d, 8)
    L, t, _, qc = _pick_shapes(1_000_000, 4096, rows.shape[1], 2, _TILE, _QB, None, _SUMMARY_BYTES)
    assert (L, t, qc) == (16, 2048, 4096)
    assert scan_variant(qb, rows, torch.zeros(rows.shape[0]), t, L) == "wgmma_deep"


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("d", [1032, 1536, 3072])
def test_openai_widths_match_jax(rng, d, metric):
    # past d = 1024 ("wgmma_deep" on the card): clustered rows, unit rows
    # under IP as OpenAI's embeddings are; the ids must be JAX's
    data, q = clustered(4096, d, 16, seed=d)
    if metric == MetricType.IP:
        data = data / np.linalg.norm(data, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    (jd, ji), (td, ti) = _both(data, q, 10, metric, **SHAPES)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-6)
