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
    _L, _QB, _ROWS_BYTES, _SUMMARY_BYTES, _TILE, _pick_shapes, _round_up,
    scan_buckets, scan_variant,
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
    (torch.bfloat16, 37, 16, "mma"), (torch.bfloat16, 56, 16, "mma"),
    (torch.bfloat16, 392, 16, "mma"), (torch.bfloat16, 132, 16, "mma"),
    (torch.bfloat16, 128, 512, "mma"), (torch.bfloat16, 128, 1, "wgmma"),
    (torch.uint8, 128, 16, "mma"), (torch.int8, 128, 16, "mma"),
])
@pytest.mark.parametrize("s_blocks", [1, 3])
def test_scan_variant_is_chosen_by_shape(dtype, d, L, want, s_blocks):
    # the main path (bf16, d=128) and the 1M scan take the TMA/wgmma
    # variant; 8-bit rows, widths TMA cannot stride and L past eight bits
    # take the mma.sync one. T = 128 * s_blocks * L: S = T/L is whole
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
