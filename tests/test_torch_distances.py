"""The port's distance ops (flatnav_tpu_torch/ops/distances.py) against the
JAX package's on the same numpy inputs, on the CPU.

Integer tables must agree exactly. Float results agree within rtol 1e-6 of
the result's magnitude: the two frameworks' float32 matmuls and reductions
sum in different orders, which moves the last bits only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flatnav_tpu.ops import distances as jd
from flatnav_tpu_torch.ops import distances as td

METRICS = [("l2", jd.MetricType.L2, td.MetricType.L2),
           ("ip", jd.MetricType.IP, td.MetricType.IP)]
DTYPES = ["float32", "bfloat16", "uint8", "int8"]


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    x = x.astype(dtype)
    return jnp.asarray(x), torch.from_numpy(x)


def _data(rng, shape, dtype):
    if dtype == "uint8":
        return rng.integers(0, 256, shape)
    if dtype == "int8":
        return rng.integers(-128, 128, shape)
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    if dtype in ("uint8", "int8"):
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,jm,tm", METRICS)
@pytest.mark.parametrize("d", [7, 37, 100])
def test_distance_blocks_match_jax(rng, d, name, jm, tm, dtype):
    xj, xt = _pair(_data(rng, (9, d), dtype), dtype)
    yj, yt = _pair(_data(rng, (23, d), dtype), dtype)
    _close(td.pairwise_distances(xt, yt, tm), jd.pairwise_distances(xj, yj, jm), dtype)
    bj, bt = _pair(_data(rng, (9, 5, d), dtype), dtype)
    _close(td.query_block_distances(xt, bt, tm),
           jd.query_block_distances(xj, bj, jm), dtype)
    _close(td.squared_norms(xt), jd.squared_norms(xj), dtype)


@pytest.mark.parametrize("dtype", ["uint8", "int8"])
def test_exact_int_dot_matches_jax(rng, dtype):
    # d = 960 at the extremes: the uint8 L2 sums pass 2^24, where float32
    # accumulation would be inexact
    lo, hi = (0, 256) if dtype == "uint8" else (-128, 128)
    x = rng.integers(lo, hi, (6, 960)).astype(dtype)
    y = rng.integers(lo, hi, (11, 960)).astype(dtype)
    x[0] = hi - 1
    y[0] = lo
    got = td.exact_int_dot(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jd.exact_int_dot(jnp.asarray(x), jnp.asarray(y)))
    )


@pytest.mark.parametrize("n_valid", [None, 411])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("name,jm,tm", METRICS)
def test_brute_force_ids_identical_with_ties(rng, name, jm, tm, dtype, n_valid):
    # small-integer values make every distance exact in both frameworks,
    # and repeated rows make exact ties: both must break them to the
    # lowest id. n=600 with tile 256 exercises the clamped last tile.
    base = rng.integers(0, 4, (150, 12))
    data = np.repeat(base, 4, axis=0)[rng.permutation(600)].astype(dtype)
    q = rng.integers(0, 4, (17, 12)).astype(dtype)
    k = 10
    jdist, jids = jd.brute_force_knn(
        jnp.asarray(data), jnp.asarray(q), k, jm, tile_size=256,
        n_valid=None if n_valid is None else jnp.int32(n_valid),
    )
    tdist, tids = td.brute_force_knn(
        torch.from_numpy(data), torch.from_numpy(q), k, tm, tile_size=256,
        n_valid=n_valid,
    )
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))
    if n_valid is not None:
        assert int(tids.max()) < n_valid


def test_brute_force_float_matches_numpy_oracle(rng):
    data = rng.standard_normal((700, 37)).astype(np.float32)
    q = rng.standard_normal((13, 37)).astype(np.float32)
    _, ids = td.brute_force_knn(torch.from_numpy(data), torch.from_numpy(q), 5,
                                tile_size=128)
    full = ((q[:, None, :].astype(np.float64) - data[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(ids.numpy(), np.argsort(full, axis=1, kind="stable")[:, :5])


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("name,jm,tm", METRICS)
def test_fast_knn_recall_at_least_jax(rng, name, jm, tm, dtype):
    data = _data(rng, (3000, 32), dtype).astype(dtype)
    q = _data(rng, (40, 32), dtype).astype(dtype)
    k = 10
    _, truth = td.brute_force_knn(torch.from_numpy(data), torch.from_numpy(q), k, tm)
    _, jids = jd.fast_knn(jnp.asarray(data), jnp.asarray(q), k, jm, tile_size=1024)
    tdist, tids = td.fast_knn(torch.from_numpy(data), torch.from_numpy(q), k, tm,
                              tile_size=1024)

    def recall(ids):
        ids = np.asarray(ids)
        return np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, truth.numpy())])

    assert recall(tids) >= recall(jids)
    assert np.all(np.diff(tdist.numpy(), axis=1) >= 0)


def test_smallest_k_total_order():
    # ties go to the lowest id, the two zeros included
    d = torch.tensor([[2.0, 0.0, -0.0, -1.5, float("inf"), 2.0, -1.5]])
    ids = torch.arange(7, dtype=torch.int32)[None]
    dist, idx = td.smallest_k(d, ids, 7)
    assert idx.tolist() == [[3, 6, 1, 2, 0, 5, 4]]
    assert dist.tolist() == [[-1.5, -1.5, 0.0, 0.0, 2.0, 2.0, float("inf")]]
