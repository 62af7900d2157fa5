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


def test_fast_knn_ranks_by_bf16_keys():
    # ROADMAP C.1: phase 1 takes the TPU's DEFAULT-precision form, bf16
    # operands with float32 accumulation and float32 norms. Row 0 is nearer
    # in float32 (distance 4e-6 against 9e-6), but its bf16-rounded key
    # (1.002 rounds to 1.0) is larger, so a one-wide shortlist holds row 1.
    data = torch.tensor([[1.002], [0.997]])
    q = torch.tensor([[1.0]])
    dist, ids = td.fast_knn(data, q, 1, td.MetricType.L2, rerank=1)
    assert ids.tolist() == [[1]]
    assert abs(dist.item() - 9e-6) < 1e-9  # the rerank's distance is exact
    _, exact = td.brute_force_knn(data, q, 1)
    assert exact.tolist() == [[0]]


def test_bf16_dot_is_the_product_of_rounded_operands(rng):
    x = rng.standard_normal((9, 37)).astype(np.float32)
    y = rng.standard_normal((23, 37)).astype(np.float32)
    xr = torch.from_numpy(x).to(torch.bfloat16).double()
    yr = torch.from_numpy(y).to(torch.bfloat16).double()
    got = td.bf16_dot(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), (xr @ yr.T).numpy(), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name,jm,tm", METRICS)
def test_fast_knn_ids_agree_with_jax(rng, name, jm, tm):
    # the port's bf16 ranking keys against JAX's float32 keys on the CPU:
    # the exact rerank of a 32-wide shortlist hides the rounding in nearly
    # every slot, and where the ids agree so do the exact distances
    data = rng.standard_normal((4000, 48)).astype(np.float32)
    q = rng.standard_normal((64, 48)).astype(np.float32)
    jdist, jids = jd.fast_knn(jnp.asarray(data), jnp.asarray(q), 10, jm, tile_size=1024,
                              recall_target=0.95)
    tdist, tids = td.fast_knn(torch.from_numpy(data), torch.from_numpy(q), 10, tm,
                              tile_size=1024, recall_target=0.95)
    same = np.asarray(jids) == tids.numpy()
    assert same.mean() >= 0.99
    _close(tdist.numpy()[same], np.asarray(jdist)[same], "float32")


def test_port_modules_have_the_jax_names_and_parameters():
    # ROADMAP C.2: every public name defined in the JAX modules exists in
    # the port's, and each function takes the same parameters in the same
    # order. Not applicable: DataType.jax_dtype (the port's is torch_dtype).
    import inspect

    import flatnav_tpu.data_type as jdt
    from flatnav_tpu_torch import data_type as tdt

    for jmod, tmod in ((jd, td), (jdt, tdt)):
        names = [n for n in dir(jmod) if not n.startswith("_")
                 and getattr(getattr(jmod, n), "__module__", None) == jmod.__name__]
        assert names and all(hasattr(tmod, n) for n in names), (jmod.__name__, names)
        for n in names:
            fn = getattr(jmod, n)
            if callable(fn) and not isinstance(fn, type):
                assert (list(inspect.signature(fn).parameters)
                        == list(inspect.signature(getattr(tmod, n)).parameters)), n
    props = {n for n, v in vars(jdt.DataType).items() if isinstance(v, property)}
    assert props - {"jax_dtype"} <= {n for n, v in vars(tdt.DataType).items()
                                     if isinstance(v, property)}


@pytest.mark.parametrize("name", ["uint8", "int8", "float16", "bfloat16", "float32"])
def test_numpy_dtype_matches_jax(name):
    from flatnav_tpu.data_type import DataType as JaxType
    from flatnav_tpu_torch.data_type import DataType, from_numpy, to_numpy

    port = DataType(name).numpy_dtype
    if name == "bfloat16":
        # numpy has no bfloat16: the port's host form is the uint16 bit view
        x = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
        assert port == np.uint16 and to_numpy(x).dtype == port
        assert torch.equal(from_numpy(to_numpy(x), torch.bfloat16), x)
        assert np.asarray(jnp.asarray([1.5, -2.25], JaxType(name).numpy_dtype)).view(np.uint16).tolist() \
            == to_numpy(x).tolist()
    else:
        assert port == JaxType(name).numpy_dtype


@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_squared_norms_of_8bit_rows_in_chunks(rng, monkeypatch, dtype):
    # integer tables are widened a chunk of rows at a time; the sums are exact
    x = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max + 1, (1000, 37)).astype(dtype)
    want = (x.astype(np.int64) ** 2).sum(-1).astype(np.float32)
    monkeypatch.setattr(td, "_NORM_ROWS", 128)
    got = td.squared_norms(torch.from_numpy(x))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    got3 = td.squared_norms(torch.from_numpy(x.reshape(10, 100, 37)))
    assert np.array_equal(got3.numpy(), want.reshape(10, 100))
    jw = np.asarray(jd.squared_norms(jnp.asarray(x)))
    assert np.array_equal(got.numpy(), jw)
