"""The port's k-means and product quantizer (flatnav_tpu_torch.quantization
.kmeans, .pq) against flatnav_tpu, on the CPU.

The same numpy arrays go through both packages. The codebook is trained by
the JAX package and carried over with `convert.pq_from_jax_arrays`, so that
everything downstream of training (codes, tables, scans) is compared on
identical centroids; training itself is held by its first Lloyd steps and by
the trained quantizer's reconstruction error. Each comparison states its
tolerance.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flatnav_tpu.ops as jops
import flatnav_tpu.quantization.pq as jpq
from flatnav_tpu_torch import convert
from flatnav_tpu_torch.ops import MetricType, brute_force_knn
from flatnav_tpu_torch.quantization import (
    ProductQuantizer,
    kmeans,
    pack_codes_4bit,
    pack_codes_lanes,
    unpack_codes_4bit,
)
from flatnav_tpu_torch.quantization import pq as pq_mod
from flatnav_tpu_torch.quantization.pq import pq_scan_knn, pq_search, score_codes

# each package's `quantization` rebinds the name `kmeans` to the function
jkm = importlib.import_module("flatnav_tpu.quantization.kmeans")
km = importlib.import_module("flatnav_tpu_torch.quantization.kmeans")

N, D, M_PQ, NQ = 2000, 32, 8, 16


def _recall(found, truth):
    return sum(len(set(f.tolist()) & set(t.tolist())) for f, t in zip(found, truth)) / truth.size


def _clustered(seed=11, n=N, d=D, nq=NQ):
    # PQ is lossy on pure-random data; clustered data is what it is for.
    # Coordinates of order 1 keep a subspace's squared norms near 10, so the
    # absolute tolerances below (1e-5) sit a few float32 roundings above the
    # cancellation in ||q||^2 - 2 q.c + ||c||^2
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32)
    data = centers[rng.integers(0, 64, n)] + 0.075 * rng.standard_normal((n, d)).astype(np.float32)
    queries = data[rng.choice(n, nq, replace=False)] + 0.0125 * rng.standard_normal(
        (nq, d)).astype(np.float32)
    return data.astype(np.float32), queries.astype(np.float32)


class Pair:
    """One codebook in both packages, and the data it encodes."""

    def __init__(self, nbits):
        self.data, self.queries = _clustered()
        self.jax = jpq.ProductQuantizer(dim=D, num_subquantizers=M_PQ, nbits=nbits).train(
            self.data[:1000], n_iters=10)
        self.centroids = np.asarray(self.jax.codebook.centroids)
        self.port = convert.pq_from_jax_arrays(self.centroids, self.jax.metric, device="cpu")
        self.jcodes = np.array(self.jax.encode(self.data))
        self.codes = torch.from_numpy(self.jcodes.copy())  # the JAX codes, so scans see one table
        self.jtables = self.jax.adc_tables(self.queries)
        self.tables = torch.from_numpy(np.array(self.jtables))


@pytest.fixture(scope="module")
def pair8():
    return Pair(8)


@pytest.fixture(scope="module")
def pair4():
    return Pair(4)


# ------------------------------------------------------------------ k-means
@pytest.mark.parametrize("init", ["random", "kmeans++", "hypercube"])
def test_kmeans_initialisers_bit_equal(rng, init):
    data = rng.standard_normal((500, 6)).astype(np.float32)
    want = jkm._INITS[init](data, 16, np.random.default_rng(3))
    got = km._INITS[init](data, 16, np.random.default_rng(3))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("steps", [1, 3])
def test_lloyd_steps_match_jax(rng, steps):
    # from identical centroids: equal to float rounding (rtol 1e-4, atol 1e-5)
    data, _ = _clustered(n=1500, d=8)
    cents0 = km._init_random(data, 32, np.random.default_rng(5))
    jc, ja = jkm._lloyd(jnp.asarray(data), jnp.asarray(cents0), steps)
    pc, pa = km._lloyd(torch.from_numpy(data), torch.from_numpy(cents0), steps)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    assert (pa.numpy() == np.asarray(ja)).mean() >= 0.999


def test_lloyd_empty_cluster_keeps_its_centroid():
    data = np.concatenate([np.zeros((20, 2)), np.ones((20, 2))]).astype(np.float32)
    cents0 = np.array([[0, 0], [1, 1], [50, 50]], np.float32)
    cents, assign = km._lloyd(torch.from_numpy(data), torch.from_numpy(cents0), 4)
    np.testing.assert_array_equal(cents.numpy(), cents0)
    assert set(assign.tolist()) == {0, 1}


def test_kmeans_centroids(rng):
    # 4 well-separated clusters must be recovered
    centers = np.array([[0, 0], [10, 0], [0, 10], [10, 10]], np.float32)
    data = np.concatenate(
        [c + 0.1 * rng.standard_normal((100, 2)).astype(np.float32) for c in centers])
    cents, assign = kmeans(data, 4, n_iters=20, device="cpu")
    for c in centers:
        assert np.min(((cents.numpy() - c) ** 2).sum(1)) < 0.04
    assert assign.shape == (400,)
    jc, _ = jkm.kmeans(data, 4, n_iters=20)
    np.testing.assert_allclose(cents.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)


def test_kmeans_validation(rng, monkeypatch):
    with pytest.raises(ValueError, match="unknown init"):
        kmeans(rng.standard_normal((10, 2)), 2, init="bogus", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kmeans(rng.standard_normal((10, 2)), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProductQuantizer(dim=8, num_subquantizers=2)


# ------------------------------------------------- codes, decode and tables
def test_encode_matches_jax(pair8):
    got = pair8.port.encode(pair8.data).numpy()
    assert got.dtype == np.uint8 and got.shape == (N, M_PQ)
    assert (got == pair8.jcodes).mean() >= 0.999  # identical up to argmin near-ties
    err = lambda c: ((pair8.port.decode(c).numpy() - pair8.data) ** 2).sum(1).mean()
    np.testing.assert_allclose(err(got), err(pair8.jcodes), rtol=1e-5)


def test_encode_in_chunks_is_the_same(pair8, monkeypatch):
    want = pair8.port.encode(pair8.data)
    monkeypatch.setattr(pq_mod, "_ENCODE_ROWS", 300)
    assert torch.equal(pair8.port.encode(pair8.data), want)
    assert pair8.port.encode(pair8.data[:0]).shape == (0, M_PQ)


@pytest.mark.parametrize("nbits", [4, 8])
def test_decode_bit_equal(pair4, pair8, nbits):
    p = pair8 if nbits == 8 else pair4
    np.testing.assert_array_equal(
        p.port.decode(p.jcodes).numpy(), np.asarray(p.jax.decode(p.jcodes)))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_adc_tables_match_jax(pair8, metric):
    jq = jpq.ProductQuantizer(D, M_PQ, metric=jops.MetricType(metric))
    jq.codebook = pair8.jax.codebook
    pq = convert.pq_from_jax_arrays(pair8.centroids, metric, device="cpu")
    got = pq.adc_tables(pair8.queries)
    assert got.shape == (NQ, M_PQ, 256)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jq.adc_tables(pair8.queries)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        pq.asymmetric_distances(pair8.queries, pair8.jcodes).numpy(),
        np.asarray(jq.asymmetric_distances(pair8.queries, pair8.jcodes)), rtol=1e-5, atol=1e-4)


def test_sdc_tables_match_jax(pair8):
    sdc = pair8.port.sdc_tables().numpy()
    assert sdc.shape == (M_PQ, 256, 256)
    np.testing.assert_allclose(sdc, np.asarray(pair8.jax.sdc_tables()), rtol=1e-5, atol=1e-5)
    assert np.allclose(np.diagonal(sdc, axis1=1, axis2=2), 0, atol=1e-3)
    assert np.allclose(sdc, sdc.transpose(0, 2, 1), atol=1e-3)


def test_asymmetric_distance_matches_decoded(pair8, monkeypatch):
    adc = pair8.port.asymmetric_distances(pair8.queries, pair8.codes)
    decoded = pair8.port.decode(pair8.codes).numpy()
    exact = ((pair8.queries[:, None, :] - decoded[None]) ** 2).sum(-1)
    np.testing.assert_allclose(adc.numpy(), exact, rtol=1e-3, atol=1e-2)
    monkeypatch.setattr(pq_mod, "_ADC_BLOCK_ELEMS", 5 * M_PQ * N)  # 5 queries a chunk
    assert torch.equal(pair8.port.asymmetric_distances(pair8.queries, pair8.codes), adc)


def test_score_codes_is_the_table_sum(pair8):
    ids = torch.arange(40).reshape(NQ // 4, 10)[[0, 1, 2, 3] * 4]
    got = score_codes(pair8.tables, pair8.codes[ids])
    t, c = pair8.tables.numpy(), pair8.jcodes
    want = np.array([[sum(t[b, s, c[i, s]] for s in range(M_PQ)) for i in row]
                     for b, row in enumerate(ids.numpy())], np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpq.score_codes(pair8.jtables, jnp.asarray(c[ids.numpy()]))),
        rtol=1e-6)


def test_packing_bit_equal(pair4, pair8):
    c4 = pair4.jcodes
    assert c4.max() < 16
    packed = pack_codes_4bit(c4)
    assert packed.shape == (N, M_PQ // 2) and packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpq.pack_codes_4bit(c4)))
    np.testing.assert_array_equal(unpack_codes_4bit(packed).numpy(), c4)
    np.testing.assert_array_equal(
        unpack_codes_4bit(packed).numpy(), np.asarray(jpq.unpack_codes_4bit(jnp.asarray(packed.numpy()))))
    for codes, tile in ((pair8.jcodes[:1437], 512), (packed.numpy()[:1437], 256)):
        flat, n_pad = pack_codes_lanes(codes, tile=tile)
        jflat, jn_pad = jpq.pack_codes_lanes(codes, tile=tile)
        assert n_pad == jn_pad and flat.shape[1] == 128 and n_pad % tile == 0
        np.testing.assert_array_equal(flat, jflat)


# ------------------------------------------------------------- the ADC scan
SCAN_MODES = {
    # name: (nbits, rows, kwargs of both packages)
    "adc_rerank": (8, 1500, dict(tile_size=512, rerank=64)),
    "raw_rerank": (8, 1500, dict(tile_size=512, rerank=64, raw=True)),
    "ip_metric": (8, 1500, dict(tile_size=512, rerank=64, metric="ip")),
    "packed_4bit": (4, 1500, dict(tile_size=512, rerank=64, packed_4bit=True)),
    "packed_4bit_raw": (4, 1500, dict(tile_size=512, rerank=128, packed_4bit=True, raw=True)),
    "lane_packed": (8, 1437, dict(tile_size=512, rerank=64, lane_packed=True)),
    "lane_packed_raw": (8, 1437, dict(tile_size=512, rerank=64, lane_packed=True, raw=True)),
    "lane_packed_4bit": (4, 1437, dict(tile_size=512, rerank=64, lane_packed=True, packed_4bit=True)),
    "n_valid_prefix": (8, 1024, dict(tile_size=256, rerank=16, n_valid=300)),
    "n_valid_prefix_raw": (8, 1024, dict(tile_size=256, rerank=16, n_valid=300, raw=True)),
    "under_128_rows": (8, 100, dict(tile_size=512, rerank=32)),
    "rows_not_a_tile_multiple": (8, 1219, dict(tile_size=512, rerank=64)),
    "one_tile": (8, 1500, dict(rerank=32)),
    "rerank_below_k": (8, 1500, dict(tile_size=512, rerank=4)),
}


def _scan_both(pair, n, kw):
    """-> ((dists, ids) of the port, (dists, ids) of the JAX package) as numpy
    arrays, and the ADC tables both scanned with"""
    kw = dict(kw)
    raw = kw.pop("raw", False)
    metric = kw.pop("metric", "l2")
    codes = pair.jcodes[:n]
    tables, jtables = pair.tables, pair.jtables
    if metric == "ip":
        jq = jpq.ProductQuantizer(D, M_PQ, metric=jops.MetricType.IP)
        jq.codebook = pair.jax.codebook
        jtables = jq.adc_tables(pair.queries)
        tables = torch.from_numpy(np.array(jtables))
    if kw.get("packed_4bit"):
        codes = np.array(jpq.pack_codes_4bit(codes))
    if kw.get("lane_packed"):
        codes, _ = pack_codes_lanes(codes, tile=kw["tile_size"])
        kw.setdefault("n_valid", n)
    jkw, pkw = dict(kw), dict(kw)
    if "n_valid" in kw:
        jkw["n_valid"] = jnp.asarray(kw["n_valid"], jnp.int32)
    if raw:
        jkw.update(vectors=jnp.asarray(pair.data[:n]), queries=jnp.asarray(pair.queries))
        pkw.update(vectors=torch.from_numpy(pair.data[:n]), queries=torch.from_numpy(pair.queries))
    jd, ji = jpq.pq_scan_knn(jnp.asarray(codes), jtables, 10, metric=jops.MetricType(metric), **jkw)
    pd, pi = pq_scan_knn(torch.from_numpy(codes), tables, 10, metric=MetricType(metric), **pkw)
    assert pd.dtype == torch.float32 and pi.dtype == torch.int32 and pd.shape == (NQ, 10)
    return (pd.numpy(), pi.numpy()), (np.asarray(jd), np.asarray(ji)), tables


@pytest.mark.parametrize("mode", SCAN_MODES)
def test_pq_scan_knn_modes_match_jax(pair4, pair8, mode):
    # ids equal in >= 99% of slots (float near-ties and the matmul's
    # summation order may swap neighbours), distances allclose(rtol=1e-4).
    # A slot whose ADC distance several nodes share exactly (rows with one
    # code: most rows of a 4-bit table this small) is exempt: the port gives
    # such ties to the lowest id, XLA's top-k in another order.
    nbits, n, kw = SCAN_MODES[mode]
    pair = pair8 if nbits == 8 else pair4
    (pd, pi), (jd, ji), tables = _scan_both(pair, n, kw)
    tied = np.zeros_like(pi, dtype=bool)
    if not kw.get("raw"):
        brute = pq_mod.score_shared_codes(tables, pair.codes[: kw.get("n_valid", n)]).numpy()
        brute += 1.0 if kw.get("metric") == "ip" else 0.0
        np.testing.assert_allclose(  # every id is a node at the distance stated for it
            np.take_along_axis(brute, pi.astype(np.int64), axis=1), pd, rtol=1e-6)
        tied = (np.isclose(brute[:, None, :], pd[:, :, None], rtol=1e-6, atol=0).sum(-1) > 1)
        assert nbits == 4 or tied.mean() < 0.05
    assert ((pi == ji) | tied).mean() >= 0.99
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-5)
    limit = kw.get("n_valid", n)
    assert pi.max() < limit and pi.min() >= 0
    for row in pi:  # the clamped last tile counts no row twice
        assert len(set(row.tolist())) == len(row)
    assert (np.diff(pd, axis=1) >= 0).all()


def test_pq_scan_knn_fewer_valid_rows_than_k(pair8):
    # unfilled slots stay inf through the rerank, in both packages
    (pd, pi), (jd, ji), _ = _scan_both(pair8, 1024, dict(tile_size=256, rerank=16, n_valid=6))
    np.testing.assert_array_equal(np.isinf(pd), np.isinf(jd))
    assert np.isinf(pd[:, 6:]).all() and np.isfinite(pd[:, :6]).all()
    np.testing.assert_array_equal(pi[:, :6], ji[:, :6])


def test_pq_scan_knn_matches_bruteforce_adc(pair8):
    # bf16 keys only select; the shortlist is re-scored in f32, so with a
    # generous shortlist the result equals a full sort of the ADC distances
    codes = pair8.codes[:1500]
    d, ids = pq_scan_knn(codes, pair8.tables, 10, tile_size=512, rerank=64)
    brute = pair8.port.asymmetric_distances(pair8.queries, codes).numpy()
    want_ids = np.argsort(brute, axis=1, kind="stable")[:, :10]
    want_d = np.take_along_axis(brute, want_ids, axis=1)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        np.take_along_axis(brute, ids.numpy().astype(np.int64), axis=1), want_d, rtol=1e-5, atol=1e-4)


def test_pq_scan_knn_raw_rerank_recall(pair4, pair8):
    data, queries = torch.from_numpy(pair8.data[:1500]), torch.from_numpy(pair8.queries)
    _, gt = brute_force_knn(data, queries, 10)
    _, adc_ids = pq_scan_knn(pair8.codes[:1500], pair8.tables, 10, tile_size=512, rerank=128)
    d_raw, raw_ids = pq_scan_knn(pair8.codes[:1500], pair8.tables, 10, tile_size=512, rerank=128,
                                 vectors=data, queries=queries)
    assert _recall(raw_ids.numpy(), gt.numpy()) >= max(_recall(adc_ids.numpy(), gt.numpy()), 0.9)
    assert (np.diff(d_raw.numpy(), axis=1) >= -1e-5).all()
    # coarse 4-bit codes rank poorly alone; the raw rerank recovers recall
    _, ids4 = pq_scan_knn(pack_codes_4bit(pair4.codes[:1500]), pair4.tables, 10, tile_size=512,
                          rerank=128, vectors=data, queries=queries, packed_4bit=True)
    assert _recall(ids4.numpy(), gt.numpy()) >= 0.9


def test_pq_scan_knn_raw_rerank_of_an_integer_table(pair8):
    # BigANN-style uint8 raw rows: the rerank is exact integer arithmetic
    rng = np.random.default_rng(2)
    raw = torch.from_numpy(rng.integers(0, 256, (1500, D)).astype(np.uint8))
    q = torch.from_numpy(rng.integers(0, 256, (NQ, D)).astype(np.uint8))
    d, ids = pq_scan_knn(pair8.codes[:1500], pair8.tables, 10, tile_size=512, rerank=32,
                         vectors=raw, queries=q)
    want = ((raw[ids.long()].long() - q[:, None, :].long()) ** 2).sum(-1)
    np.testing.assert_array_equal(d.numpy(), want.numpy().astype(np.float32))


def test_packed_and_lane_packed_scans_equal_the_unpacked_scan(pair4, pair8):
    # a storage layout, never a semantic one: identical ids and distances
    nv = 1437
    base = pq_scan_knn(pair8.codes[:nv], pair8.tables, 10, tile_size=512, rerank=64, n_valid=nv)
    flat, _ = pack_codes_lanes(pair8.jcodes[:nv], tile=512)
    lane = pq_scan_knn(torch.from_numpy(flat), pair8.tables, 10, tile_size=512, rerank=64,
                       n_valid=nv, lane_packed=True)
    assert torch.equal(base[1], lane[1]) and torch.equal(base[0], lane[0])
    base4 = pq_scan_knn(pair4.codes[:nv], pair4.tables, 10, tile_size=512, rerank=64)
    packed = pack_codes_4bit(pair4.codes[:nv])
    p4 = pq_scan_knn(packed, pair4.tables, 10, tile_size=512, rerank=64, packed_4bit=True)
    assert torch.equal(base4[1], p4[1]) and torch.equal(base4[0], p4[0])
    flat4, _ = pack_codes_lanes(packed.numpy(), tile=512)
    l4 = pq_scan_knn(torch.from_numpy(flat4), pair4.tables, 10, tile_size=512, rerank=64,
                     n_valid=nv, packed_4bit=True, lane_packed=True)
    assert torch.equal(base4[1], l4[1]) and torch.equal(base4[0], l4[0])


def test_scan_keys_are_f32_sums_of_bf16_rounded_entries(pair8):
    # the key route: one rounding of each table entry to bf16, then float32
    # sums; a bf16 matmul's bf16 result would round every key once more
    codes, tables = pair8.codes[:256], pair8.tables
    t_bf = tables.reshape(NQ, -1).to(torch.bfloat16)
    onehot = torch.zeros((256, M_PQ * 256), dtype=torch.bfloat16)
    onehot.scatter_(1, codes.long() + torch.arange(M_PQ) * 256, 1.0)
    key = pq_mod._scan_keys(t_bf, onehot)
    assert key.dtype == torch.float32
    rounded = tables.to(torch.bfloat16).to(torch.float32)
    want = score_codes(rounded, codes[None].expand(NQ, -1, -1))
    np.testing.assert_allclose(key.numpy(), want.numpy(), rtol=1e-6)
    twice = (t_bf @ onehot.T).to(torch.float32)  # what torch.matmul of bf16 returns
    assert float((twice - want).abs().max()) > 10 * float((key - want).abs().max())
    assert torch.equal(pq_mod._scan_keys_f32(t_bf, onehot), key)  # the CPU's route


@pytest.mark.parametrize("case", [
    "lane_width", "lane_bytes", "lane_n_valid", "lane_tile", "width", "packed_4bit_nc",
])
def test_pq_scan_knn_contract_violations_raise_value_error(pair4, pair8, case):
    t8, t4 = pair8.tables, pair4.tables
    lanes = torch.zeros((64, 128), dtype=torch.uint8)  # 1024 rows of 8 bytes
    call = {
        "lane_width": lambda: pq_scan_knn(torch.zeros((64, 64), dtype=torch.uint8), t8, 5,
                                          n_valid=10, lane_packed=True),
        "lane_bytes": lambda: pq_scan_knn(lanes, t8[:, :6], 5, n_valid=10, lane_packed=True),
        "lane_n_valid": lambda: pq_scan_knn(lanes, t8, 5, lane_packed=True),
        "lane_tile": lambda: pq_scan_knn(lanes, t8, 5, tile_size=768, n_valid=10, lane_packed=True),
        "width": lambda: pq_scan_knn(pair8.codes[:, :6], t8, 5),
        "packed_4bit_nc": lambda: pq_scan_knn(pair8.codes[:, :4], t8, 5, packed_4bit=True),
    }[case]
    with pytest.raises(ValueError):
        call()
    # the well-formed neighbours of those calls run
    pq_scan_knn(lanes, t8, 5, tile_size=512, n_valid=10, lane_packed=True)
    pq_scan_knn(pack_codes_4bit(pair4.codes), t4, 5, packed_4bit=True)


def test_packing_and_quantizer_validation():
    with pytest.raises(ValueError, match="even"):
        pack_codes_4bit(np.zeros((4, 3), np.uint8))
    with pytest.raises(ValueError, match="128"):
        pack_codes_lanes(np.zeros((4, 3), np.uint8))
    with pytest.raises(ValueError, match="whole lanes"):
        pack_codes_lanes(np.zeros((4, 8), np.uint8), tile=100)
    with pytest.raises(ValueError, match="nbits"):
        ProductQuantizer(dim=32, num_subquantizers=8, nbits=6, device="cpu")
    with pytest.raises(ValueError, match="even"):
        ProductQuantizer(dim=33, num_subquantizers=3, nbits=4, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        ProductQuantizer(dim=30, num_subquantizers=8, device="cpu")
    pq = ProductQuantizer(dim=32, num_subquantizers=8, nbits=4, device="cpu")
    assert pq.num_centroids == 16 and pq.code_size_bytes() == 4
    assert ProductQuantizer(dim=32, num_subquantizers=8, device="cpu").code_size_bytes() == 8
    for call in (lambda: pq.encode(np.zeros((2, 32))), lambda: pq.decode(np.zeros((2, 8))),
                 lambda: pq.adc_tables(np.zeros((2, 32))), pq.sdc_tables):
        with pytest.raises(RuntimeError, match="trained"):
            call()
    with pytest.raises(RuntimeError, match="hot_start"):
        pq.train(np.zeros((40, 32), np.float32), train_type="hot_start")
    with pytest.raises(ValueError, match="16 or 256"):
        convert.pq_from_jax_arrays(np.zeros((4, 32, 2), np.float32), "l2", device="cpu")


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("train_type", ["default", "hypercube", "shared", "hot_start"])
def test_train_types_match_jax_reconstruction_error(train_type):
    # Lloyd's steps drift apart (an argmin near-tie moves a point), so the
    # trained quantizers are held by their mean squared reconstruction
    # error: within 2% of the JAX quantizer's
    data, _ = _clustered(n=1500)
    jq = jpq.ProductQuantizer(dim=D, num_subquantizers=4)
    pq = ProductQuantizer(dim=D, num_subquantizers=4, device="cpu")
    if train_type == "hot_start":
        jq.train(data, n_iters=2)
        pq.train(data, n_iters=2)
    jq.train(data, n_iters=8, train_type=train_type, seed=3)
    pq.train(data, n_iters=8, train_type=train_type, seed=3)
    assert pq.codebook.centroids.shape == (4, 256, D // 4)
    if train_type == "shared":
        assert torch.equal(pq.codebook.centroids[0], pq.codebook.centroids[3])

    def mse(q, asarray):
        return float(((asarray(q.decode(q.encode(data))) - data) ** 2).sum(1).mean())

    got, want = mse(pq, lambda t: t.numpy()), mse(jq, np.asarray)
    assert abs(got - want) <= 0.02 * want
    assert got < 0.9 * float((data ** 2).sum(1).mean())
    # re-encoding a decoded vector is a fixed point (test_pq_e2e.cpp)
    codes = pq.encode(data)
    assert (pq.encode(pq.decode(codes)) == codes).float().mean() > 0.999


# ------------------------------------------------------- ADC graph search
def test_pq_search_over_a_knn_graph_matches_jax(pair8):
    # ADC beam search over the same kNN graph and the same codes in both
    # packages: ids equal in >= 99% of rows; recall far above chance
    n, m, k = N, 16, 10
    data = torch.from_numpy(pair8.data)
    _, nbrs = brute_force_knn(data, data, m + 1)
    links = nbrs[:, 1:].contiguous()
    labels = torch.arange(n, dtype=torch.int32)
    res = pq_search(pair8.port, pair8.codes, links, labels, n, pair8.queries, k=k, ef=64)
    jres = jpq.pq_search(pair8.jax, jnp.asarray(pair8.jcodes), jnp.asarray(links.numpy()),
                         jnp.asarray(labels.numpy()), jnp.asarray(n, jnp.int32),
                         pair8.queries, k=k, ef=64)
    assert (res.labels.numpy() == np.asarray(jres.labels)).all(axis=1).mean() >= 0.99
    np.testing.assert_allclose(res.dists.numpy(), np.asarray(jres.dists), rtol=1e-4, atol=1e-4)
    _, gt = brute_force_knn(data, torch.from_numpy(pair8.queries), k)
    r = _recall(res.labels.numpy(), gt.numpy())
    assert r >= 0.4 and r > 50 * k / n
    assert res.dist_computations > 0 and res.hops > 0
