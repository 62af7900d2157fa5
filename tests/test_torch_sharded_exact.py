"""The port's model-sharded exact / fast / fused scans
(flatnav_tpu_torch.parallel.sharded_exact_search) on gloo ranks on the CPU.

One spawn of four ranks a mesh shape runs every case. The exact scan is
held to the single-device `brute_force_knn` (ids exactly, distances within
1e-5); every engine is held exactly to `shards_on_one_device`, the same
engine run shard by shard on one device and merged; and to flatnav_tpu's
`sharded_exact_search` on the same mesh shape: >= 99% of rows identical on
float tables, every row on 8-bit tables. The two-phase engines take a
shortlist on every shard, so they can only gain on one device's result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flatnav_tpu.ops import MetricType as JMetric
from flatnav_tpu.ops import brute_force_knn as jax_brute_force
from flatnav_tpu.parallel import make_mesh as jax_make_mesh
from flatnav_tpu.parallel import sharded_exact_search as jax_sharded_exact
from flatnav_tpu_torch.ops import MetricType, brute_force_knn, fast_knn, fused_knn
from flatnav_tpu_torch.parallel import run_ranks
from flatnav_tpu_torch.parallel.dryrun import run_cases
from flatnav_tpu_torch.parallel.sharded_exact import shards_on_one_device

SHAPES = [(1, 4), (2, 2), (4, 1)]


def _recall(found, truth):
    return float(np.mean([len(set(a) & set(b)) / truth.shape[1] for a, b in zip(found, truth)]))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0x5E)
    n, d, b = 4096, 32, 64
    vec = rng.standard_normal((n, d), dtype=np.float32)
    q = rng.standard_normal((b, d), dtype=np.float32)
    part = np.random.default_rng(0x5F).standard_normal((n, 16)).astype(np.float32)
    part[1500:] *= 1e-3  # would dominate near-zero queries if leaked
    q_zero = np.zeros((32, 16), np.float32)
    odd = vec[:4090]  # rows divide by neither 3 nor 4: the last shard pads
    u8 = rng.integers(0, 256, (2048, 16)).astype(np.uint8)
    q8 = rng.integers(0, 256, (b, 16)).astype(np.uint8)
    cases = {
        # name: (table, num_nodes, queries, options)
        "l2": (vec, n, q, dict(k=10, tile_size=1024)),
        "ip": (vec, n, q, dict(k=10, metric=MetricType.IP, tile_size=1024)),
        "part": (part, 1500, q_zero, dict(k=5, tile_size=512)),
        "odd": (odd, 4090, q, dict(k=10, tile_size=1024)),
        "u8": (u8, 2048, q8, dict(k=10, tile_size=512)),
        "fast": (vec, n, q, dict(k=10, rerank=32, tile_size=2048)),
        "fused": (vec, n, q, dict(k=10, rerank=32, fused=True)),
        "fused_part": (vec, 2500, q, dict(k=10, rerank=32, fused=True)),
        "fused_u8": (u8, 2048, q8, dict(k=10, rerank=32, fused=True)),
    }
    return cases


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def shape(request):
    return request.param


@pytest.fixture(scope="module")
def ranks(inputs, shape):
    names = list(inputs)
    cases = [{"op": "exact", "args": {"vectors": t, "num_nodes": nn, "queries": q, **kw}}
             for t, nn, q, kw in (inputs[n] for n in names)]
    out = run_ranks(run_cases, 4, backend="gloo", device="cpu", timeout=300, args=(cases, *shape, "cpu"))
    return dict(zip(names, out))


def _engine(kw):
    kw = dict(kw)
    k, metric = kw.pop("k"), kw.pop("metric", MetricType.L2)
    if kw.pop("fused", False):
        kw.pop("tile_size", None)
        return lambda t, q, nv: fused_knn(t, q, k, metric, n_valid=nv, **kw)
    if kw.get("rerank"):
        return lambda t, q, nv: fast_knn(t, q, k, metric, n_valid=nv, **kw)
    return lambda t, q, nv: brute_force_knn(t, q, k, metric, n_valid=nv, **kw)


def _single(inputs, name):
    t, nn, q, kw = inputs[name]
    return _engine(kw)(torch.from_numpy(t), torch.from_numpy(q), nn)


@pytest.mark.parametrize("name", ["l2", "ip", "part", "odd", "u8"])
def test_sharded_exact_equals_single_device(ranks, inputs, name):
    d, i = _single(inputs, name)
    np.testing.assert_array_equal(ranks[name]["ids"], i.numpy())
    np.testing.assert_allclose(ranks[name]["dists"], d.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["l2", "ip", "part", "odd", "u8", "fast", "fused", "fused_part", "fused_u8"])
def test_every_engine_equals_its_shards_on_one_device(ranks, inputs, shape, name):
    t, nn, q, kw = inputs[name]
    scan = _engine(kw)
    qt = torch.from_numpy(q)
    d, i = shards_on_one_device(lambda rows, nv: scan(rows, qt, nv), torch.from_numpy(t), nn, shape[1], kw["k"])
    np.testing.assert_array_equal(ranks[name]["ids"], i.numpy())
    np.testing.assert_array_equal(ranks[name]["dists"], d.numpy())


def test_sharded_fast_equals_single_device(ranks, inputs):
    np.testing.assert_array_equal(ranks["fast"]["ids"], _single(inputs, "fast")[1].numpy())


@pytest.mark.parametrize("name", ["fused", "fused_part"])
def test_sharded_fused_recall_at_least_single_device(ranks, inputs, name):
    t, nn, q, _ = inputs[name]
    _, truth = brute_force_knn(torch.from_numpy(t), torch.from_numpy(q), 10, n_valid=nn)
    single = _single(inputs, name)[1].numpy()
    got = ranks[name]["ids"]
    assert _recall(got, truth.numpy()) >= max(0.97, _recall(single, truth.numpy()) - 1e-9)
    assert (got < nn).all()


def test_partial_prefix_excludes_uncommitted_rows(ranks):
    assert (ranks["part"]["ids"] < 1500).all()
    assert (ranks["fused_part"]["ids"] < 2500).all()


def test_fused_scan_launch_rows(ranks):
    # every rank reports its launches; the CPU runs the plain versions
    assert ranks["fused"]["launches"].shape == (4, 2)


#: cases held against flatnav_tpu's sharded scan on each shape (its compiles,
#: the fused scan's Pallas interpreter above all, dominate this file's time)
JAX_CASES = {(1, 4): ("l2", "ip", "part", "u8", "fused"), (2, 2): ("l2", "fast"), (4, 1): ("l2", "u8")}


def test_sharded_scan_matches_jax_sharded(ranks, inputs, shape):
    mesh = jax_make_mesh(n_devices=4, data=shape[0], model=shape[1])
    for name in JAX_CASES[shape]:
        t, nn, q, kw = inputs[name]
        kw = dict(kw)
        if "metric" in kw:
            kw["metric"] = JMetric(kw["metric"].value)
        jd, ji = jax_sharded_exact(jnp.asarray(t), jnp.asarray(nn, jnp.int32), jnp.asarray(q), mesh, **kw)
        got = ranks[name]
        if t.dtype == np.uint8:
            np.testing.assert_array_equal(got["ids"], np.asarray(ji))
            np.testing.assert_array_equal(got["dists"], np.asarray(jd))
            continue
        same = (got["ids"] == np.asarray(ji)).all(axis=1)
        assert same.mean() >= 0.99, name
        np.testing.assert_allclose(got["dists"][same], np.asarray(jd)[same], rtol=1e-5, atol=1e-5)


def test_odd_rows_match_jax_single_device(ranks, inputs):
    # the JAX sharded scan needs rows that divide by the model axis; the
    # port pads a shard, which must change nothing
    t, nn, q, kw = inputs["odd"]
    _, ji = jax_brute_force(jnp.asarray(t), jnp.asarray(q), 10, JMetric.L2, tile_size=1024)
    assert (ranks["odd"]["ids"] == np.asarray(ji)).all(axis=1).mean() >= 0.99
