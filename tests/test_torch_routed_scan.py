"""The port's cluster-routed scan (flatnav_tpu_torch.ops.routed_scan)
against flatnav_tpu's, on the CPU; mirrors tests/test_routed_scan.py.

On a JAX-built layout carried across with
`convert.routed_scan_from_jax_arrays`, `routed_knn` must return the JAX
package's ids in >= 99% of the slots and its distances within 1e-4 (both
scan exactly in float32; the matmuls round in another order). On the port's
own build: the layout is a permutation, the full union equals the exact
oracle, pads are masked, padding queries do not vote, and results repeat.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flatnav_tpu.ops import MetricType as JMetric
from flatnav_tpu.ops import routed_scan as jrouted
from flatnav_tpu_torch import convert
from flatnav_tpu_torch.bench import profile_routed_scan
from flatnav_tpu_torch.bench.synth import clustered
from flatnav_tpu_torch.ops import MetricType, brute_force_knn, build_routed_scan, routed_knn
from flatnav_tpu_torch.ops import routed_scan as prouted


def _recall(found, truth):
    k = truth.shape[1]
    return np.mean([
        len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(found, truth)
    ])


def _carry(jrs):
    return convert.routed_scan_from_jax_arrays(
        np.asarray(jrs.vectors), np.asarray(jrs.ids), np.asarray(jrs.block_centroids),
        jrs.n, jrs.block, jrs.metric, device="cpu")


@pytest.fixture(scope="module")
def workload():
    # well-separated clusters: the regime routing is built for
    data, queries = clustered(3000, 32, 128, center_scale=4.0, query_noise=0.5)
    gt_d, gt_i = brute_force_knn(torch.from_numpy(data), torch.from_numpy(queries), 5)
    return data, queries, gt_d.numpy(), gt_i.numpy()


@pytest.fixture(scope="module")
def jax_rs(workload):
    return jrouted.build_routed_scan(workload[0], block=256)


@pytest.fixture(scope="module")
def rs(workload):
    return build_routed_scan(workload[0], block=256, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(probes=4, union_blocks=6),
    dict(probes=4, union_blocks=6, group_size=32),
    dict(probes=8, union_blocks=3, group_size=48),  # ragged: 128 = 2 * 48 + 32
    dict(union_blocks=64),  # every block
])
def test_carried_layout_matches_jax(workload, jax_rs, kw):
    _, queries, _, _ = workload
    carried = _carry(jax_rs)
    assert carried.metric == MetricType.L2 and carried.block == jax_rs.block
    jd, ji = jrouted.routed_knn(jax_rs, jnp.asarray(queries), 5, **kw)
    pd, pi = routed_knn(carried, torch.from_numpy(queries), 5, **kw)
    assert pd.shape == (128, 5) and pi.dtype == torch.int32
    assert (pi.numpy() == np.asarray(ji)).mean() >= 0.99
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)


def test_carried_layout_ip_metric_and_ragged_batch():
    data, queries = clustered(2000, 16, 50, center_scale=4.0, query_noise=0.5)
    data /= np.linalg.norm(data, axis=1, keepdims=True) + 1e-12
    queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-12
    jrs = jrouted.build_routed_scan(data, metric=JMetric.IP, block=256)
    carried = _carry(jrs)
    assert carried.metric == MetricType.IP
    nb = carried.block_centroids.shape[0]
    gt_d, gt_i = brute_force_knn(
        torch.from_numpy(data), torch.from_numpy(queries), 5, MetricType.IP)
    for union in (nb, 3):
        jd, ji = jrouted.routed_knn(jrs, jnp.asarray(queries), 5, probes=4,
                                    union_blocks=union, group_size=32)
        pd, pi = routed_knn(carried, torch.from_numpy(queries), 5, probes=4,
                            union_blocks=union, group_size=32)
        assert pd.shape == (50, 5)
        assert (pi.numpy() == np.asarray(ji)).mean() >= 0.99
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    # the port's own IP build, full union: the exact oracle
    own = build_routed_scan(data, metric=MetricType.IP, block=256, device="cpu")
    dd, ii = routed_knn(own, torch.from_numpy(queries), 5, union_blocks=nb, group_size=32)
    np.testing.assert_allclose(dd.numpy(), gt_d.numpy(), rtol=1e-4, atol=1e-4)
    assert _recall(ii.numpy(), gt_i.numpy()) == 1.0


def test_convert_rejects_a_layout_that_is_not_whole_blocks(jax_rs):
    with pytest.raises(ValueError, match="blocks"):
        convert.routed_scan_from_jax_arrays(
            np.asarray(jax_rs.vectors)[:-1], np.asarray(jax_rs.ids)[:-1],
            np.asarray(jax_rs.block_centroids), jax_rs.n, jax_rs.block, "l2", device="cpu")


def test_full_union_matches_exact_oracle(workload, rs):
    _, queries, gt_d, gt_i = workload
    nb = rs.block_centroids.shape[0]
    dd, ii = routed_knn(rs, torch.from_numpy(queries), 5, union_blocks=nb)
    np.testing.assert_allclose(dd.numpy(), gt_d, rtol=1e-4, atol=1e-4)
    assert _recall(ii.numpy(), gt_i) == 1.0


def test_layout_is_a_permutation(workload, rs, jax_rs):
    data = workload[0]
    ids = rs.ids.numpy()
    real = ids[ids >= 0]
    assert len(real) == rs.n and len(set(real.tolist())) == rs.n
    # each real slot holds its original row's vector
    np.testing.assert_array_equal(rs.vectors.numpy()[ids >= 0], data[real])
    assert rs.vectors.shape[0] == rs.block_centroids.shape[0] * rs.block
    # the same shape of layout as the JAX build's, and centroids that are
    # the means of their cells
    assert rs.block == jax_rs.block and rs.ids.shape == jax_rs.ids.shape
    cell0 = rs.vectors.numpy()[: rs.block][ids[: rs.block] >= 0]
    np.testing.assert_allclose(rs.block_centroids.numpy()[0], cell0.mean(0), rtol=1e-5, atol=1e-6)


def test_pruned_recall_on_separated_clusters(workload, rs):
    _, queries, _, gt_i = workload
    nb = rs.block_centroids.shape[0]
    _, ii = routed_knn(rs, torch.from_numpy(queries), 5, probes=4,
                       union_blocks=nb // 2, group_size=32)
    assert bool((ii >= 0).all())
    assert _recall(ii.numpy(), gt_i) >= 0.9


def test_deterministic(workload, rs):
    q = torch.from_numpy(workload[1])
    a = routed_knn(rs, q, 5, probes=4, union_blocks=6)
    b = routed_knn(rs, q, 5, probes=4, union_blocks=6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_batch_padding_does_not_vote(workload, rs):
    _, queries, _, _ = workload
    nb = rs.block_centroids.shape[0]
    qs = queries[:20]
    rng = np.random.default_rng(11)
    pads = [
        np.tile(qs[:1], (12, 1)),
        rng.standard_normal((12, qs.shape[1])).astype(np.float32) * 10,
    ]
    outs = [
        prouted._routed_knn_padded(
            rs.vectors, rs.ids, rs.block_centroids,
            torch.from_numpy(np.concatenate([qs, pad])),
            k=5, metric=rs.metric, block=rs.block, probes=4,
            union=max(2, nb // 3), group=32, b_in=20,
        )
        for pad in pads
    ]
    assert torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][0], outs[1][0])


def test_union_breaks_vote_ties_to_the_lowest_block(rs):
    # identical queries vote for the same blocks with the same weights, so
    # blocks past their probe list tie at 0 votes: the union takes the
    # lowest block ids among them, every time
    q = torch.from_numpy(np.tile(np.linspace(-1, 1, 32, dtype=np.float32), (16, 1)))
    nb = rs.block_centroids.shape[0]
    d1, i1 = routed_knn(rs, q, 5, probes=2, union_blocks=nb - 1, group_size=16)
    d2, i2 = routed_knn(rs, q, 5, probes=2, union_blocks=nb - 1, group_size=16)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    assert bool((i1 == i1[0]).all())


def test_balanced_assign_equals_jax(rng):
    n, nb, t, cap = 700, 12, 5, 64
    cand_d = np.sort(rng.random((n, t)).astype(np.float32), axis=1)
    cand_d[::7, 0] = cand_d[3, 0]  # ties in the visiting order
    # skewed towards a few cells, so capacity bites and rows fall through
    cand_ids = np.stack([rng.permutation(nb)[:t] for _ in range(n)])
    cand_ids[: n // 2, 0] = 0
    want = jrouted._balanced_assign(cand_ids, cand_d, nb, cap)
    got = prouted._balanced_assign(cand_ids, cand_d, nb, cap)
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got, minlength=nb).max() <= cap
    # every candidate list full: the emptiest cell takes the row
    tiny = prouted._balanced_assign(np.zeros((5, 1), np.int64), np.zeros((5, 1)), 3, 2)
    np.testing.assert_array_equal(tiny, jrouted._balanced_assign(
        np.zeros((5, 1), np.int64), np.zeros((5, 1)), 3, 2))


def test_entry_points_default_to_the_card(workload, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_routed_scan(workload[0][:300], block=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_routed_scan.main(["--n", "300"])


def test_profile_tool_runs_on_the_cpu(capsys):
    profile_routed_scan.main(["--n", "6000", "--dim", "32", "--num-queries", "128",
                              "--block", "128", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_blocks"] == 47 and out["device"] == "cpu"
    assert out["full_union_recall"] == 1.0
    ceilings = [r["recall_ceiling"] for r in out["routing_ceiling"]]
    assert ceilings == sorted(ceilings) and ceilings[-1] > 0.9
    assert [(r["probes"], r["union"], r["group"]) for r in out["end_to_end"]] == list(
        profile_routed_scan.SETTINGS)
    for row, cap in zip(out["end_to_end"], out["union_capture"]):
        assert 0 < row["recall"] <= 1 and 0 < cap["probe_capture"] <= 1
        assert row["routed_knn_ms"] is None  # a CPU time is not a device time
    assert out["fast_knn_ms"] is None and out["fast_knn_recall"] >= 0.99
