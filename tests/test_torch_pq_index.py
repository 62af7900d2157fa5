"""The port's PQ-coded index (flatnav_tpu_torch.quantization.pq_index)
against flatnav_tpu, on the CPU.

One codebook, trained by the JAX package, serves both. A JAX-built PQIndex
is carried over through its .npz file (`convert.pq_index_from_jax_npz`) and
searched by both packages on the identical graph; a port-built PQIndex over
the same data is held to the JAX-built one by recall and by its links.
Each comparison states its tolerance.
"""

import json

import numpy as np
import pytest
import torch

import flatnav_tpu.ops as jops
import flatnav_tpu.quantization as jq
from flatnav_tpu_torch import convert
from flatnav_tpu_torch.ops import MetricType, brute_force_knn
from flatnav_tpu_torch.quantization import PQIndex, ProductQuantizer
from flatnav_tpu_torch.quantization import pq_index as pq_index_mod
from flatnav_tpu_torch.quantization.pq_index import back_edge_commit_pq

N, D, M_PQ, M, EFC, K, EF = 2000, 32, 8, 16, 64, 10, 96


def _recall(found, truth):
    return sum(len(set(f.tolist()) & set(t.tolist())) for f, t in zip(found, truth)) / truth.size


def _clustered(n=N, nq=256, seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, D)).astype(np.float32) * 4
    data = centers[rng.integers(0, 64, n)] + 0.3 * rng.standard_normal((n, D)).astype(np.float32)
    queries = data[rng.choice(n, nq, replace=False)] + 0.05 * rng.standard_normal(
        (nq, D)).astype(np.float32)
    return data.astype(np.float32), queries.astype(np.float32)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A JAX-built PQIndex, the same file loaded by the port, and a
    port-built PQIndex over the same data and codebook."""
    data, queries = _clustered()
    jpq = jq.ProductQuantizer(dim=D, num_subquantizers=M_PQ).train(data[:1000], n_iters=10)
    jx = jq.PQIndex(jpq, dataset_size=N, max_edges_per_node=M)
    jx.add(data, ef_construction=EFC)
    path = str(tmp_path_factory.mktemp("pq") / "jax_pq.idx")
    jx.save(path)
    loaded = convert.pq_index_from_jax_npz(path, device="cpu")
    pq = convert.pq_from_jax_arrays(np.asarray(jpq.codebook.centroids), jpq.metric, device="cpu")
    px = PQIndex(pq, dataset_size=N, max_edges_per_node=M, collect_stats=True)
    px.add(data, ef_construction=EFC)
    _, gt = brute_force_knn(torch.from_numpy(data), torch.from_numpy(queries), K)
    return data, queries, jx, loaded, px, gt.numpy(), path


def test_jax_built_index_loads_bit_for_bit(built):
    _, _, jx, loaded, _, _, _ = built
    assert loaded.num_nodes == jx.num_nodes == N
    assert loaded.capacity == jx.capacity and loaded.max_edges_per_node == M
    assert loaded.device.type == "cpu" and loaded.pq.nbits == 8
    # the committed rows (the file holds no others), in the same padded layout
    assert loaded._codes.shape == jx._codes.shape and loaded._links.shape == jx._links.shape
    np.testing.assert_array_equal(loaded._codes[:N].numpy(), np.asarray(jx._codes[:N]))
    np.testing.assert_array_equal(loaded._links[:N].numpy(), np.asarray(jx._links[:N]))
    np.testing.assert_array_equal(loaded._labels[:N].numpy(), np.asarray(jx._labels[:N]))
    np.testing.assert_array_equal(loaded._links[N:].numpy(), np.asarray(jx._links[N:]))
    np.testing.assert_array_equal(
        loaded.pq.codebook.centroids.numpy(), np.asarray(jx.pq.codebook.centroids))
    assert loaded.index_memory_bytes() == jx.index_memory_bytes() == (M_PQ + 4 * M + 4) * N


def test_search_on_the_jax_built_graph_matches_jax(built):
    # same graph, same codes: ids equal in >= 99% of rows, distances of
    # those rows allclose(rtol=1e-4) (the ADC tables differ by float rounding)
    _, queries, jx, loaded, _, _, _ = built
    jd, jl = jx.search(queries, K=K, ef_search=EF)
    pd, pl = loaded.search(queries, K=K, ef_search=EF)
    assert pd.dtype == np.float32 and pl.dtype == np.int32 and pl.shape == (256, K)
    same = (pl == jl).all(axis=1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(pd[same], jd[same], rtol=1e-4, atol=1e-4)


def test_search_scan_on_the_jax_built_index_matches_jax(built):
    _, queries, jx, loaded, _, _, _ = built
    jd, jl = jx.search_scan(queries, K=K, rerank=64, tile_size=512)
    pd, pl = loaded.search_scan(queries, K=K, rerank=64, tile_size=512)
    # ids equal in >= 99% of the rows that hold no exact tie: nodes with one
    # code (2% of this table) share their ADC distance bit for bit, and the
    # port gives such ties to the lowest id, XLA's top-k in another order
    adc = loaded.pq.asymmetric_distances(queries, loaded._codes[:N]).numpy()
    tied = (np.isclose(adc[:, None, :], pd[:, :, None], rtol=1e-6, atol=0).sum(-1) > 1).any(axis=1)
    assert tied.mean() < 0.5
    assert (pl == jl).all(axis=1)[~tied].mean() >= 0.99
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-4)
    assert np.all(np.diff(pd, axis=1) >= 0)


def test_port_built_index_matches_the_jax_built_one(built):
    # recall@10 within 0.02; the build is deterministic and both packages
    # make the same prune decisions from the same codes, so the link rows
    # come out nearly identical too: 99.8% of the rows here (a near-tie of
    # two float distances moves the rest), held at >= 99%
    data, queries, jx, _, px, gt, _ = built
    assert px.num_nodes == N
    np.testing.assert_array_equal(px._codes[:N].numpy(), np.asarray(jx._codes[:N]))
    np.testing.assert_array_equal(px._labels[:N].numpy(), np.arange(N))
    _, jl = jx.search(queries, K=K, ef_search=EF)
    _, pl = px.search(queries, K=K, ef_search=EF)
    assert abs(_recall(pl, gt) - _recall(jl, gt)) <= 0.02
    same_rows = (px._links[:N].numpy() == np.asarray(jx._links[:N])).all(axis=1)
    assert same_rows.mean() >= 0.99


def test_pq_index_end_to_end_reaches_the_adc_ceiling(built):
    # the yardstick is the QUANTIZATION ceiling: recall of the exact
    # brute-force ADC ranking. The graph search must lose almost nothing on
    # top of what PQ itself loses, and the scan ranks every node by ADC.
    data, queries, _, _, px, gt, _ = built
    adc = px.pq.asymmetric_distances(queries, px.pq.encode(data)).numpy()
    ceiling = _recall(np.argsort(adc, axis=1, kind="stable")[:, :K], gt)
    assert ceiling > 0.3  # PQ itself must be sane on clustered data
    _, labels = px.search(queries, K=K, ef_search=EF)
    assert _recall(labels, gt) >= 0.9 * ceiling
    _, scan_labels = px.search_scan(queries, K=K, rerank=64)
    assert _recall(scan_labels, gt) >= 0.95 * ceiling
    assert px.index_memory_bytes() < D * 4 * N  # codes, not raw vectors


def test_port_build_is_bit_deterministic(built):
    data, _, _, _, px, _, _ = built
    again = PQIndex(px.pq, dataset_size=N, max_edges_per_node=M)
    again.add(data, ef_construction=EFC)
    assert torch.equal(again._links, px._links) and torch.equal(again._codes, px._codes)


def test_add_in_two_calls_and_in_narrow_waves(built):
    data, queries, _, _, px, gt, _ = built
    ix = PQIndex(px.pq, dataset_size=N, max_edges_per_node=M)
    ix.add(data[:700], ef_construction=EFC, max_wave=256)
    ix.add(data[700:], ef_construction=EFC, max_wave=10**6, labels=np.arange(700, N))
    assert ix.num_nodes == N
    ix.add(data[:0], ef_construction=EFC)  # nothing to add
    _, labels = ix.search(queries, K=K, ef_search=EF)
    _, ref = px.search(queries, K=K, ef_search=EF)
    assert abs(_recall(labels, gt) - _recall(ref, gt)) <= 0.05
    # the padded tail wave wrote nothing past the rows it owns
    assert int(ix._links[N:-1, 0].min()) >= N


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("nbits", [8, 4])
def test_save_load_between_packages(tmp_path, direction, nbits):
    data, queries = _clustered(n=600, nq=64)
    jpq = jq.ProductQuantizer(dim=D, num_subquantizers=M_PQ, nbits=nbits).train(
        data[:500], n_iters=5)
    # .bin, not .npz: save must honor the literal filename
    path = str(tmp_path / "pq_index.bin")
    if direction == "jax_to_port":
        src = jq.PQIndex(jpq, dataset_size=800, max_edges_per_node=8)
        src.add(data, ef_construction=32)
        src.save(path)
        dst = PQIndex.load(path, device="cpu")
    else:
        pq = convert.pq_from_jax_arrays(np.asarray(jpq.codebook.centroids), "l2", device="cpu")
        src = PQIndex(pq, dataset_size=800, max_edges_per_node=8)
        src.add(data, ef_construction=32)
        src.save(path)
        dst = jq.PQIndex.load(path)
    assert (tmp_path / "pq_index.bin").exists() and not (tmp_path / "pq_index.bin.npz").exists()
    assert dst.num_nodes == src.num_nodes == 600 and dst.capacity == 800
    assert dst.pq.nbits == nbits and dst.pq.num_centroids == 1 << nbits
    for name in ("_codes", "_links", "_labels"):
        np.testing.assert_array_equal(
            np.asarray(getattr(dst, name))[:600], np.asarray(getattr(src, name))[:600])
    # the same graph searched by both: distances allclose(rtol=1e-4), and
    # the same labels in >= 99% of the rows whose distances are distinct (a
    # table of 16 centroids a subspace gives many nodes one code, and each
    # package breaks such exact ties its own way)
    sd, sl = (np.asarray(a) for a in src.search(queries, K=5, ef_search=32))
    dd, dl = (np.asarray(a) for a in dst.search(queries, K=5, ef_search=32))
    np.testing.assert_allclose(sd, dd, rtol=1e-4, atol=1e-4)
    distinct = (np.diff(sd, axis=1) > 1e-4 * sd[:, 1:]).all(axis=1)
    if nbits == 8:  # at 4 bits every row holds a tie here
        assert distinct.sum() >= 40
        assert (sl == dl).all(axis=1)[distinct].mean() >= 0.99


def test_save_load_round_trip_is_identical_and_reads_legacy_files(built, tmp_path):
    _, queries, _, _, px, _, jax_path = built
    d0, l0 = px.search(queries, K=5, ef_search=32)
    path = str(tmp_path / "port_pq.idx")
    px.save(path)
    reloaded = PQIndex.load(path, device="cpu")
    d1, l1 = reloaded.search(queries, K=5, ef_search=32)
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_array_equal(d0, d1)
    with np.load(path) as z:  # the layout both packages read
        assert sorted(z.files) == ["centroids", "codes", "labels", "links", "meta", "metadata"]
        arrays = {k: z[k] for k in z.files}
        assert arrays["meta"].tolist() == [N, M, 0]
    # a legacy file carries only the positional `meta` array
    del arrays["metadata"]
    arrays["meta"] = np.asarray([N, M, 1])
    legacy = str(tmp_path / "legacy.idx")
    with open(legacy, "wb") as f:
        np.savez(f, **arrays)
    old = PQIndex.load(legacy, device="cpu")
    assert old.num_nodes == N and old.capacity == N and old.pq.metric == MetricType.IP
    # a newer format version is refused
    arrays["metadata"] = np.frombuffer(json.dumps({"format_version": 2}).encode(), dtype=np.uint8)
    with open(legacy, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ValueError, match="format version"):
        PQIndex.load(legacy, device="cpu")


def test_ip_metric_index_matches_jax(tmp_path):
    data, queries = _clustered(n=500, nq=64)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    jpq = jq.ProductQuantizer(dim=D, num_subquantizers=M_PQ, metric=jops.MetricType.IP).train(
        data, n_iters=5)
    jx = jq.PQIndex(jpq, dataset_size=500, max_edges_per_node=8)
    jx.add(data, ef_construction=32)
    path = str(tmp_path / "ip.idx")
    jx.save(path)
    px = PQIndex.load(path, device="cpu")
    assert px.pq.metric == MetricType.IP
    jd, jl = jx.search(queries, K=5, ef_search=32)
    pd, pl = px.search(queries, K=5, ef_search=32)
    same = (pl == jl).all(axis=1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(pd[same], jd[same], rtol=1e-4, atol=1e-5)


def test_counters_and_single_query(built):
    data, queries, _, _, px, _, _ = built
    assert px._build_stats["distance_computations"] > 0
    px.search(queries, K=K, ef_search=32)
    assert px.get_query_distance_computations() > 0
    assert px.get_query_distance_computations() == 0  # read-and-reset
    d1, l1 = px.search(queries[0], K=K, ef_search=32)  # a 1-D query
    d2, l2 = px.search(queries[:1], K=K, ef_search=32)
    np.testing.assert_array_equal(l1, l2)
    assert px.search_scan(queries[0], K=K)[1].shape == (1, K)


def test_fewer_nodes_than_k_pads_with_minus_one(built):
    data, queries, _, _, px, _, _ = built
    ix = PQIndex(px.pq, dataset_size=64, max_edges_per_node=4)
    ix.add(data[:3], ef_construction=8, labels=[7, 8, 9])
    for d, l in (ix.search(queries[:4], K=5, ef_search=8), ix.search_scan(queries[:4], K=5)):
        assert np.isinf(d[:, 3:]).all() and (l[:, 3:] == -1).all()
        assert sorted(l[0, :3].tolist()) == [7, 8, 9]


def test_errors(built, monkeypatch):
    data, _, _, _, px, _, _ = built
    with pytest.raises(RuntimeError, match="trained"):
        PQIndex(ProductQuantizer(dim=16, num_subquantizers=4, device="cpu"), 100, 8)
    ix = PQIndex(px.pq, dataset_size=1024, max_edges_per_node=8)
    with pytest.raises(ValueError, match="labels length"):
        ix.add(data[:100], ef_construction=16, labels=np.arange(5))
    with pytest.raises(RuntimeError, match="Maximum number of nodes reached."):
        ix.add(data[:1025], ef_construction=16)
    with pytest.raises(ValueError, match="lives with its quantizer"):
        PQIndex(px.pq, 100, 8, device="cuda" if torch.cuda.is_available() else "meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PQIndex.load(built[6])


def test_pq_back_edges_never_decode_full_table(monkeypatch):
    """Back-edge repair must decode only touched rows (O(T*(M+R)*d)
    scratch), never the whole code table: with a 500k-row table, every call
    of the decoder stays within the touched-rows budget."""
    rows, m_pq, nc, dsub, m, t, r = 500_000, 4, 256, 8, 8, 256, 8
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, nc, (rows, m_pq)).astype(np.uint8))
    centroids = torch.from_numpy(rng.standard_normal((m_pq, nc, dsub)).astype(np.float32))
    links = torch.arange(rows + 1, dtype=torch.int32)[:, None].repeat(1, m)
    targets = torch.full((t,), -1, dtype=torch.int32)
    targets[:200] = torch.from_numpy(rng.choice(rows, 200, replace=False).astype(np.int32))
    requesters = torch.from_numpy(rng.integers(0, rows, (t, r)).astype(np.int32))
    decoded_rows = []
    real_decode = pq_index_mod._decode

    def counting_decode(cents, c):
        decoded_rows.append(c.shape[0])
        return real_decode(cents, c)

    monkeypatch.setattr(pq_index_mod, "_decode", counting_decode)
    before = links.clone()
    back_edge_commit_pq(codes, centroids, links, targets, requesters, metric=MetricType.L2)
    assert decoded_rows and max(decoded_rows) <= t * (m + r)
    assert sum(decoded_rows) < rows // 10
    touched = targets[:200].long()
    assert not torch.equal(links[touched], before[touched])  # free slots took requesters
    untouched = torch.ones(rows + 1, dtype=torch.bool)
    untouched[touched] = False
    assert torch.equal(links[untouched][:-1], before[untouched][:-1])
