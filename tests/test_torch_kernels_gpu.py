"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode). The file imports neither JAX nor flatnav_tpu, so on a machine
with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q

K2 and 8-bit K1 must be bit-equal to the plain version. bf16 K1 sums its
products in another order than cuBLAS, so its minima agree within 1e-5 of
the largest key magnitude and its ids on >= 99% of buckets. K1 has two
variants chosen by shape ("wgmma" and "mma"); each case states which one
it must take.

The product-quantized index and the graph reordering hold no kernel of their
own; their cases run the same call on the card and with device="cpu" at a
small size and hold the two together, at the tolerances of the CPU tests
against the JAX package.
"""

import numpy as np
import pytest
import torch

import flatnav_tpu_torch
from flatnav_tpu_torch.ops.distances import MetricType, brute_force_knn, squared_norms
from flatnav_tpu_torch.ops.fused_scan import scan_buckets, scan_buckets_plain
from flatnav_tpu_torch.ops.gather_distance import gather_distances, gather_distances_plain
from flatnav_tpu_torch.quantization import PQIndex, ProductQuantizer, pack_codes_4bit, pack_codes_lanes
from flatnav_tpu_torch.quantization.pq import PQCodebook, pq_scan_knn

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0xF1A7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("d", [7, 37, 128, 960])
def test_gather_distances_bit_equal(cuda, rng, d, metric, dtype):
    n, b, c = 2000, 37, 129  # ragged B x C
    v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda, dtype)
    i = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    before = gather_distances.launches
    got = gather_distances(v, i, q, metric)
    assert gather_distances.launches == before + 1
    assert torch.equal(got, gather_distances_plain(v, i, q, metric))


K2_DS = [1, 7, 31, 32, 33, 64, 128, 129, 130, 960, 1024, 2048, 3072, 4096]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", K2_DS)
def test_gather_distances_register_tree(cuda, rng, d, dtype):
    # every width class of the register tree: shuffles only (p <= 32), 1 to
    # 32 in-lane levels, and p = 4096 with its top level folded into the
    # loads; 16-bit rows of even d take the paired 4-byte loads. L2 on even
    # d, IP on odd
    metric = MetricType.L2 if d % 2 == 0 else MetricType.IP
    n, b, c = 3000, 19, 300
    v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda, dtype)
    i = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    assert torch.equal(gather_distances(v, i, q, metric), gather_distances_plain(v, i, q, metric))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 130])
def test_gather_distances_unaligned_16bit_table(cuda, rng, d, dtype):
    # a table view one element into its storage is 2-byte aligned: the
    # kernel must read it element by element, not in 4-byte pairs
    n, b, c = 3000, 9, 257
    full = torch.from_numpy(rng.standard_normal((n * d + 1,), dtype=np.float32)).to(cuda, dtype)
    v = full[1:].view(n, d)
    assert v.data_ptr() % 4 == 2
    i = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    assert torch.equal(gather_distances(v, i, q), gather_distances_plain(v, i, q))


@pytest.mark.parametrize("d", [7, 128, 960])
def test_gather_distances_out_of_range_ids_are_nan(cuda, rng, d):
    n, b, c = 500, 8, 200
    v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda)
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    bad = rng.random((b, c)) < 0.2
    ids[bad] = rng.choice(np.array([-1, -7, n, n + 3, 2**31 - 1], np.int32), int(bad.sum()))
    i = torch.from_numpy(ids).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    got = gather_distances(v, i, q)
    bad_t = torch.from_numpy(bad).to(cuda)
    assert bool(torch.isnan(got[bad_t]).all())
    want = gather_distances_plain(v, i.clamp(0, n - 1), q)
    assert torch.equal(got[~bad_t], want[~bad_t])


@pytest.mark.parametrize("c", [1024, 1021, 1000])
def test_gather_distances_build_wave_width(cuda, rng, c):
    # C = 1024 as in a build wave, and C with a tail of rows per warp
    n, b, d = 4000, 64, 128
    v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda)
    i = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    assert torch.equal(gather_distances(v, i, q), gather_distances_plain(v, i, q))


def _scan_case(rng, cuda, n, d, qc, dtype):
    if dtype == torch.bfloat16:
        rows = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda, dtype)
        q = torch.from_numpy(rng.standard_normal((qc, d)).astype(np.float32)).to(cuda, dtype)
    else:
        lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
        rows = torch.from_numpy(rng.integers(lo, hi, (n, d)).astype(np.int16)).to(cuda, dtype)
        q = torch.from_numpy(rng.integers(lo, hi, (qc, d)).astype(np.float32)).to(cuda, torch.bfloat16)
    return rows, q


def _check_scan(q, rows, pen, nlim, t, L, variant):
    before = scan_buckets.launches, scan_buckets.variants[variant]
    kmin, kid = scan_buckets(q, rows, pen, nlim, t, L)
    assert (scan_buckets.launches, scan_buckets.variants[variant]) == (before[0] + 1, before[1] + 1)
    pmin, pid = scan_buckets_plain(q, rows, pen, nlim, t, L)
    if rows.dtype != torch.bfloat16:
        assert torch.equal(kmin, pmin) and torch.equal(kid, pid)
    else:
        fin = torch.isfinite(pmin)
        assert torch.equal(fin, torch.isfinite(kmin))
        tol = 1e-5 * float(pmin[fin].abs().max())
        assert float((kmin[fin] - pmin[fin]).abs().max()) <= tol
        assert float((kid == pid).float().mean()) >= 0.99


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.bfloat16])
@pytest.mark.parametrize("d", [37, 128])
def test_scan_buckets_matches_plain(cuda, rng, d, dtype, metric):
    n, nlim, qc, t, L = 10000, 9000, 100, 2048, 16  # n not a multiple of t
    rows, q = _scan_case(rng, cuda, n, d, qc, dtype)
    pen = squared_norms(rows) if metric == MetricType.L2 else torch.zeros(n, device=cuda)
    variant = "wgmma" if dtype == torch.bfloat16 and d == 128 else "mma"
    _check_scan(q, rows, pen, nlim, t, L, variant)


@pytest.mark.parametrize("t,L", [(2048, 16), (2048, 4), (4096, 32), (1024, 1), (1536, 3)])
@pytest.mark.parametrize("d", [64, 128, 256, 384])
def test_scan_buckets_wgmma_shapes(cuda, rng, d, t, L):
    # n not a multiple of T, n_valid < N, a query count that is not a
    # multiple of the block's 128, and S = T/L of 1-4 bucket blocks
    n, nlim, qc = 13_000, 12_345, 300
    rows, q = _scan_case(rng, cuda, n, d, qc, torch.bfloat16)
    _check_scan(q, rows, squared_norms(rows), nlim, t, L, "wgmma")


@pytest.mark.parametrize("d", [40, 56, 392])
def test_scan_buckets_other_bf16_widths_take_mma(cuda, rng, d):
    n, nlim, qc, t, L = 5000, 4900, 70, 2048, 16
    rows, q = _scan_case(rng, cuda, n, d, qc, torch.bfloat16)
    _check_scan(q, rows, squared_norms(rows), nlim, t, L, "mma")


def test_lifecycle_on_card(cuda, tmp_path):
    rng = np.random.default_rng(11)
    data = rng.standard_normal((3000, 32), dtype=np.float32)
    q = rng.standard_normal((64, 32), dtype=np.float32)
    g0, s0 = gather_distances.launches, scan_buckets.launches
    ix = flatnav_tpu_torch.index.create("l2", 32, 3000, 16)
    assert ix.device.type == "cuda"
    ix.add(data, ef_construction=64)
    d1, l1 = ix.search(q, K=10, ef_search=64)
    ix.search_exact(q, K=10, rerank=32)
    assert gather_distances.launches > g0 and scan_buckets.launches > s0
    ix.save(str(tmp_path / "g.npz"))
    d2, l2 = flatnav_tpu_torch.index.load_index(str(tmp_path / "g.npz")).search(q, 10, 64)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(d1, d2)


def _clustered(n, d, nq, seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32)
    data = centers[rng.integers(0, 64, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    queries = data[rng.choice(n, nq, replace=False)] + 0.05 * rng.standard_normal(
        (nq, d)).astype(np.float32)
    return data.astype(np.float32), queries.astype(np.float32)


def _quantizers(nbits, data, cuda):
    """One codebook, trained on the CPU, on both devices."""
    cpu = ProductQuantizer(dim=32, num_subquantizers=8, nbits=nbits, device="cpu").train(
        data[:1000], n_iters=8)
    card = ProductQuantizer(dim=32, num_subquantizers=8, nbits=nbits, device=cuda)
    card.codebook = PQCodebook(cpu.codebook.centroids.to(cuda))
    return cpu, card


def test_pq_train_on_card_matches_cpu(cuda):
    # Lloyd's steps drift, so the quantizers are held by reconstruction
    # error: within 2%; codes from one codebook identical in >= 99.9%
    data, _ = _clustered(3000, 32, 8)
    cpu, card = _quantizers(8, data, cuda)
    trained = ProductQuantizer(dim=32, num_subquantizers=8).train(data[:1000], n_iters=8)
    assert trained.device.type == "cuda" and trained.codebook.centroids.is_cuda
    mse = lambda q: float(((q.decode(q.encode(data)).cpu().numpy() - data) ** 2).sum(1).mean())
    assert abs(mse(trained) - mse(cpu)) <= 0.02 * mse(cpu)
    assert (card.encode(data).cpu() == cpu.encode(data)).float().mean() >= 0.999
    np.testing.assert_allclose(card.adc_tables(data[:8]).cpu().numpy(),
                               cpu.adc_tables(data[:8]).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["adc", "raw", "packed_4bit", "lane_packed", "n_valid"])
def test_pq_scan_on_card_matches_cpu(cuda, mode):
    # the card's bf16 product with float32 output against the CPU's float32
    # matmul of the same rounded operands: ids equal in >= 99% of slots
    # (exact ties of the ADC rerank exempt), distances allclose(rtol=1e-4)
    n = 3000 if mode != "lane_packed" else 2917
    data, queries = _clustered(n, 32, 32)
    cpu, card = _quantizers(4 if mode == "packed_4bit" else 8, data, cuda)
    codes = cpu.encode(data)
    tables = cpu.adc_tables(queries)
    kw = dict(tile_size=512, rerank=64)
    if mode == "packed_4bit":
        codes, kw["packed_4bit"] = pack_codes_4bit(codes), True
    if mode == "lane_packed":
        codes = torch.from_numpy(pack_codes_lanes(codes.numpy(), tile=512)[0])
        kw.update(lane_packed=True, n_valid=n)
    if mode == "n_valid":
        kw["n_valid"] = 700
    raw = {}
    if mode == "raw":
        raw = dict(vectors=torch.from_numpy(data), queries=torch.from_numpy(queries))
    launches = gather_distances.launches
    cd, ci = pq_scan_knn(codes, tables, 10, **kw, **raw)
    gd, gi = pq_scan_knn(codes.to(cuda), tables.to(cuda), 10, **kw,
                         **{k: v.to(cuda) for k, v in raw.items()})
    assert gd.is_cuda and gather_distances.launches == launches + (mode == "raw")
    gd, gi = gd.cpu(), gi.cpu()
    np.testing.assert_allclose(gd.numpy(), cd.numpy(), rtol=1e-4, atol=1e-5)
    tied = torch.zeros_like(ci, dtype=torch.bool)
    tied[:, 1:] |= cd[:, 1:] == cd[:, :-1]
    tied[:, :-1] |= cd[:, :-1] == cd[:, 1:]
    tied[:, -1] |= mode != "raw"  # the last slot may tie with the one cut off
    assert float(((gi == ci) | tied).float().mean()) >= 0.99
    assert int(gi.max()) < kw.get("n_valid", n)


def test_pq_index_on_card_matches_cpu(cuda, tmp_path):
    data, queries = _clustered(3000, 32, 128)
    cpu, card = _quantizers(8, data, cuda)
    ix = PQIndex(cpu, dataset_size=3000, max_edges_per_node=16)
    ix.add(data, ef_construction=64)
    path = str(tmp_path / "pq.idx")
    ix.save(path)
    on_card = PQIndex.load(path)  # the card is the default
    assert on_card.device.type == "cuda" and on_card._codes.is_cuda
    # the same graph searched on both devices: ids equal in >= 99% of rows
    cd, cl = ix.search(queries, K=10, ef_search=96)
    gd, gl = on_card.search(queries, K=10, ef_search=96)
    same = (cl == gl).all(axis=1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(gd[same], cd[same], rtol=1e-4, atol=1e-5)
    sd, sl = ix.search_scan(queries, K=10, rerank=64, tile_size=512)
    td, tl = on_card.search_scan(queries, K=10, rerank=64, tile_size=512)
    np.testing.assert_allclose(td, sd, rtol=1e-4, atol=1e-5)
    # built on the card from the same codebook: recall@10 within 0.02
    built = PQIndex(card, dataset_size=3000, max_edges_per_node=16)
    built.add(data, ef_construction=64)
    assert built.num_nodes == 3000 and built._links.is_cuda
    _, gt = brute_force_knn(torch.from_numpy(data), torch.from_numpy(queries), 10)
    recall = lambda l: sum(len(set(a.tolist()) & set(b.tolist()))
                           for a, b in zip(l, gt.numpy())) / gt.numel()
    _, bl = built.search(queries, K=10, ef_search=96)
    assert abs(recall(bl) - recall(cl)) <= 0.02


def test_reorder_and_import_on_card_match_cpu(cuda, tmp_path):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((2000, 32), dtype=np.float32)
    q = rng.standard_normal((64, 32), dtype=np.float32)
    cpu_ix = flatnav_tpu_torch.index.create("l2", 32, 2000, 16, device="cpu")
    cpu_ix.add(data, ef_construction=64)
    path = str(tmp_path / "g.npz")
    cpu_ix.save(path)
    card_ix = flatnav_tpu_torch.index.load_index(path)
    assert card_ix.device.type == "cuda"
    for ix in (cpu_ix, card_ix):
        ix.reorder(["gorder", "rcm"])
    # the relabel runs on each index's device and gives the same committed
    # rows (past them a built index keeps its last wave's padding lanes, a
    # loaded one zeros)
    for a, b in zip((cpu_ix.graph.vectors, cpu_ix.graph.links, cpu_ix.graph.labels),
                    (card_ix.graph.vectors, card_ix.graph.links, card_ix.graph.labels)):
        assert torch.equal(a[:2000], b[:2000].cpu())
    launches = gather_distances.launches
    gd, gl = card_ix.search(q, K=10, ef_search=64)
    assert gather_distances.launches > launches  # the reordered search runs K2
    cd, cl = cpu_ix.search(q, K=10, ef_search=64)
    assert (gl == cl).all(axis=1).mean() >= 0.99
    # MatrixMarket import on the card
    links = card_ix.graph.links[:2000].cpu().numpy()
    mtx = tmp_path / "g.mtx"
    with open(mtx, "w") as f:
        edges = [(i, v) for i, row in enumerate(links) for v in row if v != i]
        f.write(f"%%MatrixMarket matrix coordinate pattern general\n2000 2000 {len(edges)}\n")
        f.writelines(f"{a + 1} {b + 1}\n" for a, b in edges)
    fresh = flatnav_tpu_torch.index.create("l2", 32, 2000, 16)
    fresh.allocate_nodes(card_ix.graph.vectors[:2000].cpu().numpy(),
                         card_ix.graph.labels[:2000].cpu().numpy())
    fresh.build_graph_links(str(mtx))
    assert torch.equal(fresh.graph.links, card_ix.graph.links)
    fd, fl = fresh.search(q, K=10, ef_search=64)
    np.testing.assert_array_equal(fl, gl)
    np.testing.assert_array_equal(fd, gd)


# ---------------------------------------------------------------------------
# the search options, the harness, the headline entry and the routed scan
# ---------------------------------------------------------------------------


def _small_index(device, n=3000, d=32, m=16, nq=128):
    rng = np.random.default_rng(9)
    data = rng.standard_normal((n, d), dtype=np.float32)
    q = rng.standard_normal((nq, d), dtype=np.float32)
    ix = flatnav_tpu_torch.index.create("l2", d, n, m, device=device)
    ix.add(data, ef_construction=64)
    return ix, data, q


@pytest.mark.parametrize("cw", [24, 32, 100])
def test_gather_distances_at_compact_width(cuda, cw, monkeypatch):
    # K2 is launched at C = compact_width and is bit-equal to its plain
    # version there; the search agrees with the same search on the CPU
    from flatnav_tpu_torch.index import search as search_mod
    from flatnav_tpu_torch.index.search import batched_search

    ix, _, q = _small_index("cpu")
    g = ix.graph
    calls = []

    def spy(vectors, ids, queries, metric):
        got = gather_distances(vectors, ids, queries, metric)
        calls.append(ids.shape[1])
        assert torch.equal(got, gather_distances_plain(vectors, ids, queries, metric))
        return got

    monkeypatch.setattr(search_mod, "gather_distances", spy)
    kw = dict(k=10, ef=32, expand_factor=8, compact_width=cw, m_search=12)
    before = gather_distances.launches
    card = batched_search(g.vectors.cuda(), g.links.cuda(), g.labels.cuda(), g.num_nodes,
                          torch.from_numpy(q).cuda(), **kw)
    assert set(calls) == {min(cw, 8 * 12)} and gather_distances.launches == before + len(calls)
    monkeypatch.undo()
    cpu = batched_search(g.vectors, g.links, g.labels, g.num_nodes, torch.from_numpy(q), **kw)
    same = (card.labels.cpu() == cpu.labels).all(dim=1)
    assert float(same.float().mean()) >= 0.99
    assert torch.allclose(card.dists.cpu()[same], cpu.dists[same], rtol=1e-5)


def test_m_search_view_gathers_without_a_table_copy(cuda):
    links = torch.arange(2_000_000 * 32, dtype=torch.int32, device=cuda).view(-1, 32)
    rows = torch.randint(0, links.shape[0], (4096,), device=cuda)
    view = links[:, :16]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = view[rows]
    torch.cuda.synchronize()
    # the gather allocates its [4096, 16] result, not a copy of the 128 MB view
    assert torch.cuda.max_memory_allocated() - base < 4 * 1024 * 1024
    assert torch.equal(got, links[rows][:, :16])


def test_graph_entry_points_land_on_the_card(cuda, tmp_path):
    from flatnav_tpu_torch.index import graph as graph_mod
    from flatnav_tpu_torch.index import serialize

    g = graph_mod.make_empty_graph(10, 8, 4)
    assert g.vectors.is_cuda and g.links.is_cuda
    g = graph_mod.graph_from_numpy(np.ones((5, 8), np.float32),
                                   np.zeros((5, 4), np.int32))
    assert g.vectors.is_cuda
    path = str(tmp_path / "g.npz")
    serialize.save_index(path, g, MetricType.L2)
    assert serialize.load_index(path)[0].vectors.is_cuda


@pytest.mark.parametrize("index_type,min_recall", [
    ("flatnav", 0.9), ("flatnav-fused", 0.98), ("flatnav-fusednr", 0.95),
    ("flatnav-exact", 1.0), ("flatnav-fast", 0.98), ("flatnav-pq-scan", 0.9),
])
def test_harness_on_card(cuda, tmp_path, index_type, min_recall):
    from flatnav_tpu_torch.bench import run_benchmark

    rng = np.random.default_rng(1)
    train = rng.standard_normal((3000, 32)).astype(np.float32)
    queries = rng.standard_normal((100, 32)).astype(np.float32)
    _, gt = brute_force_knn(torch.from_numpy(train), torch.from_numpy(queries), 10)
    for name, arr in (("train", train), ("queries", queries), ("gt", gt.numpy())):
        np.save(tmp_path / f"{name}.npy", arr)
    k1, k2 = scan_buckets.launches, gather_distances.launches
    rows = run_benchmark.main([
        "--dataset", str(tmp_path / "train.npy"), "--queries", str(tmp_path / "queries.npy"),
        "--gtruth", str(tmp_path / "gt.npy"), "--index-type", index_type,
        "--num-node-links", "16", "--ef-construction", "64", "--ef-search", "96",
        "--k", "10", "--batch-size", "64", "--no-plot",
        "--metrics-file", str(tmp_path / "metrics.json")])
    assert len(rows) == 1 and rows[0]["recall"] >= min_recall and rows[0]["qps"] > 0
    if index_type.startswith("flatnav-fused"):
        assert scan_buckets.launches > k1
    if index_type in ("flatnav", "flatnav-pq-scan"):
        assert gather_distances.launches > k2


def test_headline_on_card(cuda, tmp_path, capsys):
    import json

    from flatnav_tpu_torch.bench import headline

    files = ["--index", str(tmp_path / "ix.npz"), "--queries-file", str(tmp_path / "q.npy")]
    headline.main(["--n", "5000", "--dim", "64", "--num-queries", "512", "--batch", "512",
                   "--m", "16", *files])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["exact_recall"] == 1.0 and out["recall"] >= 0.95 and out["value"] > 0
    assert "NVIDIA" in out["device"] and out["vs_baseline"] is None
    assert out["kernel_launches"]["scan_buckets"] > 0
    assert out["kernel_launches"]["gather_distances"] > 0
    headline.main(["--time-only", "--engine", "graph", "--ef-search", "64", "--m-search", "8",
                   "--compact-width", "128", "--batch", "512", *files])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["qps"] > 0


def test_routed_scan_on_card_matches_cpu(cuda):
    from flatnav_tpu_torch.bench.synth import clustered
    from flatnav_tpu_torch.ops import build_routed_scan, routed_knn
    from flatnav_tpu_torch.ops.routed_scan import RoutedScan

    data, queries = clustered(4000, 32, 100, center_scale=4.0, query_noise=0.5)
    rs = build_routed_scan(data, block=256)  # the card is the default
    assert rs.vectors.is_cuda and rs.ids.is_cuda
    q = torch.from_numpy(queries).cuda()
    _, gt = brute_force_knn(torch.from_numpy(data).cuda(), q, 5)
    nb = rs.block_centroids.shape[0]
    _, full = routed_knn(rs, q, 5, union_blocks=nb, group_size=32)
    assert torch.equal(full.sort(dim=1).values, gt.sort(dim=1).values)
    # the same layout searched on both devices
    on_cpu = RoutedScan(rs.vectors.cpu(), rs.ids.cpu(), rs.block_centroids.cpu(),
                        rs.n, rs.block, rs.metric)
    kw = dict(probes=4, union_blocks=nb // 3, group_size=32)
    gd, gi = routed_knn(rs, q, 5, **kw)
    cd, ci = routed_knn(on_cpu, q.cpu(), 5, **kw)
    assert float((gi.cpu() == ci).float().mean()) >= 0.99
    assert torch.allclose(gd.cpu(), cd, rtol=1e-4, atol=1e-4)
    again = routed_knn(rs, q, 5, **kw)
    assert torch.equal(again[0], gd) and torch.equal(again[1], gi)


@pytest.mark.parametrize("backend,shape", [("nccl", (1, 1)), ("gloo", (1, 2)), ("gloo", (2, 1))])
def test_sharded_paths_on_card_equal_single_device(cuda, backend, shape):
    # NCCL takes one card a rank; two gloo ranks share card 0. The sharded
    # search, fused scan and mesh build equal the single-device port's, and
    # every rank launches K2 in the search and K1 in the fused scan
    from flatnav_tpu_torch.data_type import to_numpy
    from flatnav_tpu_torch.index.build import add_batch
    from flatnav_tpu_torch.index.graph import make_empty_graph
    from flatnav_tpu_torch.index.search import batched_search
    from flatnav_tpu_torch.ops import fused_knn
    from flatnav_tpu_torch.parallel import run_ranks
    from flatnav_tpu_torch.parallel.dryrun import run_cases
    from flatnav_tpu_torch.parallel.sharded_exact import shards_on_one_device

    data, q = _clustered(6000, 64, 256)
    g = add_batch(make_empty_graph(6000, 64, 16), data, np.arange(6000), ef_construction=64,
                  metric=MetricType.L2)
    graph = {"vectors": to_numpy(g.vectors), "links": to_numpy(g.links), "labels": to_numpy(g.labels),
             "num_nodes": g.num_nodes, "capacity": g.capacity}
    build = {"data": data[:2000], "capacity": 2000, "max_edges": 16, "ef_construction": 64,
             "metric": MetricType.L2}
    spec = "model" if shape[1] > 1 else "replicated"
    cases = [
        {"op": "search", "args": {"graph": graph, "queries": q, "k": 10, "ef": 64, "expand_factor": 4}},
        {"op": "exact", "args": {"vectors": data, "num_nodes": 6000, "queries": q, "k": 10, "rerank": 32,
                                 "fused": True}},
        {"op": "build", "args": {**build, "table_spec": spec}},
    ]
    search, fused, built = run_ranks(run_cases, shape[0] * shape[1], backend=backend, device="cuda",
                                     timeout=600, args=(cases, *shape, "cuda"))
    qd = torch.from_numpy(q).to(cuda)
    want = batched_search(g.vectors, g.links, g.labels, g.num_nodes, qd, k=10, ef=64, expand_factor=4)
    assert np.array_equal(search["labels"], want.labels.cpu().numpy())
    np.testing.assert_allclose(search["dists"], want.dists.cpu().numpy(), rtol=0, atol=1e-5)
    _, ids = shards_on_one_device(lambda r, nv: fused_knn(r, qd, 10, rerank=32, n_valid=nv),
                                  torch.from_numpy(data).to(cuda), 6000, shape[1], 10)
    assert np.array_equal(fused["ids"], ids.cpu().numpy())
    ref = add_batch(make_empty_graph(2000, 64, 16), data[:2000], np.arange(2000), ef_construction=64,
                    metric=MetricType.L2)
    assert np.array_equal(built["links"], to_numpy(ref.links)[: built["links"].shape[0]])
    assert (search["launches"][:, 1] > 0).all() and (fused["launches"][:, 0] > 0).all()


def test_fast_knn_ranks_by_bf16_keys_on_card(cuda, rng):
    # fast_knn's phase 1 takes the TPU's DEFAULT-precision form: one bf16
    # product with a float32 result; its rerank stays exact
    from flatnav_tpu_torch.ops.distances import bf16_dot, fast_knn

    data = torch.tensor([[1.002], [0.997]], device=cuda)
    q = torch.tensor([[1.0]], device=cuda)
    dist, ids = fast_knn(data, q, 1, MetricType.L2, rerank=1)
    assert ids.tolist() == [[1]]  # row 0 is nearer, but its bf16 key is larger
    assert abs(dist.item() - float((data[1] - q[0]).pow(2).sum())) == 0.0

    x = rng.standard_normal((64, 96), dtype=np.float32)
    y = rng.standard_normal((5000, 96), dtype=np.float32)
    xr, yr = (torch.from_numpy(a).to(torch.bfloat16).double() for a in (x, y))
    keys = bf16_dot(torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda))
    assert keys.dtype == torch.float32
    np.testing.assert_allclose(keys.cpu().numpy(), (xr @ yr.T).numpy(), rtol=1e-5, atol=1e-4)

    # the card's keys rank as the CPU's rounded-operand keys do
    gd, gi = fast_knn(torch.from_numpy(y).to(cuda), torch.from_numpy(x).to(cuda), 10, tile_size=1024)
    cd, ci = fast_knn(torch.from_numpy(y), torch.from_numpy(x), 10, tile_size=1024)
    same = gi.cpu().numpy() == ci.numpy()
    assert same.mean() >= 0.99
    np.testing.assert_allclose(gd.cpu().numpy()[same], cd.numpy()[same], rtol=1e-5, atol=1e-5)
