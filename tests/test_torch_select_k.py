"""The port's exact top-k (flatnav_tpu_torch/ops/select_k.py, kernel K3) on
the CPU, where `select_k` runs its plain version.

- `select_k_plain` against a numpy oracle (`numpy.lexsort` over the order-
  preserving bits of key + 0.0, then the id) on tie-heavy rows, +-0, +-inf
  and NaN of both signs, with full, row and implicit ids and column windows;
- against `jax.lax.approx_min_k` on the CPU, where it is exact: the values
  are equal, and the ids wherever the keys are distinct;
- the scans rebuilt on it (`brute_force_knn`, `fast_knn`, `pq_scan_knn`:
  one selection a tile seeded with the running k) equal, bit for bit, the
  form they had before: one selection over [running k | masked tile],
  kept here as the reference (`_*_cat`);
- `prior=` against the two-step merge it replaced (the tile's k, then the
  k of the concatenated 2k) and a numpy oracle, on (+inf, id 0) padding,
  repeated pairs, k past the window, windows at both ends and ties;
- the wrapper's contract (what it refuses, on either device, the prior's
  checks included), its plan of launches and its route, and that every
  caller's k stays within K_MAX.

The kernel itself runs only on the card: tests/test_torch_kernels_gpu.py.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flatnav_tpu_torch.ops import distances as td
from flatnav_tpu_torch.ops import select_k as sk
from flatnav_tpu_torch.ops.select_k import K_MAX, select_k, select_k_plain
from flatnav_tpu_torch.quantization import pq as tpq

SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, -1.0], np.float32)
SPECIAL[5] = -SPECIAL[4]  # a NaN with the sign bit set


def _keys(rng, kind, b, w):
    if kind == "normal":
        x = rng.standard_normal((b, w)).astype(np.float32)
        at = rng.integers(0, b * w, max(1, b * w // 20))
        x.reshape(-1)[at] = SPECIAL[rng.integers(0, len(SPECIAL), len(at))]
        return x
    if kind == "ties":  # 8-bit tables: integer keys, thousands of exact ties
        return rng.integers(0, 8, (b, w)).astype(np.float32)
    if kind == "inf":
        return np.full((b, w), np.inf, np.float32)
    if kind == "nan":
        x = np.full((b, w), np.nan, np.float32)
        x[:, ::2] = SPECIAL[5]
        return x
    return SPECIAL[rng.integers(0, len(SPECIAL), (b, w))]


def _oracle(keys, k, ids, cols):
    """numpy: mask, then lexsort by (monotone bits of key + 0.0, id)."""
    b, w = keys.shape
    col = np.arange(w)
    lo, hi = cols
    x = np.where((col >= lo) & (col < hi), keys, np.float32(np.inf)).astype(np.float32)
    x = x + np.float32(0.0)
    bits = x.view(np.int32).astype(np.int64)
    bits = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    ids = np.broadcast_to(ids, (b, w))
    order = np.stack([np.lexsort((ids[r], bits[r]))[:k] for r in range(b)])
    return np.take_along_axis(x, order, 1), np.take_along_axis(ids, order, 1)


@pytest.mark.parametrize("kind", ["normal", "ties", "inf", "nan", "special"])
@pytest.mark.parametrize("ids_kind", ["full", "row", "implicit"])
@pytest.mark.parametrize("window", [False, True])
def test_plain_matches_lexsort(kind, ids_kind, window):
    rng = np.random.default_rng(zlib.crc32(f"{kind} {ids_kind} {window}".encode()))
    b, w = 5, 777
    keys = _keys(rng, kind, b, w)
    kw, id_base = {}, 0
    if ids_kind == "full":
        ids = rng.permutation(10 * b * w)[: b * w].reshape(b, w).astype(np.int32)
        kw["ids"] = torch.from_numpy(ids)
    elif ids_kind == "row":
        ids = rng.integers(0, 40, (1, w)).astype(np.int32)  # repeated ids
        kw["ids"] = torch.from_numpy(ids)
    else:
        id_base = 12345
        ids = (id_base + np.arange(w, dtype=np.int32))[None, :]
        kw["id_base"] = id_base
    cols = (100, 600) if window else (0, w)
    if window:
        kw["cols"] = cols
    for k in (1, 10, 64, w):
        want_d, want_i = _oracle(keys, k, ids, cols)
        got_d, got_i = select_k_plain(torch.from_numpy(keys), k, **kw)
        assert np.array_equal(got_d.numpy().view(np.int32), want_d.view(np.int32)), k
        assert np.array_equal(got_i.numpy(), want_i), k
        got = select_k(torch.from_numpy(keys), k, **kw)
        assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got, (got_d, got_i)))


def test_total_order_of_zeros_infs_and_nans():
    keys = torch.tensor([[1.0, -0.0, float("nan"), 0.0, float("inf"), -float("inf"), 0.0, -1.0]])
    keys[0, 6] = -keys[0, 2]  # a negative NaN ranks before -inf
    d, i = select_k(keys, 8, ids=torch.arange(8, dtype=torch.int32)[None])
    assert i.tolist() == [[6, 5, 7, 1, 3, 0, 4, 2]]
    bits = d.view(torch.int32)[0].tolist()
    assert bits[3] == bits[4] == 0  # both zeros come back as +0.0


@pytest.mark.parametrize("b,w,k", [(4, 3000, 32), (2, 70000, 100), (3, 500, 500)])
def test_plain_matches_jax_approx_min_k(b, w, k):
    # on the CPU approx_min_k is exact: the same values; ids where keys differ
    rng = np.random.default_rng(w)
    keys = rng.standard_normal((b, w)).astype(np.float32)
    keys[0, : w // 2] = np.round(keys[0, : w // 2])  # a row with many ties
    jv, ji = jax.lax.approx_min_k(jnp.asarray(keys), k, recall_target=0.95)
    tv, ti = select_k_plain(torch.from_numpy(keys), k)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert np.array_equal(tv.numpy(), jv)
    for r in range(b):
        vals, counts = np.unique(keys[r], return_counts=True)
        distinct = np.isin(jv[r], vals[counts == 1])
        assert np.array_equal(ti.numpy()[r][distinct], ji[r][distinct])


# ---- the scans' former form, one selection over [running | masked tile]


def _cat_select(best_d, best_i, keys, ids, k):
    b = keys.shape[0]
    return select_k_plain(torch.cat([best_d, keys], 1), k,
                          ids=torch.cat([best_i, ids.expand(b, -1)], 1))


def _brute_cat(dataset, queries, k, metric, tile_size, n_valid):
    n, d = dataset.shape
    b = queries.shape[0]
    n_limit = n if n_valid is None else int(n_valid)
    tile = max(min(tile_size, n), 128)
    if n < tile:
        dataset = torch.cat([dataset, torch.zeros((tile - n, d), dtype=dataset.dtype)])
        n = tile
    q_sq = None if td._is_int(queries) else td.squared_norms(queries)
    best_d = torch.full((b, k), float("inf"))
    best_i = torch.zeros((b, k), dtype=torch.int32)
    iota = torch.arange(tile, dtype=torch.int32)
    for start_raw in range(0, n, tile):
        start = min(start_raw, n - tile)
        dists = td.pairwise_distances(queries, dataset[start : start + tile], metric, x_sq=q_sq)
        ids = start + iota
        dists = torch.where((ids >= start_raw) & (ids < n_limit), dists, float("inf"))
        best_d, best_i = _cat_select(best_d, best_i, dists, ids, k)
    return best_d, best_i


def _fast_cat(dataset, queries, k, metric, tile_size, rerank, n_valid):
    n, d = dataset.shape
    b = queries.shape[0]
    r = max(rerank, k)
    n_limit = n if n_valid is None else int(n_valid)
    tile = max(min(tile_size, n), 128)
    if n < tile:
        dataset = torch.cat([dataset, torch.zeros((tile - n, d), dtype=dataset.dtype)])
        n = tile
    int_path = td._is_int(queries) and td._is_int(dataset)
    qf = queries if int_path else queries.to(torch.float32)
    best_k = torch.full((b, r), float("inf"))
    best_i = torch.zeros((b, r), dtype=torch.int32)
    iota = torch.arange(tile, dtype=torch.int32)
    for start_raw in range(0, n, tile):
        start = min(start_raw, n - tile)
        rows = dataset[start : start + tile]
        if int_path:
            dots_i = td.exact_int_dot(qf, rows)
            if metric == td.MetricType.IP:
                key = (-dots_i).to(torch.float32)
            else:
                ys_i = (rows.to(torch.int32) ** 2).sum(-1, dtype=torch.int32)
                key = (ys_i[None, :] - 2 * dots_i).to(torch.float32)
        else:
            dots = td.bf16_dot(qf, rows)
            key = -dots if metric == td.MetricType.IP else (
                td.squared_norms(rows)[None, :] - 2.0 * dots)
        ids = start + iota
        key = torch.where((ids >= start_raw) & (ids < n_limit), key, float("inf"))
        best_k, best_i = _cat_select(best_k, best_i, key, ids, r)
    exact = td.query_block_distances(qf, dataset[best_i.long()], metric)
    exact = torch.where(torch.isinf(best_k), float("inf"), exact)
    order = torch.argsort(exact, dim=1, stable=True)[:, :k]
    return exact.gather(1, order), best_i.gather(1, order)


def _pq_cat(codes, tables, k, metric, tile_size, rerank, packed_4bit, vectors, queries, n_valid):
    """pq_scan_knn's former form (rows not lane-packed)."""
    b, s, nc = tables.shape
    g = (s // 2) if packed_4bit else s
    n = codes.shape[0]
    r = max(rerank, k)
    n_limit = min(n if n_valid is None else int(n_valid), n)
    if n < 128:
        codes = torch.cat([codes, codes.new_zeros((128 - n, g))])
        n = 128
    tile = max(min(tile_size, n), 128)
    t_bf = tables.reshape(b, s * nc).to(torch.bfloat16)
    sub_base = torch.arange(s) * nc
    onehot = torch.empty((tile, s * nc), dtype=torch.bfloat16)
    iota = torch.arange(tile, dtype=torch.int32)
    best_key = torch.full((b, r), float("inf"))
    best_i = torch.zeros((b, r), dtype=torch.int32)
    for start0 in range(0, n, tile):
        start = min(start0, n - tile)
        rows = codes[start : start + tile]
        if packed_4bit:
            rows = tpq.unpack_codes_4bit(rows)
        onehot.zero_().scatter_(1, rows.long() + sub_base, 1.0)
        key = tpq._scan_keys(t_bf, onehot)
        ids = start + iota
        key = torch.where((ids >= start0) & (ids < n_limit), key, float("inf"))
        best_key, best_i = _cat_select(best_key, best_i, key, ids, r)
    if vectors is not None:
        exact = td.query_block_distances(queries, vectors[best_i.long()], metric)
    else:
        cand = codes[best_i.long()]
        if packed_4bit:
            cand = tpq.unpack_codes_4bit(cand.reshape(b * r, g)).reshape(b, r, s)
        exact = tpq.score_codes(tables, cand) + (1.0 if metric == td.MetricType.IP else 0.0)
    exact = torch.where(torch.isinf(best_key), float("inf"), exact)
    order = torch.argsort(exact, dim=1, stable=True)[:, :k]
    return exact.gather(1, order), best_i.gather(1, order)


def _same(got, want):
    return all(torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y)
               for x, y in zip(got, want))


def _table(rng, n, d, dtype):
    if dtype == "uint8":
        return torch.from_numpy(rng.integers(0, 4, (n, d)).astype(np.uint8))  # many ties
    return torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))


# (n, tile, k, n_valid): whole tiles; a clamped last tile; rows past n_valid
# (fewer valid rows than k in the last case); k wider than a tile
SCANS = [(1024, 256, 10, None), (1000, 256, 10, None), (1000, 300, 16, 700),
         (300, 128, 150, None), (900, 256, 40, 25)]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("metric", [td.MetricType.L2, td.MetricType.IP])
@pytest.mark.parametrize("n,tile,k,n_valid", SCANS)
def test_brute_force_knn_equals_the_cat_form(dtype, metric, n, tile, k, n_valid):
    rng = np.random.default_rng(n + k)
    data, q = _table(rng, n, 8, dtype), _table(rng, 7, 8, dtype)
    got = td.brute_force_knn(data, q, k, metric, tile_size=tile, n_valid=n_valid)
    assert _same(got, _brute_cat(data, q, k, metric, tile, n_valid))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("metric", [td.MetricType.L2, td.MetricType.IP])
@pytest.mark.parametrize("n,tile,k,n_valid", SCANS)
def test_fast_knn_equals_the_cat_form(dtype, metric, n, tile, k, n_valid):
    rng = np.random.default_rng(n + k + 1)
    data, q = _table(rng, n, 8, dtype), _table(rng, 7, 8, dtype)
    rerank = max(k, 20)
    got = td.fast_knn(data, q, k, metric, tile_size=tile, rerank=rerank, n_valid=n_valid)
    assert _same(got, _fast_cat(data, q, k, metric, tile, rerank, n_valid))


@pytest.mark.parametrize("nbits", [8, 4])
@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("n,tile,k,n_valid", SCANS)
def test_pq_scan_knn_equals_the_cat_form(nbits, raw, n, tile, k, n_valid):
    rng = np.random.default_rng(n + k + nbits)
    s, nc, b, d = 4, 1 << nbits, 6, 8
    codes = torch.from_numpy(rng.integers(0, nc, (n, s)).astype(np.uint8))
    tables = torch.from_numpy(rng.integers(0, 5, (b, s, nc)).astype(np.float32))  # ADC ties
    packed = nbits == 4
    if packed:
        codes = tpq.pack_codes_4bit(codes)
    kw = {}
    if raw:
        kw = {"vectors": _table(rng, n, d, "float32"), "queries": _table(rng, b, d, "float32")}
    got = tpq.pq_scan_knn(codes, tables, k, tile_size=tile, rerank=max(k, 24),
                          packed_4bit=packed, n_valid=n_valid, **kw)
    want = _pq_cat(codes, tables, k, td.MetricType.L2, tile, max(k, 24), packed,
                   kw.get("vectors"), kw.get("queries"), n_valid)
    assert _same(got, want)


# ---- the wrapper's contract


def test_wrapper_refuses_what_k3_does_not_take():
    keys = torch.zeros((3, 100))
    bad = {
        "k > W": lambda: select_k(keys, 101),
        "k > K_MAX": lambda: select_k(torch.zeros((1, K_MAX + 1)), K_MAX + 1),
        "float64 keys": lambda: select_k(keys.double(), 5),
        "1-D keys": lambda: select_k(keys[0], 5),
        "int64 ids": lambda: select_k(keys, 5, ids=torch.zeros((3, 100), dtype=torch.int64)),
        "ids shape": lambda: select_k(keys, 5, ids=torch.zeros((2, 100), dtype=torch.int32)),
        "ids width": lambda: select_k(keys, 5, ids=torch.zeros((1, 99), dtype=torch.int32)),
        "negative id_base": lambda: select_k(keys, 5, id_base=-1),
        "ids past 2^31": lambda: select_k(keys, 5, id_base=(1 << 31) - 50),
        "another device": lambda: select_k(keys.to("meta"), 5),
    }
    for what, call in bad.items():
        with pytest.raises((TypeError, ValueError)):
            call()
            pytest.fail(what)
    before = select_k.launches
    d, i = select_k(torch.zeros((3, K_MAX)), K_MAX)  # the largest k runs
    assert d.shape == (3, K_MAX) and select_k.launches == before  # the CPU launches nothing
    assert select_k(keys, 0)[0].shape == (3, 0)


@pytest.mark.parametrize("b,w,k", [(4096, 62592, 32), (512, 390656, 32), (1, 390656, K_MAX),
                                   (1, 131072, 32), (8192, 8192, 64), (4096, 64, 32),
                                   (16384, 196, 8), (1, 7, 7), (1024, 32768, 1024)])
def test_plan_of_launches(b, w, k):
    rounds = sk._plan(b, w, k)
    assert rounds[0][0] == w and rounds[-1][0] == rounds[-1][1]  # one slice at the end
    for (width, sl), nxt in zip(rounds, rounds[1:] + [None]):
        slices = -(-width // sl)
        assert 1 <= sl <= width and slices <= 65535
        if nxt is not None:
            assert nxt[0] == slices * k < width  # every round narrows the rows
            assert sl >= min(width, 2 * k)
    if b >= sk.TARGET_BLOCKS:
        assert len(rounds) == 1  # a full batch takes one launch


def test_every_callers_k_is_within_k_max(monkeypatch):
    # every selection of the port goes through distances.select_k; record
    # the k of each at the largest width its caller is configured with
    from flatnav_tpu_torch.bench import bigann_100m
    from flatnav_tpu_torch.index import create
    from flatnav_tpu_torch.ops.routed_scan import build_routed_scan, routed_knn
    from flatnav_tpu_torch.quantization import PQIndex, ProductQuantizer

    seen = []

    def recorder(keys, k, **kw):
        seen.append(k)
        return select_k(keys, k, **kw)

    monkeypatch.setattr(td, "select_k", recorder)
    rng = np.random.default_rng(0)
    data = rng.standard_normal((600, 16)).astype(np.float32)
    q = data[:8] + 0.01
    widest = max(bigann_100m.PQ4_RERANKS + bigann_100m.PQ_RERANKS)
    index = create("l2", dim=16, dataset_size=600, max_edges_per_node=32, device="cpu")
    index.add(data, ef_construction=64)
    index.search_exact(q, K=10)
    index.search_exact(q, K=10, rerank=32)
    td.brute_force_knn(torch.from_numpy(data), torch.from_numpy(q), 100)
    td.fast_knn(torch.from_numpy(data), torch.from_numpy(q), 10, tile_size=256, rerank=128)
    pq = ProductQuantizer(16, 4, 4, device="cpu").train(data, n_iters=2)
    codes = pq.encode(torch.from_numpy(data))
    tpq.pq_scan_knn(codes, pq.adc_tables(torch.from_numpy(q)), 10, tile_size=256,
                    rerank=widest)
    pidx = PQIndex(pq, dataset_size=600, max_edges_per_node=16, device="cpu")
    pidx.add(data, ef_construction=32)
    rs = build_routed_scan(data, block=128, device="cpu")
    routed_knn(rs, torch.from_numpy(q), k=10)
    assert len(seen) > 10 and max(seen) >= widest
    assert all(0 < k <= K_MAX for k in seen), sorted(set(seen))


def test_an_expanded_id_row_is_one_row():
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 3, (4, 300)).astype(np.float32))
    row = torch.from_numpy(rng.permutation(300).astype(np.int32))
    want = select_k(keys, 20, ids=row[None, :])
    for ids in (row, row.expand(4, 300), row[None, :].expand(4, 300)):
        assert all(torch.equal(a, b) for a, b in zip(select_k(keys, 20, ids=ids), want))


# ---- the prior: a scan's running shortlist seeded into the selection


def _two_step(best_d, best_i, keys, start, cols):
    """The scans' merge before the prior existed: the tile's r smallest,
    then the r smallest of the concatenated 2r."""
    r = best_d.shape[1]
    tile_d, tile_i = select_k(keys, min(r, keys.shape[1]), id_base=start, cols=cols)
    return select_k(torch.cat([best_d, tile_d], 1), r, ids=torch.cat([best_i, tile_i], 1))


def _oracle_prior(pd, pi, keys, k, start, cols):
    """numpy: the prior's pairs and the masked tile's, concatenated, by
    lexsort over (monotone bits of key + 0.0, id)."""
    b, w = keys.shape
    col = np.arange(w)
    x = np.where((col >= cols[0]) & (col < cols[1]), keys, np.float32(np.inf))
    x = np.concatenate([pd, x], 1).astype(np.float32) + np.float32(0.0)
    ids = np.concatenate([pi, np.broadcast_to(start + col, (b, w)).astype(np.int32)], 1)
    bits = x.view(np.int32).astype(np.int64)
    bits = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    order = np.stack([np.lexsort((ids[r], bits[r]))[:k] for r in range(b)])
    return np.take_along_axis(x, order, 1), np.take_along_axis(ids, order, 1)


# (prior kind, W, r, cols): the (+inf, id 0) padding a scan starts from; a
# prior whose pairs the tile repeats; r wider than the tile's window; a
# window that cuts both ends; integer keys with thousands of ties
PRIOR_CASES = [("pad", 500, 20, (0, 500)), ("repeat", 300, 16, (0, 300)),
               ("finite", 200, 64, (150, 180)), ("finite", 900, 10, (37, 811)),
               ("ties", 5000, 32, (0, 5000)), ("pad", 128, 150, (0, 100)),
               ("mixed", 777, 40, (5, 700))]


@pytest.mark.parametrize("kind,w,r,cols", PRIOR_CASES)
def test_prior_equals_the_two_step_merge_and_lexsort(kind, w, r, cols):
    rng = np.random.default_rng(zlib.crc32(f"prior {kind} {w} {r}".encode()))
    b, start = 6, 4000
    keys = (rng.integers(0, 8, (b, w)) if kind == "ties"
            else rng.standard_normal((b, w))).astype(np.float32)
    pd = np.sort(rng.standard_normal((b, r)).astype(np.float32) - 1.0, axis=1)
    pi = rng.integers(0, 10_000, (b, r)).astype(np.int32)
    if kind in ("pad", "mixed"):
        h = 0 if kind == "pad" else r // 2
        pd[:, h:], pi[:, h:] = np.inf, 0
    elif kind == "repeat":  # the tile's own pairs, already in the running r
        pd = np.sort(keys[:, :r], axis=1)
        pi = (start + np.argsort(keys[:, :r], axis=1, kind="stable")).astype(np.int32)
    elif kind == "ties":
        pd = rng.integers(0, 3, (b, r)).astype(np.float32)
        pi = rng.integers(start, start + 50, (b, r)).astype(np.int32)
    t = torch.from_numpy
    got = select_k(t(keys), r, id_base=start, cols=cols, prior=(t(pd), t(pi)))
    assert _same(got, _two_step(t(pd), t(pi), t(keys), start, cols))
    want_d, want_i = _oracle_prior(pd, pi, keys, r, start, cols)
    assert np.array_equal(got[0].numpy().view(np.int32), want_d.view(np.int32))
    assert np.array_equal(got[1].numpy(), want_i)
    # _merge_tile is the seeded selection
    assert _same(td._merge_tile(t(pd), t(pi), t(keys), start, cols), got)


def test_prior_with_full_and_row_ids():
    rng = np.random.default_rng(31)
    b, w, r = 4, 400, 25
    keys = torch.from_numpy(rng.integers(0, 5, (b, w)).astype(np.float32))
    prior = (torch.from_numpy(rng.integers(0, 5, (b, r)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 100, (b, r)).astype(np.int32)))
    for ids in (torch.from_numpy(rng.integers(0, 100, (b, w)).astype(np.int32)),
                torch.from_numpy(rng.integers(0, 100, (1, w)).astype(np.int32))):
        want = select_k_plain(torch.cat([prior[0], keys], 1), r,
                              ids=torch.cat([prior[1], ids.expand(b, w)], 1))
        assert _same(select_k(keys, r, ids=ids, prior=prior), want)


def test_wrapper_checks_the_prior():
    keys = torch.zeros((3, 100))
    pd, pi = torch.zeros((3, 8)), torch.zeros((3, 8), dtype=torch.int32)
    bad = {
        "not a pair": (TypeError, lambda: select_k(keys, 8, prior=pd)),
        "float64 keys": (TypeError, lambda: select_k(keys, 8, prior=(pd.double(), pi))),
        "int64 ids": (TypeError, lambda: select_k(keys, 8, prior=(pd, pi.long()))),
        "width != k": (ValueError, lambda: select_k(keys, 7, prior=(pd, pi))),
        "rows != B": (ValueError, lambda: select_k(keys, 8, prior=(pd[:2], pi[:2]))),
        "k > K_MAX": (ValueError, lambda: select_k(
            torch.zeros((1, 10)), K_MAX + 1, prior=(torch.zeros((1, K_MAX + 1)),
                                                    torch.zeros((1, K_MAX + 1), dtype=torch.int32)))),
        "another device": (ValueError, lambda: select_k(keys, 8, prior=(pd.to("meta"), pi))),
        "no columns": (ValueError, lambda: select_k(torch.zeros((3, 0)), 8, prior=(pd, pi))),
    }
    for what, (err, call) in bad.items():
        with pytest.raises(err):
            call()
            pytest.fail(what)
    # with a prior k may pass W: the prior alone holds k pairs
    d, i = select_k(torch.zeros((3, 4)), 8, prior=(pd, pi))
    assert d.shape == (3, 8) and i[:, 4:].eq(0).all()


@pytest.mark.parametrize("k,sl,route", [(1, 7, "warp"), (8, 196, "warp"), (64, 8192, "warp"),
                                        (65, 8192, "block"), (64, 8193, "block"),
                                        (32, 131072, "block"), (1024, 64, "block"),
                                        (32, 4096, "warp")])
def test_route_choice(k, sl, route):
    assert sk._route(k, sl) == route
    assert (route == "warp") == (k <= sk.WARP_K and sl <= sk.WARP_MAX_W)
