"""The data forms the harness takes from a configuration's file (`metric`:
l2 or angular; `dtype`: float32, uint8 or int8): the generator draws them,
the program's index is created in them, the reference judges them, and a
configuration in each form, added as new files, runs correct on the CPU."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from annbench import check, control, faults, reference, synth
from annbench.registry import form, index_args
from annbench.run import run_cell
from conftest import FORM_TOYS, REPO, TOY

SEED = 2**31 + 4242
SIFT = json.loads((REPO / "annbench/configs/sift-128-euclidean.json").read_text())


def _cfg(**changes):
    return {**SIFT, **TOY, **changes}


def _digest(data, queries) -> str:
    return hashlib.sha256(data.numpy().tobytes() + queries.numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("seed,want", [
    (SEED, "1372c88bb014f09caef5ee20a3839099a4602bcc55102626f93156dd8a653565"),
    (7, "158b242dd09885ce3eebc7a06e71e6c9934ac4380355112a89992bec605e3414"),
])
def test_float32_l2_draws_are_as_before(seed, want):
    """SIFT's form at the toy sizes: the bytes the generator drew before it
    took forms (digests pinned from that tree)."""
    assert _digest(*synth.generate(_cfg(), seed, "cpu")) == want


def test_angular_rows_are_unit():
    data, q = synth.generate(_cfg(metric="angular"), SEED, "cpu")
    assert data.dtype == q.dtype == torch.float32
    for x in (data, q):
        assert (torch.linalg.vector_norm(x.double(), dim=1) - 1).abs().max() < 1e-6
    # the same draws, each row scaled
    raw, _ = synth.generate(_cfg(), SEED, "cpu")
    assert torch.allclose(data * torch.linalg.vector_norm(raw, dim=1, keepdim=True), raw,
                          rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,np_dtype", [("uint8", np.uint8), ("int8", np.int8)])
def test_8bit_arrays_are_the_ports_integer_mapping(dtype, np_dtype):
    """Given the same float arrays, `synth` maps them to the integers that
    the port's `bench/synth.clustered` gives, its percentiles included."""
    from flatnav_tpu_torch.bench import synth as port

    data, q = synth.generate(_cfg(dtype=dtype), SEED, "cpu")
    info = np.iinfo(np_dtype)
    assert data.dtype == q.dtype == getattr(torch, dtype)
    assert int(data.min()) == info.min and int(data.max()) == info.max
    for seed in (1, SEED):
        fd, fq = port.clustered(3000, 16, 300, seed=seed, centers_per_64k=26)
        want_d, want_q = port.clustered(3000, 16, 300, seed=seed, centers_per_64k=26,
                                        dtype=np_dtype)
        lo, hi = synth.percentiles(torch.from_numpy(fd))
        assert [lo, hi] == np.percentile(fd, list(synth.PERCENTILES)).tolist()
        tdt = getattr(torch, dtype)
        assert np.array_equal(synth.to_integer(torch.from_numpy(fd), lo, hi, tdt).numpy(), want_d)
        assert np.array_equal(synth.to_integer(torch.from_numpy(fq), lo, hi, tdt).numpy(), want_q)


@pytest.mark.parametrize("n", [1, 2, 7, 200, 4099])
def test_percentiles_are_numpys(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    x[::3] = np.round(x[::3])  # ties
    assert synth.percentiles(torch.from_numpy(x), (0.0, 0.5, 50.0, 99.5, 100.0)) == \
        np.percentile(x, [0.0, 0.5, 50.0, 99.5, 100.0]).tolist()


@pytest.mark.parametrize("changes,key", [
    ({"metric": "cosine"}, "metric"), ({"dtype": "float16"}, "dtype"),
    ({"metric": None}, "metric"), ({"metric": "angular", "dtype": "uint8"}, "dtype"),
])
def test_unknown_form_raises_and_names_the_key(changes, key):
    with pytest.raises(ValueError, match=f"key '{key}'"):
        form(_cfg(**changes))
    with pytest.raises(ValueError, match=f"key '{key}'"):
        synth.generate(_cfg(**changes), 1, "cpu")


@pytest.mark.parametrize("changes", [{}, *FORM_TOYS.values()])
def test_index_args_carry_the_form(changes):
    cfg = _cfg(**changes)
    args = index_args(cfg)
    assert args["distance_type"] == cfg["metric"] and args["index_data_type"].value == cfg["dtype"]
    assert (args["dim"], args["dataset_size"]) == (cfg["dim"], cfg["n"])


def test_reference_angular_is_one_minus_dot():
    data, q = synth.generate(_cfg(metric="angular"), SEED, "cpu")
    q = q[:40]
    d, i = reference.exact_knn(data, q, 10, "angular")
    want = 1.0 - (q.double() @ data.double().T)
    wd, wi = torch.topk(want, 10, dim=1, largest=False)
    assert torch.allclose(d.double(), wd, atol=1e-6) and (i == wi).float().mean() > 0.99
    direct = reference.id_distances(data, q, torch.arange(40), i, "angular")
    assert torch.allclose(direct.double(), want.gather(1, i), atol=1e-6)
    # on unit rows 1 - <q, x> ranks as squared L2 does (|q - x|^2 = 2 - 2<q, x>)
    dl, il = reference.exact_knn(data, q, 10, "l2")
    assert (i == il).float().mean() > 0.99 and torch.allclose(dl, 2 * d, atol=1e-5)
    assert torch.equal(reference.exact_knn(data, q, 10, "ip")[1], i)


@pytest.mark.parametrize("metric", ["cosine", "L2", "angular_cosine"])
def test_reference_unknown_metric_raises(metric):
    data, q = torch.zeros(8, 4), torch.zeros(2, 4)
    with pytest.raises(ValueError, match="metric"):
        reference.exact_knn(data, q, 2, metric)
    with pytest.raises(ValueError, match="metric"):
        reference.id_distances(data, q, torch.arange(2), torch.zeros(2, 2, dtype=torch.long), metric)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int16])
def test_reference_unknown_dtype_raises(dtype):
    data, q = torch.zeros(8, 4, dtype=dtype), torch.zeros(2, 4, dtype=dtype)
    with pytest.raises(ValueError, match="reference takes"):
        reference.exact_knn(data, q, 2)


def _int_rows(dtype, n, d, seed):
    """Random 8-bit rows and queries with the type's extremes in them."""
    info = torch.iinfo(dtype)
    g = torch.Generator().manual_seed(seed)
    data = torch.randint(info.min, info.max + 1, (n, d), generator=g, dtype=torch.int64)
    q = torch.randint(info.min, info.max + 1, (24, d), generator=g, dtype=torch.int64)
    data[0], data[1], q[0] = info.min, info.max, info.max  # the farthest pair: d * 255^2
    data[2, ::2], data[2, 1::2] = info.min, info.max
    return data.to(dtype), q.to(dtype)


@pytest.mark.parametrize("dtype,d", [(torch.uint8, 128), (torch.int8, 100)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_8bit_distances_are_exact(monkeypatch, dtype, d, metric):
    monkeypatch.setattr(reference, "ROW_BLOCK", 256)
    data, q = _int_rows(dtype, 1000, d, 5)
    x, y = data.long(), q.long()
    want = ((y[:, None, :] - x[None]) ** 2).sum(-1) if metric == "l2" else 1 - y @ x.T
    dist, ids = reference.exact_knn(data, q, 10, metric)
    assert dist.dtype == torch.float64 and torch.equal(dist, torch.sort(want, 1).values[:, :10].double())
    assert torch.equal(want.gather(1, ids).double(), dist)  # each id with its distance
    every = torch.arange(1000).expand(24, 1000)
    direct = reference.id_distances(data, q, torch.arange(24), every, metric)
    assert torch.equal(direct, want.double())
    if metric == "l2":
        assert int(want[0, 0]) == d * 255**2 and float(direct[0, 0]) == d * 255**2


def _run(reg, cell, seed=SEED):
    return run_cell(reg, cell, seed, 0.4, False, device="cpu")


@pytest.mark.parametrize("cell", [f"{n}.{c}" for n in FORM_TOYS for c in ("graph", "scan")])
def test_form_cells_run_correct_in_their_form(toy_reg, monkeypatch, cell):
    """A configuration in each form, added as new files, runs correct, and
    the program's index is created in that form."""
    import flatnav_tpu_torch.index as fi
    from flatnav_tpu_torch.ops.distances import MetricType

    made, real = [], fi.create
    monkeypatch.setattr(fi, "create", lambda *a, **kw: made.append(real(*a, **kw)) or made[-1])
    cfg = toy_reg.config(toy_reg.cell(cell)["config"])
    r = _run(toy_reg, cell)
    assert r["correct"] and r["failed"] == 0, r["check"]
    assert r["check"]["dist_gap"]["value"] < 1e-5
    (index,) = made
    assert index.data_type.value == cfg["dtype"] and index.graph.vectors.dtype == getattr(torch, cfg["dtype"])
    assert index.metric is (MetricType.IP if cfg["metric"] == "angular" else MetricType.L2)


def test_angular_index_created_as_l2_fails_dist_gap(toy_reg, monkeypatch):
    import flatnav_tpu_torch.index as fi

    real = fi.create
    monkeypatch.setattr(fi, "create", lambda distance_type, *a, **kw: real("l2", *a, **kw))
    r = _run(toy_reg, "toy-angular.scan")
    assert not r["correct"] and r["check"]["dist_gap"]["value"] > r["check"]["dist_gap"]["limit"]


@pytest.mark.parametrize("name", list(FORM_TOYS))
def test_dropped_tile_fails_recall_in_each_form(toy_reg, monkeypatch, name):
    faults.tile_dropped(monkeypatch.setattr, tile=64)
    r = _run(toy_reg, f"{name}.scan")
    v = r["check"]["recall_at_10"]
    assert not r["correct"] and v["value"] < v["limit"]


@pytest.mark.parametrize("name", list(FORM_TOYS))
def test_control_is_not_correct_in_each_form(toy_reg, name):
    """The reference one precision lower (TF32 for float32 rows, int4 for
    8-bit rows) in the program's place fails `dist_gap`; the reference
    itself passes every number."""
    cfg = toy_reg.config(name)
    metric = form(cfg)[0]
    limits = toy_reg.traffic("toy-scan-r1000")["limits"]
    for seed in (1, 2, 3):
        data, q = synth.generate(cfg, seed, "cpu")
        ok, numbers, _ = check.judge(data, q, control.control_answers(data, q, 10, metric, 100),
                                     10, metric, limits)
        assert not ok and numbers["dist_gap"][0] > 3 * limits["dist_gap"]
        d, i = reference.exact_knn(data, q, 10, metric)
        ok, numbers, recall = check.judge(data, q, [(0, d.numpy(), i.numpy())], 10, metric, limits)
        assert ok and recall == 1.0
        if cfg["dtype"] != "float32":  # exact integers on both sides
            assert numbers["dist_gap"][0] == 0.0
