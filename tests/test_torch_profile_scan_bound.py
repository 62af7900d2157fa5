"""The port's scan-bound profiler (flatnav_tpu_torch.bench.profile_scan_bound)
on the CPU at n=4096, d=32: its stages compute what they name, the whole
engines it times return the ids of the JAX package's `brute_force_knn` and
`fast_knn` on the same table, and its sweeps cover every requested point."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flatnav_tpu.ops import MetricType as JMetric
from flatnav_tpu.ops import brute_force_knn as jax_brute
from flatnav_tpu.ops import fast_knn as jax_fast
from flatnav_tpu_torch.bench import profile_scan_bound as psb
from flatnav_tpu_torch.ops.distances import smallest_k

N, D, B, TILE = 4096, 32, 64, 1024


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((N, D), dtype=np.float32)
    q = rng.standard_normal((B, D), dtype=np.float32)
    return vecs, q


def test_stages_compute_what_they_name(table):
    vecs, q = table
    fns = psb.stages(torch.from_numpy(vecs), torch.from_numpy(q), N, k=10, tile=TILE, rerank=32)
    assert tuple(fns) == psb.STAGE_NAMES
    # the keys of every stage: the products of the bf16-rounded operands
    keys = torch.from_numpy(q).bfloat16().float() @ torch.from_numpy(vecs).bfloat16().float().T
    torch.testing.assert_close(fns["matmul"](), keys.amin(dim=1))
    want, _ = smallest_k(keys, torch.arange(N, dtype=torch.int32)[None, :], 32)
    torch.testing.assert_close(fns["select"](), want)


def test_engines_it_times_return_jax_ids(table):
    vecs, q = table
    fns = psb.stages(torch.from_numpy(vecs), torch.from_numpy(q), N, k=10, tile=TILE, rerank=32)
    _, jax_exact = jax_brute(jnp.asarray(vecs), jnp.asarray(q), 10, JMetric.L2)
    _, jax_f = jax_fast(jnp.asarray(vecs), jnp.asarray(q), 10, JMetric.L2, tile_size=TILE, rerank=32)
    assert np.array_equal(fns["exact"]().numpy(), np.asarray(jax_exact))
    # bf16 ranking keys against JAX's float32 ones on the CPU: the exact
    # rerank of 32 hides the rounding in nearly every slot
    assert (fns["fastknn"]().numpy() == np.asarray(jax_f)).mean() >= 0.99


def test_main_on_the_cpu_with_sweeps(capsys):
    out = psb.main(["--n", str(N), "--d", str(D), "--b", str(B), "--tile", str(TILE),
                    "--reps", "1", "--sweep", "--tiles", "1024", "2048", "8192",
                    "--reranks", "32", "64", "--batches", "32", "128", "--device", "cpu"])
    assert out["device"] == "cpu" and set(out["stages"]) == set(psb.STAGE_NAMES)
    assert all(s["ms"] > 0 and 0 < s["peak_share"] < 1 for s in out["stages"].values())
    # tiles wider than the table are skipped, as profile_exact.py skips them
    points = {(r["engine"], r["b"], r["tile"], r.get("rerank")) for r in out["sweep"]}
    assert points == {(e, b, t, r) for b in (32, 128) for t in (1024, 2048)
                      for e, r in (("exact", None), ("fast", 32), ("fast", 64))}
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"device": "cpu"')
