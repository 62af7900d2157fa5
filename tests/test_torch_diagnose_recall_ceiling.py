"""The port's recall-ceiling diagnosis (flatnav_tpu_torch/tools/
diagnose_recall_ceiling.py) against the same quantities computed with the
JAX package on the same index and queries, on the CPU.

The index is built by the port and saved in the shared .npz format, which
the JAX package's `load_index` reads as it is. The JAX side takes the JAX
tool's formulas over its own `brute_force_knn` (64 neighbours) and
`batched_search`. Tie multiplicity must be equal at every tolerance on the
8-bit table (integer distances, exact in both packages) and within one
query's share on the float table (the two float32 matmuls may move a
boundary distance by an ulp); id- and distance-recall within 0.01, the
share of rows on which the two graph searches may differ (their entry
scans round differently, ROADMAP C).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from flatnav_tpu.bench.synth import clustered as jax_clustered
from flatnav_tpu.index import batched_search as jax_search
from flatnav_tpu.index.serialize import load_index as jax_load
from flatnav_tpu.ops import brute_force_knn as jax_brute
from flatnav_tpu_torch.bench.synth import clustered
from flatnav_tpu_torch.index import create
from flatnav_tpu_torch.tools import diagnose_recall_ceiling as diag

N, NQ, EF, EXPAND = 2000, 96, 24, 2


# the 8-bit table at d=2: integer distances with exact ties at the k-th
@pytest.mark.parametrize("dtype,dim", [("float32", 16), ("uint8", 2)])
def test_diagnosis_matches_jax(tmp_path, dtype, dim):
    data, queries = clustered(N, dim, NQ, dtype=np.dtype(dtype), centers_per_64k=2048)
    index = create("l2", dim=dim, dataset_size=N, max_edges_per_node=8, device="cpu")
    index.add(data, ef_construction=32)
    path = str(tmp_path / "index.npz")
    index.save(path)

    out = diag.main([path, "--n", str(N), "--dim", str(dim), "--num-queries", str(NQ),
                     "--ef", str(EF), "--expand", str(EXPAND), "--dtype", dtype,
                     "--centers-per-64k", "2048", "--device", "cpu"])

    jdata, jq = jax_clustered(N, dim, NQ, dtype=np.dtype(dtype), centers_per_64k=2048)
    assert np.array_equal(jdata, data) and np.array_equal(jq, queries)
    g, metric, _ = jax_load(path)
    gt_d, gt_i = (np.asarray(x) for x in jax_brute(jnp.asarray(jdata), jnp.asarray(jq),
                                                   diag.GT_K, metric))
    r = jax_search(g.vectors, g.links, g.labels, g.num_nodes, jnp.asarray(jq), k=diag.K,
                   ef=EF, metric=metric, expand_factor=EXPAND)
    fi, fd = np.asarray(r.labels), np.asarray(r.dists)

    dk = gt_d[:, diag.K - 1 : diag.K]
    for name, eps in diag.TOLERANCES:
        mult = (gt_d <= dk * (1.0 + eps)).sum(1)
        got = out["ties"][name]
        tol = 0.0 if dtype == "uint8" else 1.0 / NQ
        assert abs(got["mean"] - float(mult.mean())) <= tol * diag.GT_K, name
        assert abs(got["frac_past_k"] - float((mult > diag.K).mean())) <= tol, name
    if dtype == "uint8":
        assert out["ties"]["exact"]["frac_past_k"] > 0  # the ties the table was cut for
    idr = np.mean([len(set(a.tolist()) & set(b.tolist())) / diag.K
                   for a, b in zip(fi, gt_i[:, : diag.K])])
    dr = float((fd[:, : diag.K] <= dk * (1 + 1e-6) + 1e-6).mean())
    assert abs(out["id_recall"] - idr) <= 0.01
    assert abs(out["dist_recall"] - dr) <= 0.01
    assert out["dist_recall"] >= out["id_recall"] - 1e-9
