"""The port's multi-device dry run (flatnav_tpu_torch.parallel.
dryrun_multichip) on gloo ranks on the CPU, against the JAX package's
`__graft_entry__.dryrun_multichip` sequence on the same shapes of the
virtual CPU mesh.

The dry run checks every step's output inside the ranks (it raises
otherwise); these tests also hold its model-sharded build + search and its
exact scan to flatnav_tpu's on a (2, 2) mesh: >= 99% of result rows
identical, as the single-device port is held on float tables.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from flatnav_tpu.index.build import add_batch as jax_add_batch
from flatnav_tpu.index.graph import make_empty_graph as jax_empty
from flatnav_tpu.ops import MetricType as JMetric
from flatnav_tpu.parallel import make_mesh as jax_make_mesh
from flatnav_tpu.parallel import sharded_exact_search as jax_sharded_exact
from flatnav_tpu.parallel import sharded_search as jax_sharded_search
from flatnav_tpu_torch.parallel import dryrun_multichip


@pytest.fixture(scope="module")
def four():
    return dryrun_multichip(4, device="cpu", backend="gloo", timeout=300)


@pytest.fixture(scope="module")
def jax_four():
    """The JAX dry run's build, search and exact scan at 4 devices."""
    mesh = jax_make_mesh(n_devices=4, data=2, model=2)
    rng = np.random.default_rng(0)
    n, d, m = 512, 32, 8
    data = rng.standard_normal((n, d), dtype=np.float32)
    g = jax_add_batch(jax_empty(n, d, m), data, np.arange(n), ef_construction=16, metric=JMetric.L2,
                      max_wave=128, mesh=mesh, table_spec="model")
    queries = jnp.asarray(rng.standard_normal((32, d), dtype=np.float32))
    res = jax_sharded_search(g, queries, mesh, k=5, ef=16)
    rows = g.vectors.shape[0] - g.vectors.shape[0] % 2
    _, ei = jax_sharded_exact(g.vectors[:rows], g.num_nodes, queries, mesh, k=5)
    return {"labels": np.asarray(res.labels), "exact_ids": np.asarray(ei)}


def test_dryrun_runs_on_a_2x2_mesh(four):
    assert four["mesh"] == (2, 2)


def test_dryrun_large_table_is_split_over_model(four):
    # 2048 nodes: 2048 + 2048 padding rows, half on each model shard
    assert four["big_shard_rows"] == 2048


def test_dryrun_search_matches_jax(four, jax_four):
    assert four["search_labels"].shape == (32, 5)
    assert (four["search_labels"] == jax_four["labels"]).all(axis=1).mean() >= 0.99


def test_dryrun_exact_scan_matches_jax(four, jax_four):
    assert (four["exact_ids"] == jax_four["exact_ids"]).all(axis=1).mean() >= 0.99


def test_dryrun_on_three_ranks_pads_the_shards():
    # 1024 rows over a model axis of 3 (data 1): the last shard pads, which
    # the JAX package's sharded calls do not allow
    out = dryrun_multichip(3, device="cpu", backend="gloo", timeout=300)
    assert out["mesh"] == (1, 3)
    assert out["big_shard_rows"] == -(-(3072 + 4096) // 3)
