"""Multi-device execution over `torch.distributed`: the counterpart of
flatnav_tpu/parallel. One rank a device (`launch.run_ranks`), a
(data, model) `DeviceMesh` (`make_mesh`), and the sharded engines; the
mesh build is `index.build.add_batch(mesh=..., table_spec=...)`."""

from flatnav_tpu_torch.parallel.sharding import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    ShardedGraph,
    data_sharded,
    make_mesh,
    replicated,
    row_sharded,
    shard_graph,
    shard_rows,
)
from flatnav_tpu_torch.parallel.launch import run_ranks  # noqa: F401
from flatnav_tpu_torch.parallel.sharded_search import data_parallel_search  # noqa: F401
from flatnav_tpu_torch.parallel.sharded_graph import sharded_search  # noqa: F401
from flatnav_tpu_torch.parallel.sharded_exact import sharded_exact_search  # noqa: F401
from flatnav_tpu_torch.parallel.sharded_pq import sharded_pq_scan  # noqa: F401
from flatnav_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: F401
