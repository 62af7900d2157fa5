"""The device mesh, row sharding and the collectives the sharded engines use.

Counterpart of flatnav_tpu/parallel/sharding.py. One process ("rank") runs
on each device, through `torch.distributed` (`launch.run_ranks` starts the
ranks); the ranks form a two-axis `DeviceMesh`:

  * `data` axis: queries and a build wave's lanes split across it, the
    analog of the reference's thread pool (util/Multithreading.h); every
    data row of the mesh holds a whole table.
  * `model` axis: the rows of the node table (vectors, links, labels) split
    across it, for tables larger than one device's memory. A rank holds only
    its own rows (`shard_rows`, `shard_graph`).

Every rank receives the same global inputs (queries, data) and takes its
slice by its mesh coordinate; every rank returns the whole result, as
reading a sharded JAX array on the host does.

Collectives are all built from `all_reduce(SUM)` over one mesh axis's
group: `psum` is that sum. A merge in which exactly one rank contributes a
value and the others zeros (`where(own, x, 0)`; a mask never multiplies,
since NaN * 0 is NaN) is exact, because x + 0 == x; `gather_slice`, JAX's
`all_gather`, is such a merge of a zero buffer in which each rank fills its
own slot. gloo runs `all_reduce` on CPU and CUDA tensors alike, which lets
several ranks share one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from flatnav_tpu_torch.index.graph import GraphArrays

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: int | None = None, model: int = 1, *, device_type: str) -> DeviceMesh:
    """The (data, model) mesh over the process group `launch.run_ranks`
    initialised; `data` defaults to world_size // model. Rank r sits at
    (r // model, r % model)."""
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"{data} x {model} mesh != {world} ranks")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis` (JAX's `lax.axis_index`)."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_range(mesh: DeviceMesh, axis: str, n: int) -> tuple[int, int]:
    """This rank's slice [lo, hi) of n items split in order over `axis`."""
    s, i = axis_size(mesh, axis), axis_index(mesh, axis)
    return n * i // s, n * (i + 1) // s


def row_range(mesh: DeviceMesh, rows: int) -> tuple[int, int]:
    """This rank's rows [lo, hi) of a table of `rows` rows padded to divide
    by the model axis (as `shard_rows` pads)."""
    n_local = -(-rows // axis_size(mesh, MODEL_AXIS))
    lo = axis_index(mesh, MODEL_AXIS) * n_local
    return lo, lo + n_local


def shard_rows(t, mesh: DeviceMesh, self_loop: bool = False) -> torch.Tensor:
    """This rank's rows of `t` (numpy or tensor, any device) on its device.
    The rows are padded to divide by the model axis, as the JAX package's
    model-sharded build pads them (flatnav_tpu/index/build.py:610-623): with
    zeros, or with `self_loop` every link of a padding row is the row's own
    id (the untouched state of a links row). Only this rank's rows are
    copied to the device."""
    t = torch.as_tensor(t)
    rows = t.shape[0]
    lo, hi = row_range(mesh, rows)
    part = t[min(lo, rows) : min(hi, rows)]
    pad = hi - lo - part.shape[0]
    if pad:
        if self_loop:
            ids = torch.arange(hi - pad, hi, dtype=t.dtype)
            tail = ids[:, None].expand(pad, *t.shape[1:])
        else:
            tail = torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype)
        part = torch.cat([part, tail.to(part.device)])
    return part.to(mesh_device(mesh)).contiguous()


#: JAX's name for a table split over the model axis
row_sharded = shard_rows


def data_sharded(t, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's slice of a batch (numpy or tensor) over the data axis, on
    its device. The batch must divide by the data axis."""
    t = torch.as_tensor(t)
    n_data = axis_size(mesh, DATA_AXIS)
    if t.shape[0] % n_data:
        raise ValueError(f"batch {t.shape[0]} not divisible by data axis {n_data}")
    lo, hi = axis_range(mesh, DATA_AXIS, t.shape[0])
    return t[lo:hi].to(mesh_device(mesh))


def replicated(t, mesh: DeviceMesh) -> torch.Tensor:
    """The whole of `t` on this rank's device."""
    return torch.as_tensor(t).to(mesh_device(mesh))


def psum(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum of `t` over the ranks along `axis` (in place; returns `t`)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return t


def gather_slice(t: torch.Tensor, total: int, lo: int, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """[total, ...] on every rank of `axis`, where each rank contributes its
    rows `t` at [lo, lo + len(t)): a one-owner sum of zero buffers."""
    buf = torch.zeros((total,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    buf[lo : lo + t.shape[0]] = t
    return psum(buf, mesh, axis)


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """[S, *t.shape]: every rank's `t` along `axis`, in axis order (JAX's
    `lax.all_gather`)."""
    return gather_slice(t[None], axis_size(mesh, axis), axis_index(mesh, axis), mesh, axis)


@dataclasses.dataclass
class ShardedGraph(GraphArrays):
    """This rank's rows of a model-sharded graph: vectors, links and labels
    hold rows [offset, offset + n_local) of the global table, whose
    single-device form has `rows` vector rows (links' scratch row is row
    `rows`, which no rank owns). `num_nodes` and `capacity` are global."""

    rows: int = 0
    offset: int = 0

    def owned(self, ids: torch.Tensor):
        """(local ids clamped into [0, n_local), mask of the ids this rank
        owns) for global node ids."""
        n_local = self.vectors.shape[0]
        local = ids - self.offset
        own = (local >= 0) & (local < n_local)
        return torch.where(own, local, 0), own


def shard_graph(graph: GraphArrays, mesh: DeviceMesh) -> ShardedGraph:
    """This rank's rows of a full graph (on any device; the host, say), on
    the rank's device. Links are sharded like vectors; padding rows are
    self-loops."""
    rows = graph.vectors.shape[0]
    return ShardedGraph(
        vectors=shard_rows(graph.vectors, mesh),
        links=shard_rows(graph.links[:rows], mesh, self_loop=True),
        labels=shard_rows(graph.labels, mesh),
        num_nodes=graph.num_nodes,
        capacity=graph.capacity,
        rows=rows,
        offset=row_range(mesh, rows)[0],
    )


def unshard_rows(t: torch.Tensor, rows: int, mesh: DeviceMesh) -> np.ndarray:
    """The first `rows` rows of a model-sharded table as a host array, on
    every rank. For checks at small sizes: it builds the whole table on
    every rank's device."""
    full = all_gather(t, mesh, MODEL_AXIS).reshape((-1,) + tuple(t.shape[1:]))
    return full[:rows].cpu().numpy()


__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "ShardedGraph",
    "all_gather",
    "axis_index",
    "axis_range",
    "axis_size",
    "data_sharded",
    "gather_slice",
    "make_mesh",
    "mesh_device",
    "psum",
    "replicated",
    "row_range",
    "row_sharded",
    "shard_graph",
    "shard_rows",
    "unshard_rows",
]
