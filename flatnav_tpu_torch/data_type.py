"""Data type system for flatnav_tpu_torch.

Counterpart of flatnav_tpu/data_type.py: a small enum that maps onto torch
dtypes. float32, uint8 and int8 are the reference's wired-up types;
float16 and bfloat16 are extras.

numpy has no bfloat16, so a bfloat16 array crosses numpy (the .npz format,
the JAX package's arrays) as a uint16 view of its bits.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    """Mirrors flatnav.data_type.DataType (reference bindings.cpp:523-527)."""

    uint8 = "uint8"
    int8 = "int8"
    float16 = "float16"
    bfloat16 = "bfloat16"
    float32 = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def numpy_dtype(self) -> np.dtype:
        """The numpy dtype an array of this type has on the host. numpy has
        no bfloat16, so bfloat16 maps to uint16, the bit view `to_numpy`
        returns and `from_numpy(..., torch.bfloat16)` reads back (the JAX
        package returns ml_dtypes' bfloat16 here)."""
        if self is DataType.bfloat16:
            return np.dtype(np.uint16)
        return np.dtype(self.value)

    @property
    def is_integer(self) -> bool:
        return self in (DataType.uint8, DataType.int8)

    @property
    def size_bytes(self) -> int:
        """Per-element size (reference Datatype.h:75-119 `size()`)."""
        return self.torch_dtype.itemsize


def from_dtype(dtype) -> DataType:
    """Map a torch or numpy dtype (or its name) to a DataType member."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        name = np.dtype(dtype).name
    try:
        return DataType(name)
    except ValueError as e:
        raise ValueError(
            f"Unsupported index data type {name!r}; supported: "
            f"{[d.value for d in DataType]}"
        ) from e


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array; bfloat16 comes out as a uint16 bit view."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_numpy(a: np.ndarray, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy array -> CPU tensor. A uint16 array (or an ml_dtypes bfloat16
    array, as the JAX package hands out) read as `dtype=torch.bfloat16` is
    taken as raw bfloat16 bits, not converted by value."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16" or (
        dtype == torch.bfloat16 and a.dtype == np.uint16
    ):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(dtype)


def host_tensor(a) -> torch.Tensor:
    """A numpy array (or tensor) as a CPU tensor, without a copy where numpy
    allows one: a read-only array (a memory-mapped file, say) is copied, as
    torch cannot share memory it may not write."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU. A missing card with no explicit request raises; nothing falls
    back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flatnav_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
