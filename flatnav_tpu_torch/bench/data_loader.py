"""Dataset loaders for the benchmark harness (numpy only).

A copy of flatnav_tpu/bench/data_loader.py, kept here so that the port
imports nothing of the JAX package; the same file gives the same arrays in
both. The reference harness's loaders (experiments/data_loader.py): .npy,
TexMex ivecs/bvecs/fvecs, and big-ann-benchmarks .fbin/.u8bin/.i8bin binary
formats, with optional [offset, limit) ranges via memmap. The
extension-based factory mirrors data_loader.py:222-243.
"""

from __future__ import annotations

import abc
import os
from typing import Optional

import numpy as np


class DatasetLoader(abc.ABC):
    """Abstract loader (data_loader.py:50-126 contract): returns
    (train, queries, ground_truth) numpy arrays."""

    def __init__(
        self,
        train_path: str,
        queries_path: str,
        gtruth_path: str,
        offset: int = 0,
        limit: Optional[int] = None,
    ):
        self.train_path = train_path
        self.queries_path = queries_path
        self.gtruth_path = gtruth_path
        self.offset = offset
        self.limit = limit

    @abc.abstractmethod
    def load_data(self):
        ...


class NpyDatasetLoader(DatasetLoader):
    """.npy triplet loader (data_loader.py NpyDatasetLoader)."""

    def load_data(self):
        train = np.load(self.train_path, mmap_mode="r")
        end = None if self.limit is None else self.offset + self.limit
        train = train[self.offset : end]
        queries = np.load(self.queries_path)
        gtruth = np.load(self.gtruth_path)
        return np.asarray(train), queries, gtruth


def _read_vecs(path: str, dtype, elem_size: int,
               offset: int = 0, limit: Optional[int] = None):
    """TexMex .{i,b,f}vecs: each row is [int32 dim][dim elements]
    (data_loader.py:7-47). Only the [offset, offset+limit) row range is
    copied out of the memmap — a 100M-row base file must never be
    materialized whole."""
    with open(path, "rb") as f:
        dim = np.frombuffer(f.read(4), dtype=np.int32)[0]
    row_bytes = 4 + dim * elem_size
    n = os.path.getsize(path) // row_bytes
    count = n - offset if limit is None else min(limit, n - offset)
    raw = np.memmap(path, dtype=np.uint8, mode="r", shape=(n, row_bytes))
    rows = raw[offset : offset + count, 4:]
    return np.ascontiguousarray(rows).view(dtype).reshape(count, dim)


class BvecsDatasetLoader(DatasetLoader):
    """TexMex format: bvecs (uint8) train/queries, ivecs ground truth."""

    def _load(self, path: str, offset: int = 0,
              limit: Optional[int] = None):
        if path.endswith(".bvecs"):
            return _read_vecs(path, np.uint8, 1, offset, limit)
        if path.endswith(".ivecs"):
            return _read_vecs(path, np.int32, 4, offset, limit)
        if path.endswith(".fvecs"):
            return _read_vecs(path, np.float32, 4, offset, limit)
        raise ValueError(f"unsupported TexMex file: {path}")

    def load_data(self):
        train = self._load(self.train_path, self.offset, self.limit)
        return train, self._load(self.queries_path), self._load(self.gtruth_path)


class BinaryDatasetLoader(DatasetLoader):
    """big-ann-benchmarks .fbin/.u8bin/.i8bin: [int32 n][int32 d][n*d elems]
    (data_loader.py:128-219), range reads via memmap."""

    _DTYPES = {".fbin": np.float32, ".u8bin": np.uint8, ".i8bin": np.int8}

    def _load(self, path: str, offset: int = 0, limit: Optional[int] = None):
        ext = os.path.splitext(path)[1]
        if ext not in self._DTYPES:
            raise ValueError(f"unsupported binary file: {path}")
        dtype = self._DTYPES[ext]
        with open(path, "rb") as f:
            n, d = np.frombuffer(f.read(8), dtype=np.int32)
        count = n - offset if limit is None else min(limit, n - offset)
        mm = np.memmap(
            path,
            dtype=dtype,
            mode="r",
            offset=8 + offset * d * np.dtype(dtype).itemsize,
            shape=(count, d),
        )
        return np.asarray(mm)

    def _load_gtruth(self, path: str):
        # ground truth: [int32 nq][int32 k][nq*k int32 ids][nq*k fp32 dists]
        with open(path, "rb") as f:
            nq, k = np.frombuffer(f.read(8), dtype=np.int32)
            ids = np.frombuffer(f.read(4 * nq * k), dtype=np.int32)
        return ids.reshape(nq, k)

    def load_data(self):
        train = self._load(self.train_path, self.offset, self.limit)
        queries = self._load(self.queries_path)
        gtruth = self._load_gtruth(self.gtruth_path)
        return train, queries, gtruth


def get_data_loader(
    train_path: str,
    queries_path: str,
    gtruth_path: str,
    offset: int = 0,
    limit: Optional[int] = None,
) -> DatasetLoader:
    """Extension-based factory (data_loader.py:222-243)."""
    for cls, exts in (
        (NpyDatasetLoader, (".npy",)),
        (BvecsDatasetLoader, (".bvecs", ".fvecs", ".ivecs")),
        (BinaryDatasetLoader, (".fbin", ".u8bin", ".i8bin")),
    ):
        if any(train_path.endswith(e) for e in exts):
            return cls(train_path, queries_path, gtruth_path, offset, limit)
    raise ValueError(f"cannot infer dataset format from {train_path}")
