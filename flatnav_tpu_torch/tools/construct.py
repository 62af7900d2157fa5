"""Build and save an index from a dataset file.

Counterpart of tools/construct.py, the CLI analog of the reference's
construct_npy tool (tools/construct_npy.cpp:92-133 argument contract):

  python -m flatnav_tpu_torch.tools.construct <metric: 0=l2, 1=angular>
      <data file> <M> <ef_construction> <output index file>
      [--data-type float32|uint8|int8] [--quantized] [--device cpu]

Dataset files: .npy (through the native reader where it is built),
.fvecs/.bvecs/.ivecs, .fbin/.u8bin/.i8bin. The index is built on the CUDA
card unless `--device cpu` is given. The saved file loads in flatnav_tpu
too (the two packages share the .npz format).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def load_vectors(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        from flatnav_tpu_torch import native

        arr = native.npy_read(path)
        return arr if arr is not None else np.load(path)
    from flatnav_tpu_torch.bench.data_loader import get_data_loader

    return get_data_loader(path, path, path)._load(path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("metric", type=int, choices=[0, 1], help="0=l2 1=angular")
    ap.add_argument("data", help="dataset file (.npy/.fvecs/.fbin/...)")
    ap.add_argument("m", type=int, help="max edges per node (M)")
    ap.add_argument("ef_construction", type=int)
    ap.add_argument("output", help="output index file (.npz)")
    ap.add_argument(
        "--data-type", default="float32",
        choices=["float32", "uint8", "int8", "float16", "bfloat16"],
    )
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument(
        "--quantized", action="store_true",
        help="product-quantized build (PQIndex; reference "
             "construct_npy.cpp:61-75)",
    )
    ap.add_argument("--pq-m", type=int, default=8,
                    help="PQ subquantizers (with --quantized)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import flatnav_tpu_torch
    from flatnav_tpu_torch.data_type import DataType

    data = load_vectors(args.data)
    if args.limit:
        data = data[: args.limit]
    n, dim = data.shape
    print(f"loaded {n} x {dim} {data.dtype} vectors from {args.data}")

    if args.quantized:
        from flatnav_tpu_torch.ops import MetricType
        from flatnav_tpu_torch.quantization import PQIndex, ProductQuantizer

        metric = MetricType.L2 if args.metric == 0 else MetricType.IP
        t0 = time.perf_counter()
        pq = ProductQuantizer(
            dim=dim, num_subquantizers=args.pq_m, metric=metric,
            device=args.device,
        ).train(np.asarray(data[: min(n, 262_144)], np.float32))
        print(f"PQ train time: {time.perf_counter() - t0:.1f}s")
        index = PQIndex(pq, dataset_size=n, max_edges_per_node=args.m)
        t0 = time.perf_counter()
        index.add(np.asarray(data, np.float32),
                  ef_construction=args.ef_construction)
        print(f"build time: {time.perf_counter() - t0:.1f}s")
        index.save(args.output)
        print(f"saved PQ index to {args.output}")
        return

    index = flatnav_tpu_torch.index.create(
        distance_type="l2" if args.metric == 0 else "angular",
        dim=dim,
        dataset_size=n,
        max_edges_per_node=args.m,
        index_data_type=DataType(args.data_type),
        verbose=True,
        device=args.device,
    )
    t0 = time.perf_counter()
    index.add(np.asarray(data), ef_construction=args.ef_construction)
    print(f"build time: {time.perf_counter() - t0:.1f}s")
    index.save(args.output)  # copies the arrays to the host: the build is done
    print(f"saved index to {args.output}")


if __name__ == "__main__":
    main()
