"""flatnav_tpu_torch: the PyTorch / CUDA port of flatnav_tpu for NVIDIA
Hopper (H100).

Same public surface as flatnav_tpu (`index.create`, `Index.add`,
`search`, `search_exact`, `save`, `index.load_index`), in PyTorch, with the
JAX package's two Pallas TPU kernels written by hand in CUDA C++ for
sm_90a (`csrc/`). Entry points run on the CUDA card unless the caller
passes `device="cpu"`. The package imports nothing of JAX or of
flatnav_tpu; `convert` carries a JAX-built index across.
"""

from flatnav_tpu_torch import data_type  # noqa: F401
from flatnav_tpu_torch import index  # noqa: F401
from flatnav_tpu_torch.data_type import DataType  # noqa: F401
from flatnav_tpu_torch.ops.distances import MetricType  # noqa: F401

__version__ = "0.1.0"
