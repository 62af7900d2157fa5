from flatnav_tpu_torch.quantization.kmeans import kmeans  # noqa: F401
from flatnav_tpu_torch.quantization.pq import (  # noqa: F401
    ProductQuantizer,
    pack_codes_4bit,
    pack_codes_lanes,
    unpack_codes_4bit,
)
from flatnav_tpu_torch.quantization.pq_index import PQIndex  # noqa: F401
