from flatnav_tpu_torch.index.api import Index, create, load_index  # noqa: F401
from flatnav_tpu_torch.index.graph import (  # noqa: F401
    GraphArrays,
    graph_from_numpy,
    make_empty_graph,
    node_size_bytes,
)
from flatnav_tpu_torch.index.search import (  # noqa: F401
    batched_search,
    beam_search,
)
