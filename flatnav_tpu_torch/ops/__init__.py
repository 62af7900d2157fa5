from flatnav_tpu_torch.ops.distances import (  # noqa: F401
    MetricType,
    brute_force_knn,
    fast_knn,
    pairwise_distances,
    query_block_distances,
    squared_norms,
)
from flatnav_tpu_torch.ops.fused_scan import fused_knn  # noqa: F401
from flatnav_tpu_torch.ops.gather_distance import gather_distances  # noqa: F401
from flatnav_tpu_torch.ops.routed_scan import (  # noqa: F401
    RoutedScan,
    build_routed_scan,
    routed_knn,
)
