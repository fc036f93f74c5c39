from repro_torch.sched.schedulers import (
    depth_first_order,
    full_reorder,
    segment_reorder,
    fine_grained_order,
    coarse_grained_partition,
)

__all__ = [
    "depth_first_order",
    "full_reorder",
    "segment_reorder",
    "fine_grained_order",
    "coarse_grained_partition",
]
