from repro_torch.utils.tree import (
    tree_size_bytes,
    tree_num_params,
    tree_zeros_like,
    tree_cast,
    fmt_bytes,
)
from repro_torch.utils.log import get_logger

__all__ = [
    "tree_size_bytes",
    "tree_num_params",
    "tree_zeros_like",
    "tree_cast",
    "fmt_bytes",
    "get_logger",
]
