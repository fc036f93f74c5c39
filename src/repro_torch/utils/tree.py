"""Helpers on trees of nested dicts with tensor leaves.

The port of ``src/repro/utils/tree.py``. A tree is a dict whose values are
trees or leaves; ``None`` is an empty subtree, as in a JAX pytree.
``tree_leaves`` walks dict keys in sorted order, the order in which
``jax.tree_util`` flattens a dict, so a sum over the leaves adds in the
reference's order.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves, dict keys visited in sorted order (``None`` skipped)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def tree_num_params(tree) -> int:
    """Total number of elements over the leaves (a leaf with no shape
    counts 1)."""
    return int(sum(l.numel() if hasattr(l, "shape") else 1
                   for l in tree_leaves(tree)))


def tree_size_bytes(tree) -> int:
    return int(sum(l.numel() * l.element_size() for l in tree_leaves(tree)
                   if isinstance(l, torch.Tensor)))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_cast(tree, dtype):
    """Floating-point leaves cast to ``dtype``; the others as they are."""
    def _cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(_cast, tree)


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB", "PiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}EiB"
