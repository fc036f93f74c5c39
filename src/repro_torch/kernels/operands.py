"""Operand checks shared by the wrappers of the label kernels (level
eval/garble, Half-Gate gates): int32 bit-pattern words and (G, 4) labels
on one device, contiguous, and 16-byte aligned on the card (the kernels
load each label as one ``uint4``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def check(fn: str, words: Sequence[torch.Tensor],
          labels: Sequence[torch.Tensor]) -> Tuple[torch.device, int]:
    """words (G,) and labels (G, 4), all int32: returns (device, G)."""
    g = labels[0].shape[0]
    dev = labels[0].device
    for x in (*words, *labels):
        if x.device != dev:
            raise ValueError(f"{fn}: operands on {x.device} and {dev}")
        if x.dtype != torch.int32:
            raise TypeError(f"{fn}: operands must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: operands must be contiguous")
    for x in words:
        if tuple(x.shape) != (g,):
            raise ValueError(f"{fn}: expected ({g},), got {tuple(x.shape)}")
    for x in labels:
        if tuple(x.shape) != (g, 4):
            raise ValueError(f"{fn}: expected ({g}, 4), got {tuple(x.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")
    if dev.type == "cuda":
        for x in labels:
            if x.data_ptr() % 16:
                raise ValueError(f"{fn}: labels must be 16-byte aligned")
    return dev, g
