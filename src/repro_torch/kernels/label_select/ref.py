"""Active-label encoding W = W0 ^ (bit ? R : 0): the plain PyTorch version.

Bit for bit the JAX package's ``kernels/label_select/ref.py``. This is
the protocol's input-garbling hot path: every fixed-point tensor entering
a garbled circuit is bit-decomposed (k bits per element × instances) and
each bit selects a label, on the garbler's side (``garble.encode_inputs``)
and through OT on the evaluator's (``ot.choose_labels``). Labels are int32
bit patterns (see ``core/labels.py``).
"""

from __future__ import annotations

import torch


def select_labels(zero_labels: torch.Tensor, r: torch.Tensor,
                  bits: torch.Tensor) -> torch.Tensor:
    """zero_labels (..., 4); r broadcastable (..., 4); bits (...,) {0,1}."""
    mask = (-(bits.to(torch.int32)))[..., None]  # 0x0 or 0xFFFFFFFF
    return zero_labels ^ (r & mask)
