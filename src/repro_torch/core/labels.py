"""Wire-label algebra for garbled circuits.

A label is 128 bits stored as ``int32[..., 4]``: four 32-bit words, each
holding the bit pattern of the reference's ``uint32`` word (torch has no
unsigned 32-bit arithmetic on the CPU; the CUDA kernels reinterpret the
same memory as ``uint32_t``). The global FreeXOR offset R has its
point-and-permute (color) bit — bit 0 of word 0 — forced to 1, so
``lsb(W ^ R) != lsb(W)`` and the color bit of an active label selects
garbled table rows.

Labels are drawn from an explicit ``torch.Generator``. The draw runs on
the generator's device and the result moves to ``device``, so a CPU
generator with a given seed yields the same labels whatever device the
circuit is garbled on.
"""

from __future__ import annotations

import torch

LABEL_WORDS = 4
I32 = torch.int32


def random_labels(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """Uniform labels, shape (*shape, 4) int32 (all 2^32 words equally likely)."""
    x = torch.randint(-(1 << 31), 1 << 31, (*shape, LABEL_WORDS),
                      dtype=I32, generator=gen, device=gen.device)
    return x if device is None else x.to(device)


def random_delta(gen: torch.Generator, batch_shape=(), device=None
                 ) -> torch.Tensor:
    """FreeXOR offset R with color bit set."""
    r = random_labels(gen, batch_shape, device)
    r[..., 0] |= 1
    return r


def lsb(label: torch.Tensor) -> torch.Tensor:
    """Color bit, int32 {0,1}; label (..., 4) -> (...)."""
    return label[..., 0] & 1

