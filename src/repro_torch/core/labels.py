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

import numpy as np
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



# ---------------------------------------------------------------------------
# PRG label streams (v2 wire format)
# ---------------------------------------------------------------------------


def stream_seed(rng: np.random.Generator) -> bytes:
    """Mint a 16-byte seed for an *active*-label stream.

    The approved way to create a transmittable label seed: the stream it
    expands to (:func:`stream_labels`) is one label per wire — active
    labels the receiver is entitled to anyway — never a (zero, one) pair,
    so shipping the seed reveals nothing the raw stream would not. Do NOT
    ship garbling generators (the protocol's ``torch.Generator``): those
    expand to R and both labels of every wire.
    """
    return rng.bytes(16)


def stream_labels(seed: bytes, counter: int, count: int,
                  device=None) -> torch.Tensor:
    """Deterministic label stream: (count, 4) int32 from (seed, counter).

    Counter-mode Philox keyed by the 128-bit seed, drawn with numpy on the
    host exactly as the JAX package draws it, so both packages replay the
    same stream; ``counter`` is the stream offset in labels, so both
    endpoints can derive any window of the stream independently. This is
    the replay side of a v2 seed-stream segment
    (:func:`repro_torch.net.wire.pack_seed_stream`). The words come out as
    int32 bit patterns, on ``device`` if given.
    """
    bg = np.random.Philox(key=int.from_bytes(seed, "little"))
    # one Philox counter block is 4×64 bits = two labels; an odd label
    # offset additionally skips one drawn label
    if counter:
        bg.advance(counter // 2)
    skip = counter % 2
    raw = np.random.Generator(bg).integers(
        0, 1 << 64, size=(max(count, 0) + skip) * 2, dtype=np.uint64,
        endpoint=False)
    words = raw[2 * skip:].view(np.int32).reshape(count, LABEL_WORDS)
    out = torch.from_numpy(words.copy())
    return out if device is None else out.to(device)
