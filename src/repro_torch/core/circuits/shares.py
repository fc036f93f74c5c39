"""Share-boundary circuits: the glue the protocol wraps around every
nonlinear function circuit (the paper's C̃: "integrates adding the secret
shares from both parties, processing the nonlinear function, and
subtracting a random matrix").

Values are additive shares mod prime t. GC words are k = bits(t)+2 wide
two's complement:

  reconstruct: v = a + b; if v ≥ t: v −= t; center to signed (v > t/2 ⇒ v−t)
  descale:     exact arithmetic shift by extra_frac (deferred truncation)
  remask:      y (signed) → y mod t → y + (t − r) mod t  (evaluator's share)
"""

from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.circuits import arith
from repro_torch.core.circuits.builder import CircuitBuilder, Word


def gc_word_bits(t: int) -> int:
    return t.bit_length() + 2


def reconstruct_shared(cb: CircuitBuilder, g_share: Word, e_share: Word,
                       t: int, descale: int = 0) -> Word:
    """g_share (garbler) + e_share (evaluator) mod t, centered signed,
    then >> descale (exact truncation inside GC)."""
    k = len(g_share)
    v = arith.add(cb, g_share, e_share)  # < 2t < 2^k
    tw = cb.const_word(t, k)
    ge = cb.INV(arith.lt_unsigned(cb, v, tw))  # v >= t
    v = arith.mux(cb, ge, arith.sub(cb, v, tw), v)
    half = cb.const_word(t // 2, k)
    over = cb.INV(arith.lt_unsigned(cb, v, half))  # v > t/2 ⇒ negative value
    v = arith.mux(cb, over, arith.sub(cb, v, tw), v)
    if descale:
        v = arith.shift_right_const(cb, v, descale, arithmetic=True)
    return v


def input_shared_word(cb: CircuitBuilder, t: int, descale: int = 0) -> Word:
    k = gc_word_bits(t)
    g = cb.g_input_word(k)
    e = cb.e_input_word(k)
    return reconstruct_shared(cb, g, e, t, descale)


def remask_output(cb: CircuitBuilder, y: Word, t: int,
                  mask: Word = None) -> Word:
    """y signed → (y mod t) + (t − r) mod t; r is a fresh garbler word.

    The evaluator learns only its share; the garbler's share is r.
    """
    k = len(y)
    tw = cb.const_word(t, k)
    neg = y[-1]
    v = arith.mux(cb, neg, arith.add(cb, y, tw), y)  # y mod t (|y| < t/2)
    m = mask if mask is not None else cb.g_input_word(k)
    s = arith.add(cb, v, m)  # m encodes (t − r)
    ge = cb.INV(arith.lt_unsigned(cb, s, tw))
    return arith.mux(cb, ge, arith.sub(cb, s, tw), s)


def output_shared(cb: CircuitBuilder, y: Word, t: int) -> Word:
    out = remask_output(cb, y, t)
    cb.output(out)
    return out
