"""Plain PyTorch version of one garbled netlist level, both sides.

Per gate (op ∈ {0:XOR, 1:AND, 2:INV, 3:PAD}):
    XOR -> a ^ b              (FreeXOR)
    AND -> HalfGate(a, b, tables, tweak)
    INV -> a                  (label passes through; semantics flip
                               garbler-side)
    PAD -> 0                  (padding lane of a compiled level plan)

The Half-Gate is computed on every lane and selected by op, branch-free,
exactly as the JAX package's ``kernels/level_eval/ref.py``. The garble
side zeroes the table rows off the AND lanes. This is the CPU path of
the wrappers in ``level_eval.py`` and the oracle their CUDA kernels are
held to.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.halfgate import ref as HG


def eval_level(ops, a, b, tg, te, tweaks):
    """ops (G,) int32; labels/tables (G, 4) int32; tweaks (G,). -> (G, 4)."""
    and_out = HG.eval_and_gates(a, b, tg, te, tweaks)
    is_and = (ops == 1)[:, None]
    is_inv = (ops == 2)[:, None]
    is_pad = (ops >= 3)[:, None]
    out = torch.where(is_and, and_out, a ^ b)
    out = torch.where(is_inv, a, out)
    return torch.where(is_pad, torch.zeros_like(out), out)


def garble_level(ops, a0, b0, r, tweaks):
    """Garbler-side level pass.

    ops (G,) int32; a0/b0/r (G, 4) zero-labels and FreeXOR offset;
    tweaks (G,). Returns (c0, tg, te), each (G, 4): the output zero-label
    plus the two Half-Gate table rows (zero off the AND lanes).
    """
    c_and, tg, te = HG.garble_and_gates(a0, b0, r, tweaks)
    is_and = (ops == 1)[:, None]
    is_inv = (ops == 2)[:, None]
    is_pad = (ops >= 3)[:, None]
    zero = torch.zeros_like(tg)
    c0 = torch.where(is_and, c_and, a0 ^ b0)
    c0 = torch.where(is_inv, a0 ^ r, c0)
    c0 = torch.where(is_pad, zero, c0)
    return c0, torch.where(is_and, tg, zero), torch.where(is_and, te, zero)
