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

``eval_walk`` / ``garble_walk`` run a whole level plan, chunk by chunk,
from the packed per-chunk records (:class:`WalkMeta`) that the walk
kernels read: the executor's CPU path, and the oracle of the walk
kernels on the card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

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


# ---------------------------------------------------------------------------
# whole walks over a level plan, from packed per-chunk records
# ---------------------------------------------------------------------------


class WalkMeta(NamedTuple):
    """One side's packed walk: a record per plan chunk.

    ``records`` is a contiguous ``(n_chunks, stride)`` int32 tensor. With
    ``ca``/``cf`` the plan's AND/free widths, a record holds, in order:

    ====================  ==========  ====================================
    field                 lanes       meaning
    ====================  ==========  ====================================
    gather                2ca + 2cf   store rows of ``[a | b | fa | fb]``
    dest                  ca + cf     commit rows ``base + argsort(perm)``
    tweak                 ca          Half-Gate tweak (the dense slot)
    op                    ca          1 on real AND lanes, 3 on pads
    slot (evaluate)       ca          table row, pads clamped to a real one
    table_base (garble)   1           first table-store row of the chunk
    ====================  ==========  ====================================

    padded with zeros to a multiple of 4 words (16 bytes). The walk's wire
    store is ``(store_rows, I, 4)``; ``table_rows`` is how many table rows
    the records address (evaluate: table slots, garble: the packed table
    store with its spill tail).
    """

    records: torch.Tensor
    and_width: int
    free_width: int
    garble: bool
    store_rows: int
    table_rows: int

    @property
    def n_chunks(self) -> int:
        return self.records.shape[0]

    @property
    def stride(self) -> int:
        return self.records.shape[1]


def walk_offsets(ca: int, cf: int) -> Dict[str, int]:
    """First word of each record field (see :class:`WalkMeta`)."""
    return {"gather": 0, "dest": 2 * ca + 2 * cf, "tweak": 3 * ca + 3 * cf,
            "op": 4 * ca + 3 * cf, "extra": 5 * ca + 3 * cf}


def walk_stride(ca: int, cf: int, garble: bool) -> int:
    n = walk_offsets(ca, cf)["extra"] + (1 if garble else ca)
    return -(-n // 4) * 4


def _chunk(meta: WalkMeta, k: int):
    ca, cf = meta.and_width, meta.free_width
    o = walk_offsets(ca, cf)
    rec = meta.records[k].long()
    return (rec[:o["dest"]], rec[o["dest"]:o["tweak"]],
            rec[o["tweak"]:o["op"]].int(), rec[o["op"]:o["extra"]].int(),
            rec[o["extra"]:])


def eval_walk(meta: WalkMeta, store, tg_rows, te_rows) -> None:
    """Evaluate every chunk of the walk in order, in place on ``store``
    ``(store_rows, I, 4)``; ``tg_rows``/``te_rows`` are ``(table_rows, I,
    4)`` row stores of the two table halves. Per chunk: gather all input
    rows, compute the AND lanes (:func:`eval_level`) and the free lanes
    (``fa ^ fb``), then commit both blocks."""
    ca, cf, I = meta.and_width, meta.free_width, store.shape[1]
    for k in range(meta.n_chunks):
        rows, dest, tw, ops, slot = _chunk(meta, k)
        g = store.index_select(0, rows)
        slot = slot[:ca]
        # per-lane words repeat over the instances: lane-major like labels
        out = eval_level(
            ops.repeat_interleave(I), g[:ca].view(-1, 4),
            g[ca:2 * ca].view(-1, 4),
            tg_rows.index_select(0, slot).view(-1, 4),
            te_rows.index_select(0, slot).view(-1, 4), tw.repeat_interleave(I))
        free = g[2 * ca:2 * ca + cf] ^ g[2 * ca + cf:]
        store.index_copy_(0, dest[:ca], out.view(ca, I, 4))
        store.index_copy_(0, dest[ca:], free)


def garble_walk(meta: WalkMeta, store, r, tg_store, te_store) -> None:
    """Garble every chunk of the walk in order, in place on ``store``
    ``(store_rows, I, 4)``, whose last row holds ``r`` ``(I, 4)`` (read by
    INV lanes); chunk k's table rows, pads included (zero), land at
    ``table_base[k] + lane`` of ``tg_store``/``te_store`` ``(table_rows,
    I, 4)``. Gather, compute, then commit, as :func:`eval_walk`."""
    ca, cf, I = meta.and_width, meta.free_width, store.shape[1]
    r_lanes = r.repeat(ca, 1)  # lane l * I + i holds r[i]
    for k in range(meta.n_chunks):
        rows, dest, tw, ops, extra = _chunk(meta, k)
        g = store.index_select(0, rows)
        tb = int(extra[0])
        c0, tg, te = garble_level(
            ops.repeat_interleave(I), g[:ca].view(-1, 4),
            g[ca:2 * ca].view(-1, 4), r_lanes, tw.repeat_interleave(I))
        tg_store[tb:tb + ca] = tg.view(ca, I, 4)
        te_store[tb:tb + ca] = te.view(ca, I, 4)
        free = g[2 * ca:2 * ca + cf] ^ g[2 * ca + cf:]
        store.index_copy_(0, dest[:ca], c0.view(ca, I, 4))
        store.index_copy_(0, dest[ca:], free)
