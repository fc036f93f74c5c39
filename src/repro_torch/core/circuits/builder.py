"""Circuit construction DSL with aggressive constant folding.

The paper's "GC-friendly circuit generation" premise is that the *structure*
of the circuit — not just post-hoc XAG rewriting — determines AND count.
The builder therefore folds at build time:

    XOR(x,0)=x  XOR(x,1)=INV(x)  XOR(x,x)=0  XOR(c1,c2)=const
    AND(x,1)=x  AND(x,0)=0       AND(x,x)=x  AND(c1,c2)=const
    INV(INV(x))=x                INV(const)=const

so e.g. multiplications by constants, mux trees over constant tables, and
the XFBQ correction terms are automatically reduced — reproducing the
"modify the fundamental implementation" effect (§3.2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.netlist import Netlist, OP_AND, OP_INV, OP_XOR


@dataclass(frozen=True)
class Word:
    """Little-endian fixed-width bundle of wire ids (two's complement)."""

    bits: Tuple[int, ...]

    def __len__(self):
        return len(self.bits)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Word(self.bits[i])
        return self.bits[i]

    def __iter__(self):
        return iter(self.bits)


class CircuitBuilder:
    def __init__(self, name: str = ""):
        self.name = name
        self._ops: List[int] = []
        self._in0: List[int] = []
        self._in1: List[int] = []
        self._out: List[int] = []
        self._n = 0
        self._g_inputs: List[int] = []
        self._e_inputs: List[int] = []
        self._outputs: List[int] = []
        self._const_of: Dict[int, int] = {}  # wire -> 0/1 (known constant)
        self._const_wire: Dict[int, int] = {}  # bit -> materialized wire
        self._inv_of: Dict[int, int] = {}  # wire -> its INV wire (dedup)
        self._cse: Dict[Tuple[int, int, int], int] = {}  # structural dedup

    # ---- wires -------------------------------------------------------------
    def _new(self) -> int:
        w = self._n
        self._n += 1
        return w

    def g_input(self) -> int:
        w = self._new()
        self._g_inputs.append(w)
        return w

    def e_input(self) -> int:
        w = self._new()
        self._e_inputs.append(w)
        return w

    def g_input_word(self, width: int) -> Word:
        return Word(tuple(self.g_input() for _ in range(width)))

    def e_input_word(self, width: int) -> Word:
        return Word(tuple(self.e_input() for _ in range(width)))

    def constant(self, bit: int) -> int:
        bit = int(bit) & 1
        if bit not in self._const_wire:
            w = self._new()
            # const wires are neither gate outputs nor party inputs; the
            # garbler knows their bits and supplies active labels directly.
            self._const_of[w] = bit
            self._const_wire[bit] = w
        return self._const_wire[bit]

    def const_word(self, value: int, width: int) -> Word:
        return Word(tuple(self.constant((value >> i) & 1) for i in range(width)))

    def is_const(self, w: int) -> Optional[int]:
        return self._const_of.get(w)

    # ---- gates (with folding) -----------------------------------------------
    def _emit(self, op: int, a: int, b: int) -> int:
        w = self._new()
        self._ops.append(op)
        self._in0.append(a)
        self._in1.append(b)
        self._out.append(w)
        return w

    def XOR(self, a: int, b: int) -> int:
        ca, cb = self.is_const(a), self.is_const(b)
        if ca is not None and cb is not None:
            return self.constant(ca ^ cb)
        if ca is not None:
            a, b, ca, cb = b, a, cb, ca
        if cb == 0:
            return a
        if cb == 1:
            return self.INV(a)
        if a == b:
            return self.constant(0)
        if self._inv_of.get(a) == b:
            return self.constant(1)
        key = (OP_XOR, a, b) if a < b else (OP_XOR, b, a)
        w = self._cse.get(key)
        if w is None:
            w = self._cse[key] = self._emit(OP_XOR, a, b)
        return w

    def AND(self, a: int, b: int) -> int:
        ca, cb = self.is_const(a), self.is_const(b)
        if ca is not None and cb is not None:
            return self.constant(ca & cb)
        if ca is not None:
            a, b, ca, cb = b, a, cb, ca
        if cb == 0:
            return self.constant(0)
        if cb == 1:
            return a
        if a == b:
            return a
        if self._inv_of.get(a) == b:
            return self.constant(0)
        key = (OP_AND, a, b) if a < b else (OP_AND, b, a)
        w = self._cse.get(key)
        if w is None:
            w = self._cse[key] = self._emit(OP_AND, a, b)
        return w

    def INV(self, a: int) -> int:
        ca = self.is_const(a)
        if ca is not None:
            return self.constant(1 - ca)
        if a in self._inv_of:
            return self._inv_of[a]
        w = self._emit(OP_INV, a, a)
        self._inv_of[a] = w
        self._inv_of[w] = a
        return w

    def OR(self, a: int, b: int) -> int:
        return self.INV(self.AND(self.INV(a), self.INV(b)))

    def MUX(self, sel: int, a: int, b: int) -> int:
        """sel ? a : b — one AND."""
        return self.XOR(b, self.AND(sel, self.XOR(a, b)))

    # ---- finalize -----------------------------------------------------------
    def output(self, wires) -> None:
        if isinstance(wires, Word):
            wires = wires.bits
        if isinstance(wires, int):
            wires = [wires]
        self._outputs.extend(wires)

    def build(self, prune: bool = True) -> Netlist:
        """Finalize into a Netlist.

        ``prune=True`` (default) drops gates whose output never reaches a
        netlist output — composed generators routinely compute wide
        intermediate words and then slice (e.g. ``exp``'s widened q
        product), leaving whole dead cones that would still cost garbled
        tables and hash lanes. Party input wires are always kept (the
        protocol's I/O contract); unused constant wires are dropped.
        Wires are renumbered compactly, preserving creation order (and
        therefore topological gate order).
        """
        ops, in0, in1, out = self._ops, self._in0, self._in1, self._out
        G, W = len(ops), self._n
        if prune and G:
            needed = bytearray(W)
            for w in self._outputs:
                needed[w] = 1
            live = bytearray(G)
            for g in range(G - 1, -1, -1):
                if needed[out[g]]:
                    live[g] = 1
                    needed[in0[g]] = 1
                    if ops[g] != OP_INV:
                        needed[in1[g]] = 1
            if not all(live):
                keep_wire = bytearray(W)
                for w in self._g_inputs:
                    keep_wire[w] = 1
                for w in self._e_inputs:
                    keep_wire[w] = 1
                for w in self._outputs:
                    keep_wire[w] = 1
                for w in self._const_of:
                    if needed[w]:
                        keep_wire[w] = 1
                for g in range(G):
                    if live[g]:
                        keep_wire[in0[g]] = 1
                        keep_wire[in1[g]] = 1
                        keep_wire[out[g]] = 1
                remap = np.cumsum(
                    np.frombuffer(keep_wire, np.uint8)).astype(np.int32) - 1
                lv = np.frombuffer(live, np.uint8).astype(bool)
                return Netlist(
                    num_wires=int(remap[-1]) + 1,
                    op=np.asarray(ops, np.uint8)[lv],
                    in0=remap[np.asarray(in0, np.int32)[lv]],
                    in1=remap[np.asarray(in1, np.int32)[lv]],
                    out=remap[np.asarray(out, np.int32)[lv]],
                    garbler_inputs=remap[np.asarray(
                        self._g_inputs, np.int32)],
                    evaluator_inputs=remap[np.asarray(
                        self._e_inputs, np.int32)],
                    outputs=remap[np.asarray(self._outputs, np.int32)],
                    const_bits={int(remap[w]): b
                                for w, b in self._const_of.items()
                                if needed[w]},
                    name=self.name,
                )
        return Netlist(
            num_wires=W,
            op=np.asarray(ops, np.uint8),
            in0=np.asarray(in0, np.int32),
            in1=np.asarray(in1, np.int32),
            out=np.asarray(out, np.int32),
            garbler_inputs=np.asarray(self._g_inputs, np.int32),
            evaluator_inputs=np.asarray(self._e_inputs, np.int32),
            outputs=np.asarray(self._outputs, np.int32),
            const_bits=dict(self._const_of),
            name=self.name,
        )
