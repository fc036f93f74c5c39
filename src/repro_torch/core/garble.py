"""Garbling and evaluation of netlists, batched over instances.

Gates run one compiled plan chunk at a time, vectorized across
(instances × gates-in-chunk), through the device-resident executor of
:mod:`repro_torch.core.gc_exec`. The paper's coarse-grained scheduling
(independent softmax rows -> cores) becomes the leading ``instances``
dim.

Labels and tables are int32 tensors (uint32 bit patterns) on the
caller's ``device``; the JAX package's host-side numpy walk
(``impl="ref"``) is its oracle and is not ported. Labels are drawn from
an explicit ``torch.Generator``: R first, then the source wires'
zero-labels, so one seed gives the same circuit on every device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import labels as LB
from repro_torch.core.gc_exec import get_executor
from repro_torch.core.netlist import Netlist
from repro_torch.kernels.label_select.label_select import select_labels

I32 = torch.int32


@dataclass
class GarbledCircuit:
    """Garbler-side artifact for a batch of instances.

    Input zero-labels are position-indexed: ``input_zero[:, j]`` is the
    zero-label of wire ``input_wires[j]`` (garbler inputs, then evaluator
    inputs, then constant wires). ``input_positions`` maps wire ids to
    positions through a dense lookup.
    """

    net: Netlist
    r: torch.Tensor  # (I, 4)
    input_wires: np.ndarray  # (n_in,) wire ids in position order
    input_zero: torch.Tensor  # (I, n_in, 4) zero-labels, position-indexed
    tables: torch.Tensor  # (I, nAND, 2, 4)
    output_perm: torch.Tensor  # (I, n_out) color bit of the FALSE label
    wire_zero: Optional[torch.Tensor] = None  # (I, W, 4) if kept
    _pos: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def num_instances(self) -> int:
        return self.r.shape[0]

    @property
    def device(self) -> torch.device:
        return self.r.device

    def input_positions(self, wire_ids) -> np.ndarray:
        """Positions of ``wire_ids`` in the packed ``input_zero`` array."""
        if self._pos is None:
            pos = np.full(self.net.num_wires, -1, np.int64)
            pos[self.input_wires] = np.arange(len(self.input_wires))
            self._pos = pos
        p = self._pos[np.asarray(wire_ids, np.int64)]
        if len(p) and p.min(initial=0) < 0:
            raise KeyError("wire ids are not input/const wires")
        return p


def _input_ids(net: Netlist) -> np.ndarray:
    """Position order of the packed input labels (stable across paths)."""
    if not net.num_wires:
        return np.array([], np.int64)
    return np.concatenate([
        net.garbler_inputs, net.evaluator_inputs,
        np.array(sorted(net.const_bits), dtype=np.int64),
    ]).astype(np.int64)


def _index(pos: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(pos, dtype=torch.int64, device=device)


def _seeded_zero_labels(seeded_inputs, instances: int, r: torch.Tensor):
    """Zero-labels for wires whose *active* labels come from a PRG stream.

    ``seeded_inputs`` is ``(wire_ids, bits, seed, counter)``: the garbler
    commits that the active label of wire ``wire_ids[j]`` in instance
    ``i`` is stream label ``counter + i*n + j``, so the zero-label must
    be ``active ^ bits * R`` (one label-select launch on the card).
    ``encode_inputs`` on those wires then reproduces the stream exactly —
    which is what lets the v2 wire ship a 32-byte seed record instead of
    the label bytes.
    """
    wire_ids, bits, seed, counter = seeded_inputs
    wire_ids = np.asarray(wire_ids, np.int64)
    n = len(wire_ids)
    active = LB.stream_labels(seed, counter, instances * n, r.device)
    return wire_ids, select_labels(active.reshape(instances, n, 4),
                                   r[:, None, :], bits)


def garble(net: Netlist, gen: torch.Generator, instances: int = 1, *,
           device="cuda", keep_wires: bool = False,
           seeded_inputs=None) -> GarbledCircuit:
    """Garble ``instances`` independent copies of ``net`` on ``device``.

    ``keep_wires`` needs every gate's row alive at the end, so it pins
    the append-only (compact=False) plan; the default garbles through the
    liveness-compacted store on the garble-width plan.

    ``seeded_inputs=(wire_ids, bits, seed, counter)`` presets the listed
    input wires so their active labels replay a PRG stream (see
    :func:`_seeded_zero_labels`); all other wires draw fresh labels, in
    the same generator order as without it.
    """
    I = instances
    in_ids = _input_ids(net)
    exe = get_executor(net, I, device, compact=not keep_wires,
                       garbling=True)
    plan = exe.plan
    r = LB.random_delta(gen, (I,), device)
    src_labels = LB.random_labels(gen, (I, len(plan.source_ids)), device)
    if seeded_inputs is not None:
        wids, zeros = _seeded_zero_labels(seeded_inputs, I, r)
        src_labels[:, _index(plan.source_positions(wids), device)] = zeros
    res = exe.garble(src_labels, r, keep_wires=keep_wires)
    src_zero, tables, out_perm = res[:3]
    in_zero = src_zero[:, _index(plan.source_positions(in_ids), device)]
    return GarbledCircuit(
        net=net, r=r, input_wires=in_ids, input_zero=in_zero,
        tables=tables, output_perm=out_perm,
        wire_zero=res[3] if keep_wires else None,
    )


def slice_instances(gc: GarbledCircuit, lo: int, hi: int) -> GarbledCircuit:
    """A view of instances [lo, hi) of a batch-garbled circuit.

    Sessions garble once per cached netlist for a whole preprocessing
    batch, then hand each op/request its instance band.
    """
    return GarbledCircuit(
        net=gc.net,
        r=gc.r[lo:hi],
        input_wires=gc.input_wires,
        input_zero=gc.input_zero[lo:hi],
        tables=gc.tables[lo:hi],
        output_perm=gc.output_perm[lo:hi],
        wire_zero=None if gc.wire_zero is None else gc.wire_zero[lo:hi],
        _pos=gc._pos,
    )


def input_zeros(gc: GarbledCircuit, wire_ids: Sequence[int]) -> torch.Tensor:
    """Zero-labels for the given input/const wires: one gather, (I, n, 4)."""
    return gc.input_zero[:, _index(gc.input_positions(wire_ids), gc.device)]


def encode_inputs(gc: GarbledCircuit, wire_ids: Sequence[int], bits
                  ) -> torch.Tensor:
    """Active labels for given wires/bits. bits: (I, n) in {0,1}.

    This is the garbler-side encode (and what OT delivers for evaluator
    inputs). Returns (I, n, 4).
    """
    return select_labels(input_zeros(gc, wire_ids), gc.r[:, None, :], bits)


def const_wires_labels(gc: GarbledCircuit) -> Tuple[np.ndarray, torch.Tensor]:
    """Active labels of constant wires, packed: (wire_ids, (I, n_c, 4))."""
    if not gc.net.const_bits:
        return (np.array([], np.int64),
                torch.zeros((gc.num_instances, 0, 4), dtype=I32,
                            device=gc.device))
    wires = np.array(sorted(gc.net.const_bits), np.int64)
    bits = np.array([gc.net.const_bits[int(w)] for w in wires], np.int32)
    lab = encode_inputs(gc, wires, np.broadcast_to(bits, (gc.num_instances,
                                                          len(wires))))
    return wires, lab


def const_labels(gc: GarbledCircuit) -> Dict[int, torch.Tensor]:
    """Active labels of constant wires (garbler supplies with the tables)."""
    wires, lab = const_wires_labels(gc)
    return {int(w): lab[:, j] for j, w in enumerate(wires)}


def evaluate(net: Netlist, tables: torch.Tensor,
             active: Tuple[np.ndarray, torch.Tensor]) -> torch.Tensor:
    """Evaluator: active labels for all input+const wires -> output labels.

    ``active`` is packed ``(wire_ids (n,), labels (I, n, 4))``; the walk
    runs on the labels' device. Returns (I, n_out, 4).
    """
    wire_ids, labels = active
    I = labels.shape[0]
    dev = labels.device
    exe = get_executor(net, I, dev)
    plan = exe.plan
    pos = _index(plan.source_positions(np.asarray(wire_ids, np.int64)), dev)
    packed = torch.zeros((I, len(plan.source_ids), 4), dtype=I32, device=dev)
    packed[:, pos] = labels.to(I32)
    return exe.evaluate(packed, tables)


def decode_outputs(gc: GarbledCircuit, out_labels: torch.Tensor) -> np.ndarray:
    """(I, n_out, 4) active labels -> (I, n_out) bits via output permute bits."""
    return (LB.lsb(out_labels) ^ gc.output_perm).cpu().numpy().astype(np.uint8)


# ---------------------------------------------------------------------------
# convenience: end-to-end two-party run (tests / engine)
# ---------------------------------------------------------------------------


def run_garbled(net: Netlist, gen: torch.Generator, garbler_bits,
                evaluator_bits, *, device="cuda") -> np.ndarray:
    """Full garble -> encode -> evaluate -> decode round trip.

    garbler_bits: (I, len(garbler_inputs)); evaluator_bits: (I, len(eval)).
    Returns (I, n_out) uint8 — must equal net.eval_plain(...).
    """
    garbler_bits = np.atleast_2d(np.asarray(garbler_bits, np.int32))
    evaluator_bits = np.atleast_2d(np.asarray(evaluator_bits, np.int32))
    I = garbler_bits.shape[0]
    gc = garble(net, gen, I, device=device)
    parts = []
    if len(net.garbler_inputs):
        parts.append((np.asarray(net.garbler_inputs, np.int64),
                      encode_inputs(gc, net.garbler_inputs, garbler_bits)))
    if len(net.evaluator_inputs):
        parts.append((np.asarray(net.evaluator_inputs, np.int64),
                      encode_inputs(gc, net.evaluator_inputs,
                                    evaluator_bits)))  # via OT
    cw, cl = const_wires_labels(gc)
    if len(cw):
        parts.append((cw, cl))
    wire_ids = np.concatenate([p[0] for p in parts]) if parts else \
        np.array([], np.int64)
    labels = torch.cat([p[1] for p in parts], dim=1) if parts else \
        torch.zeros((I, 0, 4), dtype=I32, device=gc.device)
    out = evaluate(net, gc.tables, (wire_ids, labels))
    return decode_outputs(gc, out)
