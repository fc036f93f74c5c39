"""Structural verification of netlists.

The structural half of the JAX package's ``analysis/netcheck.py``,
copied with its imports rewritten: ``verify_netlist`` lists every
violation of a netlist's invariants (op codes, wire ranges, one driver
per wire, topological order, no dangling reads, reachable outputs) and
``verify_netlist_strict`` raises on them. ``core/circuits/bristol.py``
runs it on every parsed file. The dataflow passes and the lint of the
reference's analysis package are not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.netlist import Netlist, OP_AND, OP_INV, OP_XOR

__all__ = ["NetlistError", "verify_netlist", "verify_netlist_strict"]


class NetlistError(ValueError):
    """A netlist violates a structural invariant."""


# ---------------------------------------------------------------------------
# structural verification
# ---------------------------------------------------------------------------


def verify_netlist(net: Netlist) -> List[str]:
    """All structural violations in ``net`` (empty list == well-formed)."""
    errs: List[str] = []
    G, W = net.num_gates, net.num_wires
    op, in0, in1, out = net.op, net.in0, net.in1, net.out
    if not (len(in0) == len(in1) == len(out) == G):
        return [f"gate arrays disagree on length: op={G} in0={len(in0)} "
                f"in1={len(in1)} out={len(out)}"]

    bad_op = np.nonzero(~np.isin(op, (OP_XOR, OP_AND, OP_INV)))[0]
    if len(bad_op):
        errs.append(f"gate {bad_op[0]}: op code {int(op[bad_op[0]])} "
                    f"not in {{XOR=0, AND=1, INV=2}}")

    for label, arr in (("in0", in0), ("in1", in1), ("out", out)):
        if G and (arr.min() < 0 or arr.max() >= W):
            g = int(np.nonzero((arr < 0) | (arr >= W))[0][0])
            errs.append(f"gate {g}: {label} wire {int(arr[g])} out of "
                        f"range [0, {W})")
    for label, arr in (("garbler input", net.garbler_inputs),
                       ("evaluator input", net.evaluator_inputs),
                       ("output", net.outputs)):
        a = np.asarray(arr)
        if len(a) and (a.min() < 0 or a.max() >= W):
            errs.append(f"{label} wire out of range [0, {W})")
    for w, b in net.const_bits.items():
        if not (0 <= int(w) < W):
            errs.append(f"const wire {w} out of range [0, {W})")
        if int(b) not in (0, 1):
            errs.append(f"const wire {w}: bit {b!r} is not 0/1")
    if errs:
        return errs  # range errors poison everything below

    inv_bad = np.nonzero((op == OP_INV) & (in0 != in1))[0]
    if len(inv_bad):
        g = int(inv_bad[0])
        errs.append(f"gate {g}: INV requires in1 == in0, got "
                    f"({int(in0[g])}, {int(in1[g])})")

    # exactly one driver per wire; drivers must not hit inputs/consts
    driver = np.full(W, -1, np.int64)
    for g in range(G):
        w = int(out[g])
        if driver[w] >= 0:
            errs.append(f"gate {g}: wire {w} already driven by gate "
                        f"{int(driver[w])} (duplicate driver)")
        driver[w] = g
    inputs = set(map(int, net.garbler_inputs)) | set(
        map(int, net.evaluator_inputs))
    dup_in = set(map(int, net.garbler_inputs)) & set(
        map(int, net.evaluator_inputs))
    for w in sorted(dup_in):
        errs.append(f"wire {w} claimed by both garbler and evaluator inputs")
    for w in sorted(inputs):
        if driver[w] >= 0:
            errs.append(f"input wire {w} is driven by gate {int(driver[w])}")
    for w in sorted(net.const_bits):
        w = int(w)
        if driver[w] >= 0:
            errs.append(f"const wire {w} is driven by gate {int(driver[w])} "
                        f"(conflicting const_bits)")
        if w in inputs:
            errs.append(f"const wire {w} is also a party input "
                        f"(conflicting const_bits)")

    # topological order + no reads of undriven, non-source wires
    defined = np.zeros(W, bool)
    defined[list(inputs)] = True
    defined[[int(w) for w in net.const_bits]] = True
    seen_driven = np.zeros(W, bool)
    for g in range(G):
        for w in ((int(in0[g]),) if op[g] == OP_INV
                  else (int(in0[g]), int(in1[g]))):
            if seen_driven[w] or defined[w]:
                continue
            if driver[w] >= 0:
                errs.append(f"gate {g}: reads wire {w} before gate "
                            f"{int(driver[w])} drives it (not topological)")
            else:
                errs.append(f"gate {g}: reads dangling wire {w} (never "
                            f"driven, not an input or constant)")
            defined[w] = True  # report each wire once
        seen_driven[int(out[g])] = True

    outs = [int(w) for w in net.outputs]
    if len(set(outs)) != len(outs):
        errs.append("duplicate wires in outputs")
    for w in outs:
        if driver[w] < 0 and w not in inputs and w not in net.const_bits:
            errs.append(f"output wire {w} is undriven")

    # outputs reachable from party inputs (a constant-only output computes
    # a public value inside GC — almost certainly a generator bug)
    if inputs:
        reach = np.zeros(W, bool)
        reach[list(inputs)] = True
        for g in range(G):
            r = reach[int(in0[g])]
            if op[g] != OP_INV:
                r = r or reach[int(in1[g])]
            if r:
                reach[int(out[g])] = True
        for w in outs:
            if 0 <= w < W and not reach[w] and w not in inputs \
                    and w not in net.const_bits:
                # declared const outputs are fine (folding can prove an
                # output bit, e.g. XFBQ's low product bit); an *undeclared*
                # input-independent output is a generator bug
                errs.append(f"output wire {w} is not reachable from any "
                            f"party input")
    return errs


def verify_netlist_strict(net: Netlist) -> None:
    """Raise :class:`NetlistError` on the first structural violations."""
    errs = verify_netlist(net)
    if errs:
        name = f" {net.name!r}" if net.name else ""
        head = "; ".join(errs[:4])
        more = f" (+{len(errs) - 4} more)" if len(errs) > 4 else ""
        raise NetlistError(f"malformed netlist{name}: {head}{more}")
