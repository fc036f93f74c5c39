"""Bristol Fashion netlist emit/parse [Tillich & Smart].

Format:
    <num_gates> <num_wires>
    <n_input_values> <wires_per_value...>
    <n_output_values> <wires_per_value...>
    (blank)
    2 1 <a> <b> <out> AND|XOR
    1 1 <a> <out> INV

Input value 0 = garbler inputs, value 1 = evaluator inputs, value 2
(when present) = constant wires (the format has no constants; we emit them
as a third input bundle and record their bits in a `# const:` header
comment, which our parser understands and foreign parsers skip).

A copy of the JAX package's ``core/circuits/bristol.py`` with the imports
rewritten: the port emits the same text for the same netlist.
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.netlist import Netlist, OP_AND, OP_INV, OP_XOR


def emit(net: Netlist) -> str:
    """Emit with Bristol wire numbering: inputs first, outputs last.

    Gate order already carries the topology, so renumbering is a pure
    permutation of ids.
    """
    outputs = [int(w) for w in net.outputs]
    assert len(set(outputs)) == len(outputs), "duplicate output wires"
    out_set = set(outputs)
    in_groups = [list(map(int, net.garbler_inputs)),
                 list(map(int, net.evaluator_inputs))]
    const_order = sorted(net.const_bits)
    if const_order:
        in_groups.append(const_order)

    remap = {}
    nxt = 0
    for g in in_groups:
        for w in g:
            remap[w] = nxt
            nxt += 1
    n_out = len(outputs)
    tail_start = net.num_wires - n_out
    for g in range(net.num_gates):
        w = int(net.out[g])
        if w not in remap and w not in out_set:
            remap[w] = nxt
            nxt += 1
    for i, w in enumerate(outputs):
        remap[w] = tail_start + i
    # any untouched wires (dangling inputs of nothing) — fill remaining slots
    for w in range(net.num_wires):
        if w not in remap:
            remap[w] = nxt
            nxt += 1

    lines: List[str] = []
    if const_order:
        bits = "".join(str(net.const_bits[w]) for w in const_order)
        mapped = " ".join(str(remap[w]) for w in const_order)
        lines.append(f"# const: {mapped} = {bits}")
    lines.append(f"{net.num_gates} {net.num_wires}")
    lines.append(
        " ".join([str(len(in_groups))] + [str(len(g)) for g in in_groups])
    )
    lines.append(f"1 {n_out}")
    lines.append("")
    names = {OP_AND: "AND", OP_XOR: "XOR", OP_INV: "INV"}
    for g in range(net.num_gates):
        op = int(net.op[g])
        if op == OP_INV:
            lines.append(
                f"1 1 {remap[int(net.in0[g])]} {remap[int(net.out[g])]} INV"
            )
        else:
            lines.append(
                f"2 1 {remap[int(net.in0[g])]} {remap[int(net.in1[g])]} "
                f"{remap[int(net.out[g])]} {names[op]}"
            )
    return "\n".join(lines) + "\n"


def parse(text: str, name: str = "", verify: bool = True) -> Netlist:
    """Parse a Bristol Fashion netlist.

    Malformed files — bad headers, wrong gate arity, non-integer or
    out-of-range wires, gate-count mismatches — raise ``ValueError``
    with the offending line, and the result is run through the
    structural verifier (:func:`repro_torch.analysis.verify_netlist_strict`:
    topological order, single drivers, const consistency, reachable
    outputs) so a foreign circuit fails HERE with a message instead of
    deep inside ``compile_level_plan`` or, worse, garbling the wrong
    function. ``verify=False`` skips the verifier (not the arity/range
    checks) for callers that deliberately build bad netlists.
    """

    def fail(msg: str, ln: str = "") -> "ValueError":
        where = f" in line {ln!r}" if ln else ""
        return ValueError(f"bristol parse{f' [{name}]' if name else ''}: "
                          f"{msg}{where}")

    def ints(parts: List[str], ln: str) -> List[int]:
        try:
            return [int(p) for p in parts]
        except ValueError:
            raise fail("non-integer field", ln) from None

    const_bits = {}
    lines = []
    for ln in text.splitlines():
        ln = ln.strip()
        if ln.startswith("# const:"):
            body = ln[len("# const:"):]
            if "=" not in body:
                raise fail("malformed '# const:' header", ln)
            wires_s, bits_s = body.split("=", 1)
            wires = ints(wires_s.split(), ln)
            bits = bits_s.strip()
            if len(bits) != len(wires) or set(bits) - {"0", "1"}:
                raise fail("const header bits must be one 0/1 per wire", ln)
            const_bits = {w: int(b) for w, b in zip(wires, bits)}
            continue
        if ln.startswith("#"):
            continue
        lines.append(ln)
    if len(lines) < 3:
        raise fail(f"expected >= 3 header lines, got {len(lines)}")
    hdr = ints(lines[0].split(), lines[0])
    if len(hdr) != 2:
        raise fail("header must be '<num_gates> <num_wires>'", lines[0])
    num_gates, num_wires = hdr
    if num_gates < 0 or num_wires <= 0:
        raise fail(f"bad sizes: {num_gates} gates, {num_wires} wires")
    in_hdr = ints(lines[1].split(), lines[1])
    if not in_hdr or len(in_hdr) != in_hdr[0] + 1:
        raise fail("input header must be '<n> <count_1> ... <count_n>'",
                   lines[1])
    in_counts = in_hdr[1:]
    # wires are assigned to inputs first, in declaration order
    cursor = 0
    groups = []
    for c in in_counts:
        groups.append(list(range(cursor, cursor + c)))
        cursor += c
    g_inputs = groups[0] if len(groups) > 0 else []
    e_inputs = groups[1] if len(groups) > 1 else []
    if len(groups) > 2 and not const_bits:
        const_bits = {w: 0 for w in groups[2]}
    out_hdr = ints(lines[2].split(), lines[2])
    if not out_hdr or len(out_hdr) != out_hdr[0] + 1:
        raise fail("output header must be '<n> <count_1> ... <count_n>'",
                   lines[2])
    n_out = sum(out_hdr[1:])
    if n_out > num_wires:
        raise fail(f"{n_out} output wires > {num_wires} total wires")

    arity = {"INV": (1, OP_INV), "NOT": (1, OP_INV),
             "AND": (2, OP_AND), "XOR": (2, OP_XOR)}
    ops, in0, in1, out = [], [], [], []
    for ln in lines[3:]:
        if not ln:
            continue
        parts = ln.split()
        kind = parts[-1].upper()
        if kind not in arity:
            raise fail(f"unsupported gate {kind!r}", ln)
        n_in, opc = arity[kind]
        fields = ints(parts[:-1], ln)
        if len(fields) != 2 + n_in + 1 or fields[0] != n_in \
                or fields[1] != 1:
            raise fail(f"{kind} gate must read '{n_in} 1 "
                       f"<in...> <out> {kind}'", ln)
        ops.append(opc)
        in0.append(fields[2])
        in1.append(fields[2] if n_in == 1 else fields[3])
        out.append(fields[2 + n_in])
    if len(ops) != num_gates:
        raise fail(f"header promises {num_gates} gates, file has "
                   f"{len(ops)}")
    # Bristol convention: outputs are the last n_out wires
    outputs = list(range(num_wires - n_out, num_wires))
    net = Netlist(
        num_wires=num_wires,
        op=np.asarray(ops, np.uint8),
        in0=np.asarray(in0, np.int32),
        in1=np.asarray(in1, np.int32),
        out=np.asarray(out, np.int32),
        garbler_inputs=np.asarray(g_inputs, np.int32),
        evaluator_inputs=np.asarray(e_inputs, np.int32),
        outputs=np.asarray(outputs, np.int32),
        const_bits=const_bits,
        name=name,
    )
    if verify:
        from repro_torch.analysis.netcheck import verify_netlist_strict
        verify_netlist_strict(net)  # raises NetlistError (a ValueError)
    return net
