"""Netlist structural verification and dataflow analysis (pillar 1).

``verify_netlist`` checks the invariants every consumer of a
:class:`~repro_torch.core.netlist.Netlist` assumes but none re-checks:
topological gate order, no duplicate-driven wires, op codes and wire ids
in range, ``const_bits`` consistency (const wires are neither gate
outputs nor party inputs, bits are 0/1), INV arity, no reads of undriven
wires, and outputs that are actually driven and reachable from party
inputs. ``compile_level_plan`` would either crash opaquely or —
worse — silently garble the wrong function on such a netlist; the
Bristol import path routes through :func:`verify_netlist_strict` so
malformed files die with a clear ``ValueError`` instead.

``analyze_netlist`` runs the dataflow passes:

* **constant propagation** — forward walk with an alias lattice
  (wire -> value token; negation is token^1) folding
  XOR/AND/INV over known bits, ``x op x`` and ``x op !x``;
* **duplicate detection (CSE)** — structural hashing over canonical
  input tokens, so a duplicate of a folded gate is caught too;
* **dead-gate / dead-wire detection** — backward reachability from the
  netlist outputs;
* **histograms** — per-level AND population and live-wire counts.

A gate is *removable* when any pass proves it: dead, foldable to a
constant/alias, or a duplicate. ``removable_and`` is the count the
ROADMAP's AND-minimization item optimizes; it is folded into
``Netlist.stats()`` / ``LevelPlan.stats()`` (and from there the
``bench_gc_eval`` JSON) via :func:`dataflow_summary`.

A copy of the JAX package's ``analysis/netcheck.py`` (numpy only) with
its imports rewritten, so the port's netlists get the same verdicts and
counters as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.netlist import Netlist, OP_AND, OP_INV, OP_XOR

__all__ = [
    "NetlistError",
    "verify_netlist",
    "verify_netlist_strict",
    "analyze_netlist",
    "dataflow_summary",
    "generator_registry",
    "NetReport",
]


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


# ---------------------------------------------------------------------------
# dataflow passes
# ---------------------------------------------------------------------------


@dataclass
class NetReport:
    """Dataflow counters for one netlist. ``removable_and`` is the count
    of AND gates provably deletable (dead OR const-foldable OR duplicate)
    — each one saves a 32-byte garbled table and two/four hash lanes."""

    name: str
    gates: int
    and_gates: int
    dead_gates: int
    dead_and: int
    foldable_gates: int
    foldable_and: int
    dup_gates: int
    dup_and: int
    removable_and: int
    dead_wires: int
    and_per_level: np.ndarray = field(default_factory=lambda: np.zeros(0))
    live_per_level: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def summary(self) -> Dict[str, int]:
        return {
            "dead_gates": self.dead_gates,
            "dead_and": self.dead_and,
            "foldable_and": self.foldable_and,
            "dup_and": self.dup_and,
            "removable_and": self.removable_and,
            "dead_wires": self.dead_wires,
        }


# alias-lattice tokens: fresh values get even tokens (2*wire), negation is
# token^1, known constants use CONST0/CONST1 and are handled by value
_CONST0, _CONST1, _UNK = -2, -4, -9


def analyze_netlist(net: Netlist, histograms: bool = False) -> NetReport:
    """Run constant propagation + CSE + liveness over ``net``."""
    G, W = net.num_gates, net.num_wires
    op, in0, in1, out = net.op, net.in0, net.in1, net.out

    # value per wire: _CONST0/_CONST1 when known, else an alias token
    tok = np.full(W, _UNK, np.int64)
    src = np.ones(W, bool)
    if G:
        src[out] = False
    for w in np.nonzero(src)[0]:
        tok[w] = 2 * int(w)
    for w, b in net.const_bits.items():
        tok[int(w)] = _CONST1 if int(b) else _CONST0

    def neg(t: int) -> int:
        if t == _CONST0:
            return _CONST1
        if t == _CONST1:
            return _CONST0
        return t ^ 1

    foldable = np.zeros(G, bool)
    dup = np.zeros(G, bool)
    cse: Dict[Tuple[int, int, int], int] = {}
    for g in range(G):
        o = int(op[g])
        ta = int(tok[in0[g]])
        if o == OP_INV:
            r = neg(ta)
            if r in (_CONST0, _CONST1):
                foldable[g] = True
            else:
                key = (OP_INV, ta, ta)
                prev = cse.get(key)
                if prev is not None:
                    dup[g] = True
                    r = prev
                else:
                    cse[key] = r
            tok[out[g]] = r
            continue
        tb = int(tok[in1[g]])
        consts = {_CONST0, _CONST1}
        r = None
        if o == OP_XOR:
            if ta in consts and tb in consts:
                r = _CONST1 if (ta != tb) else _CONST0
            elif ta == _CONST0:
                r = tb
            elif tb == _CONST0:
                r = ta
            elif ta == _CONST1:
                r = neg(tb)
            elif tb == _CONST1:
                r = neg(ta)
            elif ta == tb:
                r = _CONST0
            elif ta == neg(tb):
                r = _CONST1
        else:  # AND
            if ta == _CONST0 or tb == _CONST0:
                r = _CONST0
            elif ta == _CONST1:
                r = tb
            elif tb == _CONST1:
                r = ta
            elif ta == tb:
                r = ta
            elif ta == neg(tb):
                r = _CONST0
        if r is not None:
            foldable[g] = True
            tok[out[g]] = r
            continue
        key = (o, min(ta, tb), max(ta, tb))
        prev = cse.get(key)
        if prev is not None:
            dup[g] = True
            tok[out[g]] = prev
        else:
            r = 2 * int(out[g])
            cse[key] = r
            tok[out[g]] = r

    # backward reachability from outputs (over the original structure)
    needed = np.zeros(W, bool)
    if len(net.outputs):
        needed[np.asarray(net.outputs, np.int64)] = True
    live = np.zeros(G, bool)
    for g in range(G - 1, -1, -1):
        if needed[out[g]]:
            live[g] = True
            needed[in0[g]] = True
            if op[g] != OP_INV:
                needed[in1[g]] = True
    dead = ~live

    read = np.zeros(W, bool)
    if G:
        read[in0] = True
        ni = op != OP_INV
        read[in1[ni]] = True
    is_out = np.zeros(W, bool)
    if len(net.outputs):
        is_out[np.asarray(net.outputs, np.int64)] = True
    driven = np.zeros(W, bool)
    if G:
        driven[out] = True
    dead_wires = int(np.sum(driven & ~read & ~is_out))

    is_and = op == OP_AND
    removable = dead | foldable | dup

    rep = NetReport(
        name=net.name,
        gates=G,
        and_gates=int(is_and.sum()),
        dead_gates=int(dead.sum()),
        dead_and=int((dead & is_and).sum()),
        foldable_gates=int(foldable.sum()),
        foldable_and=int((foldable & is_and).sum()),
        dup_gates=int(dup.sum()),
        dup_and=int((dup & is_and).sum()),
        removable_and=int((removable & is_and).sum()),
        dead_wires=dead_wires,
    )
    if histograms:
        levels = net.levels()
        rep.and_per_level = np.array(
            [int(is_and[lv].sum()) for lv in levels], np.int64)
        # wires written at or before each level and still needed after it
        last_read = np.zeros(W, np.int64)
        gate_lv = np.zeros(G, np.int64)
        for li, lv in enumerate(levels):
            gate_lv[lv] = li
        for g in range(G):
            last_read[in0[g]] = max(last_read[in0[g]], gate_lv[g])
            if op[g] != OP_INV:
                last_read[in1[g]] = max(last_read[in1[g]], gate_lv[g])
        born = np.full(W, -1, np.int64)
        born[np.nonzero(src)[0]] = 0
        if G:
            born[out] = gate_lv + 1
        n_lv = len(levels)
        live_hist = np.zeros(n_lv, np.int64)
        for li in range(n_lv):
            live_hist[li] = int(np.sum(
                (born >= 0) & (born <= li)
                & ((last_read >= li) | is_out)))
        rep.live_per_level = live_hist
    return rep


def dataflow_summary(net: Netlist) -> Dict[str, int]:
    """Scalar dataflow counters, cached on the netlist (cheap for
    ``stats()`` calls inside benchmark loops)."""
    cached = getattr(net, "_dataflow_summary", None)
    if cached is None:
        cached = analyze_netlist(net).summary()
        net._dataflow_summary = cached  # type: ignore[attr-defined]
    return cached


# ---------------------------------------------------------------------------
# generator inventory (what the CLI's --netlists pass sweeps)
# ---------------------------------------------------------------------------


def generator_registry(k: int = 16, frac: int = 6
                       ) -> Dict[str, Callable[[], Netlist]]:
    """Small, fast instantiations of every public ``core/circuits``
    generator — one analyzable netlist per builder. Parameters are kept
    small so the lint sweep costs seconds; the counters are structural
    (per-word-width), so regressions show up at any size."""
    from repro_torch.core.circuits import arith, nonlinear
    from repro_torch.core.circuits.builder import CircuitBuilder, Word

    def binop(name: str, fn) -> Callable[[], Netlist]:
        def build() -> Netlist:
            cb = CircuitBuilder(name)
            a = cb.g_input_word(k)
            b = cb.e_input_word(k)
            cb.output(fn(cb, a, b))
            return cb.build()
        return build

    def mul_style(style: str) -> Callable[[], Netlist]:
        def build() -> Netlist:
            cb = CircuitBuilder(f"mul_{style}{k}")
            a = cb.g_input_word(k)
            b = cb.e_input_word(k)
            cb.output(arith.mul(cb, a, b, style=style))
            return cb.build()
        return build

    def predicate(name: str, fn) -> Callable[[], Netlist]:
        def build() -> Netlist:
            cb = CircuitBuilder(name)
            a = cb.g_input_word(k)
            b = cb.e_input_word(k)
            cb.output(fn(cb, a, b))
            return cb.build()
        return build

    def mux_build() -> Netlist:
        cb = CircuitBuilder(f"mux{k}")
        sel = cb.e_input()
        a = cb.g_input_word(k)
        b = cb.e_input_word(k)
        cb.output(arith.mux(cb, sel, a, b))
        return cb.build()

    def shift_var_build() -> Netlist:
        cb = CircuitBuilder(f"shift_right_var{k}")
        x = cb.e_input_word(k)
        amt = Word(tuple(cb.e_input() for _ in range(4)))
        cb.output(arith.shift_right_var(cb, x, amt, arithmetic=True))
        return cb.build()

    def unary(name: str, fn) -> Callable[[], Netlist]:
        def build() -> Netlist:
            cb = CircuitBuilder(name)
            x = cb.e_input_word(k)
            cb.output(fn(cb, x))
            return cb.build()
        return build

    style = "xfbq"
    return {
        f"add{k}": binop(f"add{k}", arith.add),
        f"sub{k}": binop(f"sub{k}", arith.sub),
        f"mul_conventional{k}": mul_style("conventional"),
        f"mul_xfbq{k}": mul_style("xfbq"),
        f"fx_mul{k}": binop(
            f"fx_mul{k}",
            lambda cb, a, b: arith.fx_mul(cb, a, b, frac, style=style)),
        f"lt_signed{k}": predicate(f"lt_signed{k}", arith.lt_signed),
        f"eq{k}": predicate(f"eq{k}", arith.eq),
        f"max_word{k}": binop(f"max_word{k}", arith.max_word),
        f"mux{k}": mux_build,
        f"shift_right_var{k}": shift_var_build,
        f"exp{k}": unary(
            f"exp{k}",
            lambda cb, x: nonlinear.exp_circuit(cb, x, frac, style)),
        f"reciprocal{k}": unary(
            f"reciprocal{k}",
            lambda cb, x: nonlinear.reciprocal_circuit(cb, x, frac, style)),
        f"rsqrt{k}": unary(
            f"rsqrt{k}",
            lambda cb, x: nonlinear.rsqrt_circuit(cb, x, frac, style)),
        "softmax4": lambda: nonlinear.softmax_circuit(
            4, k=k, frac=frac, style=style).build(),
        "gelu": lambda: nonlinear.gelu_circuit(
            k=k, frac=frac, style=style).build(),
        "silu": lambda: nonlinear.silu_circuit(
            k=k, frac=frac, style=style).build(),
        "layernorm_full4": lambda: nonlinear.layernorm_full_circuit(
            4, k=k, frac=frac, style=style).build(),
        "layernorm_reduced4": lambda: nonlinear.layernorm_reduced_circuit(
            4, k=k, frac=frac, style=style).build(),
    }


def run_netcheck(baseline_reasons: Optional[Dict] = None) -> List:
    """Verify + analyze every generator; return Finding objects."""
    from repro_torch.analysis.report import Finding

    findings: List[Finding] = []
    for gname, build in generator_registry().items():
        path = f"netlist:{gname}"
        try:
            net = build()
        except Exception as e:  # a generator that cannot build is a finding
            findings.append(Finding("netcheck", "build-error", path, 0,
                                    gname, f"generator raised: {e!r}"))
            continue
        for err in verify_netlist(net):
            findings.append(
                Finding("netcheck", "structure", path, 0, gname, err))
        rep = analyze_netlist(net)
        if rep.removable_and:
            findings.append(Finding(
                "netcheck", "removable-and", path, 0, gname,
                f"{rep.removable_and} of {rep.and_gates} AND gates provably "
                f"removable (dead={rep.dead_and}, foldable="
                f"{rep.foldable_and}, duplicate={rep.dup_and})",
                count=rep.removable_and))
        if rep.dead_gates:
            findings.append(Finding(
                "netcheck", "dead-gate", path, 0, gname,
                f"{rep.dead_gates} of {rep.gates} gates dead "
                f"(unreachable from outputs); {rep.dead_wires} dead wires",
                count=rep.dead_gates))
    return findings
