"""Declarative op-graph plans for private transformer inference.

``compile_plan(model, seq_len)`` traces the exact operation sequence of
``PrivateTransformer.forward_private`` into a flat, declarative program
over a small register file of share pairs. Op kinds mirror the protocol
surface one-to-one:

  linear         — DELPHI split matmul against a server weight
  beaver_matmul  — private×private matmul (QKᵀ, PV)
  gc_apply       — garbled nonlinear circuit (softmax rows, GeLU/SiLU)
  layernorm      — residual add + LayerNorm (full-GC or APINT offload)
  trunc          — exact GC rescale back to `frac`

Shapes and scales are resolved at compile time for one request bucket
(a fixed sequence length), so the offline phase can execute every op's
preprocessing — garbling, HE mask products, Beaver triples — from the
plan alone, with no input in sight. ``core/session.py`` interprets plans.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class RegRef:
    """A read/write site in the register file of (client, server) shares.

    ``cols`` selects a column band [lo, hi) — the per-head slices;
    ``transpose`` reads the transposed matrix (K in QKᵀ).
    """

    reg: str
    cols: Optional[Tuple[int, int]] = None
    transpose: bool = False


@dataclass(frozen=True)
class OpSpec:
    """One protocol-level operation with fully resolved shapes/scales."""

    kind: str  # linear | beaver_matmul | gc_apply | layernorm | trunc
    name: str  # unique within a plan, e.g. "L0.h1.softmax"
    reads: Tuple[RegRef, ...]
    write: RegRef
    shape: Tuple[int, int]  # output shape
    in_scale: int
    out_scale: int
    attrs: Dict[str, object] = field(default_factory=dict)


GC_KINDS = ("gc_apply", "trunc", "layernorm")


@dataclass
class Plan:
    """A compiled program for one (seq_len, model) request bucket."""

    seq_len: int
    d: int
    heads: int
    head_dim: int
    d_ff: int
    n_layers: int
    activation: str
    frac: int
    layernorm_offload: bool
    ops: Tuple[OpSpec, ...] = ()
    reg_shapes: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    output_reg: str = "x"

    @property
    def plan_id(self) -> str:
        return (f"bert(S={self.seq_len},d={self.d},h={self.heads},"
                f"dff={self.d_ff},L={self.n_layers},act={self.activation},"
                f"f={self.frac},ln_off={self.layernorm_offload})")

    def read_shape(self, ref: RegRef) -> Tuple[int, int]:
        r, c = self.reg_shapes[ref.reg]
        if ref.cols is not None:
            c = ref.cols[1] - ref.cols[0]
        return (c, r) if ref.transpose else (r, c)

    def gc_instances(self, op: OpSpec) -> int:
        """Rows fed to the garbled circuit backing ``op`` (0 if none)."""
        rows, cols = op.shape
        if op.kind == "trunc":
            return rows * cols  # elementwise, flattened
        if op.kind == "gc_apply":
            circ = op.attrs.get("circuit")
            return rows if circ == "softmax" else rows * cols
        if op.kind == "layernorm":
            return rows
        return 0

    def gc_ops(self) -> List[OpSpec]:
        return [op for op in self.ops if op.kind in GC_KINDS]

    def coarse_schedule(self, num_cores: int) -> List[List[str]]:
        """APINT coarse-grained scheduling hook: map the plan's independent
        GC unit operations onto accelerator cores round-robin (§3.3.1)."""
        from repro_torch.sched.schedulers import coarse_grained_partition

        names = [op.name for op in self.gc_ops()]
        assign = coarse_grained_partition(names, num_cores)
        return [[names[i] for i in core] for core in assign]


def plan_to_spec(plan: Plan) -> Dict[str, object]:
    """Serialize a :class:`Plan` to plain JSON-safe data.

    Plans are pure shape/scale programs — no weights, no protocol state —
    so the two-party runtime (:mod:`repro.net`) ships them in the session
    handshake and the evaluator reconstructs an identical walk with
    :func:`plan_from_spec`.
    """

    def ref(r: RegRef) -> Dict[str, object]:
        return {"reg": r.reg,
                "cols": list(r.cols) if r.cols is not None else None,
                "transpose": r.transpose}

    return {
        "seq_len": plan.seq_len, "d": plan.d, "heads": plan.heads,
        "head_dim": plan.head_dim, "d_ff": plan.d_ff,
        "n_layers": plan.n_layers, "activation": plan.activation,
        "frac": plan.frac, "layernorm_offload": plan.layernorm_offload,
        "output_reg": plan.output_reg,
        "reg_shapes": {k: list(v) for k, v in plan.reg_shapes.items()},
        "ops": [
            {"kind": op.kind, "name": op.name,
             "reads": [ref(r) for r in op.reads], "write": ref(op.write),
             "shape": list(op.shape), "in_scale": op.in_scale,
             "out_scale": op.out_scale, "attrs": dict(op.attrs)}
            for op in plan.ops
        ],
    }


def plan_from_spec(spec: Dict[str, object]) -> Plan:
    """Inverse of :func:`plan_to_spec` (round-trips to an equal walk)."""

    def ref(d) -> RegRef:
        return RegRef(d["reg"],
                      tuple(d["cols"]) if d["cols"] is not None else None,
                      bool(d["transpose"]))

    plan = Plan(
        seq_len=int(spec["seq_len"]), d=int(spec["d"]),
        heads=int(spec["heads"]), head_dim=int(spec["head_dim"]),
        d_ff=int(spec["d_ff"]), n_layers=int(spec["n_layers"]),
        activation=str(spec["activation"]), frac=int(spec["frac"]),
        layernorm_offload=bool(spec["layernorm_offload"]),
        output_reg=str(spec["output_reg"]),
        reg_shapes={k: tuple(v) for k, v in spec["reg_shapes"].items()},
    )
    plan.ops = tuple(
        OpSpec(o["kind"], o["name"], tuple(ref(r) for r in o["reads"]),
               ref(o["write"]), tuple(o["shape"]), int(o["in_scale"]),
               int(o["out_scale"]), dict(o["attrs"]))
        for o in spec["ops"]
    )
    return plan


def compile_plan(model, seq_len: int) -> Plan:
    """Trace ``model.forward_private`` (a ``PrivateTransformer``) at a fixed
    sequence length into a :class:`Plan`.

    The emitted op order is exactly the order the legacy eager path
    executes, so a session run replays the same protocol transcript.
    """
    S = int(seq_len)
    d, h, hd, dff = model.d, model.h, model.hd, model.d_ff
    f = model.p.frac
    plan = Plan(
        seq_len=S, d=d, heads=h, head_dim=hd, d_ff=dff,
        n_layers=len(model.weights), activation=model.activation,
        frac=f, layernorm_offload=model.p.pcfg.layernorm_offload,
        reg_shapes={
            "x": (S, d), "q": (S, d), "k": (S, d), "v": (S, d),
            "att": (S, S), "o": (S, hd), "ctx": (S, d), "a": (S, d),
            "h1": (S, dff), "g": (S, dff), "h2": (S, d),
        },
    )
    ops: List[OpSpec] = []

    def lin(name, layer, wkey, src, dst, shape, wscale=1.0):
        ops.append(OpSpec(
            "linear", name, (RegRef(src),), RegRef(dst), shape, f, 2 * f,
            {"layer": layer, "weight": wkey, "wscale": wscale},
        ))

    def trunc(name, src, dst, shape, cols=None):
        ops.append(OpSpec(
            "trunc", name, (RegRef(src),), RegRef(dst, cols=cols),
            shape, 2 * f, f,
        ))

    for l in range(len(model.weights)):
        # ---- attention ------------------------------------------------
        lin(f"L{l}.q", l, "wq", "x", "q", (S, d), wscale=model.scale_q)
        trunc(f"L{l}.q.t", "q", "q", (S, d))
        lin(f"L{l}.k", l, "wk", "x", "k", (S, d))
        trunc(f"L{l}.k.t", "k", "k", (S, d))
        lin(f"L{l}.v", l, "wv", "x", "v", (S, d))
        trunc(f"L{l}.v.t", "v", "v", (S, d))
        for hh in range(h):
            sl = (hh * hd, (hh + 1) * hd)
            ops.append(OpSpec(
                "beaver_matmul", f"L{l}.h{hh}.qk",
                (RegRef("q", cols=sl), RegRef("k", cols=sl, transpose=True)),
                RegRef("att"), (S, S), f, 2 * f,
            ))
            ops.append(OpSpec(
                "gc_apply", f"L{l}.h{hh}.softmax",
                (RegRef("att"),), RegRef("att"), (S, S), 2 * f, f,
                {"circuit": "softmax", "row_len": S},
            ))
            ops.append(OpSpec(
                "beaver_matmul", f"L{l}.h{hh}.pv",
                (RegRef("att"), RegRef("v", cols=sl)),
                RegRef("o"), (S, hd), f, 2 * f,
            ))
            trunc(f"L{l}.h{hh}.o.t", "o", "ctx", (S, hd), cols=sl)
        lin(f"L{l}.wo", l, "wo", "ctx", "a", (S, d))
        trunc(f"L{l}.wo.t", "a", "a", (S, d))
        # residual + LN1 (post-norm); reads are summed before the LN
        ops.append(OpSpec(
            "layernorm", f"L{l}.ln1", (RegRef("x"), RegRef("a")),
            RegRef("x"), (S, d), f, f, {"layer": l, "which": "ln1"},
        ))
        # ---- MLP ------------------------------------------------------
        lin(f"L{l}.w1", l, "w1", "x", "h1", (S, dff))
        ops.append(OpSpec(
            "gc_apply", f"L{l}.act", (RegRef("h1"),), RegRef("g"),
            (S, dff), 2 * f, f, {"circuit": model.activation},
        ))
        lin(f"L{l}.w2", l, "w2", "g", "h2", (S, d))
        trunc(f"L{l}.w2.t", "h2", "h2", (S, d))
        ops.append(OpSpec(
            "layernorm", f"L{l}.ln2", (RegRef("x"), RegRef("h2")),
            RegRef("x"), (S, d), f, f, {"layer": l, "which": "ln2"},
        ))

    plan.ops = tuple(ops)
    return plan
