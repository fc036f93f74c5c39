"""The unit of work: the garbled-circuit ops of one encoder layer for one
input of S tokens, served through the program's protocol calls.

The ops are frozen in the benchmark: ``pitbench/ops/<cell>.json`` lists
each op as ``[name, kind, [rows, cols], instances, in_scale]`` (per head
a softmax over rows of S, the GeLU over S x d_ff, the two LayerNorms
through the offload circuit, and the truncations). A run refuses to
start where the program's own plan of the layer
(``compile_plan(model, S).gc_ops()``, ``Plan.gc_instances``) differs from
that list, and the inputs and the reference read the list, not the plan.
The netlists are the program's (``gc_net_for``). A request walks the ops
netlist by netlist, in order of first use, as ``PiTSession.preprocess``
and ``PiTSession.run`` do, with the tables streamed in slabs of at most
:data:`SLAB_TABLE_BYTES`: offline, one ``garble`` call per slab and the
slab's meter, then each call's ``*_offline`` leg on its slice; online,
each call's ``*_online`` leg on fresh shares; then the slab's tables are
released.

Inputs are drawn from the seed at each op's scale and split into two
shares mod t; the circuits are data-oblivious, so the values set what is
compared, not what it costs.
"""

from __future__ import annotations

import math
import time
import types
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np

from pitbench.reference.compare import OpCase
from pitbench.reference.gc_ops import encode_fx
from pitbench.yardstick import TABLE_BYTES

#: the most table bytes one ``garble`` call makes. A call holds its tables
#: about 2.5 times over (two stores, the dense copy, a temporary:
#: ``LevelExecutor._garble``), so a whole netlist of an S=128 layer (27 GB
#: of softmax tables, 18.9 GB of GeLU tables) runs the 80 GB card out of
#: memory; at 8 GB a call peaks near 20 GB, and the tables are streamed
#: as a deployment on one card must stream them.
SLAB_TABLE_BYTES = 8e9
#: the standard deviation of each kind's inputs, in real units: at the
#: scale of the activations each op meets in the layer (scores into the
#: softmax, the FFN's pre-activation, the residual into LayerNorm). The
#: circuits are data-oblivious: these set what is compared, not the cost.
INPUT_STD = {"trunc": 4.0, "softmax": 3.0, "gelu": 2.0, "layernorm": 1.0}


@dataclass
class Op:
    """One garbled op of the layer, with the program's netlist."""

    index: int
    name: str
    kind: str  # trunc | softmax | gelu | layernorm
    net: object  # the program's netlist (None until with_nets)
    shape: Tuple[int, int]  # the input the protocol call takes
    instances: int
    in_scale: int
    spec: object = None  # the program's OpSpec

    def entry(self) -> list:
        """The op as a frozen list holds it."""
        return [self.name, self.kind, list(self.shape), self.instances,
                self.in_scale]


@dataclass
class Group:
    """Ops that share one netlist, garbled as one slab."""

    net: object  # the program's netlist (None until with_nets)
    ops: List[Op] = field(default_factory=list)

    @property
    def instances(self) -> int:
        return sum(op.instances for op in self.ops)


def layer_ops(cfg: dict, seq_len: int, pcfg) -> List[Op]:
    """The GC ops of ``cfg``'s layers at ``seq_len`` tokens, from the
    program's plan (no weights: a plan is shapes and scales), without
    netlists (see :func:`with_nets`)."""
    from repro_torch.core.plan import compile_plan

    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    model = types.SimpleNamespace(
        d=d, h=h, hd=d // h, d_ff=cfg["intermediate_size"],
        weights=[None] * cfg["num_hidden_layers"],
        activation=cfg["hidden_act"], scale_q=1.0,
        p=types.SimpleNamespace(frac=pcfg.frac_bits, pcfg=pcfg))
    plan = compile_plan(model, seq_len)
    ops = []
    for i, op in enumerate(plan.gc_ops()):
        if op.kind == "gc_apply":
            kind = "softmax" if op.attrs["circuit"] == "softmax" \
                else op.attrs["circuit"]
        else:
            kind = op.kind
        ops.append(Op(i, op.name, kind, None, tuple(op.shape),
                      plan.gc_instances(op), op.in_scale, op))
    return ops


def frozen(entries) -> List[Op]:
    """The ops of a frozen list (``[name, kind, [rows, cols], instances,
    in_scale]`` each), without netlists or the program's specs."""
    return [Op(i, name, kind, None, (int(shape[0]), int(shape[1])),
               int(instances), int(in_scale))
            for i, (name, kind, shape, instances, in_scale)
            in enumerate(entries)]


def differences(ops: List[Op], planned: List[Op]) -> List[str]:
    """Where the program's plan departs from the frozen ops."""
    out = []
    if len(ops) != len(planned):
        out.append(f"{len(planned)} ops planned, {len(ops)} frozen")
    for op, pl in zip(ops, planned):
        if op.entry() != pl.entry():
            out.append(f"op {op.index}: planned {pl.entry()}, "
                       f"frozen {op.entry()}")
    return out


def with_nets(protocol, ops: List[Op]) -> List[Op]:
    """Each op's netlist, as the program resolves it (``gc_net_for``)."""
    from repro_torch.core.session import gc_net_for

    for op in ops:
        op.net = gc_net_for(protocol, op.spec)
    return ops


def cut(ops: List[Op]) -> List[Op]:
    """The protocol calls that serve ``ops``: an elementwise op (a
    truncation, the activation) whose tables pass the slab limit is
    served as several calls on blocks of its rows, as few as keep each
    block's tables within the limit.
    Calls are numbered in order; each draws its own inputs."""
    out = []
    for op in ops:
        rows, cols = op.shape
        n = 1
        if op.kind in ("trunc", "gelu"):
            tables = op.instances * op.net.and_count * TABLE_BYTES
            n = min(rows, max(1, math.ceil(tables / SLAB_TABLE_BYTES)))
        k, extra = divmod(rows, n)
        lo = 0
        for i in range(n):
            hi = lo + k + (i < extra)
            name = op.name if n == 1 else f"{op.name}[{lo}:{hi}]"
            out.append(Op(len(out), name, op.kind, op.net, (hi - lo, cols),
                          op.instances * (hi - lo) // rows, op.in_scale,
                          op.spec))
            lo = hi
    return out


def groups_of(ops: List[Op]) -> List[Group]:
    """Calls grouped by netlist, in order of first use, each group cut
    into slabs of consecutive calls, as even in count as can be and as
    few as keep every slab's tables within :data:`SLAB_TABLE_BYTES` (one
    call a slab where no fewer do)."""
    by_net: Dict[str, List[Op]] = {}
    for op in ops:
        by_net.setdefault(op.net.name, []).append(op)
    out = []
    for same in by_net.values():
        per = same[0].net.and_count * TABLE_BYTES
        total = sum(op.instances for op in same) * per
        for n in range(max(1, math.ceil(total / SLAB_TABLE_BYTES)),
                       len(same) + 1):
            k, extra = divmod(len(same), n)
            bounds = [i * k + min(i, extra) for i in range(n + 1)]
            slabs = [same[a:b] for a, b in zip(bounds, bounds[1:])]
            if all(sum(op.instances for op in sl) * per <= SLAB_TABLE_BYTES
                   for sl in slabs):
                break
        out.extend(Group(same[0].net, sl) for sl in slabs)
    return out


def seed_words(seed: int) -> List[int]:
    """A seed of any size as 32-bit words for ``SeedSequence``."""
    s = int(seed)
    words = [1 if s < 0 else 0]
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            return words


class Inputs:
    """Every input of a run, drawn from its seed: each call's shares, and
    LayerNorm's gamma and beta (drawn as the program's ``random_weights``
    draws them: N(1, 0.05) and N(0, 0.05))."""

    def __init__(self, seed: int, t: int):
        self.seed = seed_words(seed)
        self.t = t

    def shares(self, request: int, op: Op) -> Tuple[np.ndarray, np.ndarray]:
        """Op ``op``'s two input shares in request ``request`` (-1: the
        warm request)."""
        rng = np.random.default_rng(self.seed + [1, request + 1, op.index])
        x = rng.normal(0.0, INPUT_STD[op.kind], op.shape)
        enc = encode_fx(x, op.in_scale, self.t)
        xc = rng.integers(0, self.t, op.shape, dtype=np.uint64)
        xs = (enc + (np.uint64(self.t) - xc)) % np.uint64(self.t)
        return xc, xs

    def layernorm(self, op: Op) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed + [2, op.index])
        d = op.shape[1]
        return rng.normal(1, 0.05, d), rng.normal(0, 0.05, d)


def _offline(p, op: Op, gcirc, inputs: Inputs):
    if op.kind == "trunc":
        return p.trunc_offline(op.in_scale, op.instances, gcirc=gcirc)
    if op.kind == "softmax":
        return p.softmax_offline(op.shape[1], op.in_scale, op.instances,
                                 gcirc=gcirc)
    if op.kind == "layernorm":
        gamma, beta = inputs.layernorm(op)
        return p.layernorm_offline(op.shape[1], op.instances, op.in_scale,
                                   gamma, beta, gcirc=gcirc)
    return p.activation_offline(op.kind, op.in_scale, op.instances,
                                gcirc=gcirc)


def _online(p, op: Op, corr, xc, xs):
    if op.kind == "trunc":
        return p.trunc_online(corr, xc, xs)
    if op.kind == "softmax":
        return p.gc_online(corr, xc, xs)
    if op.kind == "layernorm":
        return p.layernorm_online(corr, xc, xs)
    return p.activation_online(corr, xc, xs)


@dataclass
class Served:
    """One request as served: its offline and online parts (host
    perf_counter ns, each ended by a device synchronise), each op's
    output shares, and the process's CPU ns over it."""

    index: int
    offline: List[Tuple[int, int]] = field(default_factory=list)
    online: List[Tuple[int, int]] = field(default_factory=list)
    outputs: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict)
    cpu_ns: int = 0


def serve_request(p, groups: List[Group], inputs: Inputs, index: int,
                  sync: Callable[[], None]) -> Served:
    """Serve one request, group by group (see the module's docstring)."""
    from repro_torch import obs
    from repro_torch.core import garble as G

    out = Served(index)
    clock = time.perf_counter_ns
    cpu0 = time.process_time_ns()
    for g in groups:
        shares = [inputs.shares(index, op) for op in g.ops]
        t0 = clock()
        with obs.span("pitbench.offline", netlist=g.net.name):
            with obs.span("pitbench.garble", netlist=g.net.name,
                          instances=g.instances):
                slab = G.garble(g.net, p.gen, g.instances, device=p.device)
            p.gc_slab_offline(g.net)
            corrs, lo = [], 0
            for op in g.ops:
                sl = G.slice_instances(slab, lo, lo + op.instances)
                lo += op.instances
                corrs.append(_offline(p, op, sl, inputs))
            sync()
        t1 = clock()
        out.offline.append((t0, t1))
        with obs.span("pitbench.online", netlist=g.net.name):
            for op, corr, (xc, xs) in zip(g.ops, corrs, shares):
                out.outputs[op.index] = _online(p, op, corr, xc, xs)
            sync()
        out.online.append((t1, clock()))
        del slab, corrs, sl
    out.cpu_ns = time.process_time_ns() - cpu0
    return out


def cases(served: Served, ops: List[Op], inputs: Inputs,
          outputs: bool = True) -> List[OpCase]:
    """The comparison's cases for one served request, its inputs drawn
    again from the seed (with ``outputs=False``, no output shares)."""
    out = []
    for op in ops:
        xc, xs = inputs.shares(served.index, op)
        oc, os_ = served.outputs[op.index] if outputs else (None, None)
        gamma = beta = None
        if op.kind == "layernorm":
            gamma, beta = inputs.layernorm(op)
        out.append(OpCase(op.kind, op.in_scale, xc, xs, oc, os_, gamma,
                          beta))
    return out


def work(ops: List[Op]) -> List[Tuple[int, int, int, int]]:
    """``(and_gates, inputs, outputs, instances)`` of each op: what the
    yardstick's GC bound counts."""
    return [(int(op.net.and_count),
             len(op.net.garbler_inputs) + len(op.net.evaluator_inputs),
             len(op.net.outputs), op.instances) for op in ops]
