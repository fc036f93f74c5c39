"""PiTSession: an explicit compile → preprocess → run lifecycle for
private transformer serving.

APINT's headline result is the offline/online split: everything that does
not depend on the client's input — garbling, the DELPHI HE mask products,
Beaver triple dealing — can be generated ahead of time and pooled across
inferences. This module makes that split a first-class API:

    session = compile(model, pcfg, shape=(S, d))   # trace → op-graph Plan
    bundles = session.preprocess(n)                # ALL offline work, n×
    y = session.run(x, bundles[0])                 # online phase only

``compile`` traces ``PrivateTransformer.forward_private`` into a
declarative :class:`~repro_torch.core.plan.Plan`; ``preprocess`` executes every
op's ``*_offline`` protocol leg (with one *batched* garbling call per
cached netlist across the whole bundle batch) and returns poolable
:class:`PreprocessedBundle`\\ s; ``run`` replays the plan against one
bundle, touching only ``channel_online``. A bundle is single-use — holding
fresh garbled tables and masks is exactly what makes the online phase
secure — so ``run`` raises :class:`BundleExhausted` on reuse.

The JAX package's ``core/session.py`` with ``impl`` replaced by the
``device`` the session garbles and evaluates on.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.config import PrivacyConfig
from repro_torch import obs
from repro_torch.core import garble as G
from repro_torch.core import secret_sharing as SS
from repro_torch.core.netlist import Netlist
from repro_torch.core.plan import GC_KINDS, OpSpec, Plan, RegRef, compile_plan
from repro_torch.core.protocol import PiTProtocol, Stats

_bundle_counter = itertools.count()


class BundleExhausted(RuntimeError):
    """Raised when ``run`` is asked to reuse a consumed (or foreign) bundle."""


def gc_net_for(protocol: PiTProtocol, op: OpSpec) -> Netlist:
    """The cached netlist backing a GC-kind op.

    Module-level because both :class:`PiTSession` and the two-party
    endpoints of the two-party runtime must resolve *identical* netlists
    from a plan — the circuit structure depends only on the privacy config
    and the op's shapes/scales, never on weights, so two protocol
    instances on two machines build the same gate DAG.
    """
    p = protocol
    if op.kind == "trunc":
        return p.trunc_net(op.in_scale)
    if op.kind == "gc_apply":
        circ = op.attrs["circuit"]
        if circ == "softmax":
            return p.softmax_net(op.attrs["row_len"], op.in_scale)
        return p.activation_net(circ, op.in_scale)
    if op.kind == "layernorm":
        n = op.shape[1]
        if p.pcfg.layernorm_offload:
            return p.layernorm_reduced_net(n, op.in_scale)
        return p.layernorm_full_net(n, op.in_scale)
    raise ValueError(op.kind)


class GarblingCache:
    """Observable shared-garbling-cache keying: ``(netlist, instances,
    device)`` → one slab structure, however many sessions use it.

    The expensive artifacts behind a GC op are the generated
    :class:`Netlist` (circuit generation is seconds-scale for production
    rows) and the compiled executor walk :mod:`repro_torch.core.gc_exec` keys
    on ``(netlist, instances, device)``. Both hang off ONE protocol
    instance's netlist cache — so a multi-client gateway that shares one
    protocol across all sessions garbles/compiles each distinct slab
    once and serves it to every client. This wrapper makes that sharing
    *observable and thread-safe*: every resolution goes through one lock
    (two sessions racing a first build would otherwise construct the
    netlist twice via the protocol's bare check-then-set cache), counts
    a miss the first time a key is seen and a hit on every reuse.
    """

    def __init__(self, protocol: PiTProtocol):
        self.protocol = protocol
        self._lock = threading.Lock()
        self._slabs: Dict[Tuple[str, int, str], int] = {}  # key -> uses
        self.hits = 0
        self.misses = 0

    def distinct_nets(self, plan: Plan, n: int = 1
                      ) -> Tuple[Dict[str, Netlist], Dict[str, int]]:
        """Resolve every GC op's netlist for an ``n``-bundle slab batch.

        Returns netlists in first-appearance order plus per-request
        instance totals (the garbler's slab widths are ``per_req[name] *
        n``). The whole walk holds the cache lock so concurrent first
        resolutions from two sessions cannot double-build a netlist, and
        each distinct slab key counts one hit/miss per call.
        """
        with self._lock:
            nets: Dict[str, Netlist] = {}
            per_req: Dict[str, int] = {}
            for op in plan.ops:
                if op.kind in GC_KINDS:
                    net = gc_net_for(self.protocol, op)
                    per_req[net.name] = (per_req.get(net.name, 0)
                                         + plan.gc_instances(op))
                    nets.setdefault(net.name, net)
            for name in nets:
                key = (name, per_req[name] * n,
                       str(self.protocol.device))
                if key in self._slabs:
                    self.hits += 1
                else:
                    self.misses += 1
                    self._slabs[key] = 0
                self._slabs[key] += 1
            return nets, per_req

    @property
    def distinct_netlists(self) -> int:
        with self._lock:
            return len({name for name, _, _ in self._slabs})

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {
                "slabs": len(self._slabs),
                "distinct_netlists": len({n for n, _, _ in self._slabs}),
                "hits": self.hits,
                "misses": self.misses,
                "by_key": {f"{n}/I{i}/{im}": uses
                           for (n, i, im), uses in sorted(self._slabs.items())},
            }


@dataclass
class PreprocessedBundle:
    """Offline material for exactly one online inference.

    ``session_id`` pins the bundle to the session whose garbled circuits
    and HE masks it holds — structural plan equality is not enough, since
    two same-shape models would otherwise silently swap weights.
    """

    plan_id: str
    session_id: int
    parts: Dict[str, object]
    bundle_id: int = field(default_factory=lambda: next(_bundle_counter))
    consumed: bool = False


class PiTSession:
    """Executes a compiled :class:`Plan` in two explicit phases."""

    def __init__(self, plan: Plan, weights: Sequence, pcfg: PrivacyConfig,
                 *, seed: int = 0, device="cuda",
                 protocol: Optional[PiTProtocol] = None,
                 wire_version: int = 1, compression: bool = True):
        assert plan.n_layers == len(weights)
        self.plan = plan
        self.weights = list(weights)
        self.protocol = protocol or PiTProtocol(
            pcfg, seed=seed, device=device, wire_version=wire_version,
            compression=compression)
        if self.protocol.frac != plan.frac or \
                self.protocol.pcfg.layernorm_offload != plan.layernorm_offload:
            raise ValueError(
                f"privacy config (frac_bits={self.protocol.frac}, "
                f"layernorm_offload={self.protocol.pcfg.layernorm_offload}) "
                f"disagrees with the traced plan ({plan.plan_id}); recompile "
                f"from a model built with this config")
        # quantized weights are bundle-invariant: cache once per linear op
        self._quantized: Dict[str, tuple] = {}
        self._session_id = next(_bundle_counter)

    # ------------------------------------------------------------------
    @property
    def stats(self) -> Stats:
        return self.protocol.stats

    def _weight(self, op: OpSpec) -> np.ndarray:
        W = self.weights[op.attrs["layer"]]
        w = getattr(W, op.attrs["weight"])
        scale = op.attrs.get("wscale", 1.0)
        return w * scale if scale != 1.0 else w

    def _ln_params(self, op: OpSpec) -> Tuple[np.ndarray, np.ndarray]:
        W = self.weights[op.attrs["layer"]]
        which = op.attrs["which"]
        return getattr(W, f"{which}_g"), getattr(W, f"{which}_b")

    def _gc_net(self, op: OpSpec) -> Netlist:
        """The cached netlist backing a GC-kind op."""
        return gc_net_for(self.protocol, op)

    # ------------------------------------------------------------------
    # offline phase
    # ------------------------------------------------------------------
    def preprocess(self, n: int = 1) -> List[PreprocessedBundle]:
        """Execute all offline work for ``n`` future requests up front.

        Garbling is batched per cached netlist: every netlist appearing in
        the plan is garbled in ONE call covering all its instances across
        all ops and all ``n`` bundles, then sliced per use. HE mask
        products, output masks and Beaver triples are drawn per bundle.
        At these instance counts the executor walks the throughput-width
        plan over a liveness-compacted wire store with packed table
        emission (:mod:`repro_torch.core.gc_exec`).
        """
        if n < 1:
            raise ValueError("preprocess needs n >= 1")
        p = self.protocol
        plan = self.plan
        with obs.span("preprocess", plan=plan.plan_id, bundles=n), \
                p.stats.phase("offline"):
            # ---- one garbling call per distinct netlist ----------------
            gc_ops = [(op, self._gc_net(op), plan.gc_instances(op))
                      for op in plan.ops if op.kind in GC_KINDS]
            per_req: Dict[str, int] = {}
            nets: Dict[str, Netlist] = {}
            for _, net, I in gc_ops:
                per_req[net.name] = per_req.get(net.name, 0) + I
                nets[net.name] = net
            slabs = {}
            for name in nets:
                with obs.span("garble", netlist=name,
                              instances=per_req[name] * n):
                    slabs[name] = G.garble(
                        nets[name], p.gen, per_req[name] * n,
                        device=p.device)
            for name in nets:
                # v2 wire: the batch-fixed costs (delta-table anchor +
                # seed-stream record) are per garbled slab, not per op —
                # meter them here, where the slab exists (no-op on v1)
                p.gc_slab_offline(nets[name])
            offsets = {name: 0 for name in nets}

            def take(net: Netlist, I: int) -> G.GarbledCircuit:
                lo = offsets[net.name]
                offsets[net.name] = lo + I
                return G.slice_instances(slabs[net.name], lo, lo + I)

            # ---- per-bundle correlations -------------------------------
            bundles: List[PreprocessedBundle] = []
            for _ in range(n):
                parts: Dict[str, object] = {}
                for op in plan.ops:
                    if op.kind == "linear":
                        if op.name not in self._quantized:
                            self._quantized[op.name] = p.quantize_weight(
                                self._weight(op))
                        parts[op.name] = p.linear_offline(
                            None, plan.read_shape(op.reads[0]),
                            quantized=self._quantized[op.name])
                    elif op.kind == "beaver_matmul":
                        m, k = plan.read_shape(op.reads[0])
                        _, nn = plan.read_shape(op.reads[1])
                        parts[op.name] = p.beaver_offline(m, k, nn)
                    elif op.kind == "trunc":
                        I = plan.gc_instances(op)
                        parts[op.name] = p.trunc_offline(
                            op.in_scale, I, gcirc=take(self._gc_net(op), I))
                    elif op.kind == "gc_apply":
                        I = plan.gc_instances(op)
                        circ = op.attrs["circuit"]
                        if circ == "softmax":
                            parts[op.name] = p.softmax_offline(
                                op.attrs["row_len"], op.in_scale, I,
                                gcirc=take(self._gc_net(op), I))
                        else:
                            parts[op.name] = p.activation_offline(
                                circ, op.in_scale, I,
                                gcirc=take(self._gc_net(op), I))
                    elif op.kind == "layernorm":
                        I = plan.gc_instances(op)
                        gamma, beta = self._ln_params(op)
                        parts[op.name] = p.layernorm_offline(
                            op.shape[1], I, op.in_scale, gamma, beta,
                            gcirc=take(self._gc_net(op), I))
                    else:
                        raise ValueError(op.kind)
                bundles.append(PreprocessedBundle(
                    plan.plan_id, self._session_id, parts))
        return bundles

    # ------------------------------------------------------------------
    # online phase
    # ------------------------------------------------------------------
    def run(self, x: np.ndarray, bundle: PreprocessedBundle) -> np.ndarray:
        """Online phase only: serve one request against one bundle."""
        if bundle.consumed:
            raise BundleExhausted(
                f"bundle {bundle.bundle_id} already consumed — preprocess "
                f"more bundles or refill the pool")
        if (bundle.plan_id != self.plan.plan_id
                or bundle.session_id != self._session_id):
            raise BundleExhausted(
                f"bundle {bundle.bundle_id} was preprocessed by another "
                f"session (for {bundle.plan_id}), not this one "
                f"({self.plan.plan_id})")
        x = np.asarray(x, np.float64)
        if x.shape != (self.plan.seq_len, self.plan.d):
            raise ValueError(
                f"input shape {x.shape} != bucket shape "
                f"{(self.plan.seq_len, self.plan.d)}")
        bundle.consumed = True
        p = self.protocol
        plan = self.plan
        with obs.span("run", plan=plan.plan_id,
                      bundle_id=bundle.bundle_id), \
                p.stats.phase("online"):
            regs: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
            regs["x"] = p.share_input(x)
            for op in plan.ops:
                part = bundle.parts[op.name]
                rd = [self._read(regs, ref) for ref in op.reads]
                if op.kind == "linear":
                    out = p.linear_online(part, *rd[0])
                elif op.kind == "beaver_matmul":
                    out = p.beaver_online(part, *rd[0], *rd[1])
                elif op.kind == "trunc":
                    out = p.trunc_online(part, *rd[0])
                elif op.kind == "gc_apply":
                    if op.attrs["circuit"] == "softmax":
                        out = p.gc_online(part, *rd[0])
                    else:
                        out = p.activation_online(part, *rd[0])
                elif op.kind == "layernorm":
                    hc, hs = rd[0]
                    for (ac, as_) in rd[1:]:  # residual adds
                        hc = SS.add_mod(hc, ac, p.t)
                        hs = SS.add_mod(hs, as_, p.t)
                    out = p.layernorm_online(part, hc, hs)
                else:
                    raise ValueError(op.kind)
                self._write(regs, op.write, out)
            return p.reveal(*regs[plan.output_reg])

    def _read(self, regs, ref: RegRef) -> Tuple[np.ndarray, np.ndarray]:
        c, s = regs[ref.reg]
        if ref.cols is not None:
            lo, hi = ref.cols
            c, s = c[:, lo:hi], s[:, lo:hi]
        if ref.transpose:
            c, s = c.T.copy(), s.T.copy()
        return c, s

    def _write(self, regs, ref: RegRef, out) -> None:
        oc, os_ = out
        if ref.cols is None:
            regs[ref.reg] = (oc, os_)
            return
        if ref.reg not in regs:
            shape = self.plan.reg_shapes[ref.reg]
            regs[ref.reg] = (np.zeros(shape, np.uint64),
                             np.zeros(shape, np.uint64))
        lo, hi = ref.cols
        regs[ref.reg][0][:, lo:hi] = oc
        regs[ref.reg][1][:, lo:hi] = os_


def compile(model, pcfg: Optional[PrivacyConfig] = None,
            shape: Union[int, Tuple[int, ...], None] = None,
            *, seed: Optional[int] = None,
            device=None, wire_version: int = 1,
            compression: bool = True) -> PiTSession:
    """Trace ``model.forward_private`` into a Plan and wrap it in a session.

    ``model``: a ``PrivateTransformer`` (or any object with ``d``, ``h``,
    ``hd``, ``d_ff``, ``weights``, ``activation``, ``scale_q`` and a
    protocol ``p``). ``shape`` is the request bucket: ``(seq_len, d)`` or
    just ``seq_len``. ``pcfg`` defaults to the model's privacy config; the
    session gets its own protocol instance so its phase ledgers start
    clean and bundles never alias the model's eager state.

    ``device`` defaults to the model's device (``"cuda"`` unless the model
    was built for the CPU); the GC executor of
    :mod:`repro_torch.core.gc_exec` runs there.
    """
    if shape is None:
        raise ValueError("compile needs the request bucket shape (S, d)")
    if isinstance(shape, (tuple, list)):
        seq_len = int(shape[0])
        if len(shape) > 1 and int(shape[1]) != model.d:
            raise ValueError(f"shape {shape} does not match model d={model.d}")
    else:
        seq_len = int(shape)
    with obs.span("compile", seq_len=seq_len, d=int(model.d)):
        plan = compile_plan(model, seq_len)
    pcfg = pcfg or model.p.pcfg
    return PiTSession(
        plan, model.weights, pcfg,
        seed=seed if seed is not None else 0,
        device=device if device is not None else
        getattr(model, "device", "cuda"),
        wire_version=wire_version, compression=compression,
    )
