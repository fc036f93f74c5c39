"""Two-party endpoints: the compiled plan walk as real message exchanges.

Roles follow the repo's protocol convention (``core/protocol.py``): the
**client owns the input and acts as garbler**; the **server owns the
weights and acts as evaluator**. So in deployment terms:

  :class:`GarblerEndpoint`    the client process — holds ``x``, garbles
                              every netlist in the plan, drives
                              ``preprocess``/``run`` requests
  :class:`EvaluatorEndpoint`  the long-lived model server — holds the
                              weights, evaluates circuits, deals triples

Both endpoints walk the *same* compiled :class:`~repro_torch.core.plan.Plan`
in lockstep (the server ships the plan spec in the handshake) and
execute each op's offline/online halves as framed wire messages. Every
protocol-metered message becomes a PROTO segment whose payload length is
exactly what the in-process ``ot.Channel`` meters — the simulation is
the byte oracle, and the per-tag :class:`WireLedger` can be asserted
equal to a metered ``PiTSession`` transcript (``tests/test_torch_net.py``).

Fidelity boundary (documented, measured): the runtime is *share- and
size-faithful*, not cryptographically hardened — it inherits the repo's
honest-but-curious simulation level. Concretely: HE ciphertext frames
are identity-encrypted blocks of the exact ciphertext wire size; OT
frames carry the choice bits / chosen labels in correctly-sized IKNP
blocks; and a small **sim sideband** (SIM frames, ledgered separately as
overhead) carries what the oracle treats as implicit — GC decode
metadata, the LayerNorm-offload centered share whose HE transfer the
meter prepays offline, and the final output shares.

Outputs are bit-identical to the in-process ``PiTSession.run`` path:
every op's algebra is the same mod-t computation, and additive masks
cancel under reconstruction regardless of which party drew them.

The port of the JAX package's ``net/party.py``. Frames are the
reference's byte for byte, so a torch endpoint and a JAX endpoint run a
session together in either role. Each party garbles or evaluates on its
``device`` (``"cuda"`` unless the caller asks for the CPU): the garbler's
walk kernel writes tables that go device-to-host for the wire, and the
evaluator's tables and labels go host-to-device on receipt. The spans
``net.d2h`` and ``net.h2d`` time those copies (the device is synchronised
before a timed device-to-host copy, so a walk still running does not
count as copy time).
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
import traceback
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import PrivacyConfig
from repro_torch import obs
from repro_torch.core import garble as G
from repro_torch.core import labels as LB
from repro_torch.core import ot as OT
from repro_torch.core import secret_sharing as SS
from repro_torch.core.netlist import Netlist
from repro_torch.core.ot import Channel
from repro_torch.core.plan import (
    GC_KINDS,
    OpSpec,
    Plan,
    RegRef,
    compile_plan,
    plan_from_spec,
    plan_to_spec,
)
from repro_torch.core.protocol import (
    PiTProtocol,
    _row_sum,
    _row_sum_sq,
    _rowwise_mul,
    bits_of,
    words_from_bits,
)
from repro_torch.core.session import GarblingCache, gc_net_for
from repro_torch.net import wire as W
from repro_torch.net.transport import (
    Deadlines,
    Transport,
    TransportClosed,
    TransportTimeout,
)
from repro_torch.serve.errors import BundlePoolEmpty


class NetProtocolError(RuntimeError):
    """Lockstep violation, peer error, or malformed exchange."""


class SessionRebindError(NetProtocolError):
    """A reconnecting endpoint pair landed in a different session than
    the one its client state remembers — the server reclaimed the old
    session (lease expired, or it was never parked) and minted a new
    one. The client's pooled bundles belong to the dead session and are
    unusable; a resilient caller surfaces this as ``SessionLost``."""


_bundle_ids = itertools.count(1)


def _d2h(x: torch.Tensor) -> np.ndarray:
    """Labels or tables (int32 bit patterns) to host uint32, reinterpreted.
    The span ``net.d2h`` times the copy alone: the device is synchronised
    first, so a walk kernel still running is not counted as copy time."""
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    with obs.span("net.d2h", bytes=int(x.numel()) * 4):
        return W.as_u32(x)


def _h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host uint32 labels or tables onto ``device`` as int32 bit patterns
    (span ``net.h2d``)."""
    a = np.ascontiguousarray(a, np.uint32)
    with obs.span("net.h2d", bytes=int(a.nbytes)):
        return torch.from_numpy(a.view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# ledgers
# ---------------------------------------------------------------------------


@dataclass
class WireLedger:
    """Per-phase protocol byte ledger + overhead counters.

    ``offline``/``online`` reuse :class:`~repro_torch.core.ot.Channel`, keyed
    by the same tags the in-process meter uses, so equality with the
    oracle's ``Stats.channel_offline/online.by_tag`` is a direct dict
    compare. ``sim_bytes``/``control_bytes`` are the sideband and
    ``dir_flips`` counts wire direction alternations over ALL frames
    (control and sim included — the hello/bye handshake contributes two
    flips, which is why this number reads higher than the PROTO-only
    round structure). ``dir_flips_offline``/``dir_flips_online`` count
    alternations over PROTO frames of one phase only — the real
    latency-bearing round structure the LAN model charges — and
    ``proto_frames_*`` count PROTO frames per phase, i.e. the v2
    post-coalescing round count (the oracle's ``rounds`` counts meter
    calls = pre-coalescing segments).

    ``seed_stream_*``/``delta_batches``/``resid_bytes`` count the v2
    compressed streams (how many label batches were replayed from seeds
    and how much table residual rode the sim sideband).

    One ledger is shared by all endpoints of a party — in the pipelined
    mode the offline and online endpoints mutate it from two threads, so
    every update happens under ``_mutex``.
    """

    offline: Channel = field(default_factory=Channel)
    online: Channel = field(default_factory=Channel)
    sim_bytes: int = 0
    control_bytes: int = 0
    frame_bytes: int = 0  # total frame bytes incl. headers, both ways
    dir_flips: int = 0
    dir_flips_offline: int = 0
    dir_flips_online: int = 0
    proto_frames_offline: int = 0
    proto_frames_online: int = 0
    seed_stream_segs: int = 0
    seed_stream_labels: int = 0
    delta_batches: int = 0
    resid_bytes: int = 0
    _last_io: int = 0  # +1 sent, -1 received
    _last_proto: Dict[int, int] = field(default_factory=dict)
    _mutex: threading.Lock = field(default_factory=threading.Lock,
                                   repr=False)

    def _channel(self, phase: int) -> Channel:
        if phase == W.PHASE_OFFLINE:
            return self.offline
        if phase == W.PHASE_ONLINE:
            return self.online
        raise NetProtocolError("PROTO frame without a phase")

    def record_segs(self, phase: int, segs: Sequence[W.Seg]) -> None:
        ch = self._channel(phase)
        with self._mutex:
            for s in segs:
                if s.dir == W.DIR_C2S:
                    ch.c2s(len(s.data), s.tag)
                else:
                    ch.s2c(len(s.data), s.tag)

    def record_io(self, outgoing: bool, nbytes: int) -> None:
        d = 1 if outgoing else -1
        with self._mutex:
            if self._last_io and d != self._last_io:
                self.dir_flips += 1
            self._last_io = d
            self.frame_bytes += nbytes

    def record_proto_frame(self, phase: int, outgoing: bool,
                           nbytes: int) -> None:
        """One PROTO frame on the wire: the post-coalescing round unit."""
        d = 1 if outgoing else -1
        with self._mutex:
            last = self._last_proto.get(phase, 0)
            if last and d != last:
                if phase == W.PHASE_OFFLINE:
                    self.dir_flips_offline += 1
                else:
                    self.dir_flips_online += 1
            self._last_proto[phase] = d
            if phase == W.PHASE_OFFLINE:
                self.proto_frames_offline += 1
            else:
                self.proto_frames_online += 1

    def add_sim(self, nbytes: int) -> None:
        with self._mutex:
            self.sim_bytes += nbytes

    def add_stream(self, labels: int) -> None:
        """One seed-stream segment replacing ``labels`` raw labels."""
        with self._mutex:
            self.seed_stream_segs += 1
            self.seed_stream_labels += int(labels)

    def add_delta_batch(self, resid_bytes: int) -> None:
        """One delta-encoded table batch with its sideband residual."""
        with self._mutex:
            self.delta_batches += 1
            self.resid_bytes += int(resid_bytes)

    def add_control(self, nbytes: int) -> None:
        with self._mutex:
            self.control_bytes += nbytes

    def absorb(self, other: "WireLedger") -> None:
        """Fold another ledger's counters into this one (a gateway
        endpoint meters its pre-hello frames on a provisional ledger,
        then transfers them to the session it resolves to)."""
        with self._mutex, other._mutex:
            for phase_ch, o_ch in ((self.offline, other.offline),
                                   (self.online, other.online)):
                for tag, n in o_ch.by_tag.items():
                    phase_ch.by_tag[tag] = phase_ch.by_tag.get(tag, 0) + n
                phase_ch.client_to_server += o_ch.client_to_server
                phase_ch.server_to_client += o_ch.server_to_client
                phase_ch.rounds += o_ch.rounds
            self.sim_bytes += other.sim_bytes
            self.control_bytes += other.control_bytes
            self.frame_bytes += other.frame_bytes
            self.dir_flips += other.dir_flips
            self.dir_flips_offline += other.dir_flips_offline
            self.dir_flips_online += other.dir_flips_online
            self.proto_frames_offline += other.proto_frames_offline
            self.proto_frames_online += other.proto_frames_online
            self.seed_stream_segs += other.seed_stream_segs
            self.seed_stream_labels += other.seed_stream_labels
            self.delta_batches += other.delta_batches
            self.resid_bytes += other.resid_bytes
            if other._last_io:
                self._last_io = other._last_io
            for phase, last in other._last_proto.items():
                if last:
                    self._last_proto[phase] = last

    def summary(self) -> Dict[str, object]:
        # consistent snapshot: endpoint threads mutate every field below
        # under ``_mutex``, so the reader must hold it too — without it a
        # poll racing a ``record_segs`` can see a frame counted in
        # ``frame_bytes`` but not yet in its phase channel
        with self._mutex:
            return {
                "offline_bytes": self.offline.total,
                "online_bytes": self.online.total,
                "sim_bytes": self.sim_bytes,
                "control_bytes": self.control_bytes,
                "frame_bytes": self.frame_bytes,
                "dir_flips": self.dir_flips,
                "dir_flips_offline": self.dir_flips_offline,
                "dir_flips_online": self.dir_flips_online,
                "proto_frames_offline": self.proto_frames_offline,
                "proto_frames_online": self.proto_frames_online,
                "rounds_after_coalescing": (self.proto_frames_offline
                                            + self.proto_frames_online),
                "raw_messages": self.offline.rounds + self.online.rounds,
                "seed_stream_segs": self.seed_stream_segs,
                "seed_stream_labels": self.seed_stream_labels,
                "delta_batches": self.delta_batches,
                "resid_bytes": self.resid_bytes,
                "offline_by_tag": dict(self.offline.by_tag),
                "online_by_tag": dict(self.online.by_tag),
            }


def _gc_geom(net: Netlist, k: int) -> Tuple[int, int, int]:
    """(n_out_words, xc_label_count, evaluator_label_count) of a netlist."""
    n_out_bits = len(net.outputs)
    xc_bits = len(net.garbler_inputs) - n_out_bits
    return n_out_bits // k, xc_bits, len(net.evaluator_inputs)


def _distinct_nets(protocol: PiTProtocol, plan: Plan, *, n: int = 1,
                   cache: Optional[GarblingCache] = None
                   ) -> Tuple[Dict[str, Netlist], Dict[str, int]]:
    """Netlists in first-appearance order + per-request instance totals.

    With ``cache`` (the server side of a multi-session gateway), netlist
    resolution routes through the shared :class:`GarblingCache`, counted
    per distinct slab — ``n`` is the bundle batch size, so the slab key
    matches the ``instances`` the garbler actually ships.
    """
    if cache is not None:
        return cache.distinct_nets(plan, n)
    nets: Dict[str, Netlist] = {}
    per_req: Dict[str, int] = {}
    for op in plan.ops:
        if op.kind in GC_KINDS:
            net = gc_net_for(protocol, op)
            per_req[net.name] = per_req.get(net.name, 0) + plan.gc_instances(op)
            nets.setdefault(net.name, net)
    return nets, per_req


def _read_reg(regs: Dict[str, np.ndarray], ref: RegRef) -> np.ndarray:
    v = regs[ref.reg]
    if ref.cols is not None:
        v = v[:, ref.cols[0]: ref.cols[1]]
    if ref.transpose:
        v = v.T.copy()
    return v


def _write_reg(regs: Dict[str, np.ndarray], shapes, ref: RegRef,
               val: np.ndarray) -> None:
    if ref.cols is None:
        regs[ref.reg] = val
        return
    if ref.reg not in regs:
        regs[ref.reg] = np.zeros(shapes[ref.reg], np.uint64)
    regs[ref.reg][:, ref.cols[0]: ref.cols[1]] = val


# ---------------------------------------------------------------------------
# endpoint base: framed send/recv with ledger + lockstep checks
# ---------------------------------------------------------------------------


_PHASE_NAMES = {W.PHASE_OFFLINE: "offline", W.PHASE_ONLINE: "online"}


def _trace_segs(phase: int, segs: Sequence[W.Seg], direction: str) -> None:
    """Mirror a ledger ``record_segs`` into the trace, one instant per
    segment, carrying the SAME (phase, tag, byte-count) the ledger
    records — so the trace reconciles against ``WireLedger.by_tag``
    exactly, segment by segment. Attributes are sizes and tags only,
    never the segment payload."""
    tr = obs.current()
    if not tr.enabled:
        return
    ph = _PHASE_NAMES.get(phase, str(phase))
    for s in segs:
        tr.instant("wire:seg", tag=s.tag, bytes=len(s.data), phase=ph,
                   dir=direction)


class _Endpoint:
    def __init__(self, transport: Transport, *, timeout: Optional[float],
                 ledger: WireLedger,
                 deadlines: Optional[Deadlines] = None):
        self.transport = transport
        self.timeout = timeout
        # per-phase recv deadlines; a bare ``timeout`` becomes the
        # uniform default for callers that predate Deadlines
        self.deadlines = deadlines if deadlines is not None \
            else Deadlines.uniform(timeout)
        self._phase_name = "idle"
        self.ledger = ledger
        self._seg_queue: Deque[Tuple[int, W.Seg]] = deque()
        # negotiated at hello; v1 until then (pre-hello traffic is v1)
        self.wire_version = W.WIRE_VERSION
        self.compression = True
        # v2 round coalescing: outgoing PROTO segs buffer here and flush
        # as ONE frame per consecutive same-phase run — before anything
        # that must hit the wire in order (CONTROL/SIM sends) and before
        # any blocking receive (so lockstep can never deadlock on a
        # buffered segment the peer is waiting for)
        self._out_buf: List[Tuple[int, W.Seg]] = []

    # -- send ----------------------------------------------------------
    def _send_control(self, tag: str, payload=None) -> None:
        self._flush()
        # CONTROL stays v1-framed: hello happens before negotiation and
        # a v1-only peer must be able to parse the handshake
        frame = W.encode_msg(W.KIND_CONTROL, tag, payload)
        self.ledger.add_control(len(frame))
        self.ledger.record_io(True, len(frame))
        self.transport.send(frame)

    def _send_sim(self, tag: str, payload, phase: int) -> None:
        self._flush()
        frame = W.encode_msg(W.KIND_SIM, tag, payload, phase=phase)
        self.ledger.add_sim(len(frame))
        self.ledger.record_io(True, len(frame))
        self.transport.send(frame)

    def _send_segs(self, segs: Sequence[W.Seg], phase: int) -> None:
        if not segs:
            return
        if self.wire_version >= 2:
            self._out_buf.extend((phase, s) for s in segs)
            return
        self._emit_proto(list(segs), phase)

    def _emit_proto(self, segs: List[W.Seg], phase: int) -> None:
        with obs.span("wire.send", phase=_PHASE_NAMES.get(phase, str(phase)),
                      segs=len(segs)) as sp:
            frame = W.encode_proto(segs, phase, version=self.wire_version)
            sp.set(bytes=len(frame))
            self.ledger.record_segs(phase, segs)
            _trace_segs(phase, segs, "send")
            self.ledger.record_proto_frame(phase, True, len(frame))
            self.ledger.record_io(True, len(frame))
            self.transport.send(frame)

    def _flush(self) -> None:
        if not self._out_buf:
            return
        buf, self._out_buf = self._out_buf, []
        with obs.span("wire.flush", segs=len(buf)):
            i = 0
            while i < len(buf):
                phase = buf[i][0]
                j = i
                while j < len(buf) and buf[j][0] == phase:
                    j += 1
                self._emit_proto([s for _, s in buf[i:j]], phase)
                i = j

    @contextmanager
    def _in_phase(self, phase: str):
        prev, self._phase_name = self._phase_name, phase
        try:
            yield
        finally:
            self._phase_name = prev

    # -- recv ----------------------------------------------------------
    def _recv_frame(self) -> W.Msg:
        self._flush()
        with obs.span("wire.recv") as sp:
            frame = self.transport.recv(
                timeout=self.deadlines.for_phase(self._phase_name))
            msg = W.decode_frame(frame)
        sp.set(bytes=len(frame), kind=msg.kind)
        self.ledger.record_io(False, len(frame))
        if msg.kind == W.KIND_PROTO:
            self.ledger.record_segs(msg.phase, msg.segs)
            _trace_segs(msg.phase, msg.segs, "recv")
            self.ledger.record_proto_frame(msg.phase, False, len(frame))
        elif msg.kind == W.KIND_SIM:
            self.ledger.add_sim(len(frame))
        else:
            self.ledger.add_control(len(frame))
            if msg.tag == "error":
                raise NetProtocolError(f"peer error: {msg.payload}")
            if msg.tag == "shed":
                # typed load-shed frame, never an exception string: the
                # peer stays healthy, we back off for the hinted time
                p = msg.payload if isinstance(msg.payload, dict) else {}
                raise BundlePoolEmpty(
                    f"peer shed load (scope={p.get('scope', 'pool')}): "
                    f"retry after {p.get('retry_after_s')}s",
                    retry_after_s=p.get("retry_after_s"),
                    scope=str(p.get("scope", "pool")))
        return msg

    def _expect_seg(self, tag: str) -> bytes:
        while not self._seg_queue:
            msg = self._recv_frame()
            if msg.kind != W.KIND_PROTO:
                raise NetProtocolError(
                    f"expected PROTO seg {tag!r}, got kind={msg.kind} "
                    f"tag={msg.tag!r}")
            self._seg_queue.extend((msg.phase, s) for s in msg.segs)
        _, seg = self._seg_queue.popleft()
        if seg.tag != tag:
            raise NetProtocolError(
                f"lockstep violation: expected seg {tag!r}, got {seg.tag!r}")
        return seg.data

    def _expect_msg(self, kind: int, tag: str):
        if self._seg_queue:
            pending = self._seg_queue[0][1].tag
            raise NetProtocolError(
                f"expected {tag!r} but PROTO seg {pending!r} is pending")
        msg = self._recv_frame()
        if msg.kind != kind or msg.tag != tag:
            raise NetProtocolError(
                f"lockstep violation: expected ({kind}, {tag!r}), got "
                f"({msg.kind}, {msg.tag!r})")
        return msg.payload

    def close(self) -> None:
        self.transport.close()


# ---------------------------------------------------------------------------
# server (evaluator) side
# ---------------------------------------------------------------------------


class SessionState:
    """One client relationship's server-side state: a private bundle-id
    namespace, its own :class:`WireLedger`, and rate/byte accounting.

    ``PitNetServer`` owns exactly one (every endpoint pair serves the
    same client); the JAX package's gateway (``serve/gateway.py``) mints one
    per admitted client and binds each accepted transport to the session
    its hello names — bundle ids from different clients can no longer
    collide, which is what let the old server refuse a second client.
    """

    def __init__(self, sid: int = 0, client: str = "local"):
        self.sid = sid
        self.client = client
        self.lock = threading.Lock()  # bundle store
        self.bundles: Dict[int, Dict[str, dict]] = {}
        self.ledger = WireLedger()
        self.endpoints = 0  # live transports bound to this session
        self.wire_version = W.WIRE_VERSION  # negotiated at hello
        self.iknp = None  # per-session IKNP receiver state (v2, lazy)
        self.created_s = time.perf_counter()
        # resilience: lease/epoch so a reconnecting client can rebind
        # its transports to THIS session instead of getting a new one.
        # epoch counts transport generations; lease_expires_s is set
        # (monotonic clock) while the session is parked with zero live
        # endpoints awaiting a resume, None otherwise.
        self.epoch = 0
        self.resumes = 0
        self.gen = 0  # highest client transport generation seen in a
        # hello — lets a gateway detect a reconnect deterministically
        # even when the new hellos race the old endpoints' teardown
        self.lease_expires_s: Optional[float] = None
        # accounting (mutated under ``lock``)
        self.prep_requests = 0
        self.run_requests = 0
        self.run_inflight = 0  # runs started, neither consumed nor burned
        self.bundles_prepped = 0
        self.bundles_consumed = 0
        self.bundles_returned = 0
        self.bundles_burned = 0
        self.sheds = 0

    def outstanding(self) -> int:
        with self.lock:
            return len(self.bundles) + self.run_inflight

    def summary(self) -> Dict[str, object]:
        """Per-session rate/byte accounting on top of the wire ledger."""
        dt = max(time.perf_counter() - self.created_s, 1e-9)
        led = self.ledger.summary()  # snapshot under the ledger mutex
        with self.lock:
            out = {
                "sid": self.sid,
                "client": self.client,
                "wire_version": self.wire_version,
                "prep_requests": self.prep_requests,
                "run_requests": self.run_requests,
                "bundles_prepped": self.bundles_prepped,
                "bundles_consumed": self.bundles_consumed,
                "bundles_returned": self.bundles_returned,
                "bundles_burned": self.bundles_burned,
                "bundles_outstanding": len(self.bundles) + self.run_inflight,
                "epoch": self.epoch,
                "resumes": self.resumes,
                "sheds": self.sheds,
                "elapsed_s": round(dt, 3),
                "runs_per_s": round(self.run_requests / dt, 3),
                "bytes_per_s": round(led["frame_bytes"] / dt, 1),
            }
        out.update(led)
        return out


class ServerShared:
    """Weight-owner state shared by all evaluator endpoints of a server.

    Two axes of sharing: the pipelined mode runs one endpoint per
    transport (a dedicated offline pair and an online pair) over one
    bundle store, and the gateway runs N client *sessions* over one
    model/protocol. Everything here is session-invariant — the plan, the
    protocol (whose netlist cache IS the shared garbling cache, made
    observable by ``gc_cache``), quantized weights, LN parameters — while
    per-client state (bundle namespace, ledger, accounting) lives in
    :class:`SessionState`. ``session`` is the default single-client
    namespace that ``PitNetServer`` endpoints use.
    """

    def __init__(self, model, seq_len: int, *, device="cuda",
                 seed: int = 104729, wire_version: int = W.WIRE_V2,
                 compression: bool = True):
        self.model = model
        self.device = torch.device(device)
        #: highest wire revision this server offers; each hello
        #: negotiates min(client, server) per session, so a v1-only
        #: peer still completes runs against a v2 server
        self.wire_version = wire_version
        self.compression = compression
        self.plan = compile_plan(model, seq_len)
        self.protocol = PiTProtocol(model.p.pcfg, seed=seed,
                                    device=self.device,
                                    wire_version=wire_version,
                                    compression=compression)
        self.gc_cache = GarblingCache(self.protocol)
        self.rng = np.random.default_rng(seed)
        self.rng_lock = threading.Lock()
        self.session = SessionState()
        self._weight_lock = threading.Lock()
        self._quantized: Dict[str, tuple] = {}
        self._ln_cache: Dict[str, dict] = {}

    # default-session views (the pre-gateway single-client API)
    @property
    def lock(self) -> threading.Lock:
        return self.session.lock

    @property
    def bundles(self) -> Dict[int, Dict[str, dict]]:
        return self.session.bundles

    @property
    def ledger(self) -> WireLedger:
        return self.session.ledger

    # -- weight access (mirrors PiTSession; locked: gateway sessions
    # race the first resolution from N endpoint threads) ---------------
    def weight_mod(self, op: OpSpec) -> np.ndarray:
        with self._weight_lock:
            if op.name not in self._quantized:
                Wt = self.model.weights[op.attrs["layer"]]
                w = getattr(Wt, op.attrs["weight"])
                scale = op.attrs.get("wscale", 1.0)
                if scale != 1.0:
                    w = w * scale
                self._quantized[op.name] = self.protocol.quantize_weight(w)
            return self._quantized[op.name][1]

    def _ln_params_locked(self, op: OpSpec) -> dict:
        if op.name not in self._ln_cache:
            p = self.protocol
            Wt = self.model.weights[op.attrs["layer"]]
            which = op.attrs["which"]
            gamma = getattr(Wt, f"{which}_g")
            beta = getattr(Wt, f"{which}_b")
            f = p.frac
            self._ln_cache[op.name] = {
                "gq_mod": SS.encode_fx(np.asarray(gamma), f, p.t),
                "bq_mod": SS.encode_fx(np.asarray(beta), f, p.t),
                "gq_raw": np.round(np.asarray(gamma, np.float64) * (1 << f)
                                   ).astype(np.int64),
                "bq_raw": np.round(np.asarray(beta, np.float64) * (1 << f)
                                   ).astype(np.int64),
            }
        return self._ln_cache[op.name]

    def ln_params(self, op: OpSpec) -> dict:
        with self._weight_lock:
            return self._ln_params_locked(op)

    def hello_payload(self) -> dict:
        p = self.protocol
        ln_gq = {
            op.name: self.ln_params(op)["gq_mod"]
            for op in self.plan.ops
            if op.kind == "layernorm" and p.pcfg.layernorm_offload
        }
        return {
            "version": self.wire_version,
            "compression": self.compression,
            "plan": plan_to_spec(self.plan),
            "pcfg": asdict(self.model.p.pcfg),
            "ln_gq": ln_gq,
        }


class EvaluatorEndpoint(_Endpoint):
    """Model-server endpoint: serves preprocess + run requests on one
    transport. Spawn one per transport over a shared :class:`ServerShared`
    for the pipelined offline/online split."""

    def __init__(self, transport: Transport, *, model=None,
                 seq_len: Optional[int] = None,
                 shared: Optional[ServerShared] = None, device="cuda",
                 timeout: Optional[float] = None,
                 deadlines: Optional[Deadlines] = None,
                 session: Optional[SessionState] = None):
        if shared is None:
            if model is None or seq_len is None:
                raise ValueError("need model+seq_len or a ServerShared")
            shared = ServerShared(model, seq_len, device=device)
        session = session or shared.session
        super().__init__(transport, timeout=timeout, ledger=session.ledger,
                         deadlines=deadlines)
        self.shared = shared
        self.session = session
        #: why the serve loop ended: "bye" | "closed" | "timeout" |
        #: "error" | None while still serving. Session owners (the
        #: gateway) use it to tell a clean goodbye from a vanished peer.
        self.disconnect_reason: Optional[str] = None
        #: the session epoch this endpoint was bound at (set at hello);
        #: a resume bumps the session's, which retires this endpoint
        self.epoch = session.epoch

    # ------------------------------------------------------------------
    def serve_forever(self) -> None:
        """Handle requests until the peer says bye / closes the transport.

        Errors are reported to the peer as a CONTROL ``error`` frame and
        re-raised (the endpoint thread dies loudly — a deadlocked or
        diverged session must never hang silently). ``_on_disconnect``
        runs on every exit — normal bye, peer vanishing mid-exchange, or
        an error — so session owners (the gateway) can reclaim state.
        """
        try:
            self._serve_loop()
        finally:
            self._on_disconnect()

    def _on_disconnect(self) -> None:
        """Hook: the transport is done (bye, close or error). Base
        endpoints have nothing to reclaim."""

    def _serve_loop(self) -> None:
        while True:
            try:
                msg = self._recv_frame()  # idle phase: between requests
            except TransportTimeout:
                # the peer is slow/absent but the connection is intact:
                # an idle deadline expiring is this server's decision to
                # hang up, not a peer crash — tell the peer why (class
                # name only), then release the transport
                self.disconnect_reason = "timeout"
                try:
                    self._send_control("error", "TransportTimeout "
                                                "(idle deadline exceeded)")
                except (TransportClosed, OSError):
                    pass
                self._close_quietly()
                return
            except TransportClosed:
                self.disconnect_reason = "closed"
                return
            try:
                if msg.kind != W.KIND_CONTROL:
                    raise NetProtocolError(
                        f"expected a CONTROL frame, got kind={msg.kind}")
                if msg.tag == "bye":
                    self.disconnect_reason = "bye"
                    return
                if msg.tag == "hello":
                    with self._in_phase("hello"):
                        self._handle_hello(msg.payload)
                elif msg.tag == "prep":
                    with obs.span("offline", role="evaluator",
                                  sid=self.session.sid), \
                            self._in_phase("offline"):
                        self._handle_prep(msg.payload)
                elif msg.tag == "run":
                    with obs.span("online", role="evaluator",
                                  sid=self.session.sid), \
                            self._in_phase("online"):
                        self._handle_run(msg.payload)
                else:
                    raise NetProtocolError(f"unknown request {msg.tag!r}")
            except TransportTimeout:
                # mid-request deadline: the stream may be desynced
                # (lockstep position unknown) — signal and hang up; any
                # interrupted run was already burned by _handle_run
                self.disconnect_reason = "timeout"
                try:
                    self._send_control("error", "TransportTimeout "
                                                "(request deadline exceeded)")
                except (TransportClosed, OSError):
                    pass
                self._close_quietly()
                return
            except TransportClosed:
                self.disconnect_reason = "closed"
                return
            except Exception as e:  # report, then die loudly
                # full traceback stays on THIS side only: exception reprs
                # interpolate live values (shapes, array contents, key
                # material in the worst case), so the peer gets just the
                # class name — enough to correlate with the server log
                self.disconnect_reason = "error"
                traceback.print_exc(file=sys.stderr)
                try:
                    self._send_control(
                        "error", f"{type(e).__name__} "
                                 f"(see evaluator-side log)")
                    self._drain_peer()
                except TransportClosed:
                    pass  # peer already gone — nothing left to tell it
                # close so a peer blocked mid-send fails fast
                self._close_quietly()
                raise

    def _drain_peer(self) -> None:
        """Drain the peer's in-flight stream after sending an error:
        closing a TCP socket with unread data RSTs the connection, which
        would discard the queued error frame before the peer reads it.
        Each wait respects the configured idle deadline (the old code
        hardcoded 0.5 s, silently overriding long-timeout deployments);
        a timeout or close ends the drain, and an OSError is surfaced as
        a typed close instead of being swallowed indistinguishably."""
        budget = self.deadlines.for_phase("idle")
        if budget is None or budget > 5.0:
            budget = 5.0  # a drain must stay bounded even when the
            # serve deadline is "block forever"
        while True:
            try:
                self.transport.recv(timeout=budget)
            except TransportTimeout:
                return  # peer went quiet without closing: good enough
            except OSError as e:
                if isinstance(e, TransportClosed):
                    raise
                raise TransportClosed(
                    f"drain failed: {type(e).__name__}") from e

    def _close_quietly(self) -> None:
        try:
            self.transport.close()
        except OSError:
            pass

    # ------------------------------------------------------------------
    def _handle_hello(self, payload) -> None:
        peer_v = payload.get("version")
        if not isinstance(peer_v, int) or peer_v < W.WIRE_VERSION:
            raise NetProtocolError(
                f"wire version mismatch: peer {peer_v}, "
                f"ours {W.WIRE_VERSION}..{self.shared.wire_version}")
        # pick the highest revision both ends speak: an old v1-only peer
        # advertises 1 and gets a v1 session; newer peers get v2 frames
        ver = min(peer_v, self.shared.wire_version)
        comp = (bool(payload.get("compression", True))
                and self.shared.compression and ver >= 2)
        extra = self._on_hello(payload)
        # _on_hello may have re-bound self.session (gateway resolution)
        self.wire_version = ver
        self.compression = comp
        with self.session.lock:  # readers (stats pollers) snapshot it
            self.session.wire_version = ver
            self.epoch = self.session.epoch
            if payload.get("reset_ot"):
                # reconnect hello: the IKNP extension counters on a
                # half-dead transport pair are desynced (receiver and
                # sender advance at different message boundaries), so a
                # resuming client asks both sides to redo the base OT —
                # ~32 KiB, vs silently corrupted labels otherwise
                self.session.iknp = None
        self._send_control("hello-ok", {
            **self.shared.hello_payload(),
            **extra,
            "version": ver,
            "compression": comp,
        })

    def _on_hello(self, payload) -> dict:
        """Hook: inspect the client hello (id/token), return extra
        hello-ok fields. The gateway resolves the session here; the
        single-client server just names its one session."""
        return {"session": self.session.sid}

    def _admit_prep(self, n: int) -> Optional[float]:
        """Hook: admission control for ``n`` more bundles. Return None to
        admit, or a retry-after hint (seconds) to shed. The base server
        has no bound — bounded pools are gateway policy."""
        return None

    # ------------------------------------------------------------------
    # offline: receive the garbling stream, deal server-side material
    # ------------------------------------------------------------------
    def _handle_prep(self, payload) -> None:
        sh = self.shared
        sess = self.session
        p = sh.protocol
        plan = sh.plan
        t, k = p.t, p.k
        n = int(payload["n"])
        ids = [int(i) for i in payload["ids"]]
        hint = self._admit_prep(n)
        if hint is not None:
            # bounded pool: typed CONTROL shed with a retry-after hint —
            # the client has garbled nothing yet, so nothing is wasted
            with sess.lock:
                sess.sheds += 1
            self._send_control("shed",
                               {"retry_after_s": hint, "scope": "prep"})
            return
        with sess.lock:
            dup = sorted(set(ids) & set(sess.bundles))
            sess.prep_requests += 1
        if dup or len(set(ids)) != n:
            # refuse rather than corrupt: a client reusing ids within its
            # own session would silently swap tables under the first
            # use's labels (ids are per-session — a *different* client's
            # ids live in a different SessionState namespace)
            raise NetProtocolError(
                f"bundle ids {dup or ids} already exist in this session")
        self._send_control("prep-ok", {"n": n})
        nets, per_req = _distinct_nets(p, plan, n=n, cache=sh.gc_cache)
        v2c = self.wire_version >= 2 and self.compression
        dev = sh.device

        slabs: Dict[str, dict] = {}
        if v2c:
            # the garbler coalesces every slab's segments into one frame
            # and defers the sideband: pop ALL the PROTO segs first, then
            # the resid/meta sims, mirroring the send order exactly
            heads: Dict[str, tuple] = {}
            for name, net in nets.items():
                I_tot = per_req[name] * n
                n_out, _, _ = _gc_geom(net, k)
                wire_b = self._expect_seg(f"tables:{name}")
                seed, ctr, count = W.unpack_seed_stream(
                    self._expect_seg("g-labels"))
                if ctr != 0 or count != I_tot * n_out * k:
                    raise NetProtocolError(
                        f"seed stream for {name!r} does not match the "
                        f"plan ({ctr}, {count})")
                heads[name] = (wire_b, seed, count)
            for name, net in nets.items():
                I_tot = per_req[name] * n
                n_out, _, _ = _gc_geom(net, k)
                wire_b, seed, count = heads[name]
                resid = self._expect_msg(W.KIND_SIM, f"tables-resid:{name}")
                meta = self._expect_msg(W.KIND_SIM, f"gc-meta:{name}")
                with obs.span("net.decode", netlist=name):
                    tables = W.unpack_tables_delta(wire_b, resid, I_tot,
                                                   net.and_count)
                tables = _h2d(tables, dev)
                with obs.span("net.h2d", bytes=count * 16):
                    mlab = LB.stream_labels(seed, 0, count, dev).reshape(
                        I_tot, n_out * k, 4)
                self.ledger.add_stream(count)
                self.ledger.add_delta_batch(len(resid))
                slabs[name] = {
                    "tables": tables, "mlab": mlab,
                    "perm": np.asarray(meta["perm"], np.uint32),
                    "cw": np.asarray(meta["cw"], np.int64),
                    "clab": _h2d(meta["clab"], dev),
                    "off": 0,
                }
        else:
            for name, net in nets.items():
                I_tot = per_req[name] * n
                n_out, xc_bits, _ = _gc_geom(net, k)
                tables = _h2d(W.unpack_tables(
                    self._expect_seg(f"tables:{name}"), I_tot,
                    net.and_count), dev)
                mlab = _h2d(W.unpack_labels(self._expect_seg("g-labels"),
                                            (I_tot, n_out * k)), dev)
                meta = self._expect_msg(W.KIND_SIM, f"gc-meta:{name}")
                slabs[name] = {
                    "tables": tables, "mlab": mlab,
                    "perm": np.asarray(meta["perm"], np.uint32),
                    "cw": np.asarray(meta["cw"], np.int64),
                    "clab": _h2d(meta["clab"], dev),
                    "off": 0,
                }

        resp: List[W.Seg] = []
        new_bundles: Dict[int, Dict[str, dict]] = {}
        for bid in ids:
            parts: Dict[str, dict] = {}
            for op in plan.ops:
                if op.kind == "linear":
                    x_shape = plan.read_shape(op.reads[0])
                    r1 = W.ct_unpack(self._expect_seg("he-enc-r"), x_shape)
                    Wmod = sh.weight_mod(op)
                    wr = SS.matmul_mod(r1, Wmod.T, t)
                    with sh.rng_lock:
                        s_mask = sh.rng.integers(0, t, wr.shape,
                                                 dtype=np.uint64)
                    client_y = SS.sub_mod(wr, s_mask, t)
                    resp.append(W.Seg("he-wr", W.DIR_S2C,
                                      W.ct_pack(client_y, p._ct_bytes,
                                                p.params.n)))
                    parts[op.name] = {"s_mask": s_mask}
                elif op.kind == "beaver_matmul":
                    m, kk = plan.read_shape(op.reads[0])
                    _, nn = plan.read_shape(op.reads[1])
                    with sh.rng_lock:
                        trip = SS.deal_matmul_triple(sh.rng, m, kk, nn, t)
                    resp.append(W.Seg(
                        "beaver", W.DIR_S2C,
                        W.pack_u64(trip.a1) + W.pack_u64(trip.b1)
                        + W.pack_u64(trip.c1)))
                    parts[op.name] = {"a2": trip.a2, "b2": trip.b2,
                                      "c2": trip.c2}
                else:  # GC kinds
                    I = plan.gc_instances(op)
                    net = gc_net_for(p, op)
                    slab = slabs[net.name]
                    lo = slab["off"]
                    slab["off"] = lo + I
                    parts[op.name] = {
                        "net": net,
                        "tables": slab["tables"][lo: lo + I],
                        "mlab": slab["mlab"][lo: lo + I],
                        "perm": slab["perm"][lo: lo + I],
                        "cw": slab["cw"],
                        "clab": slab["clab"][lo: lo + I],
                    }
                    if op.kind == "layernorm" and p.pcfg.layernorm_offload:
                        I_ln, nn = op.shape
                        self._expect_seg("he-ln-r")
                        self._expect_seg("he-enc-centered")
                        with sh.rng_lock:
                            parts[op.name]["he_mask"] = sh.rng.integers(
                                0, t, I_ln, dtype=np.uint64)
            new_bundles[bid] = parts
        self._send_segs(resp, W.PHASE_OFFLINE)
        with sess.lock:
            sess.bundles.update(new_bundles)
            sess.bundles_prepped += n
        self._send_control("prep-done", {"n": n, "ids": ids})

    # ------------------------------------------------------------------
    # online: one run against one bundle
    # ------------------------------------------------------------------
    def _handle_run(self, payload) -> None:
        sess = self.session
        bid = int(payload["id"])
        with sess.lock:
            sparts = sess.bundles.pop(bid, None)
            if sparts is not None:
                sess.run_requests += 1
                sess.run_inflight += 1
        if sparts is None:
            raise NetProtocolError(
                f"bundle {bid} unknown or already consumed on the server")
        try:
            self._run_bundle(sparts, payload)
        except BaseException:
            # burn on interrupt: the online leg exchanged SOME of this
            # bundle's labels before dying — re-running it would hand
            # the peer a second active label per wire, breaking GC
            # security. The bundle is gone from the store (popped above)
            # and is accounted as burned, never returned to any pool.
            with sess.lock:
                sess.run_inflight -= 1
                sess.bundles_burned += 1
            obs.instant("net.bundle_burn", sid=sess.sid, bundle=bid)
            raise
        with sess.lock:
            sess.run_inflight -= 1
            sess.bundles_consumed += 1

    def _run_bundle(self, sparts: Dict[str, dict], payload) -> None:
        sh = self.shared
        p = sh.protocol
        plan = sh.plan
        t = p.t
        bid = int(payload["id"])
        S, d = plan.seq_len, plan.d
        regs: Dict[str, np.ndarray] = {
            "x": W.unpack_u64(self._expect_seg("input-share"), (S, d))
        }
        for op in plan.ops:
            part = sparts[op.name]
            rd = [_read_reg(regs, ref) for ref in op.reads]
            with obs.span("op:" + op.kind, op=op.name):
                if op.kind == "linear":
                    xo_c = W.unpack_u64(self._expect_seg("x-minus-r"),
                                        rd[0].shape)
                    x_open = SS.add_mod(xo_c, rd[0], t)
                    wx = SS.matmul_mod(x_open, sh.weight_mod(op).T, t)
                    out = SS.add_mod(wx, part["s_mask"], t)
                elif op.kind == "beaver_matmul":
                    Es = SS.sub_mod(rd[0], part["a2"], t)
                    Fs = SS.sub_mod(rd[1], part["b2"], t)
                    self._send_segs([W.Seg("beaver-open", W.DIR_S2C,
                                           W.pack_u64(Es) + W.pack_u64(Fs))],
                                    W.PHASE_ONLINE)
                    data = self._expect_seg("beaver-open")
                    Ec = W.unpack_u64(data[: Es.size * 8], Es.shape)
                    Fc = W.unpack_u64(data[Es.size * 8:], Fs.shape)
                    E = SS.add_mod(Ec, Es, t)
                    F = SS.add_mod(Fc, Fs, t)
                    out = SS.add_mod(
                        SS.add_mod(part["c2"],
                                   SS.matmul_mod(E, part["b2"], t), t),
                        SS.matmul_mod(part["a2"], F, t), t)
                elif op.kind == "trunc":
                    flat = rd[0].reshape(-1, 1)
                    out = self._server_gc(part, flat, None
                                          ).reshape(rd[0].shape)
                elif op.kind == "gc_apply":
                    if op.attrs["circuit"] == "softmax":
                        out = self._server_gc(part, rd[0], None)
                    else:
                        flat = rd[0].reshape(-1, 1)
                        out = self._server_gc(part, flat, None
                                              ).reshape(rd[0].shape)
                elif op.kind == "layernorm":
                    hs = rd[0]
                    for extra in rd[1:]:
                        hs = SS.add_mod(hs, extra, t)
                    out = self._server_layernorm(op, part, hs)
                else:
                    raise NetProtocolError(f"unknown op kind {op.kind!r}")
                _write_reg(regs, plan.reg_shapes, op.write, out)

        self._send_sim("reveal", {"s": regs[plan.output_reg]},
                       W.PHASE_ONLINE)
        self._send_control("run-done", {"id": bid})

    # ------------------------------------------------------------------
    def _server_gc(self, part: dict, xs: np.ndarray,
                   raw_e: Optional[np.ndarray]) -> np.ndarray:
        """Evaluator leg of one GC op: OT request, receive labels,
        evaluate on the device, decode to this party's output share."""
        sh = self.shared
        p = sh.protocol
        t, k = p.t, p.k
        net: Netlist = part["net"]
        n_out, xc_bits, n_e = _gc_geom(net, k)
        I = xs.shape[0]

        e_bits = bits_of(xs, k, t)
        if raw_e is not None:
            rv = np.mod(np.asarray(raw_e, np.int64), 1 << k).astype(np.uint64)
            e_bits = np.concatenate([e_bits, bits_of(rv, k, 1 << k)], axis=1)
        assert e_bits.shape == (I, n_e)
        if self.wire_version >= 2:
            # real IKNP extension. One-time base OT, lazily at the
            # session's first online GC op: this endpoint (the OT
            # receiver) acts as base-OT *sender* — it sends A, the
            # garbler answers with the κ B-elements. Then per batch:
            # column matrix u out, masked label pairs back.
            sess = self.session
            g_lab_data = None
            with sess.lock:
                self._check_epoch()
                iknp = sess.iknp
            if iknp is None:
                with sh.rng_lock:
                    iknp = OT.IknpReceiver(sh.rng)
                self._send_segs([W.Seg("ot-base", W.DIR_S2C,
                                       iknp.base_msg_a())], W.PHASE_ONLINE)
                g_lab_data = self._expect_seg("g-labels")
                iknp.absorb_base_b(self._expect_seg("ot-base"))
                with sess.lock:
                    self._check_epoch()
                    sess.iknp = iknp
            u, t_cols = iknp.extend(e_bits)
            self._send_segs([W.Seg(f"ot:{net.name}", W.DIR_C2S, u)],
                            W.PHASE_ONLINE)
            if g_lab_data is None:
                g_lab_data = self._expect_seg("g-labels")
            g_lab = W.unpack_labels(g_lab_data, (I, xc_bits))
            e_lab = iknp.receive(self._expect_seg(f"ot:{net.name}"),
                                 e_bits, t_cols).reshape(I, n_e, 4)
            e_lab = e_lab.numpy().view(np.uint32)
        else:
            # sim-OT: the receiver's choice-derived messages (logical c2s
            # in the oracle's ledger; see core/ot.ot_labels)
            self._send_segs([W.Seg(f"ot:{net.name}", W.DIR_C2S,
                                   W.pack_ot_request(e_bits))],
                            W.PHASE_ONLINE)
            g_lab = W.unpack_labels(self._expect_seg("g-labels"),
                                    (I, xc_bits))
            e_lab = W.unpack_ot_response(self._expect_seg(f"ot:{net.name}"),
                                         (I, n_e))
        wire_ids = np.concatenate([
            np.asarray(net.garbler_inputs, np.int64),
            np.asarray(net.evaluator_inputs, np.int64), part["cw"]])
        # the labels that came over the wire this op: one copy up
        live = _h2d(np.concatenate([g_lab, e_lab], axis=1), sh.device)
        labels = torch.cat([live[:, :xc_bits], part["mlab"],
                            live[:, xc_bits:], part["clab"]], dim=1)
        out_lab = G.evaluate(net, part["tables"], (wire_ids, labels))
        out_bits = ((_d2h(out_lab[..., 0].contiguous()) & 1) ^ part["perm"]
                    ).astype(np.uint8)
        return words_from_bits(out_bits, k, t)

    def _check_epoch(self) -> None:
        """Refuse the session's IKNP state to a retired endpoint (caller
        holds the session lock). After a resume, the dead pair's endpoint
        may still be working through frames queued before its transport
        died; the JAX package lets it extend the receiver the resumed
        pair just built, which advances that receiver's counters past the
        client's sender and garbles the retried run's labels. Its run is
        burned anyway, so it stops here as a closed transport."""
        if self.epoch != self.session.epoch:
            raise TransportClosed(
                f"endpoint of session epoch {self.epoch} retired by a "
                f"resume (epoch {self.session.epoch})")

    def _server_layernorm(self, op: OpSpec, part: dict, hs: np.ndarray
                          ) -> np.ndarray:
        sh = self.shared
        p = sh.protocol
        t, f = p.t, p.frac
        I, n = hs.shape
        lp = sh.ln_params(op)
        if not p.pcfg.layernorm_offload:
            raw = np.concatenate([np.broadcast_to(lp["gq_raw"], (I, n)),
                                  np.broadcast_to(lp["bq_raw"], (I, n))],
                                 axis=1)
            return self._server_gc(part, hs, raw)
        # APINT Fig. 4 offload, evaluator legs (mirrors layernorm_online)
        inv_n = int(round((1 << f) / n))
        mu = SS.scalar_mul_mod(inv_n, _row_sum(hs, t), t)
        cxs = SS.sub_mod(SS.scalar_mul_mod(1 << f, hs, t), mu[:, None], t)
        cxc = np.asarray(self._expect_msg(W.KIND_SIM, "ln-centered"),
                         np.uint64)
        cross = np.array(
            [int(np.dot(cxc[i].astype(object), cxs[i].astype(object)) % t)
             for i in range(I)], dtype=np.uint64)
        cross_c = SS.sub_mod(cross, part["he_mask"], t)
        self._send_segs([W.Seg("he-cross", W.DIR_S2C,
                               W.ct_pack_rows(cross_c, p._ct_bytes))],
                        W.PHASE_ONLINE)
        var_s = SS.add_mod(_row_sum_sq(cxs, t),
                           SS.scalar_mul_mod(2, part["he_mask"], t), t)
        var_s = SS.scalar_mul_mod(inv_n, var_s, t)
        gxs = _rowwise_mul(lp["gq_mod"], cxs, t)
        in_s = np.concatenate([gxs, var_s[:, None]], axis=1)
        out = self._server_gc(part, in_s, None)
        return SS.add_mod(out, np.broadcast_to(lp["bq_mod"], out.shape), t)


# ---------------------------------------------------------------------------
# client (garbler) side
# ---------------------------------------------------------------------------


class ClientShared:
    """Input-owner state shared by a client's endpoints (offline + online
    pairs in the pipelined mode): protocol, plan, and the bundle pool."""

    def __init__(self, *, seed: int = 0, device="cuda",
                 wire_version: int = W.WIRE_V2, compression: bool = True):
        self.seed = seed
        self.device = torch.device(device)
        #: highest wire revision this client requests at hello; the
        #: server replies with min(ours, theirs) — see ``adopt_hello``
        self.wire_version = wire_version
        self.compression = compression
        self.negotiated_version: Optional[int] = None
        self.negotiated_compression: Optional[bool] = None
        self.protocol: Optional[PiTProtocol] = None
        self.plan: Optional[Plan] = None
        self.ln_gq: Dict[str, np.ndarray] = {}
        self.rng = np.random.default_rng(seed)  # offline draws
        self.run_rng = np.random.default_rng(seed + 1)  # input shares
        self.lock = threading.Lock()  # pool + lazy init
        self.bundles: Dict[int, Dict[str, dict]] = {}
        self.order: Deque[int] = deque()
        self.ledger = WireLedger()
        self.iknp = None  # per-session IKNP sender state (v2, lazy)
        # both endpoints of a pair send the same token, so a gateway can
        # bind them to ONE session/bundle namespace (uuid: two clients
        # with the same seed must still be distinct sessions)
        self.client_token = f"c{seed}-{uuid.uuid4().hex[:12]}"
        self.session_id: Optional[int] = None

    def adopt_hello(self, payload: dict) -> None:
        sid = payload.get("session")
        ver = payload.get("version", W.WIRE_VERSION)
        comp = bool(payload.get("compression", False))
        if not isinstance(ver, int) or ver < W.WIRE_VERSION \
                or ver > self.wire_version:
            raise NetProtocolError(
                f"server negotiated wire version {ver!r}, outside our "
                f"supported range {W.WIRE_VERSION}..{self.wire_version}")
        with self.lock:
            if self.plan is not None:  # second endpoint of a pair
                if plan_to_spec(self.plan) != payload["plan"]:
                    raise NetProtocolError(
                        "offline/online endpoints saw different plans")
                if sid != self.session_id:
                    raise SessionRebindError(
                        f"endpoint landed in session {sid}, not the "
                        f"client's session {self.session_id} — either the "
                        f"hellos carried different tokens, or the server "
                        f"reclaimed the session (lease expired) and "
                        f"minted a new one")
                if ver != self.negotiated_version \
                        or comp != self.negotiated_compression:
                    raise NetProtocolError(
                        f"offline/online endpoints negotiated different "
                        f"wire formats (v{self.negotiated_version} vs "
                        f"v{ver})")
                return
            pcfg = PrivacyConfig(**payload["pcfg"])
            self.negotiated_version = ver
            self.negotiated_compression = comp
            self.protocol = PiTProtocol(pcfg, seed=self.seed,
                                        device=self.device,
                                        wire_version=ver, compression=comp)
            self.plan = plan_from_spec(payload["plan"])
            self.session_id = sid
            self.ln_gq = {k: np.asarray(v, np.uint64)
                          for k, v in payload["ln_gq"].items()}

    def pool_size(self) -> int:
        with self.lock:
            return len(self.order)

    def take_bundle_id(self) -> Optional[int]:
        with self.lock:
            return self.order.popleft() if self.order else None


class GarblerEndpoint(_Endpoint):
    """Client endpoint: connect, ``handshake()``, then ``preprocess(n)``
    (offline: garble + stream) and ``run(x)`` (online only)."""

    def __init__(self, transport: Transport, *,
                 shared: Optional[ClientShared] = None, seed: int = 0,
                 device="cuda", timeout: Optional[float] = None,
                 deadlines: Optional[Deadlines] = None,
                 wire_version: int = W.WIRE_V2, compression: bool = True,
                 reset_ot: bool = False, gen: int = 0):
        shared = shared or ClientShared(seed=seed, device=device,
                                        wire_version=wire_version,
                                        compression=compression)
        super().__init__(transport, timeout=timeout, ledger=shared.ledger,
                         deadlines=deadlines)
        self.shared = shared
        #: reconnect endpoints set this so the hello asks the server to
        #: drop the session's IKNP state (see EvaluatorEndpoint hello)
        self.reset_ot = reset_ot
        #: client transport generation (0 = first pair, bumped by the
        #: resilient client on every reconnect) — rides in the hello so
        #: the server's resume accounting is timing-independent
        self.gen = gen
        self._lock = threading.Lock()  # one request at a time per endpoint

    # ------------------------------------------------------------------
    def handshake(self) -> Plan:
        """Hello exchange; raises :class:`BundlePoolEmpty` if a gateway
        at its session cap sheds the connection (typed CONTROL frame
        with a retry-after hint, not an error string), and
        :class:`SessionRebindError` if a reconnect hello lands in a
        different session than the client remembers."""
        with self._lock, self._in_phase("hello"):
            hello = {
                "version": self.shared.wire_version,
                "compression": self.shared.compression,
                "client": self.shared.client_token,
            }
            if self.reset_ot:
                hello["reset_ot"] = True
            if self.gen:
                hello["gen"] = self.gen
            self._send_control("hello", hello)
            self.shared.adopt_hello(self._expect_msg(W.KIND_CONTROL,
                                                     "hello-ok"))
            self.wire_version = self.shared.negotiated_version
            self.compression = bool(self.shared.negotiated_compression)
        return self.shared.plan

    def close(self) -> None:
        try:
            self._send_control("bye")
        except TransportClosed:
            pass
        self.transport.close()

    # ------------------------------------------------------------------
    # offline
    # ------------------------------------------------------------------
    def preprocess(self, n: int = 1) -> List[int]:
        """Garble every netlist in the plan (one batched call per distinct
        netlist across all ``n`` bundles), stream tables/labels/HE frames
        to the evaluator, and pool the client halves. Returns bundle ids."""
        if n < 1:
            raise ValueError("preprocess needs n >= 1")
        sh = self.shared
        if sh.plan is None:
            self.handshake()
        with self._lock, obs.span("offline", role="garbler", bundles=n), \
                self._in_phase("offline"):
            return self._preprocess_locked(n)

    def _preprocess_locked(self, n: int) -> List[int]:
        sh = self.shared
        p = sh.protocol
        plan = sh.plan
        t, k = p.t, p.k
        ids = [next(_bundle_ids) for _ in range(n)]
        self._send_control("prep", {"n": n, "ids": ids})
        # admission gate BEFORE any garbling: a bounded server pool sheds
        # here (BundlePoolEmpty via the CONTROL shed frame) while the
        # expensive offline work is still unstarted on both sides
        self._expect_msg(W.KIND_CONTROL, "prep-ok")

        nets, per_req = _distinct_nets(p, plan)
        v2c = self.wire_version >= 2 and self.compression
        slabs: Dict[str, tuple] = {}
        sims: List[Tuple[str, object]] = []
        for name, net in nets.items():
            I_tot = per_req[name] * n
            n_out, xc_bits, _ = _gc_geom(net, k)
            if v2c:
                # v2: masks are drawn BEFORE garbling so the mask-wire
                # active labels can be preset to the PRG stream — the
                # evaluator replays the same stream from the 32-byte
                # seed record instead of receiving raw labels, and the
                # table batch ships delta-encoded (anchor + per-instance
                # XOR head; the residual rides the sim sideband)
                masks = sh.rng.integers(0, t, (I_tot, n_out),
                                        dtype=np.uint64)
                mask_enc = SS.sub_mod(np.zeros_like(masks), masks, t)
                seed = LB.stream_seed(sh.rng)
                with obs.span("garble", netlist=name, instances=I_tot):
                    gcirc = G.garble(
                        net, p.gen, I_tot, device=sh.device,
                        seeded_inputs=(net.garbler_inputs[xc_bits:],
                                       bits_of(mask_enc, k, t), seed, 0))
                tables = _d2h(gcirc.tables)
                with obs.span("net.encode", netlist=name):
                    wire_b, resid = W.pack_tables_delta(tables)
                self._send_segs([
                    W.Seg(f"tables:{name}", W.DIR_C2S, wire_b),
                    W.Seg("g-labels", W.DIR_C2S,
                          W.pack_seed_stream(seed, 0, I_tot * n_out * k)),
                ], W.PHASE_OFFLINE)
                self.ledger.add_stream(I_tot * n_out * k)
                self.ledger.add_delta_batch(len(resid))
                sims.append((f"tables-resid:{name}", resid))
            else:
                with obs.span("garble", netlist=name, instances=I_tot):
                    gcirc = G.garble(net, p.gen, I_tot, device=sh.device)
                masks = sh.rng.integers(0, t, (I_tot, n_out),
                                        dtype=np.uint64)
                mask_enc = SS.sub_mod(np.zeros_like(masks), masks, t)
                mlab = G.encode_inputs(gcirc, net.garbler_inputs[xc_bits:],
                                       bits_of(mask_enc, k, t))
                self._send_segs([
                    W.Seg(f"tables:{name}", W.DIR_C2S,
                          W.pack_tables(_d2h(gcirc.tables))),
                    W.Seg("g-labels", W.DIR_C2S, W.pack_labels(_d2h(mlab))),
                ], W.PHASE_OFFLINE)
            cw, clab = G.const_wires_labels(gcirc)
            # the reference's dtypes (uint32 perm and labels), so the
            # sideband frames are byte-identical to a JAX garbler's
            meta = {
                "perm": _d2h(gcirc.output_perm),
                "cw": np.asarray(cw), "clab": _d2h(clab),
            }
            if v2c:
                # defer the sideband so all slab segments coalesce into
                # one offline frame; the evaluator pops every PROTO seg
                # first, then the sims, in this exact order
                sims.append((f"gc-meta:{name}", meta))
            else:
                self._send_sim(f"gc-meta:{name}", meta, W.PHASE_OFFLINE)
            slabs[name] = (gcirc, masks)
        for tag, obj in sims:
            self._send_sim(tag, obj, W.PHASE_OFFLINE)

        offsets = {name: 0 for name in nets}
        new_bundles: Dict[int, Dict[str, dict]] = {}
        for bid in ids:
            parts: Dict[str, dict] = {}
            segs: List[W.Seg] = []
            for op in plan.ops:
                if op.kind == "linear":
                    x_shape = plan.read_shape(op.reads[0])
                    r1 = sh.rng.integers(0, t, x_shape, dtype=np.uint64)
                    segs.append(W.Seg("he-enc-r", W.DIR_C2S,
                                      W.ct_pack(r1, p._ct_bytes, p.params.n)))
                    parts[op.name] = {"r1": r1}
                elif op.kind == "beaver_matmul":
                    parts[op.name] = {}
                else:  # GC kinds
                    I = plan.gc_instances(op)
                    net = gc_net_for(p, op)
                    lo = offsets[net.name]
                    offsets[net.name] = lo + I
                    gcirc, masks = slabs[net.name]
                    parts[op.name] = {
                        "gc": G.slice_instances(gcirc, lo, lo + I),
                        "masks": masks[lo: lo + I],
                    }
                    if op.kind == "layernorm" and p.pcfg.layernorm_offload:
                        I_ln, nn = op.shape
                        blocks = W.ct_blocks(I_ln * nn, p.params.n)
                        segs.append(W.Seg("he-ln-r", W.DIR_C2S,
                                          bytes(blocks * p._ct_bytes)))
                        segs.append(W.Seg("he-enc-centered", W.DIR_C2S,
                                          bytes(I_ln * p._ct_bytes)))
            self._send_segs(segs, W.PHASE_OFFLINE)
            new_bundles[bid] = parts

        # server responses arrive in the same deterministic walk order
        for bid in ids:
            for op in plan.ops:
                if op.kind == "linear":
                    new_bundles[bid][op.name]["client_y"] = W.ct_unpack(
                        self._expect_seg("he-wr"), op.shape)
                elif op.kind == "beaver_matmul":
                    m, kk = plan.read_shape(op.reads[0])
                    _, nn = plan.read_shape(op.reads[1])
                    data = self._expect_seg("beaver")
                    o1, o2 = m * kk * 8, (m * kk + kk * nn) * 8
                    new_bundles[bid][op.name] = {
                        "a1": W.unpack_u64(data[:o1], (m, kk)),
                        "b1": W.unpack_u64(data[o1:o2], (kk, nn)),
                        "c1": W.unpack_u64(data[o2:], (m, nn)),
                    }
        self._expect_msg(W.KIND_CONTROL, "prep-done")
        with sh.lock:
            sh.bundles.update(new_bundles)
            sh.order.extend(ids)
        return ids

    # ------------------------------------------------------------------
    # online
    # ------------------------------------------------------------------
    def run(self, x: np.ndarray, bundle_id: Optional[int] = None
            ) -> np.ndarray:
        """Online phase for one request; consumes one pooled bundle."""
        sh = self.shared
        if sh.plan is None:
            self.handshake()
        plan = sh.plan
        x = np.asarray(x, np.float64)
        if x.shape != (plan.seq_len, plan.d):
            raise ValueError(f"input shape {x.shape} != bucket shape "
                             f"{(plan.seq_len, plan.d)}")
        with self._lock:
            if bundle_id is None:
                bundle_id = sh.take_bundle_id()
                if bundle_id is None:
                    raise NetProtocolError(
                        "no preprocessed bundle in the pool — call "
                        "preprocess() first")
            with sh.lock:
                parts = sh.bundles.pop(bundle_id, None)
            if parts is None:
                raise NetProtocolError(
                    f"bundle {bundle_id} unknown or already consumed")
            with obs.span("online", role="garbler", bundle_id=bundle_id), \
                    self._in_phase("online"):
                return self._run_locked(x, bundle_id, parts)

    def _run_locked(self, x, bundle_id: int, parts) -> np.ndarray:
        sh = self.shared
        p = sh.protocol
        plan = sh.plan
        t, f = p.t, p.frac
        self._send_control("run", {"id": bundle_id})

        enc = SS.encode_fx(x, f, t)
        # SS.share is the approved split: xs = enc − fresh one-time mask
        # (draws the mask from run_rng exactly as the inline split did)
        xc, xs = SS.share(sh.run_rng, enc, t)
        self._send_segs([W.Seg("input-share", W.DIR_C2S, W.pack_u64(xs))],
                        W.PHASE_ONLINE)
        regs: Dict[str, np.ndarray] = {"x": xc}
        for op in plan.ops:
            part = parts[op.name]
            rd = [_read_reg(regs, ref) for ref in op.reads]
            with obs.span("op:" + op.kind, op=op.name):
                if op.kind == "linear":
                    xo = SS.sub_mod(rd[0], part["r1"], t)
                    self._send_segs([W.Seg("x-minus-r", W.DIR_C2S,
                                           W.pack_u64(xo))], W.PHASE_ONLINE)
                    out = part["client_y"]
                elif op.kind == "beaver_matmul":
                    Ec = SS.sub_mod(rd[0], part["a1"], t)
                    Fc = SS.sub_mod(rd[1], part["b1"], t)
                    self._send_segs([W.Seg("beaver-open", W.DIR_C2S,
                                           W.pack_u64(Ec) + W.pack_u64(Fc))],
                                    W.PHASE_ONLINE)
                    data = self._expect_seg("beaver-open")
                    Es = W.unpack_u64(data[: Ec.size * 8], Ec.shape)
                    Fs = W.unpack_u64(data[Ec.size * 8:], Fc.shape)
                    E = SS.add_mod(Ec, Es, t)
                    F = SS.add_mod(Fc, Fs, t)
                    out = SS.add_mod(
                        SS.add_mod(part["c1"],
                                   SS.matmul_mod(E, part["b1"], t), t),
                        SS.add_mod(SS.matmul_mod(part["a1"], F, t),
                                   SS.matmul_mod(E, F, t), t), t)
                elif op.kind == "trunc":
                    flat = rd[0].reshape(-1, 1)
                    out = self._client_gc(part, flat).reshape(rd[0].shape)
                elif op.kind == "gc_apply":
                    if op.attrs["circuit"] == "softmax":
                        out = self._client_gc(part, rd[0])
                    else:
                        flat = rd[0].reshape(-1, 1)
                        out = self._client_gc(part, flat).reshape(rd[0].shape)
                elif op.kind == "layernorm":
                    hc = rd[0]
                    for extra in rd[1:]:
                        hc = SS.add_mod(hc, extra, t)
                    out = self._client_layernorm(op, part, hc)
                else:
                    raise NetProtocolError(f"unknown op kind {op.kind!r}")
                _write_reg(regs, plan.reg_shapes, op.write, out)

        xs_out = np.asarray(
            self._expect_msg(W.KIND_SIM, "reveal")["s"], np.uint64)
        self._expect_msg(W.KIND_CONTROL, "run-done")
        v = SS.reconstruct(regs[plan.output_reg], xs_out, t)
        return SS.decode_fx(v, f, t)

    # ------------------------------------------------------------------
    def _client_gc(self, part: dict, xc: np.ndarray) -> np.ndarray:
        """Garbler leg of one GC op: send active labels for this party's
        share, answer the sim-OT request, output share = the masks."""
        sh = self.shared
        p = sh.protocol
        t, k = p.t, p.k
        gcirc: G.GarbledCircuit = part["gc"]
        net = gcirc.net
        n_out, xc_bits, n_e = _gc_geom(net, k)
        I = xc.shape[0]
        g_lab = G.encode_inputs(gcirc, net.garbler_inputs[:xc_bits],
                                bits_of(xc, k, t))
        self._send_segs([W.Seg("g-labels", W.DIR_C2S,
                               W.pack_labels(_d2h(g_lab)))],
                        W.PHASE_ONLINE)
        if self.wire_version >= 2:
            # IKNP sender leg: answer the one-time base OT if this is
            # the session's first online GC op, then mask both labels of
            # every evaluator wire under the extension-matrix hash
            if sh.iknp is None:
                a_data = self._expect_seg("ot-base")
                with sh.lock:
                    snd = OT.IknpSender(sh.rng)
                    b_data = snd.base_msg_b(a_data)
                    sh.iknp = snd
                self._send_segs([W.Seg("ot-base", W.DIR_C2S, b_data)],
                                W.PHASE_ONLINE)
            u_data = self._expect_seg(f"ot:{net.name}")
            e_zero = G.input_zeros(gcirc, net.evaluator_inputs)
            y = sh.iknp.respond(u_data, I * n_e, _d2h(e_zero),
                                _d2h(gcirc.r)[:, None, :])
            self._send_segs([W.Seg(f"ot:{net.name}", W.DIR_S2C, y)],
                            W.PHASE_ONLINE)
        else:
            choice = W.unpack_ot_request(self._expect_seg(f"ot:{net.name}"),
                                         (I, n_e))
            e_zero = G.input_zeros(gcirc, net.evaluator_inputs)
            e_lab = OT.choose_labels(e_zero, gcirc.r[:, None, :], choice)
            self._send_segs([W.Seg(f"ot:{net.name}", W.DIR_S2C,
                                   W.pack_ot_response(_d2h(e_lab)))],
                            W.PHASE_ONLINE)
        return part["masks"]

    def _client_layernorm(self, op: OpSpec, part: dict, hc: np.ndarray
                          ) -> np.ndarray:
        sh = self.shared
        p = sh.protocol
        t, f = p.t, p.frac
        I, n = hc.shape
        if not p.pcfg.layernorm_offload:
            return self._client_gc(part, hc)
        inv_n = int(round((1 << f) / n))
        mu = SS.scalar_mul_mod(inv_n, _row_sum(hc, t), t)
        cxc = SS.sub_mod(SS.scalar_mul_mod(1 << f, hc, t), mu[:, None], t)
        # sim sideband: the oracle prepays the centered-share ciphertext
        # offline ("he-enc-centered"); the actual coefficients ride here
        self._send_sim("ln-centered", cxc, W.PHASE_ONLINE)
        cross_c = W.ct_unpack_rows(self._expect_seg("he-cross"), I,
                                   p._ct_bytes)
        var_c = SS.add_mod(_row_sum_sq(cxc, t),
                           SS.scalar_mul_mod(2, cross_c, t), t)
        var_c = SS.scalar_mul_mod(inv_n, var_c, t)
        gxc = _rowwise_mul(sh.ln_gq[op.name], cxc, t)
        in_c = np.concatenate([gxc, var_c[:, None]], axis=1)
        return self._client_gc(part, in_c)


# ---------------------------------------------------------------------------
# pipelined server wrapper
# ---------------------------------------------------------------------------


class PitNetServer:
    """Host a model behind N evaluator endpoints over one bundle store.

    The pipelined deployment gives the offline phase its own endpoint
    pair so ``refill_async`` traffic streams concurrently with online
    ``run`` traffic (see ``serve.private_engine.NetPrivateServeEngine``).
    """

    def __init__(self, model, seq_len: int, *, device="cuda",
                 seed: int = 104729, wire_version: int = W.WIRE_V2,
                 compression: bool = True):
        self.shared = ServerShared(model, seq_len, device=device, seed=seed,
                                   wire_version=wire_version,
                                   compression=compression)
        self.endpoints: List[EvaluatorEndpoint] = []
        self.threads: List[threading.Thread] = []

    def serve_transport(self, transport: Transport, *,
                        timeout: Optional[float] = None,
                        deadlines: Optional[Deadlines] = None, name: str = ""
                        ) -> threading.Thread:
        ep = EvaluatorEndpoint(transport, shared=self.shared,
                               timeout=timeout, deadlines=deadlines)
        self.endpoints.append(ep)
        th = threading.Thread(target=ep.serve_forever, daemon=True,
                              name=name or f"pit-eval-{len(self.threads)}")
        th.start()
        self.threads.append(th)
        return th

    def serve_tcp(self, listener, *, accept_timeout: float = 1.0,
                  timeout: Optional[float] = None,
                  deadlines: Optional[Deadlines] = None, name: str = "",
                  max_conns: Optional[int] = None):
        """Serve every connection accepted on ``listener`` in the
        background (each becomes an evaluator endpoint over the shared
        store) until the returned :class:`~repro_torch.net.transport.AcceptLoop`
        is stopped, the listener closes, or ``max_conns`` is reached.

        One call now serves a whole pipelined endpoint pair — callers
        sequence with ``loop.wait_accepted(n)`` instead of joining a
        one-shot accept thread (the old single-accept-per-call shape).
        ``accept_timeout`` is the stop-flag poll interval.
        """
        def handler(transport):
            self.serve_transport(transport, timeout=timeout,
                                 deadlines=deadlines, name=name)

        return listener.accept_loop(
            handler, accept_timeout=accept_timeout, max_accepts=max_conns,
            name=(name or "pit-eval") + "-accept")

    def join(self, timeout: Optional[float] = None) -> None:
        for th in self.threads:
            th.join(timeout=timeout)

    def close(self) -> None:
        for ep in self.endpoints:
            ep.close()
