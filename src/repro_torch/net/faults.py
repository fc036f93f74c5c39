"""Deterministic fault injection for any :class:`Transport`.

:class:`FaultyTransport` wraps a transport and injects faults from a
**seeded schedule**: every ``send``/``recv`` call on the wrapper advances
one shared *op counter*, and a :class:`Fault` scheduled at op ``k`` fires
exactly when the k-th call happens. Because the endpoints walk the
protocol in lockstep on a single thread per transport, the op sequence —
and therefore the injected fault sequence — is a pure function of the
schedule, identical on :class:`InProcPipe` and :class:`TcpTransport`.
That makes every chaos run replayable: same seed, same faults, same
outcome.

Fault kinds (the realistic failure modes of a long-lived 2PC socket):

* ``reset`` — the connection dies at op k: the inner transport is closed
  and the call raises :class:`TransportClosed`. Models a peer crash or
  an RST from a middlebox.
* ``stall`` — the peer stops sending for ``delay_s``: a recv sleeps
  and then either delivers late (``delay_s < timeout``) or raises
  :class:`TransportTimeout` (``delay_s >= timeout``); a send is just
  delayed. Models GC pauses, congestion, a wedged remote thread.
* ``torn`` — a frame is truncated mid-write and the connection dies:
  the receiver gets half a frame (a framing-level torn length-prefix),
  the sender sees :class:`TransportClosed`. The wrapper sits above the
  byte framing, so a torn frame is delivered as a *valid transport
  frame with a truncated payload* — the same decode failure on both
  transports, deterministically.
* ``dup`` — a frame is delivered (or sent) twice. Models retransmit
  bugs and at-least-once relays; the lockstep protocol must reject the
  duplicate with a typed error rather than desync.

``FaultPlan`` extends the idea across reconnects: a resilient client
that reconnects gets a fresh transport per attempt, and the plan hands
each new connection its own seeded schedule (empty after
``faulty_conns`` connections, so chaos runs terminate).

A copy of the JAX package's ``net/faults.py`` (standard library only)
with its imports rewritten: schedules draw from ``random.Random(seed)``
as the reference's do, so one seed gives the same faults in both
packages. Over the port's :class:`TcpTransport`, whose ``send`` only
queues a frame for its writer thread, a ``reset`` or ``torn`` still cuts
the stream where a blocking send would have: ``close`` lets the writer
finish the frames queued before the fault (the torn half included) and
then shuts the socket, so the peer reads the same frames as on
:class:`InProcPipe`.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.net.transport import (
    Transport,
    TransportClosed,
    TransportTimeout,
)

KINDS = ("reset", "stall", "torn", "dup")

# frames larger than this are slab payloads, not CONTROL traffic — the
# frame log keeps only small frames so hygiene checks stay cheap
_LOG_FRAME_CAP = 4096


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: fires at shared op index ``op``."""

    op: int
    kind: str  # one of KINDS
    delay_s: float = 0.0  # stall duration (ignored for other kinds)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclass(frozen=True)
class FaultSchedule:
    """An immutable set of faults keyed by op index."""

    faults: Tuple[Fault, ...] = ()

    @classmethod
    def from_seed(cls, seed: int, *, n_faults: int = 1, first_op: int = 2,
                  horizon: int = 64, kinds: Tuple[str, ...] = KINDS,
                  stall_s: float = 0.25) -> "FaultSchedule":
        """Derive a schedule from a seed — same seed, same schedule.

        Ops below ``first_op`` are spared so the very first hello frames
        can flow (schedules that kill op 0 only ever test "connect
        failed", which the backoff tests cover directly).
        """
        rng = random.Random(seed)
        n = min(n_faults, max(0, horizon - first_op))
        ops = sorted(rng.sample(range(first_op, horizon), n))
        faults = tuple(
            Fault(op, kind, stall_s if kind == "stall" else 0.0)
            for op, kind in ((op, rng.choice(kinds)) for op in ops))
        return cls(faults)

    def by_op(self) -> Dict[int, Fault]:
        return {f.op: f for f in self.faults}

    def __len__(self) -> int:
        return len(self.faults)


class FaultyTransport(Transport):
    """Wrap ``inner`` and inject faults from a deterministic schedule.

    Counters (`bytes_*`, `frames_*`) mirror the inner transport so
    ledger reconciliation still works; ``injected`` records every fault
    that actually fired as ``(op, kind)`` for replay assertions, and
    ``frame_log`` keeps small frames (CONTROL-sized) as
    ``(direction, bytes)`` so tests can audit what crossed the wire on
    error paths.
    """

    def __init__(self, inner: Transport, schedule: FaultSchedule = FaultSchedule(),
                 *, record_frames: bool = False):
        super().__init__()
        self.inner = inner
        self.schedule = schedule
        self.injected: List[Tuple[int, str]] = []
        self.frame_log: List[Tuple[str, bytes]] = []
        self._record = record_frames
        self._by_op = schedule.by_op()
        self._op = 0
        self._dead = False
        self._pending: "deque[bytes]" = deque()  # duplicated frames
        self._lock = threading.Lock()

    # -- counters mirror the inner transport ---------------------------
    @property
    def bytes_sent(self):  # type: ignore[override]
        return self.inner.bytes_sent

    @bytes_sent.setter
    def bytes_sent(self, v):
        pass

    @property
    def bytes_recv(self):  # type: ignore[override]
        return self.inner.bytes_recv

    @bytes_recv.setter
    def bytes_recv(self, v):
        pass

    @property
    def frames_sent(self):  # type: ignore[override]
        return self.inner.frames_sent

    @frames_sent.setter
    def frames_sent(self, v):
        pass

    @property
    def frames_recv(self):  # type: ignore[override]
        return self.inner.frames_recv

    @frames_recv.setter
    def frames_recv(self, v):
        pass

    @property
    def op(self) -> int:
        """The next op index the shared send/recv counter will assign."""
        with self._lock:
            return self._op

    def arm(self, fault: Fault) -> None:
        """Add a fault at an absolute op index on a live transport —
        tests use ``ft.arm(Fault(ft.op + k, ...))`` to land a kill a
        known number of ops into the *next* exchange."""
        with self._lock:
            self._by_op[fault.op] = fault

    # -- fault machinery ----------------------------------------------
    def _next_fault(self) -> Tuple[int, Optional[Fault]]:
        with self._lock:
            op = self._op
            self._op += 1
        return op, self._by_op.get(op)

    def _kill(self, op: int, why: str) -> None:
        self._dead = True
        try:
            self.inner.close()
        except OSError:
            pass
        raise TransportClosed(f"injected {why} at op {op}")

    def _log_frame(self, direction: str, frame: bytes) -> None:
        if self._record and len(frame) <= _LOG_FRAME_CAP:
            self.frame_log.append((direction, frame))

    # -- Transport interface -------------------------------------------
    def send(self, frame: bytes) -> None:
        op, fault = self._next_fault()
        if self._dead:
            raise TransportClosed("injected fault: transport already dead")
        if fault is not None:
            self.injected.append((op, fault.kind))
            if fault.kind == "reset":
                self._kill(op, "reset")
            if fault.kind == "stall":
                time.sleep(fault.delay_s)
            elif fault.kind == "torn":
                torn = frame[:max(1, len(frame) // 2)]
                self._log_frame("send", torn)
                self.inner.send(torn)
                self._kill(op, "torn frame")
            elif fault.kind == "dup":
                self._log_frame("send", frame)
                self.inner.send(frame)  # once here, once below
        self._log_frame("send", frame)
        self.inner.send(frame)

    def recv(self, timeout: Optional[float] = None) -> bytes:
        op, fault = self._next_fault()
        if self._dead:
            raise TransportClosed("injected fault: transport already dead")
        if fault is not None:
            self.injected.append((op, fault.kind))
            if fault.kind == "reset":
                self._kill(op, "reset")
            if fault.kind == "stall":
                if timeout is not None and fault.delay_s >= timeout:
                    # the peer is still stalled when the deadline fires
                    time.sleep(timeout)
                    raise TransportTimeout(
                        f"injected stall at op {op} outlived "
                        f"timeout={timeout}s")
                time.sleep(fault.delay_s)
            elif fault.kind == "torn":
                frame = self.inner.recv(timeout=timeout)
                torn = frame[:max(1, len(frame) // 2)]
                self._log_frame("recv", torn)
                self._dead = True
                try:
                    self.inner.close()
                except OSError:
                    pass
                return torn
            elif fault.kind == "dup":
                frame = self.inner.recv(timeout=timeout)
                self._pending.append(frame)
                self._log_frame("recv", frame)
                return frame
        if self._pending:
            frame = self._pending.popleft()  # the duplicate delivery
        else:
            frame = self.inner.recv(timeout=timeout)
        self._log_frame("recv", frame)
        return frame

    def close(self) -> None:
        self.inner.close()


@dataclass
class FaultPlan:
    """Seeded fault schedules for a whole client, across reconnects.

    Connection ``i`` (in wrap order) gets
    ``FaultSchedule.from_seed(seed * 1009 + i, ...)`` while
    ``i < faulty_conns`` and an empty schedule afterwards, so a
    reconnecting client eventually runs on clean transports and the
    chaos run terminates. All wrapped transports are kept on
    ``transports`` for post-run assertions (injected-fault logs, frame
    hygiene).
    """

    seed: int
    faulty_conns: int = 2
    n_faults: int = 1
    first_op: int = 2
    horizon: int = 64
    kinds: Tuple[str, ...] = KINDS
    stall_s: float = 0.25
    record_frames: bool = False
    transports: List[FaultyTransport] = field(default_factory=list)

    def __post_init__(self):
        self._lock = threading.Lock()
        self._conns = 0

    def schedule_for(self, conn_index: int) -> FaultSchedule:
        if conn_index >= self.faulty_conns:
            return FaultSchedule(())
        return FaultSchedule.from_seed(
            self.seed * 1009 + conn_index, n_faults=self.n_faults,
            first_op=self.first_op, horizon=self.horizon, kinds=self.kinds,
            stall_s=self.stall_s)

    def wrap(self, inner: Transport) -> FaultyTransport:
        with self._lock:
            i = self._conns
            self._conns += 1
        ft = FaultyTransport(inner, self.schedule_for(i),
                             record_frames=self.record_frames)
        self.transports.append(ft)
        return ft

    def injected(self) -> List[Tuple[int, int, str]]:
        """Every fault that fired, as (conn_index, op, kind)."""
        out = []
        for i, ft in enumerate(self.transports):
            out.extend((i, op, kind) for op, kind in ft.injected)
        return out
