"""Multi-client front door for the two-party serving runtime.

:class:`PitGateway` hosts one model behind a single
:class:`~repro_torch.net.transport.TcpListener` accept loop and muxes N
concurrent client *sessions* over it. The session — not the transport —
is the unit of isolation: every admitted client token gets its own
:class:`~repro_torch.net.party.SessionState` (a private bundle-id namespace, a
per-session :class:`~repro_torch.net.party.WireLedger`, rate/byte accounting),
and both transports of a pipelined endpoint pair bind to the same
session because their hellos carry the same client token.

What is shared, deliberately, is the expensive part: all sessions run
over ONE :class:`~repro_torch.net.party.ServerShared` — one compiled plan,
one protocol instance whose netlist cache is the shared garbling cache
(observable via :class:`~repro_torch.core.session.GarblingCache`: exactly one
slab per distinct ``(netlist, instances, device)``, however many clients
are connected), one quantized-weight store, and one preprocessing refill
pool discipline.

Admission control (the serving-plane contract):

* **session cap** — at ``max_sessions`` live sessions, a new client's
  hello is answered with a typed CONTROL ``shed`` frame carrying a
  ``retry_after_s`` hint and the connection is closed. The client sees
  :class:`~repro_torch.serve.errors.BundlePoolEmpty` (``scope="session"``),
  never an exception string off the wire.
* **bounded bundle pools** — each session may hold at most ``pool_cap``
  outstanding bundles. A ``prep`` that would exceed it is shed the same
  way (``scope="prep"``) *before* the client garbles anything; the hint
  is computed from the gateway-wide refill queue depth times the
  observed per-bundle preprocessing time.
* **graceful teardown** — when a session's last transport drops (clean
  bye or a mid-exchange kill), its in-flight bundles are counted as
  returned and reclaimed, and the session slot frees for the next
  client. Other sessions never notice.

Resilience (the fault-tolerance contract):

* **lease/resume** — with ``lease_s > 0``, a session whose last
  transport drops *without* a clean bye is **parked** for the lease
  window instead of reclaimed: its bundle store, ledger, and sid
  survive, and a re-hello carrying the same client token rebinds fresh
  transports to it (``epoch`` increments, the hello's ``reset_ot``
  redoes the base OT). A clean bye still reclaims immediately. Expired
  leases are garbage-collected on the next admission or stats poll and
  their bundles counted as returned.
* **burn-on-interrupt** — a run that dies mid-op burns its bundle
  (``bundles_burned``): partial label disclosure makes re-running it
  unsafe. The metrics identity under every fault is
  ``prepped == consumed + outstanding + returned + burned``.

The port of the JAX package's ``serve/gateway.py``: the same admission,
lease and accounting logic over the port's endpoints, with the
reference's ``impl=`` become ``device=`` (``"cuda"`` unless the caller
asks for the CPU). The server evaluates on that device and each client
garbles on its own, so frames, ledgers and outputs are the reference's.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.net.party import (
    EvaluatorEndpoint,
    ServerShared,
    SessionState,
)
from repro_torch.net.transport import AcceptLoop, Deadlines, TcpListener, \
    Transport, TransportClosed


class _SessionShed(TransportClosed):
    """Internal: hello refused at the session cap. Subclasses
    TransportClosed so the serve loop unwinds as a clean disconnect —
    the shed frame is already on the wire."""


class _GatewayEndpoint(EvaluatorEndpoint):
    """One accepted transport. Starts on a provisional session (so
    pre-hello frame bytes are metered somewhere), then binds to the
    session the hello's client token resolves to."""

    def __init__(self, transport: Transport, gateway: "PitGateway", *,
                 timeout: Optional[float] = None,
                 deadlines: Optional["Deadlines"] = None):
        super().__init__(transport, shared=gateway.shared, timeout=timeout,
                         deadlines=deadlines,
                         session=SessionState(sid=-1, client="pre-hello"))
        self.gateway = gateway
        self._bound = False

    # -- session resolution -------------------------------------------
    def _on_hello(self, payload) -> dict:
        token = payload.get("client")
        gen = int(payload.get("gen", 0) or 0)
        sess, hint = self.gateway._admit_session(token, gen=gen)
        if sess is None:
            self._send_control("shed", {"retry_after_s": hint,
                                        "scope": "session"})
            raise _SessionShed("session cap reached, connection shed")
        # fold the provisional (pre-hello) metering into the real ledger,
        # then rebind this endpoint onto the session's state
        sess.ledger.absorb(self.ledger)
        self.session = sess
        self.ledger = sess.ledger
        self._bound = True
        return {"session": sess.sid, "epoch": sess.epoch}

    def _admit_prep(self, n: int) -> Optional[float]:
        return self.gateway._admit_prep(self.session, n)

    def _handle_prep(self, payload) -> None:
        sess = self.session
        before = sess.bundles_prepped
        n = int(payload["n"])
        self.gateway._prep_begin(n)
        # span-backed timing: the gateway's prep EWMA reads the span's
        # duration instead of a hand-rolled perf_counter delta
        sp = obs.timer("gateway.prep", sid=sess.sid, bundles=n)
        try:
            super()._handle_prep(payload)
        finally:
            prepped = sess.bundles_prepped > before
            self.gateway._prep_end(n, sp.close().elapsed_s,
                                   counted=prepped)

    def _on_disconnect(self) -> None:
        if self._bound:
            self.gateway._release_endpoint(
                self.session, reason=self.disconnect_reason or "closed")


class PitGateway:
    """Serve one model to many clients from one accept loop.

    ``max_sessions`` bounds concurrently-live client sessions;
    ``pool_cap`` bounds outstanding preprocessed bundles per session
    (admission happens before the client garbles, so a shed wastes no
    offline work on either side). ``retry_floor_s`` is the minimum
    retry-after hint when no preprocessing time has been observed yet.
    """

    def __init__(self, model, seq_len: int, *, device="cuda",
                 seed: int = 104729, max_sessions: int = 8,
                 pool_cap: int = 4, retry_floor_s: float = 0.05,
                 lease_s: float = 0.0,
                 shared: Optional[ServerShared] = None,
                 wire_version: Optional[int] = None,
                 compression: Optional[bool] = None):
        if shared is None:
            kw = {}
            if wire_version is not None:
                kw["wire_version"] = wire_version
            if compression is not None:
                kw["compression"] = compression
            shared = ServerShared(model, seq_len, device=device, seed=seed,
                                  **kw)
        self.shared = shared
        self.max_sessions = max_sessions
        self.pool_cap = pool_cap
        self.retry_floor_s = retry_floor_s
        #: resume window: a session whose last transport dropped without
        #: a clean bye keeps its state for this long, waiting for a
        #: re-hello with the same token. 0 = legacy behavior (reclaim
        #: immediately — a dropped client's bundles return at once).
        self.lease_s = lease_s
        self._lock = threading.Lock()
        self._sessions: Dict[str, SessionState] = {}  # token -> live
        self._closed: List[Dict[str, object]] = []  # summaries, torn down
        self._next_sid = 1
        self.sessions_admitted = 0
        self.sessions_shed = 0
        self.sessions_resumed = 0
        self.leases_expired = 0
        self.bundles_returned = 0
        # refill-queue instrumentation for retry-after hints
        self._prep_inflight = 0  # bundles in flight across all sessions
        self._prep_ewma_s: Optional[float] = None  # seconds per bundle
        self.endpoints: List[_GatewayEndpoint] = []
        self.threads: List[threading.Thread] = []
        self._loops: List[AcceptLoop] = []
        self._started_s = time.perf_counter()

    # ------------------------------------------------------------------
    # admission control
    # ------------------------------------------------------------------
    def _admit_session(self, token: Optional[str], *, gen: int = 0
                       ) -> Tuple[Optional[SessionState], Optional[float]]:
        """Resolve a hello's client token to a session, minting one if
        needed. Returns ``(session, None)`` on admit, ``(None, hint)``
        when the session cap sheds the connection."""
        with self._lock:
            self._gc_leases_locked()
            if token and token in self._sessions:
                # second endpoint of a pair, or a resume. A resume is a
                # re-hello on a parked session (zero live endpoints) OR
                # one carrying a new client transport generation — the
                # ``gen`` check is what makes resume accounting
                # deterministic when the fresh hellos race the dead
                # pair's teardown. Either way the session state
                # survives: new epoch, IKNP dropped (the dead pair's
                # extension counters are untrustworthy; the reset costs
                # one base OT).
                sess = self._sessions[token]
                if sess.endpoints == 0 or gen > sess.gen:
                    with sess.lock:
                        sess.epoch += 1
                        sess.resumes += 1
                        sess.gen = max(sess.gen, gen)
                        sess.lease_expires_s = None
                        sess.iknp = None
                    self.sessions_resumed += 1
                    obs.instant("gateway.session_resume", sid=sess.sid,
                                epoch=sess.epoch)
                sess.endpoints += 1
                return sess, None
            if len(self._sessions) >= self.max_sessions:
                self.sessions_shed += 1
                return None, self._retry_hint_locked(self.pool_cap)
            sid = self._next_sid
            self._next_sid += 1
            # a token-less hello (bare GarblerEndpoint predating the
            # gateway) still gets a session — keyed so it cannot collide
            token = token or f"anon-{sid}"
            sess = SessionState(sid=sid, client=token)
            sess.endpoints = 1
            self._sessions[token] = sess
            self.sessions_admitted += 1
            return sess, None

    def _admit_prep(self, sess: SessionState, n: int) -> Optional[float]:
        """Bounded per-session pool: admit ``n`` more bundles or return a
        retry-after hint."""
        with self._lock:
            if sess.outstanding() + n <= self.pool_cap:
                return None
            # _prep_begin already counted this request into the refill
            # queue depth, so the hint covers it without adding n again
            return self._retry_hint_locked(0)

    def _retry_hint_locked(self, n: int) -> float:
        """Retry-after = (refill queue depth + the refused request) times
        the observed per-bundle preprocessing time — an actual backlog
        estimate, not a constant."""
        per = self._prep_ewma_s or self.retry_floor_s
        return round(max(self.retry_floor_s,
                         (self._prep_inflight + n) * per), 3)

    # -- refill-queue instrumentation ----------------------------------
    def _prep_begin(self, n: int) -> None:
        with self._lock:
            self._prep_inflight += n

    def _prep_end(self, n: int, elapsed_s: float, *, counted: bool) -> None:
        with self._lock:
            self._prep_inflight -= n
            if counted and n > 0:
                per = elapsed_s / n
                self._prep_ewma_s = (per if self._prep_ewma_s is None
                                     else 0.7 * self._prep_ewma_s
                                     + 0.3 * per)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def serve_transport(self, transport: Transport, *,
                        timeout: Optional[float] = None,
                        deadlines: Optional[Deadlines] = None
                        ) -> threading.Thread:
        """Serve one accepted transport on its own thread (session
        resolution happens at its hello)."""
        ep = _GatewayEndpoint(transport, self, timeout=timeout,
                              deadlines=deadlines)
        self.endpoints.append(ep)
        th = threading.Thread(target=self._serve_one, args=(ep,),
                              daemon=True,
                              name=f"pit-gw-ep-{len(self.threads)}")
        th.start()
        self.threads.append(th)
        return th

    @staticmethod
    def _serve_one(ep: _GatewayEndpoint) -> None:
        try:
            ep.serve_forever()
        finally:
            # unlike the single-client server, the gateway owns the
            # accepted socket's lifetime: done (bye, kill or shed) means
            # closed, so shed clients fail fast instead of waiting out
            # their recv timeout
            try:
                ep.transport.close()
            except OSError:
                pass

    def serve_listener(self, listener: TcpListener, *,
                       accept_timeout: float = 1.0,
                       timeout: Optional[float] = None,
                       deadlines: Optional[Deadlines] = None, **shaping
                       ) -> AcceptLoop:
        """The front door: ONE accept loop on ``listener``; every
        accepted connection becomes a gateway endpoint."""
        loop = listener.accept_loop(
            lambda t: self.serve_transport(t, timeout=timeout,
                                           deadlines=deadlines),
            accept_timeout=accept_timeout, name="pit-gateway-accept",
            **shaping)
        self._loops.append(loop)
        return loop

    # ------------------------------------------------------------------
    # teardown & introspection
    # ------------------------------------------------------------------
    def _release_endpoint(self, sess: SessionState, *,
                          reason: str = "closed") -> None:
        """An endpoint bound to ``sess`` disconnected. When the last one
        drops: a clean ``bye`` (or a lease-less gateway) reclaims the
        session — outstanding bundles are returned (the client is gone;
        its ids can never be run) and the slot frees. With ``lease_s``
        set, an *unclean* drop (kill, timeout, error) parks the session
        instead: the state survives for the lease window so a
        reconnecting client can resume it."""
        with self._lock:
            sess.endpoints -= 1
            if sess.endpoints > 0:
                return
            if self.lease_s > 0 and reason != "bye":
                with sess.lock:
                    sess.lease_expires_s = time.monotonic() + self.lease_s
                obs.instant("gateway.session_park", sid=sess.sid,
                            reason=reason, lease_s=self.lease_s)
                return
            self._reclaim_locked(sess)

    def _reclaim_locked(self, sess: SessionState) -> None:
        """Tear a session down for good (caller holds the gateway lock):
        unconsumed bundles are returned, the summary is archived, and
        the token slot frees. Burned bundles stay burned — they were
        never reusable."""
        with sess.lock:
            returned = len(sess.bundles)
            sess.bundles.clear()
            sess.bundles_returned += returned
            sess.lease_expires_s = None
        self.bundles_returned += returned
        self._sessions.pop(sess.client, None)
        self._closed.append(sess.summary())

    def _gc_leases_locked(self) -> None:
        """Reclaim parked sessions whose lease expired (caller holds the
        gateway lock). Runs on every admission and stats poll, so an
        expired lease is observed without waiting for wire traffic."""
        if self.lease_s <= 0:
            return
        now = time.monotonic()
        expired = [s for s in self._sessions.values()
                   if s.endpoints == 0 and s.lease_expires_s is not None
                   and s.lease_expires_s <= now]
        for sess in expired:
            self.leases_expired += 1
            obs.instant("gateway.lease_expire", sid=sess.sid)
            self._reclaim_locked(sess)

    def stats(self) -> Dict[str, object]:
        """Gateway-wide accounting: admission counters, the shared
        garbling cache, and per-session summaries (live + torn down).

        The whole snapshot is taken under the gateway lock — admission
        counters (``sessions_admitted``/``sessions_shed``/
        ``bundles_returned``) are mutated by endpoint threads under the
        same lock, so a reader polling while sessions churn always sees
        a consistent set (hammer-tested on the JAX package's gateway).
        Per-session summaries snapshot under each session's own lock and
        ledger mutex inside it.
        """
        with self._lock:
            self._gc_leases_locked()
            active = sum(1 for s in self._sessions.values()
                         if s.endpoints > 0)
            parked = len(self._sessions) - active
            live = [s.summary() for s in self._sessions.values()]
            closed = list(self._closed)
            inflight = self._prep_inflight
            ewma = self._prep_ewma_s
            admitted = self.sessions_admitted
            sess_shed = self.sessions_shed
            resumed = self.sessions_resumed
            expired = self.leases_expired
            returned = self.bundles_returned
        sessions = closed + live
        dt = max(time.perf_counter() - self._started_s, 1e-9)
        consumed = sum(s["bundles_consumed"] for s in sessions)
        return {
            "sessions_active": active,
            "sessions_parked": parked,
            "sessions_admitted": admitted,
            "sessions_shed": sess_shed,
            "sessions_resumed": resumed,
            "leases_expired": expired,
            "prep_sheds": sum(s["sheds"] for s in sessions),
            "bundles_prepped": sum(s["bundles_prepped"] for s in sessions),
            "bundles_consumed": consumed,
            "bundles_returned": returned,
            "bundles_burned": sum(s["bundles_burned"] for s in sessions),
            "bundles_outstanding": sum(s["bundles_outstanding"]
                                       for s in sessions),
            "prep_inflight": inflight,
            "prep_ewma_s": None if ewma is None else round(ewma, 4),
            "elapsed_s": round(dt, 3),
            "bundles_per_s": round(consumed / dt, 3),
            "garbling_cache": self.shared.gc_cache.summary(),
            "sessions": sessions,
        }

    def metrics(self) -> Dict[str, object]:
        """Scrape-able counters snapshot in a stable schema.

        ``counters`` are monotonic over the gateway's lifetime (totals
        include torn-down sessions); ``gauges`` are instantaneous;
        ``spans`` are the current tracer's per-span-path aggregates
        (count/total/mean/max seconds — empty when tracing is off). The
        top-level key set is the scrape contract: keys are only ever
        added, never renamed or removed within ``pit.gateway.v1``.
        """
        st = self.stats()
        tr = obs.current()
        return {
            "schema": "pit.gateway.v1",
            "counters": {
                "sessions_admitted": st["sessions_admitted"],
                "sessions_shed": st["sessions_shed"],
                "sessions_resumed": st["sessions_resumed"],
                "leases_expired": st["leases_expired"],
                "prep_sheds": st["prep_sheds"],
                "bundles_prepped": st["bundles_prepped"],
                "bundles_consumed": st["bundles_consumed"],
                "bundles_returned": st["bundles_returned"],
                "bundles_burned": st["bundles_burned"],
                "garbling_cache_hits": st["garbling_cache"]["hits"],
                "garbling_cache_misses": st["garbling_cache"]["misses"],
            },
            "gauges": {
                "sessions_active": st["sessions_active"],
                "sessions_parked": st["sessions_parked"],
                "bundles_outstanding": st["bundles_outstanding"],
                "prep_inflight": st["prep_inflight"],
                "prep_ewma_s": st["prep_ewma_s"],
                "bundles_per_s": st["bundles_per_s"],
                "elapsed_s": st["elapsed_s"],
            },
            "spans": tr.report(),
        }

    def join(self, timeout: Optional[float] = None) -> None:
        for th in self.threads:
            th.join(timeout=timeout)

    def close(self) -> None:
        for loop in self._loops:
            loop.stop()
        for ep in self.endpoints:
            try:
                ep.transport.close()
            except OSError:
                pass


def gateway_client(host: str, port: int, *, pool_target: int = 2,
                   seed: int = 0, device="cuda",
                   timeout: Optional[float] = None, **shaping):
    """Connect a pipelined client (offline + online transport pair) to a
    gateway and return a ready :class:`NetPrivateServeEngine`. Both
    transports carry the same client token, so the gateway binds them to
    one session. Raises :class:`~repro_torch.serve.errors.BundlePoolEmpty`
    (``scope="session"``) if the gateway sheds the connection."""
    from repro_torch.net.transport import TcpTransport
    from repro_torch.serve.private_engine import NetPrivateServeEngine

    offline = TcpTransport.connect(host, port, **shaping)
    online = TcpTransport.connect(host, port, **shaping)
    return NetPrivateServeEngine(offline, online, pool_target=pool_target,
                                 seed=seed, device=device, timeout=timeout)
