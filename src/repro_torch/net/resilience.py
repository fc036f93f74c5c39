"""Client-side resilience: reconnect, resume, backoff, burn-on-interrupt.

:class:`ResilientClient` wraps the pipelined two-endpoint client
(offline + online :class:`GarblerEndpoint` pair over one
:class:`ClientShared`) and makes its operations survive transport
faults:

* **Reconnect + resume.** On any transport/protocol failure the client
  tears down *both* legs, then redials with exponential backoff +
  seeded jitter. The fresh hellos carry the client's existing uuid
  token, so a lease-holding server (``PitGateway(lease_s=...)``) rebinds
  the transports to the same :class:`SessionState` — the server-side
  bundle store, ledger, and epoch survive the reconnect. Both legs are
  always cycled together so the IKNP OT reset (``reset_ot`` in the
  hello) happens at a quiet point on both sides; half-pair reconnects
  would race the reset against an in-flight run's extension counters.
* **Typed give-up.** A reconnect that lands in a *different* session
  (the server reclaimed ours — lease expired or no lease) raises
  :class:`SessionLost`; exhausted retries re-raise the last typed error.
  Nothing in this module ever hangs: every wait is bounded by the
  endpoint deadlines plus the backoff budget.
* **Burn on interrupt.** A ``run`` that fails after its bundle was
  committed to the wire never reuses that bundle: partial label
  disclosure makes a second execution unsafe (two active labels per
  wire reconstructs the mask). The retry draws a *fresh* bundle —
  outputs stay bit-identical because reconstruction cancels whichever
  bundle's masks were used. Interrupted ``preprocess`` calls are
  idempotent by construction (neither side commits bundles before
  prep-done) and retry under fresh bundle ids.
* **Shed hints.** CONTROL ``shed`` frames (``BundlePoolEmpty``) are
  honored: the backoff sleeps at least the server's ``retry_after_s``.

Error text discipline matches the rest of the stack: retry/backoff/burn
paths log class names and counters, never exception payloads or label
bytes (``tests/fixtures/leaky_retry.py`` pins the lint rules for this).

The port of the JAX package's ``net/resilience.py``: the reference's
``impl=`` is ``device=`` here (``"cuda"`` unless the caller asks for
the CPU), the device every garbling of this client runs on.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.net import wire as W
from repro_torch.net.party import (
    ClientShared,
    GarblerEndpoint,
    NetProtocolError,
    SessionRebindError,
)
from repro_torch.net.transport import (
    Deadlines,
    Transport,
    TransportClosed,
    TransportTimeout,
)
from repro_torch.serve.errors import BundlePoolEmpty


class SessionLost(TransportClosed):
    """The server no longer holds our session: a resume hello was bound
    to a fresh session id. Pooled client bundles are unusable (their
    server halves are gone) — callers must start a new client."""


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with seeded jitter.

    ``attempts`` bounds each *operation* (one preprocess/run call), not
    the client's lifetime. Jitter is drawn from a ``random.Random(seed)``
    owned by the client, so a chaos run with a fixed seed replays the
    same backoff sequence.
    """

    attempts: int = 5
    base_s: float = 0.05
    factor: float = 2.0
    max_s: float = 2.0
    jitter: float = 0.25  # +/- fraction of the delay
    seed: int = 0

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        d = min(self.max_s, self.base_s * (self.factor ** attempt))
        if self.jitter > 0:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)


class ResilientClient:
    """A fault-tolerant pipelined client over one ``ClientShared``.

    ``connect`` is called once per fresh transport (twice per
    connection generation: offline leg first, then online) — wrap it
    with :class:`~repro_torch.net.faults.FaultPlan` to chaos-test, or point it
    at ``TcpTransport.connect`` for production use.
    """

    def __init__(self, connect: Callable[[], Transport], *, seed: int = 0,
                 device="cuda", policy: Optional[RetryPolicy] = None,
                 timeout: Optional[float] = None,
                 deadlines: Optional[Deadlines] = None,
                 wire_version: int = W.WIRE_V2, compression: bool = True):
        self._connect = connect
        self.policy = policy or RetryPolicy()
        self.timeout = timeout
        self.deadlines = deadlines
        self.shared = ClientShared(seed=seed, device=device,
                                   wire_version=wire_version,
                                   compression=compression)
        self.offline: Optional[GarblerEndpoint] = None
        self.online: Optional[GarblerEndpoint] = None
        self._rng = random.Random(self.policy.seed)
        self._lock = threading.RLock()  # one op at a time; resilience
        # wrapper serializes — pipelined throughput stays the concern of
        # NetPrivateServeEngine, this class's concern is surviving
        # faults without desyncing the pair
        # counters (read via stats())
        self.reconnects = 0
        self.resume_handshakes = 0
        self.bundles_burned = 0
        self.preps_retried = 0
        self.sheds_honored = 0
        self.backoffs = 0

    # -- connection management -----------------------------------------
    def _make_endpoint(self, *, reset_ot: bool) -> GarblerEndpoint:
        return GarblerEndpoint(self._connect(), shared=self.shared,
                               timeout=self.timeout,
                               deadlines=self.deadlines, reset_ot=reset_ot,
                               gen=self.reconnects)

    def _ensure_connected(self) -> None:
        if self.online is not None:
            return
        resuming = self.shared.plan is not None
        off = on = None
        try:
            # a resume must redo the base OT on both sides — the old
            # pair may have died mid-extension with desynced counters
            if resuming:
                with self.shared.lock:
                    self.shared.iknp = None
            off = self._make_endpoint(reset_ot=resuming)
            on = self._make_endpoint(reset_ot=resuming)
            try:
                off.handshake()
                on.handshake()
            except SessionRebindError as e:
                raise SessionLost(
                    "server reclaimed the session; pooled bundles are "
                    "void — start a new client") from e
        except BaseException:
            for ep in (off, on):
                if ep is not None:
                    self._close_quietly(ep)
            raise
        self.offline, self.online = off, on
        if resuming:
            self.resume_handshakes += 1
            obs.instant("resilience.resume", session=self.shared.session_id
                        if self.shared.session_id is not None else -1)

    @staticmethod
    def _close_quietly(ep: GarblerEndpoint) -> None:
        try:
            ep.transport.close()
        except OSError:
            pass

    def _teardown(self) -> None:
        """Drop both legs after a fault; the next op redials."""
        for ep in (self.offline, self.online):
            if ep is not None:
                self._close_quietly(ep)
        self.offline = self.online = None
        self.reconnects += 1

    def _backoff(self, attempt: int, hint_s: Optional[float] = None) -> None:
        d = self.policy.delay_s(attempt, self._rng)
        if hint_s is not None:
            d = max(d, float(hint_s))
            self.sheds_honored += 1
        self.backoffs += 1
        with obs.span("resilience.backoff", attempt=attempt,
                      delay_s=round(d, 4)):
            time.sleep(d)

    def _give_up(self, last: Optional[BaseException]) -> "BaseException":
        if isinstance(last, (TransportClosed, BundlePoolEmpty)):
            return last  # already typed
        name = type(last).__name__ if last is not None else "unknown"
        return TransportClosed(
            f"gave up after {self.policy.attempts} attempts "
            f"(last: {name})")

    # -- operations -----------------------------------------------------
    def handshake(self):
        with self._lock:
            last: Optional[BaseException] = None
            for attempt in range(self.policy.attempts):
                try:
                    self._ensure_connected()
                    return self.shared.plan
                except SessionLost:
                    raise
                except BundlePoolEmpty as e:
                    last = e
                    self._teardown()
                    self._backoff(attempt, e.retry_after_s)
                except (TransportClosed, NetProtocolError, W.WireError) as e:
                    last = e
                    self._teardown()
                    self._backoff(attempt)
            raise self._give_up(last)

    def preprocess(self, n: int = 1) -> List[int]:
        """Resilient offline prep: retried under *fresh* bundle ids on
        any failure — neither side commits a bundle before prep-done, so
        an interrupted prep leaves no partial state to collide with."""
        with self._lock:
            last: Optional[BaseException] = None
            for attempt in range(self.policy.attempts):
                try:
                    self._ensure_connected()
                    return self.offline.preprocess(n)
                except SessionLost:
                    raise
                except BundlePoolEmpty as e:
                    # typed shed: the server is healthy but full — keep
                    # the connection, honor the hint, ask again
                    last = e
                    self._backoff(attempt, e.retry_after_s)
                except (TransportClosed, NetProtocolError, W.WireError) as e:
                    last = e
                    self.preps_retried += 1
                    obs.instant("resilience.prep_retry", attempt=attempt,
                                error=type(e).__name__)
                    self._teardown()
                    self._backoff(attempt)
            raise self._give_up(last)

    def run(self, x: np.ndarray) -> np.ndarray:
        """Resilient online run. An interrupted attempt burns its bundle
        (client side mirrors the server's burn) and the retry consumes a
        fresh one — the output is bit-identical either way, because
        reconstruction cancels whichever bundle's masks were drawn."""
        with self._lock:
            last: Optional[BaseException] = None
            for attempt in range(self.policy.attempts):
                try:
                    self._ensure_connected()
                    bid = self.shared.take_bundle_id()
                    if bid is None:
                        self.offline.preprocess(1)
                        bid = self.shared.take_bundle_id()
                    if bid is None:
                        raise NetProtocolError(
                            "preprocess returned no bundle")
                except SessionLost:
                    raise
                except BundlePoolEmpty as e:
                    last = e
                    self._backoff(attempt, e.retry_after_s)
                    continue
                except (TransportClosed, NetProtocolError, W.WireError) as e:
                    last = e  # connect/refill failure: nothing burned
                    self._teardown()
                    self._backoff(attempt)
                    continue
                try:
                    return self.online.run(x, bundle_id=bid)
                except (TransportClosed, NetProtocolError, W.WireError) as e:
                    # the bundle is gone from the client pool and burned
                    # server-side — the retry MUST NOT re-run it: its
                    # labels are partially disclosed
                    last = e
                    self.bundles_burned += 1
                    obs.instant("resilience.burn", attempt=attempt,
                                error=type(e).__name__)
                    self._teardown()
                    self._backoff(attempt)
            raise self._give_up(last)

    def pool_size(self) -> int:
        return self.shared.pool_size()

    def stats(self) -> Dict[str, int]:
        return {
            "reconnects": self.reconnects,
            "resume_handshakes": self.resume_handshakes,
            "bundles_burned": self.bundles_burned,
            "preps_retried": self.preps_retried,
            "sheds_honored": self.sheds_honored,
            "backoffs": self.backoffs,
            "pool_size": self.pool_size(),
        }

    def close(self) -> None:
        with self._lock:
            for ep in (self.offline, self.online):
                if ep is not None:
                    try:
                        ep.close()  # sends bye: a clean goodbye releases
                        # the session immediately instead of parking it
                    except (TransportClosed, OSError):
                        pass
            self.offline = self.online = None
