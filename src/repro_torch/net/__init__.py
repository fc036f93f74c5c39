"""repro_torch.net — the two-party runtime for the PiT protocol.

The port of the JAX package's ``repro.net``: two endpoints talking over a
pluggable transport, each garbling or evaluating on its own device.

  ``net.wire``      versioned typed message codec (labels, garbled-table
                    streams, HE ciphertexts, Beaver shares, OT batches);
                    frames are byte-identical to the JAX package's
  ``net.transport`` Transport ABC + InProcPipe (threaded queues) +
                    TcpTransport (length-prefixed framing, loopback or
                    real sockets, optional LAN-model shaping) +
                    per-phase Deadlines and the
                    TransportTimeout/TransportClosed split
  ``net.party``     GarblerEndpoint / EvaluatorEndpoint: walk the compiled
                    ``core/plan.py`` op-graph and execute each op's
                    offline/online halves as actual message exchanges,
                    with per-tag byte ledgers equal to the metered
                    Channel of an in-process session
  ``net.faults``    FaultyTransport: seeded, deterministic fault
                    injection (reset/stall/torn/dup) over any transport
  ``net.resilience`` ResilientClient: reconnect with backoff + jitter,
                    session resume via the client token, burn-on-
                    interrupt bundle semantics
"""

from repro_torch.net.transport import (
    AcceptLoop,
    Deadlines,
    InProcPipe,
    TcpListener,
    TcpTransport,
    Transport,
    TransportClosed,
    TransportTimeout,
)
from repro_torch.net.wire import WIRE_VERSION, Msg, Seg, decode_frame, encode_msg
from repro_torch.net.party import (
    EvaluatorEndpoint,
    GarblerEndpoint,
    NetProtocolError,
    PitNetServer,
    SessionRebindError,
    SessionState,
    WireLedger,
)
from repro_torch.net.faults import (
    Fault,
    FaultPlan,
    FaultSchedule,
    FaultyTransport,
)
from repro_torch.net.resilience import (
    ResilientClient,
    RetryPolicy,
    SessionLost,
)

__all__ = [
    "Transport", "InProcPipe", "TcpTransport", "TcpListener", "AcceptLoop",
    "TransportClosed", "TransportTimeout", "Deadlines",
    "WIRE_VERSION", "Msg", "Seg", "encode_msg", "decode_frame",
    "GarblerEndpoint", "EvaluatorEndpoint", "PitNetServer",
    "SessionState", "WireLedger", "NetProtocolError", "SessionRebindError",
    "Fault", "FaultSchedule", "FaultyTransport", "FaultPlan",
    "ResilientClient", "RetryPolicy", "SessionLost",
]
