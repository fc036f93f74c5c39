"""Pluggable byte transports for the two-party runtime.

A :class:`Transport` moves whole frames (opaque byte strings) between two
endpoints, full-duplex. Two implementations:

* :class:`InProcPipe` — queue-backed, for same-process endpoints on two
  threads. Zero syscalls; the default for tests and for measuring pure
  protocol overhead.
* :class:`TcpTransport` — length-prefixed framing over a socket
  (loopback or real NICs), with :class:`TcpListener` for the serving
  side. ``TCP_NODELAY`` is set: the runtime already batches per-op
  messages, so Nagle only adds latency.

Both support *LAN-model shaping* (``bandwidth_bps`` / ``latency_s``):
each sent frame pays ``latency + bytes·8/bandwidth`` of sleep on the
sender, replaying the paper's 9.6 Gb/s / 0.165 ms setting so measured
wall-clock can be compared against the metered ``Channel.time_s``
prediction.

Every endpoint counts ``bytes_sent`` / ``bytes_recv`` (payload) and
``frames_sent`` / ``frames_recv``; the framing overhead (u64 length
prefixes) is ``8 * frames`` and reported by the benchmarks separately
from protocol payload.

A copy of the JAX package's ``net/transport.py`` (standard library only),
so the port's endpoints and the reference's share framing and timeouts,
with one change: :class:`TcpTransport` sends from a writer thread. Both
endpoints of the runtime send before they receive at some lockstep points
(a GC leg's labels one way and its OT request the other; every v2 flush
before a receive). The reference's ``send`` blocks in ``sendall`` until
the peer reads, so two frames larger than the sockets' buffers, sent at
once from both ends, block each other for good: at BERT-base width a GC
leg's frames are megabytes. Here ``send`` queues the frame and returns;
frames still leave in order, byte for byte as before. The socket then
stays blocking with no timeout, since the writer's ``sendall`` shares it:
``recv`` waits for its deadline in ``poll`` instead of ``settimeout``.
"""

from __future__ import annotations

import dataclasses
import queue
import select
import socket
import struct
import threading
import time
from typing import Callable, Optional, Tuple


class TransportClosed(ConnectionError):
    """The peer closed the connection (or the stream is unrecoverable)."""


class TransportTimeout(TransportClosed):
    """A recv/accept deadline expired with the connection still open.

    Subclasses :class:`TransportClosed` so every existing ``except
    TransportClosed`` teardown path still fires, but callers that care
    (the resilient client, the evaluator serve loop) can distinguish "the
    peer is slow" from "the peer is gone": a timeout at a frame boundary
    leaves the stream intact and the operation retryable, a close does
    not.
    """


@dataclasses.dataclass(frozen=True)
class Deadlines:
    """Per-phase recv deadlines for an endpoint (seconds, None = block).

    The two-party walk has phases with wildly different latency
    envelopes: a ``hello`` answers in one round trip, an ``offline`` prep
    streams garbled slabs for seconds, an ``online`` op is
    sub-second, and an ``idle`` serve loop may legitimately sit for a
    long time between client requests. One uniform timeout either kills
    idle sessions or lets a stalled prep hang for the idle budget —
    per-phase deadlines bound each wait by what that phase can honestly
    need. Unset phases fall back to ``default_s``.
    """

    hello_s: Optional[float] = None
    offline_s: Optional[float] = None
    online_s: Optional[float] = None
    idle_s: Optional[float] = None
    default_s: Optional[float] = None

    @classmethod
    def uniform(cls, timeout_s: Optional[float]) -> "Deadlines":
        return cls(default_s=timeout_s)

    def for_phase(self, phase: str) -> Optional[float]:
        t = getattr(self, f"{phase}_s", None)
        return self.default_s if t is None else t


class Transport:
    """Frame transport base: counts traffic and applies LAN shaping."""

    def __init__(self, *, bandwidth_bps: float = 0.0, latency_s: float = 0.0):
        self.bandwidth_bps = float(bandwidth_bps)
        self.latency_s = float(latency_s)
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.frames_sent = 0
        self.frames_recv = 0

    # -- shaping -------------------------------------------------------
    def _shape(self, nbytes: int) -> None:
        dt = self.latency_s
        if self.bandwidth_bps > 0:
            dt += nbytes * 8.0 / self.bandwidth_bps
        if dt > 0:
            time.sleep(dt)

    # -- interface -----------------------------------------------------
    def send(self, frame: bytes) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> bytes:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# in-process pipe
# ---------------------------------------------------------------------------


_CLOSE = object()


class InProcPipe(Transport):
    """One end of a threaded, queue-backed duplex pipe.

    ``recv_gate`` (optional :class:`threading.Event`) holds back frame
    *delivery* on this end until set — benchmarks/tests use it to pin a
    peer mid-exchange and prove that traffic on another transport keeps
    flowing (the pipelined refill-vs-serve overlap).
    """

    def __init__(self, send_q: "queue.Queue", recv_q: "queue.Queue",
                 **shaping):
        super().__init__(**shaping)
        self._send_q = send_q
        self._recv_q = recv_q
        self._closed = False
        self.recv_gate = None

    @classmethod
    def make_pair(cls, **shaping) -> Tuple["InProcPipe", "InProcPipe"]:
        """Two connected ends; shaping applies to both directions."""
        a2b: "queue.Queue" = queue.Queue()
        b2a: "queue.Queue" = queue.Queue()
        return cls(a2b, b2a, **shaping), cls(b2a, a2b, **shaping)

    def send(self, frame: bytes) -> None:
        if self._closed:
            raise TransportClosed("pipe closed")
        self._shape(len(frame))
        self.bytes_sent += len(frame)
        self.frames_sent += 1
        self._send_q.put(frame)

    def recv(self, timeout: Optional[float] = None) -> bytes:
        if self.recv_gate is not None:
            if not self.recv_gate.wait(timeout=timeout):
                raise TransportTimeout(
                    f"recv gate not released within {timeout}s")
        try:
            frame = self._recv_q.get(timeout=timeout)
        except queue.Empty:
            raise TransportTimeout(
                f"recv timed out after {timeout}s") from None
        if frame is _CLOSE:
            raise TransportClosed("peer closed the pipe")
        self.bytes_recv += len(frame)
        self.frames_recv += 1
        return frame

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._send_q.put(_CLOSE)


# ---------------------------------------------------------------------------
# TCP
# ---------------------------------------------------------------------------

# u64 length prefix: preprocess ships each netlist's garbled-table slab
# for a whole bundle batch as one frame, which crosses 4 GiB at
# production scale — a u32 prefix would fail only then, and only on TCP
_LEN = struct.Struct("<Q")


class TcpTransport(Transport):
    """Length-prefixed frames over a connected socket. ``send`` queues a
    frame for the writer thread (see the module note); a write failure
    surfaces as :class:`TransportClosed` on the next ``send``."""

    #: seconds ``close`` waits for queued frames (a final ``bye``) to leave
    CLOSE_FLUSH_S = 10.0

    def __init__(self, sock: socket.socket, **shaping):
        super().__init__(**shaping)
        self._sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._out: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._send_error: Optional[OSError] = None
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name="tcp-writer")
        self._writer.start()

    def _write_loop(self) -> None:
        while True:
            data = self._out.get()
            if data is None:
                return
            try:
                self._sock.sendall(data)
            except OSError as e:
                self._send_error = e
                return

    @classmethod
    def connect(cls, host: str, port: int, *, timeout: Optional[float] = 30.0,
                **shaping) -> "TcpTransport":
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(None)
        return cls(sock, **shaping)

    def send(self, frame: bytes) -> None:
        if self._send_error is not None:
            raise TransportClosed(f"send failed: {self._send_error}")
        if not self._writer.is_alive():
            raise TransportClosed("send failed: transport closed")
        self._shape(len(frame))
        self._out.put(_LEN.pack(len(frame)))
        self._out.put(frame)
        self.bytes_sent += len(frame)
        self.frames_sent += 1

    def _wait_readable(self, timeout: Optional[float]) -> bool:
        """Whether the socket has bytes (or an EOF) to read within
        ``timeout`` seconds; None waits without end."""
        if timeout is None:
            return True
        try:
            fd = self._sock.fileno()
            if fd < 0:
                raise OSError("socket closed")
            poller = select.poll()
            poller.register(fd, select.POLLIN)
            return bool(poller.poll(max(0, int(timeout * 1000))))
        except OSError as e:
            # closed by another thread (server shutdown racing a blocked
            # endpoint): a close, not an error worth a thread's life
            raise TransportClosed(f"recv failed: {e}") from e

    def _recv_exact(self, n: int, timeout: Optional[float], *,
                    mid_frame: bool = False) -> bytes:
        chunks = []
        while n:
            if not self._wait_readable(timeout):
                if chunks or mid_frame:
                    # partial frame consumed: the byte stream has lost
                    # its framing — no retry can resynchronize it
                    raise TransportClosed(
                        "recv timed out mid-frame: framing lost")
                raise TransportTimeout("recv timed out")
            try:
                chunk = self._sock.recv(min(n, 1 << 20))
            except OSError as e:
                raise TransportClosed(f"recv failed: {e}") from e
            if not chunk:
                raise TransportClosed("peer closed the socket")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def recv(self, timeout: Optional[float] = None) -> bytes:
        # ``timeout`` bounds each wait for bytes, as a socket timeout would
        (n,) = _LEN.unpack(self._recv_exact(_LEN.size, timeout))
        frame = self._recv_exact(n, timeout, mid_frame=True)
        self.bytes_recv += len(frame)
        self.frames_recv += 1
        return frame

    def close(self) -> None:
        self._out.put(None)
        if self._writer is not threading.current_thread():
            self._writer.join(timeout=self.CLOSE_FLUSH_S)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class AcceptLoop:
    """Handle on a background accept loop (see ``TcpListener.accept_loop``).

    ``accepted`` counts handed-off connections; ``wait_accepted(n)``
    blocks until at least ``n`` arrived (how callers sequence "connect,
    then talk" without racing the acceptor); ``stop()`` asks the loop to
    exit at its next poll and ``join()`` waits for the thread. Closing
    the listener also stops the loop (the blocked ``accept`` fails).
    """

    def __init__(self, thread: threading.Thread, stop_event: threading.Event):
        self._thread = thread
        self._stop = stop_event
        self._cv = threading.Condition()
        self.accepted = 0
        self.error: Optional[BaseException] = None  # handler failure, if any

    def _note_accept(self) -> None:
        with self._cv:
            self.accepted += 1
            self._cv.notify_all()

    def wait_accepted(self, n: int, timeout: Optional[float] = None) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: self.accepted >= n,
                                     timeout=timeout)

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout=timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()


class TcpListener:
    """Serving-side acceptor: ``TcpListener() -> accept() -> TcpTransport``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 backlog: int = 4):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(backlog)
        # serialize accepts: settimeout is socket-wide state, and callers
        # (PitNetServer.serve_tcp) accept from several threads at once
        self._accept_lock = threading.Lock()

    @property
    def address(self) -> Tuple[str, int]:
        return self._sock.getsockname()[:2]

    @property
    def port(self) -> int:
        return self.address[1]

    def accept(self, timeout: Optional[float] = None, **shaping
               ) -> TcpTransport:
        with self._accept_lock:
            self._sock.settimeout(timeout)
            try:
                sock, _ = self._sock.accept()
            except socket.timeout:
                raise TransportTimeout(
                    f"accept timed out after {timeout}s") from None
            finally:
                self._sock.settimeout(None)
        sock.settimeout(None)
        return TcpTransport(sock, **shaping)

    def accept_loop(self, handler: Callable[[TcpTransport], None], *,
                    accept_timeout: float = 1.0,
                    max_accepts: Optional[int] = None,
                    name: str = "accept-loop", **shaping) -> AcceptLoop:
        """Accept connections in the background until stopped.

        Every accepted transport is handed to ``handler`` from the loop
        thread (handlers that serve should spawn and return, like
        ``PitNetServer.serve_transport``). ``accept_timeout`` is the
        poll interval at which the loop re-checks its stop flag, so
        ``stop()`` takes effect within one interval; closing the
        listener stops it immediately. ``max_accepts`` bounds the number
        of connections (None = until stopped). A handler exception stops
        the loop and is kept on ``AcceptLoop.error`` — an acceptor that
        silently drops connections would look exactly like a network
        problem to clients.
        """
        stop = threading.Event()

        def work() -> None:
            while not stop.is_set():
                if max_accepts is not None and loop.accepted >= max_accepts:
                    return
                try:
                    transport = self.accept(timeout=accept_timeout, **shaping)
                except TransportClosed:
                    continue  # poll timeout: re-check the stop flag
                except OSError:
                    return  # listener closed under us: clean shutdown
                try:
                    handler(transport)
                except Exception as e:
                    loop.error = e
                    transport.close()
                    return
                loop._note_accept()

        th = threading.Thread(target=work, daemon=True, name=name)
        loop = AcceptLoop(th, stop)
        th.start()
        return loop

    def close(self) -> None:
        self._sock.close()
