"""Fault injection and the resilient client of the port
(``repro_torch.net.faults``, ``repro_torch.net.resilience``) against the
JAX package's: seeded schedules equal to the reference's for the same
seeds, each fault kind doing on the port's transports what it does on the
reference's (the port's TCP transport sends from a writer thread, and a
fault must still cut the stream where a blocking send would), fatal
faults with the same outcome on ``InProcPipe`` and TCP, resume with
burn-on-interrupt against a lease-holding ``PitGateway``, lease expiry, an
interrupted prep, and a short chaos sweep whose seeds were fixed before
it was first run. Also pinned: the port's repair of a reference fault —
after a resume, the dead pair's server endpoint must not touch the IKNP
receiver the resumed pair built (in the JAX package it can, and the
retried run's labels come out wrong). Runs on the CPU at d=8, S=4;
outputs are compared bit for bit."""

import time

import numpy as np
import pytest

import repro.net as JN
from repro.core.engine import random_weights
import repro_torch.net as TN
from repro_torch.config import PrivacyConfig as TConfig
from repro_torch.core.engine import PrivateTransformer as TModel
from repro_torch.core.engine import weights_from_reference
from repro_torch.net import (
    Deadlines,
    Fault,
    FaultPlan,
    FaultSchedule,
    FaultyTransport,
    GarblerEndpoint,
    InProcPipe,
    PitNetServer,
    ResilientClient,
    RetryPolicy,
    SessionLost,
    TcpListener,
    TcpTransport,
    TransportClosed,
)
from repro_torch.net import wire as W
from repro_torch.serve import BundlePoolEmpty, PitGateway

D, HEADS, DFF, S = 8, 2, 16, 4
#: the reference tests' widths and ring; a 16-bit share modulus keeps the
#: plain (CPU) walks of every session to seconds
PCFG = dict(he_poly_n=256, he_num_primes=2, he_t_bits=16, frac_bits=5)


@pytest.fixture(scope="module")
def world():
    ws = random_weights(np.random.default_rng(71), D, DFF, 1)
    tm = TModel(TConfig(**PCFG), D, HEADS, DFF, weights_from_reference(ws),
                seed=71, device="cpu")
    x = np.random.default_rng(72).normal(0, 1, (S, D))
    sess = tm.compile_session(S)
    return {"tm": tm, "x": x,
            "y": sess.run(x, sess.preprocess(1)[0])}


def _identity(st):
    assert st["bundles_prepped"] == (
        st["bundles_consumed"] + st["bundles_outstanding"]
        + st["bundles_returned"] + st["bundles_burned"]), st


def _wait(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# schedules: seeded, and the reference's for the same seed
# ---------------------------------------------------------------------------


def _faults(schedule):
    return [(f.op, f.kind, f.delay_s) for f in schedule.faults]


def test_schedules_equal_reference_for_the_same_seeds():
    for seed in range(40):
        for kw in ({}, dict(n_faults=3, horizon=48),
                   dict(n_faults=2, first_op=5, horizon=20, stall_s=0.5,
                        kinds=("reset", "dup"))):
            t = FaultSchedule.from_seed(seed, **kw)
            assert _faults(t) == _faults(JN.FaultSchedule.from_seed(seed,
                                                                    **kw))
            assert all(f.op >= kw.get("first_op", 2) for f in t.faults)
        tp = FaultPlan(seed=seed, faulty_conns=2, n_faults=2, horizon=40)
        jp = JN.FaultPlan(seed=seed, faulty_conns=2, n_faults=2, horizon=40)
        for i in range(4):
            assert _faults(tp.schedule_for(i)) == _faults(jp.schedule_for(i))
        assert len(tp.schedule_for(2)) == 0  # chaos runs terminate
    with pytest.raises(ValueError):
        Fault(0, "melt")


# ---------------------------------------------------------------------------
# each fault kind, frame by frame: port (pipe and TCP) == reference (pipe)
# ---------------------------------------------------------------------------

FRAMES = [b"alpha" * 3, b"bravo" * 2000, b"charlie", b"delta" * 9]


def _pair(pkg, kind):
    """(near end, far end, cleanup) of one connection."""
    if kind == "pipe":
        a, b = pkg.InProcPipe.make_pair()
        return a, b, lambda: (a.close(), b.close())
    lst = pkg.TcpListener()
    a = pkg.TcpTransport.connect("127.0.0.1", lst.port)
    b = lst.accept(timeout=10)

    def cleanup():
        for t in (a, b):
            t.close()
        lst.close()
    return a, b, cleanup


def _outcome(fn):
    """("ok", result) or the exception's class name (each package raises
    its own classes, so names are what compare)."""
    try:
        return ("ok", fn())
    except Exception as e:
        return (type(e).__name__,)


def _script(pkg, kind, fault, side):
    """Four frames through one FaultyTransport with ``fault`` armed, on
    its send side or its recv side; returns everything either end saw."""
    near, far, cleanup = _pair(pkg, kind)
    ft = pkg.FaultyTransport(near, pkg.FaultSchedule((fault,)),
                             record_frames=True)
    seen = []
    try:
        if side == "send":
            for f in FRAMES:
                seen.append(_outcome(lambda: ft.send(f)))
            # what the peer reads: frames, then a close (or silence)
            for _ in range(len(FRAMES) + 1):
                got = _outcome(lambda: far.recv(timeout=0.5))
                seen.append(got)
                if got[0] != "ok":
                    break
        else:
            for f in FRAMES:
                far.send(f)
            for _ in range(len(FRAMES) + 1):
                got = _outcome(lambda: ft.recv(timeout=0.5))
                seen.append(got)
                if got[0] != "ok":
                    break
        return seen, list(ft.injected), ft.op
    finally:
        cleanup()


@pytest.mark.parametrize("fault, side", [
    ((1, "reset", 0.0), "send"), ((1, "reset", 0.0), "recv"),
    ((1, "torn", 0.0), "send"), ((1, "torn", 0.0), "recv"),
    ((1, "dup", 0.0), "send"), ((1, "dup", 0.0), "recv"),
    ((2, "stall", 0.05), "send"), ((2, "stall", 0.05), "recv"),
    ((1, "stall", 5.0), "recv")],
    ids=["reset-send", "reset-recv", "torn-send", "torn-recv", "dup-send",
         "dup-recv", "stall-send", "stall-recv", "stall-past-deadline"])
def test_fault_kinds_behave_as_in_reference(fault, side):
    want = _script(JN, "pipe", JN.Fault(*fault), side)
    assert want[1] == [fault[:2]]
    for kind in ("pipe", "tcp"):
        t0 = time.monotonic()
        got = _script(TN, kind, Fault(*fault), side)
        assert got == want, kind
        # a stall past the deadline sleeps the deadline, not the stall
        assert time.monotonic() - t0 < 4.0


# ---------------------------------------------------------------------------
# fatal faults in a real session: the same outcome on InProcPipe and TCP
# ---------------------------------------------------------------------------


def _faulted_prep(world, kind, schedule):
    srv = PitNetServer(world["tm"], S, device="cpu")
    if kind == "pipe":
        a, b = InProcPipe.make_pair()
        srv.serve_transport(b, timeout=60)
        ft = FaultyTransport(a, schedule, record_frames=True)
        cleanup = a.close
    else:
        lst = TcpListener()
        loop = srv.serve_tcp(lst, timeout=60)
        ft = FaultyTransport(TcpTransport.connect("127.0.0.1", lst.port),
                             schedule, record_frames=True)
        assert loop.wait_accepted(1, timeout=30)

        def cleanup():
            ft.close()
            lst.close()
    cli = GarblerEndpoint(ft, seed=7, device="cpu", timeout=60)
    try:
        cli.preprocess(1)
        out = "ok"
    except Exception as e:
        out = type(e).__name__
    finally:
        cleanup()
    srv.join(timeout=30)
    assert not any(th.is_alive() for th in srv.threads)
    # what the server read before the stream was cut, and what it holds
    ep = srv.endpoints[0]
    # frame sizes only: the hello carries a random client token
    return (out, list(ft.injected), ft.op,
            [(d, len(f)) for d, f in ft.frame_log],
            (ep.transport.frames_recv, ep.transport.bytes_recv),
            len(srv.shared.session.bundles))


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("fault", [Fault(5, "reset"), Fault(7, "torn")],
                         ids=["reset", "torn"])
def test_fatal_fault_identical_on_inproc_and_tcp(world, fault):
    schedule = FaultSchedule((fault,))
    pipe = _faulted_prep(world, "pipe", schedule)
    tcp = _faulted_prep(world, "tcp", schedule)
    assert pipe == tcp
    assert pipe[0] == "TransportClosed" and pipe[1] == [(fault.op,
                                                         fault.kind)]
    assert pipe[5] == 0  # nothing committed on the server


# ---------------------------------------------------------------------------
# resilient client against a lease-holding gateway
# ---------------------------------------------------------------------------


def _connector(gw, dl, schedules, fts):
    conns = [0]

    def connect():
        c, s = InProcPipe.make_pair()
        gw.serve_transport(s, deadlines=dl)
        i = conns[0]
        conns[0] += 1
        ft = FaultyTransport(c, schedules.get(i, FaultSchedule()),
                             record_frames=True)
        fts.append(ft)
        return ft
    return connect


def test_resilient_reconnect_resumes_and_burns(world):
    """A reset at op 8 of the online leg, mid-run: the client burns the
    bundle, redials into the SAME session (lease held) and the retried
    run, on a fresh bundle, is bit-identical. The server counts the burn
    once its endpoint has seen the drop, and the bundle identity holds on
    both sides. The idle deadline outlasts ``preprocess`` so the online
    leg is alive when the run starts and the reset is what cuts it."""
    gw = PitGateway(world["tm"], S, device="cpu", max_sessions=4,
                    pool_cap=4, lease_s=30.0)
    dl = Deadlines(default_s=30.0, idle_s=300.0)
    fts = []
    cli = ResilientClient(
        _connector(gw, dl, {1: FaultSchedule((Fault(8, "reset"),))}, fts),
        seed=5, device="cpu", policy=RetryPolicy(attempts=6, base_s=0.02),
        deadlines=dl)
    cli.preprocess(2)
    y = cli.run(world["x"])
    assert np.array_equal(y, world["y"])
    assert fts[1].injected == [(8, "reset")]
    cst = cli.stats()
    assert (cst["reconnects"], cst["resume_handshakes"],
            cst["bundles_burned"], cst["pool_size"]) == (1, 1, 1, 0)
    _wait(lambda: gw.stats()["bundles_burned"] == 1, "the server's burn")
    st = gw.stats()
    assert st["sessions_resumed"] == 1 and st["sessions_admitted"] == 1
    assert [s["epoch"] for s in st["sessions"]] == [1]
    assert (st["bundles_prepped"], st["bundles_consumed"],
            st["bundles_outstanding"]) == (2, 1, 0)
    _identity(st)
    cli.close()  # clean bye: immediate reclaim despite the lease
    _wait(lambda: gw.stats()["sessions_active"] == 0, "teardown")
    st = gw.stats()
    assert st["sessions_parked"] == 0
    _identity(st)
    gw.close()


def test_retired_endpoint_leaves_the_resumed_receiver_alone(world):
    """After a resume (the session's epoch bumped past the endpoint's),
    an endpoint of the dead pair that reaches its next GC op raises
    instead of extending the session's IKNP receiver — the receiver the
    resumed pair shares with the client's fresh sender."""
    from repro_torch.core.session import gc_net_for
    from repro_torch.net.party import EvaluatorEndpoint, ServerShared, \
        SessionState

    class Receiver:
        extended = 0

        def extend(self, bits):
            Receiver.extended += 1
            raise AssertionError("a retired endpoint extended the receiver")

    shared = ServerShared(world["tm"], S, device="cpu")
    sess = SessionState(sid=1, client="c")
    a, b = InProcPipe.make_pair()
    ep = EvaluatorEndpoint(b, shared=shared, session=sess, timeout=5)
    ep.wire_version = 2
    op = next(o for o in shared.plan.ops if o.kind == "trunc")
    net = gc_net_for(shared.protocol, op)
    k = shared.protocol.k
    xs = np.zeros((3, len(net.evaluator_inputs) // k), np.uint64)
    with sess.lock:  # what a resume does: new epoch, the new pair's OT
        sess.epoch += 1
        sess.iknp = Receiver()
    with pytest.raises(TransportClosed, match="retired by a resume"):
        ep._server_gc({"net": net}, xs, None)
    assert Receiver.extended == 0
    a.close()


def test_interrupted_prep_retried_with_fresh_ids(world):
    """A reset mid-prep (op 6 of the offline leg): nothing is committed on
    either side, and the retry sends new bundle ids."""
    gw = PitGateway(world["tm"], S, device="cpu", max_sessions=4,
                    pool_cap=4, lease_s=30.0)
    dl = Deadlines(default_s=30.0, idle_s=300.0)
    fts = []
    cli = ResilientClient(
        _connector(gw, dl, {0: FaultSchedule((Fault(6, "reset"),))}, fts),
        seed=6, device="cpu", policy=RetryPolicy(attempts=6, base_s=0.02),
        deadlines=dl)
    ids = cli.preprocess(1)
    assert len(ids) == 1 and cli.pool_size() == 1
    assert fts[0].injected == [(6, "reset")]
    assert cli.stats()["preps_retried"] == 1
    sent = [[W.decode_frame(f).payload["ids"] for d, f in ft.frame_log
             if d == "send" and W.decode_frame(f).tag == "prep"]
            for ft in (fts[0], fts[2])]  # first and retried offline leg
    assert sent[1] == [ids] and not set(sent[0][0]) & set(ids)
    st = gw.stats()
    assert st["bundles_prepped"] == 1 and st["bundles_burned"] == 0
    _identity(st)
    cli.close()
    gw.close()


def test_lease_expiry_reclaims_and_surfaces_session_lost(world):
    gw = PitGateway(world["tm"], S, device="cpu", max_sessions=4,
                    pool_cap=4, lease_s=0.2)
    dl = Deadlines.uniform(30.0)

    def connect():
        c, s = InProcPipe.make_pair()
        gw.serve_transport(s, deadlines=dl)
        return c

    cli = ResilientClient(connect, seed=7, device="cpu",
                          policy=RetryPolicy(attempts=3, base_s=0.02),
                          deadlines=dl)
    cli.preprocess(1)
    cli.offline.transport.close()  # crash: both legs vanish, no bye
    cli.online.transport.close()
    cli._teardown()
    _wait(lambda: gw.stats()["leases_expired"] == 1, "lease expiry")
    st = gw.stats()
    assert st["sessions_parked"] == 0 and st["bundles_returned"] == 1
    _identity(st)
    with pytest.raises(SessionLost):
        cli.run(world["x"])
    cli.close()
    gw.close()


# ---------------------------------------------------------------------------
# chaos: seeds fixed before the first run; typed or bit-identical
# ---------------------------------------------------------------------------

CHAOS_SEEDS = (0, 1, 2)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_chaos_sweep_typed_or_bit_identical(world):
    dl = Deadlines.uniform(30.0)
    outcomes, fired = {}, {}
    for seed in CHAOS_SEEDS:
        gw = PitGateway(world["tm"], S, device="cpu", max_sessions=4,
                        pool_cap=4, lease_s=30.0)
        plan = FaultPlan(seed=seed, faulty_conns=2, n_faults=1, first_op=2,
                         horizon=40, stall_s=0.05, record_frames=True)

        def connect():
            c, s = InProcPipe.make_pair()
            gw.serve_transport(s, deadlines=dl)
            return plan.wrap(c)

        cli = ResilientClient(
            connect, seed=seed, device="cpu", deadlines=dl,
            policy=RetryPolicy(attempts=6, base_s=0.01, max_s=0.05,
                               seed=seed))
        try:
            cli.preprocess(1)
            y = cli.run(world["x"])
            outcomes[seed] = "ok" if np.array_equal(y, world["y"]) \
                else "DIVERGED"
        except (BundlePoolEmpty, TransportClosed) as e:
            outcomes[seed] = type(e).__name__
        finally:
            try:
                cli.close()
            except (TransportClosed, OSError):
                pass
        # replay: the plan re-derives every schedule it ran, and they are
        # the reference's for the same seed
        jplan = JN.FaultPlan(seed=seed, faulty_conns=2, n_faults=1,
                             first_op=2, horizon=40, stall_s=0.05)
        for i, ft in enumerate(plan.transports):
            assert ft.schedule == plan.schedule_for(i), (seed, i)
            assert _faults(ft.schedule) == _faults(jplan.schedule_for(i))
        fired[seed] = plan.injected()
        # error frames carry a class name only
        for ft in plan.transports:
            for _d, frame in ft.frame_log:
                try:
                    msg = W.decode_frame(frame)
                except Exception:
                    continue  # torn halves do not decode
                if msg.kind == W.KIND_CONTROL and msg.tag == "error":
                    assert msg.payload.split(" (")[0].isidentifier()
        _wait(lambda: gw.stats()["prep_inflight"] == 0, "quiet server")
        _identity(gw.stats())
        gw.close()
    assert set(outcomes.values()) <= {"ok", "BundlePoolEmpty",
                                      "TransportClosed", "TransportTimeout",
                                      "SessionLost"}, outcomes
    assert "ok" in outcomes.values(), outcomes
    assert any(fired.values()), fired  # the sweep injected something
