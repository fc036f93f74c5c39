"""The port's multi-client gateway (``repro_torch.serve.gateway``) against
the JAX package's: concurrent TCP sessions behind one listener, each
bit-identical to the port's in-process session with its own
``SessionState`` and a per-tag wire ledger equal to its client's and to
the metered session's; one garbled slab per distinct netlist across all
sessions; a JAX client served by the port's gateway and a port client
served by the JAX package's, in both directions bit-identical with equal
ledgers on both ends; admission control (session cap and bounded pool)
shedding with retry-after hints; a killed session returning its bundles
without touching the others; and the gateway's accounting when the
server's idle deadline drops a client's legs before a run, as in the
reference. Runs on the CPU at d=8, S=4; outputs are compared bit for
bit, ledgers byte for byte."""

import threading
import time

import numpy as np
import pytest

import repro.net as JN
from repro.config import PrivacyConfig as JConfig
from repro.core.engine import PrivateTransformer as JModel
from repro.core.engine import random_weights
from repro.serve import PitGateway as JGateway
from repro.serve import gateway_client as j_gateway_client
import repro_torch.net as TN
from repro_torch.config import PrivacyConfig as TConfig
from repro_torch.core.engine import PrivateTransformer as TModel
from repro_torch.core.engine import weights_from_reference
from repro_torch.net import InProcPipe, TcpListener
from repro_torch.serve import (
    BundlePoolEmpty,
    NetPrivateServeEngine,
    PitGateway,
    gateway_client,
)

D, HEADS, DFF, S = 8, 2, 16, 4
#: the reference tests' widths and ring; a 16-bit share modulus keeps the
#: plain (CPU) walks of every session to seconds
PCFG = dict(he_poly_n=256, he_num_primes=2, he_t_bits=16, frac_bits=5)
TIMEOUT = 120


@pytest.fixture(scope="module")
def world():
    """Both packages' model on the same weights, an input, and the port's
    in-process session at wire v2 (the gateway clients' default): its
    revealed output, and its metered ledger after ``preprocess(1)`` and
    one run."""
    ws = random_weights(np.random.default_rng(11), D, DFF, 1)
    tm = TModel(TConfig(**PCFG), D, HEADS, DFF, weights_from_reference(ws),
                seed=11, device="cpu")
    jm = JModel(JConfig(**PCFG), D, HEADS, DFF, ws, seed=11)
    x = np.random.default_rng(12).normal(0, 1, (S, D))
    sess = tm.compile_session(S, wire_version=2)
    y = sess.run(x, sess.preprocess(1)[0])
    return {"tm": tm, "jm": jm, "x": x, "y": y,
            "comm": sess.stats.comm_snapshot()}


def _ledgers_equal(summary, ledger, comm=None):
    """A session's server-side summary == its client's ledger, tag for tag
    (and == the metered in-process session's where given)."""
    for phase in ("offline", "online"):
        got = summary[f"{phase}_by_tag"]
        assert got == dict(getattr(ledger, phase).by_tag), phase
        if comm is not None:
            assert got == comm[phase]["by_tag"], phase
    assert summary["offline_bytes"] > 0 and summary["online_bytes"] > 0


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


def test_four_tcp_sessions_shed_bit_identical_then_one_killed(world):
    """Four clients connect at once behind one listener and stay live
    together; a fifth is shed at hello (the session cap), and a second
    prep past the pool of one is shed before anything is garbled (no
    offline PROTO bytes move), both with a positive retry-after hint.
    Each client runs one request: outputs equal the in-process session's,
    one session per client, each session's ledger equal to its client's
    and to the metered session's; the garbling cache builds one slab per
    distinct netlist and every later session hits it. Then client 0
    preprocesses one more bundle and dies with it outstanding: it comes
    back as returned, and the other sessions' state is untouched. (The sessions' work runs one
    client at a time: on the CPU, clients and server endpoints stepping
    the plain walks at once trade the interpreter lock for every tensor
    op and take several times as long. ``chip_smoke.py`` runs two
    sessions concurrently on the card.)"""
    gw = PitGateway(world["tm"], S, device="cpu", max_sessions=4,
                    pool_cap=1)
    lst = TcpListener()
    loop = gw.serve_listener(lst, accept_timeout=0.2, timeout=TIMEOUT)
    engines, errs = [None] * 4, []

    def connect(i):
        try:
            engines[i] = gateway_client("127.0.0.1", lst.port, seed=100 + i,
                                        device="cpu", timeout=TIMEOUT)
        except Exception as e:  # surfaced below: threads swallow raises
            errs.append((i, e))

    threads = [threading.Thread(target=connect, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errs, errs
    assert loop.accepted == 8  # 4 clients x (offline + online)
    assert gw.stats()["sessions_active"] == 4
    with pytest.raises(BundlePoolEmpty) as ei:
        gateway_client("127.0.0.1", lst.port, seed=99, device="cpu",
                       timeout=TIMEOUT)
    assert ei.value.scope == "session" and ei.value.retry_after_s > 0

    for i, eng in enumerate(engines):
        assert eng.preprocess(1) == 1  # at the pool cap
        if i == 0:
            c2s = eng.ledger.offline.client_to_server
            with pytest.raises(BundlePoolEmpty) as ei:
                eng.preprocess(1)
            assert ei.value.scope == "prep" and ei.value.retry_after_s > 0
            assert eng.ledger.offline.client_to_server == c2s
        assert np.array_equal(eng.run(world["x"]), world["y"]), i
    m = gw.metrics()
    assert m["schema"] == "pit.gateway.v1"
    assert (m["counters"]["sessions_shed"], m["counters"]["prep_sheds"]) \
        == (1, 1)

    st = gw.stats()
    assert st["sessions_active"] == 4 and st["sessions_admitted"] == 4
    assert len({s["sid"] for s in st["sessions"]}) == 4
    by_token = {s["client"]: s for s in st["sessions"]}
    for i, eng in enumerate(engines):
        summary = by_token[eng._shared.client_token]
        # client 0's shed prep cost one CONTROL round trip, nothing else
        _ledgers_equal(summary, eng.ledger, None if i == 0 else
                       world["comm"])
        assert summary["sheds"] == (i == 0)
    cache = st["garbling_cache"]
    assert cache["slabs"] == cache["distinct_netlists"] > 0
    assert cache["misses"] == cache["slabs"]
    assert cache["hits"] == 3 * cache["slabs"]
    assert set(cache["by_key"].values()) == {4}
    _identity(st)

    # kill client 0 (no bye) with one bundle still outstanding
    victim = engines[0]
    victim.preprocess(1)
    by_token = {s["client"]: s for s in gw.stats()["sessions"]}
    victim.offline.transport.close()
    victim.online.transport.close()
    _wait(lambda: gw.stats()["sessions_active"] == 3, "the victim's teardown")
    after = gw.stats()
    assert after["bundles_returned"] == 1
    dead = by_token[victim._shared.client_token]["sid"]
    assert [s["bundles_returned"] for s in after["sessions"]
            if s["sid"] == dead] == [1]
    # the others: same sessions, same accounting, same ledgers
    strip = ("elapsed_s", "runs_per_s", "bytes_per_s")
    for s in after["sessions"]:
        if s["sid"] != dead:
            assert {k: v for k, v in s.items() if k not in strip} == \
                {k: v for k, v in by_token[s["client"]].items()
                 if k not in strip}
    _identity(after)
    for eng in engines[1:]:
        eng.close()
    loop.stop()
    gw.close()
    lst.close()


def test_jax_client_served_by_the_port_s_gateway(world):
    gw = PitGateway(world["tm"], S, device="cpu", max_sessions=2)
    lst = TcpListener()
    loop = gw.serve_listener(lst, accept_timeout=0.2, timeout=TIMEOUT)
    eng = j_gateway_client("127.0.0.1", lst.port, seed=7, impl="ref",
                           timeout=TIMEOUT)
    eng.preprocess(1)
    assert np.array_equal(eng.run(world["x"]), world["y"])
    (summary,) = gw.stats()["sessions"]
    _ledgers_equal(summary, eng.ledger)
    eng.close()
    loop.stop()
    gw.close()
    lst.close()


def test_port_client_served_by_the_jax_gateway(world):
    gw = JGateway(world["jm"], S, impl="ref", max_sessions=2)
    lst = JN.TcpListener()
    loop = gw.serve_listener(lst, accept_timeout=0.2, timeout=TIMEOUT)
    eng = gateway_client("127.0.0.1", lst.port, seed=8, device="cpu",
                         timeout=TIMEOUT)
    eng.preprocess(1)
    assert np.array_equal(eng.run(world["x"]), world["y"])
    (summary,) = gw.stats()["sessions"]
    _ledgers_equal(summary, eng.ledger)
    eng.close()
    loop.stop()
    gw.close()
    lst.close()


def _idle_drop_run(pkg, world):
    """The reference's resume-and-burn test with the server's idle
    deadline shorter than ``preprocess``: both legs are dropped (an error
    frame, then a close) before the run, so the run request reaches no
    live endpoint and the reset scheduled at op 8 never fires."""
    if pkg is TN:
        gw = PitGateway(world["tm"], S, device="cpu", max_sessions=4,
                        pool_cap=4, lease_s=30.0)
        dev = dict(device="cpu")
    else:
        gw = JGateway(world["jm"], S, impl="ref", max_sessions=4,
                      pool_cap=4, lease_s=30.0)
        dev = dict(impl="ref")
    dl = pkg.Deadlines(default_s=30.0, idle_s=0.3)
    conns, fts = [0], []

    def connect():
        c, s = pkg.InProcPipe.make_pair()
        gw.serve_transport(s, deadlines=dl)
        i = conns[0]
        conns[0] += 1
        ft = pkg.FaultyTransport(c, pkg.FaultSchedule(
            (pkg.Fault(8, "reset"),) if i == 1 else ()))
        fts.append(ft)
        return ft

    cli = pkg.ResilientClient(connect, seed=5, deadlines=dl,
                              policy=pkg.RetryPolicy(attempts=1), **dev)
    cli.preprocess(1)
    _wait(lambda: gw.stats()["sessions_parked"] == 1, "the idle drops")
    with pytest.raises(pkg.TransportClosed) as ei:
        cli.run(world["x"])
    st = gw.stats()
    _identity(st)
    gw.close()
    keys = ("sessions_admitted", "sessions_resumed", "bundles_prepped",
            "bundles_consumed", "bundles_outstanding", "bundles_returned",
            "bundles_burned")
    return (type(ei.value).__name__, [ft.injected for ft in fts],
            cli.stats(), {k: st[k] for k in keys})


def test_idle_drop_before_a_run_burns_client_side_only_as_in_reference(
        world):
    """Why the reference's ``test_faults.py::
    test_resilient_reconnect_resumes_and_burns`` reads no burn on the
    gateway on a slow host: its 15 s idle deadline expires during a
    longer ``preprocess(2)``, so the client burns a bundle the server
    never popped (the server counts it outstanding) and its scheduled
    reset never fires. The port's gateway and client count it the same
    way as the JAX package's."""
    port = _idle_drop_run(TN, world)
    assert port == _idle_drop_run(JN, world)
    _err, injected, cst, st = port
    assert injected == [[], []]
    assert cst["bundles_burned"] == 1 and st["bundles_burned"] == 0
    assert st["bundles_outstanding"] == 1 and st["bundles_consumed"] == 0


def test_inproc_pair_binds_one_session_per_token(world):
    """The pipelined client's two transports (an ``InProcPipe`` pair each)
    bind to one session; a bare endpoint pair with its own token gets its
    own. Then a clean close reclaims both sessions at once."""
    gw = PitGateway(world["tm"], S, device="cpu", max_sessions=4)
    engs = []
    for seed in (1, 2):
        (oc, os_), (nc, ns) = InProcPipe.make_pair(), InProcPipe.make_pair()
        gw.serve_transport(os_, timeout=TIMEOUT)
        gw.serve_transport(ns, timeout=TIMEOUT)
        engs.append(NetPrivateServeEngine(oc, nc, seed=seed, device="cpu",
                                          timeout=TIMEOUT))
    st = gw.stats()
    assert st["sessions_active"] == 2 and st["sessions_admitted"] == 2
    assert {s["client"] for s in st["sessions"]} == \
        {e._shared.client_token for e in engs}
    for e in engs:
        e.close()
    _wait(lambda: gw.stats()["sessions_active"] == 0, "clean teardown")
    assert gw.stats()["sessions_parked"] == 0
    gw.close()
