"""The port's two-party runtime against the JAX package's ``repro.net``
and against the port's own in-process session: the wire codec (frames and
packers byte-identical to the reference's, int32 label tensors included),
both transports, the PRG label streams, seeded garbling, IKNP OT between
a port party and a reference party in both roles, a two-party run whose
revealed outputs equal the port's session and the reference's net run
bit for bit with per-tag wire ledgers equal to the metered oracle on both
endpoints, a v1-only peer negotiating a TCP session down, two threads
first-using one level plan or one protocol's netlist, and TCP frames
that stay whole while their sender waits on short receive deadlines. Tolerance 0 throughout: labels,
bytes and shares are integers. Everything runs on the CPU (the kernels'
plain versions); the JAX side garbles through its host oracle."""

import hashlib
import threading

import numpy as np
import pytest
import torch

from repro.config import PrivacyConfig as JConfig
from repro.core import labels as JL
from repro.core import ot as JOT
from repro.core.engine import PrivateTransformer as JModel
from repro.core.engine import random_weights
from repro.net import GarblerEndpoint as JGarbler
from repro.net import InProcPipe as JPipe
from repro.net import PitNetServer as JServer
from repro.net import wire as JW
from repro_torch.config import PrivacyConfig as TConfig
from repro_torch.core import garble as TG
from repro_torch.core import gc_exec as TX
from repro_torch.core import labels as TL
from repro_torch.core import ot as TOT
from repro_torch.core.circuits import arith as TA
from repro_torch.core.circuits.builder import CircuitBuilder as TB
from repro_torch.core.engine import PrivateTransformer as TModel
from repro_torch.core.engine import weights_from_reference
from repro_torch.core.protocol import PiTProtocol as TProtocol
from repro_torch.kernels import build
from repro_torch.net import (
    GarblerEndpoint,
    InProcPipe,
    NetProtocolError,
    PitNetServer,
    TcpListener,
    TcpTransport,
)
from repro_torch.net import wire as W
from repro_torch.net.transport import TransportClosed, TransportTimeout

D, HEADS, DFF, S = 8, 2, 16, 4
PCFG = dict(he_poly_n=256, he_num_primes=3, he_t_bits=40, frac_bits=6)
# a narrower share modulus: the same circuits with 16-bit words, for the
# runs beyond the main one (keeps the file near two minutes)
NARROW = dict(he_poly_n=64, he_num_primes=2, he_t_bits=16, frac_bits=5)


def _models(seed=0, offload=True, pcfg=PCFG):
    ws = random_weights(np.random.default_rng(seed), D, DFF, 1)
    jm = JModel(JConfig(**pcfg, layernorm_offload=offload), D, HEADS, DFF,
                ws, seed=seed)
    tm = TModel(TConfig(**pcfg, layernorm_offload=offload), D, HEADS, DFF,
                weights_from_reference(ws), seed=seed, device="cpu")
    return jm, tm


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# wire codec: the reference's bytes
# ---------------------------------------------------------------------------


def test_wire_frames_are_the_reference_bytes():
    rng = np.random.default_rng(0)
    lab = rng.integers(0, 1 << 32, (3, 5, 4), dtype=np.uint32)
    tables = rng.integers(0, 1 << 32, (4, 7, 2, 4), dtype=np.uint32)
    payload = {"perm": np.arange(6, dtype=np.uint32).reshape(2, 3),
               "n": 42, "name": "softmax4", "none": None, "f": 2.5,
               "l": [1, "two", b"\x00"]}
    for v in (W.WIRE_VERSION, W.WIRE_V2):
        assert W.encode_msg(W.KIND_SIM, "gc-meta:x", payload, phase=1,
                            version=v) == \
            JW.encode_msg(JW.KIND_SIM, "gc-meta:x", payload, phase=1,
                          version=v)
        segs = [W.Seg("tables:x", W.DIR_C2S, b"\x01" * 32),
                W.Seg("g-labels", W.DIR_S2C, b"")]
        jsegs = [JW.Seg(s.tag, s.dir, s.data) for s in segs]
        assert W.encode_proto(segs, W.PHASE_ONLINE, version=v) == \
            JW.encode_proto(jsegs, JW.PHASE_ONLINE, version=v)
    # the reference's golden frame (tests/test_net.py)
    frame = W.encode_msg(
        W.KIND_SIM, "gc-meta:softmax4",
        {"perm": np.arange(6, dtype=np.uint32).reshape(2, 3),
         "n": 42, "name": "softmax4"}, phase=W.PHASE_OFFLINE)
    assert hashlib.sha256(frame).hexdigest() == (
        "49f279af8581e90b783ace4921d4acbe8d970dd60311f0b42d3caa276f015427")
    # int32 label and table tensors pack as their uint32 bit patterns
    assert W.pack_labels(_i32(lab)) == JW.pack_labels(lab)
    assert W.pack_tables(_i32(tables)) == JW.pack_tables(tables)
    assert W.pack_ot_response(_i32(lab)) == JW.pack_ot_response(lab)
    assert W.pack_tables_delta(_i32(tables)) == JW.pack_tables_delta(tables)
    assert np.array_equal(W.unpack_labels(W.pack_labels(_i32(lab)), (3, 5)),
                          lab)
    assert W.pack_seed_stream(bytes(range(16)), 7, 9) == \
        JW.pack_seed_stream(bytes(range(16)), 7, 9)
    bits = rng.integers(0, 2, (2, 3)).astype(np.uint8)
    assert W.pack_ot_request(bits) == JW.pack_ot_request(bits)
    arr = rng.integers(0, 1 << 40, (3, 5)).astype(np.uint64)
    assert W.ct_pack(arr, 6144, 256) == JW.ct_pack(arr, 6144, 256)
    assert W.ct_pack_rows(arr[:, 0], 6144) == JW.ct_pack_rows(arr[:, 0], 6144)
    with pytest.raises(W.WireError):
        W.pack_labels(torch.zeros((2, 4), dtype=torch.int64))


def test_inproc_pipe_duplex_and_close():
    a, b = InProcPipe.make_pair()
    a.send(b"ping")
    assert b.recv(timeout=5) == b"ping"
    b.send(b"pong")
    assert a.recv(timeout=5) == b"pong"
    assert a.bytes_sent == 4 and a.bytes_recv == 4
    a.close()
    with pytest.raises(TransportClosed):
        b.recv(timeout=5)


def test_tcp_transport_frames_and_timeout():
    lst = TcpListener()
    got = {}

    def server():
        t = lst.accept(timeout=10)
        got["frame"] = t.recv(timeout=10)
        t.send(b"y" * 100_000)
        t.close()

    th = threading.Thread(target=server)
    th.start()
    cli = TcpTransport.connect("127.0.0.1", lst.port)
    cli.send(b"x" * 70_000)
    assert cli.recv(timeout=10) == b"y" * 100_000
    th.join(timeout=10)
    assert got["frame"] == b"x" * 70_000
    with pytest.raises(TransportClosed):
        cli.recv(timeout=0.2)
    cli.close()
    lst.close()


# ---------------------------------------------------------------------------
# label streams, seeded garbling, IKNP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counter,count", [(0, 5), (1, 4), (6, 7), (3, 0)])
def test_stream_labels_match_reference(counter, count):
    seed = JL.stream_seed(np.random.default_rng(counter))
    assert TL.stream_seed(np.random.default_rng(counter)) == seed
    got = TL.stream_labels(seed, counter, count)
    assert got.dtype == torch.int32 and got.shape == (count, 4)
    want = JL.stream_labels(seed, counter, count)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_seeded_garbling_replays_the_stream():
    cb = TB("add")
    a, b = cb.g_input_word(6), cb.e_input_word(6)
    cb.output(TA.add(cb, a, b))
    net = cb.build()
    I, wires = 3, net.garbler_inputs[2:]
    bits = np.random.default_rng(1).integers(0, 2, (I, len(wires)))
    seed = bytes(range(16))
    gc = TG.garble(net, torch.Generator().manual_seed(0), I, device="cpu",
                   seeded_inputs=(wires, bits, seed, 5))
    active = TG.encode_inputs(gc, wires, bits)
    assert torch.equal(active.reshape(-1, 4),
                       TL.stream_labels(seed, 5, I * len(wires)))
    plain = TG.garble(net, torch.Generator().manual_seed(0), I, device="cpu")
    assert torch.equal(gc.r, plain.r)  # the same draws otherwise
    g = np.random.default_rng(2).integers(0, 2, (I, len(net.garbler_inputs)))
    g[:, 2:] = bits
    e = np.random.default_rng(3).integers(0, 2, (I, len(net.evaluator_inputs)))
    lab = torch.cat([TG.encode_inputs(gc, net.garbler_inputs, g),
                     TG.encode_inputs(gc, net.evaluator_inputs, e)], dim=1)
    ids = np.concatenate([net.garbler_inputs, net.evaluator_inputs])
    out = TG.decode_outputs(gc, TG.evaluate(net, gc.tables, (ids, lab)))
    assert np.array_equal(out, net.eval_plain(g, e))


@pytest.mark.parametrize("receiver", ["port", "reference"])
def test_iknp_between_port_and_reference(receiver):
    """Base OT and two extension batches with one side from each package:
    the receiver gets exactly the labels of its choice bits."""
    R, Snd = ((TOT.IknpReceiver, JOT.IknpSender) if receiver == "port"
              else (JOT.IknpReceiver, TOT.IknpSender))
    rcv, snd = R(np.random.default_rng(1)), Snd(np.random.default_rng(2))
    rcv.absorb_base_b(snd.base_msg_b(rcv.base_msg_a()))
    rng = np.random.default_rng(3)
    for n in (70, 129):
        zero = rng.integers(0, 1 << 32, (n, 4), dtype=np.uint32)
        r = rng.integers(0, 1 << 32, (1, 4), dtype=np.uint32)
        x = rng.integers(0, 2, n).astype(np.uint8)
        u, t_cols = rcv.extend(x)
        z_in, r_in = ((_i32(zero), _i32(r)) if Snd is TOT.IknpSender
                      else (zero, r))
        y = snd.respond(u, n, z_in, r_in)
        got = rcv.receive(y, x, t_cols)
        got = (got.numpy().view(np.uint32) if isinstance(got, torch.Tensor)
               else got)
        assert np.array_equal(got, zero ^ (r * x[:, None]))


def test_iknp_port_pair_matches_reference_pair_bytes():
    """The same seeds give the same base-OT and extension bytes."""
    pr, ps = (TOT.IknpReceiver(np.random.default_rng(1)),
              TOT.IknpSender(np.random.default_rng(2)))
    jr, js = (JOT.IknpReceiver(np.random.default_rng(1)),
              JOT.IknpSender(np.random.default_rng(2)))
    a = pr.base_msg_a()
    assert a == jr.base_msg_a()
    b = ps.base_msg_b(a)
    assert b == js.base_msg_b(a)
    pr.absorb_base_b(b)
    jr.absorb_base_b(b)
    x = np.random.default_rng(4).integers(0, 2, 50).astype(np.uint8)
    (pu, pt), (ju, jt) = pr.extend(x), jr.extend(x)
    assert pu == ju and np.array_equal(pt, jt)
    zero = np.random.default_rng(5).integers(0, 1 << 32, (50, 4),
                                            dtype=np.uint32)
    r = np.random.default_rng(6).integers(0, 1 << 32, (4,), dtype=np.uint32)
    assert ps.respond(pu, 50, _i32(zero), _i32(r)) == \
        js.respond(ju, 50, zero, r)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def _run_pair(cli, x, n=2):
    cli.handshake()
    ids = cli.preprocess(n)
    ys = [cli.run(x) for _ in range(n)]
    return ids, ys


@pytest.fixture(scope="module")
def netrun():
    """The port's two-party run (wire v2 over InProcPipe, 2 bundles, 2
    runs) beside the port's metered session and the reference's net run
    on the same weights and inputs."""
    jm, tm = _models()
    x = np.random.default_rng(1).normal(0, 1, (S, D))
    srv = PitNetServer(tm, S, device="cpu")
    a, b = InProcPipe.make_pair()
    srv.serve_transport(b, timeout=300)
    cli = GarblerEndpoint(a, seed=7, device="cpu", timeout=300)
    ids, ys = _run_pair(cli, x)

    sess = tm.compile_session(S, wire_version=2, device="cpu")
    bundles = sess.preprocess(2)
    y_sess = [sess.run(x, bnd) for bnd in bundles]

    jsrv = JServer(jm, S, impl="ref")
    ja, jb = JPipe.make_pair()
    jsrv.serve_transport(jb, timeout=300)
    jcli = JGarbler(ja, seed=7, impl="ref", timeout=300)
    _, jys = _run_pair(jcli, x)
    cli.close()
    jcli.close()
    return dict(tm=tm, cli=cli, srv=srv, x=x, ids=ids, y=ys, y_sess=y_sess,
                oracle=sess.stats, jcli=jcli, jy=jys)


def test_net_outputs_bit_identical(netrun):
    for y, ys, jy in zip(netrun["y"], netrun["y_sess"], netrun["jy"]):
        assert y.shape == (S, D)
        assert np.array_equal(y, ys) and np.array_equal(y, jy)
    want = netrun["tm"].forward_float(netrun["x"])
    assert np.abs(netrun["y"][0] - want).max() < 0.25


@pytest.mark.parametrize("side", ["client", "server"])
def test_net_ledger_matches_metered_oracle(netrun, side):
    led = (netrun["cli"] if side == "client" else netrun["srv"]).shared.ledger
    st = netrun["oracle"]
    assert led.offline.by_tag == dict(st.channel_offline.by_tag)
    assert led.online.by_tag == dict(st.channel_online.by_tag)
    assert led.offline.total == st.channel_offline.total
    assert led.online.total == st.channel_online.total
    assert led.seed_stream_segs > 0 and led.delta_batches > 0


def test_net_ledger_equals_reference_net_run(netrun):
    mine = netrun["cli"].shared.ledger.summary()
    ref = netrun["jcli"].shared.ledger.summary()
    for k in ("offline_by_tag", "online_by_tag", "proto_frames_offline",
              "proto_frames_online", "dir_flips_offline", "dir_flips_online",
              "seed_stream_labels", "resid_bytes", "sim_bytes"):
        assert mine[k] == ref[k], k


def test_net_bundle_consumed_and_unknown(netrun):
    cli = netrun["cli"]
    with pytest.raises((NetProtocolError, TransportClosed)):
        cli.run(netrun["x"], bundle_id=netrun["ids"][0])


def test_v1_peer_negotiates_a_tcp_session_down():
    """A v1-pinned client against a v2 server over loopback TCP: the run
    completes with v1 framing and v1 byte accounting."""
    _, tm = _models(seed=21, pcfg=NARROW)
    x = np.random.default_rng(22).normal(0, 1, (S, D))
    srv = PitNetServer(tm, S, device="cpu")
    lst = TcpListener()
    loop = srv.serve_tcp(lst, timeout=300)
    cli = GarblerEndpoint(TcpTransport.connect("127.0.0.1", lst.port),
                          seed=23, device="cpu", timeout=300, wire_version=1)
    assert loop.wait_accepted(1, timeout=30)
    cli.preprocess(1)
    y = cli.run(x)
    assert cli.shared.negotiated_version == 1
    assert cli.shared.negotiated_compression is False
    sess = tm.compile_session(S, device="cpu")  # v1 oracle
    assert np.array_equal(y, sess.run(x, sess.preprocess(1)[0]))
    led = cli.shared.ledger
    assert led.offline.by_tag == dict(sess.stats.channel_offline.by_tag)
    assert led.online.by_tag == dict(sess.stats.channel_online.by_tag)
    assert led.seed_stream_segs == 0 and led.delta_batches == 0
    cli.close()
    loop.stop()
    lst.close()


# ---------------------------------------------------------------------------
# first use from two threads
# ---------------------------------------------------------------------------


def test_two_threads_first_using_one_plan(monkeypatch):
    """Two endpoints of one party may reach a netlist's plan at once: it
    is compiled once and both get the same executor."""
    cb = TB("mul")
    a, b = cb.g_input_word(6), cb.e_input_word(6)
    cb.output(TA.mul(cb, a, b))
    net = cb.build()
    calls = []
    real = TX.compile_level_plan

    def slow(*args, **kw):
        calls.append(threading.get_ident())
        threading.Event().wait(0.2)  # widen the window
        return real(*args, **kw)

    monkeypatch.setattr(TX, "compile_level_plan", slow)
    got, start = [], threading.Barrier(2)

    def first_use():
        start.wait()
        got.append(TX.get_executor(net, 4, "cpu"))

    ths = [threading.Thread(target=first_use) for _ in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=60)
    assert len(got) == 2 and got[0] is got[1]
    assert len(net._level_plans) == 1
    assert len(next(iter(net._level_plans.values()))._executors) == 1


def test_two_threads_first_building_one_netlist():
    """Two threads of one party that first ask a protocol for one circuit
    build it once and get the same netlist (and so the same plans)."""
    pr = TProtocol(TConfig(**NARROW), seed=0, device="cpu")
    bodies, got, start = [], [], threading.Barrier(2)

    def body(cb, ins):
        bodies.append(threading.get_ident())
        threading.Event().wait(0.2)  # widen the window
        return [TA.add(cb, ins[0], ins[1])]

    def first_use():
        start.wait()
        got.append(pr.build_fn_circuit("sum2", 2, 1, body))

    ths = [threading.Thread(target=first_use) for _ in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=60)
    assert len(bodies) == 1 and len(got) == 2 and got[0] is got[1]


def test_two_threads_first_building_one_kernel(monkeypatch, tmp_path):
    """Two threads that first launch one kernel run the compiler once."""
    runs = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            runs.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            threading.Event().wait(0.2)
            open(out, "wb").close()

        def communicate(self):
            return "ptxas info: fake", None

    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    got, start = [], threading.Barrier(2)

    def first_use():
        start.wait()
        got.append(build.build([src])[0])

    ths = [threading.Thread(target=first_use) for _ in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=60)
    assert len(runs) == 1 and got[0] is got[1] and got[0].path.exists()


def test_tcp_both_ends_send_large_frames_before_receiving():
    """Both endpoints send a frame far larger than the sockets' buffers
    before either receives (as a GC leg does at BERT-base width): the
    writer threads keep either send from blocking on the other."""
    lst = TcpListener()
    got, big = {}, 48 << 20
    a_ready = threading.Event()

    def server():
        t = lst.accept(timeout=10)
        a_ready.wait(10)
        t.send(b"s" * big)
        got["s"] = t.recv(timeout=60)
        t.close()

    th = threading.Thread(target=server)
    th.start()
    cli = TcpTransport.connect("127.0.0.1", lst.port)
    cli.send(b"c" * big)
    a_ready.set()
    assert cli.recv(timeout=60) == b"s" * big
    th.join(timeout=60)
    assert got["s"] == b"c" * big
    cli.close()
    lst.close()


def test_tcp_frames_stay_whole_while_their_sender_waits_on_deadlines():
    """Frames far larger than the sockets' buffers leave from the writer
    thread while their sender polls ``recv`` with short deadlines and the
    peer reads each late: the deadlines bound the waits for bytes only,
    never the writer's sends, so both frames arrive whole and the reply
    after them."""
    lst = TcpListener()
    frames = [bytes([i]) * (32 << 20) for i in (1, 2)]
    got = []

    def server():
        t = lst.accept(timeout=10)
        for _ in frames:
            threading.Event().wait(0.5)  # the client's writer fills the buffers
            got.append(t.recv(timeout=10))
        t.send(b"ok")
        t.close()

    th = threading.Thread(target=server)
    th.start()
    cli = TcpTransport.connect("127.0.0.1", lst.port)
    for f in frames:
        cli.send(f)
    timeouts, reply = 0, None
    while reply is None and timeouts < 3000:  # 30 s of deadlines at most
        try:
            reply = cli.recv(timeout=0.01)
        except TransportTimeout:
            timeouts += 1
    th.join(timeout=60)
    assert got == frames and reply == b"ok" and timeouts > 0
    cli.close()
    lst.close()
