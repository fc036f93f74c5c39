"""The port's tracer (``repro_torch.obs``) on the CPU: the shared no-op
span, span paths, ``timer`` with tracing off, payload rejection, a Chrome
export that ``scripts/trace_check.py`` passes, and the spans the
garbled-circuit path records (``circuit.build``, ``garble.draw``,
``gc_offline.masks``, ``gc_online.encode``, ``gc_online.decode``) with
their parents and attributes; with tracing off those calls record none
and compute the same outputs."""

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.config import PrivacyConfig
from repro_torch.core import garble as G
from repro_torch.core.gc_exec import get_executor
from repro_torch.core.protocol import PiTProtocol

ROOT = Path(__file__).resolve().parents[1]
#: a 10-bit prime ring, as the benchmark's tiny CPU cell
PCFG = PrivacyConfig(he_t_bits=10, he_poly_n=32, he_num_primes=1,
                     frac_bits=3)
I, SCALE = 4, 6
#: (span, its path, its attribute keys); ``offline`` / ``online`` are
#: the ``Stats.phase`` timers
GC_SPANS = [
    ("circuit.build", "circuit.build", {"netlist", "and_gates", "gates"}),
    ("garble.draw", "garble.draw", {"instances", "words"}),
    ("gc_offline.masks", "offline/gc_offline/gc_offline.masks",
     {"instances", "n_out"}),
    ("gc_online.encode", "online/gc_online/gc_online.encode",
     {"instances", "bits"}),
    ("gc_online.decode", "online/gc_online/gc_online.decode",
     {"instances", "n_out"}),
]


def _trace_check():
    spec = importlib.util.spec_from_file_location(
        "trace_check", ROOT / "scripts" / "trace_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gc_calls(seed=3):
    """A fresh protocol's truncation netlist garbled, its offline leg on
    the garbled batch and its online leg on shares of fixed inputs; the
    softmax netlist asked for twice. Returns the protocol, the netlist
    and the revealed outputs."""
    p = PiTProtocol(PCFG, seed=seed, device="cpu")
    net = p.trunc_net(SCALE)
    p.softmax_net(2, SCALE)
    p.softmax_net(2, SCALE)  # cached: no second build
    gcirc = G.garble(net, p.gen, I, device="cpu")
    corr = p.gc_offline(net, I, 1, gcirc)
    rng = np.random.default_rng(seed)
    xc = rng.integers(0, p.t, (I, 1), dtype=np.uint64)
    xs = rng.integers(0, p.t, (I, 1), dtype=np.uint64)
    oc, os_ = p.gc_online(corr, xc, xs)
    return p, net, (oc + os_) % np.uint64(p.t)


@pytest.fixture(scope="module")
def traced():
    tr = obs.enable()
    try:
        p, net, out = _gc_calls()
    finally:
        obs.disable()
    return tr, p, net, out


@pytest.fixture
def off():
    obs.disable()
    yield
    obs.disable()


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def test_null_tracer_hands_back_one_shared_span_and_records_nothing(off):
    a = obs.span("a", n=1)
    b = obs.span("b")
    assert a is b
    with a as sp:
        assert sp.set(n=2) is a
    assert a.attrs == {} and a.elapsed_s == 0.0
    assert obs.current() is obs.NULL_TRACER
    assert obs.current().finished_spans() == []
    assert obs.current().report() == {}


def test_nested_spans_get_their_path(off):
    tr = obs.enable()
    try:
        with obs.span("a"):
            with obs.span("b", n=1):
                with obs.span("c"):
                    pass
            with obs.span("b"):
                pass
    finally:
        obs.disable()
    assert sorted(s.path for s in tr.finished_spans()) == [
        "a", "a/b", "a/b", "a/b/c"]
    rep = tr.report()
    assert rep["a/b"]["count"] == 2
    assert rep["a"]["total_s"] >= rep["a/b"]["total_s"] > 0


def test_timer_measures_with_tracing_off(off):
    tr = obs.enable()
    obs.disable()
    with obs.timer("t", n=1) as sp:
        time.sleep(0.01)
    took = sp.elapsed_s
    time.sleep(0.005)
    assert took >= 0.01 and sp.elapsed_s == took  # closed: fixed
    assert tr.finished_spans() == []


@pytest.mark.parametrize("payload", [np.arange(3), b"\x00\x01", [1, 2]],
                         ids=["array", "bytes", "list"])
def test_span_attributes_reject_payloads(off, payload):
    obs.enable()
    try:
        with pytest.raises(TypeError):
            obs.span("x", size=payload)
        with obs.span("x") as sp:
            with pytest.raises(TypeError):
                sp.set(size=payload)
    finally:
        obs.disable()


def test_export_of_a_run_passes_trace_check(traced, tmp_path):
    tr = traced[0]
    path = tr.export(str(tmp_path / "trace.json"))
    doc = json.loads(Path(path).read_text())
    assert _trace_check().check_events(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert {name for name, _, _ in GC_SPANS} <= names


# ---------------------------------------------------------------------------
# the garbled-circuit path's spans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,path,keys", GC_SPANS,
                         ids=[s[0] for s in GC_SPANS])
def test_gc_path_records_its_spans(traced, name, path, keys):
    tr, p, net, _ = traced
    got = [s for s in tr.finished_spans() if s.name == name]
    if name == "circuit.build":
        # one per netlist: the second softmax_net found it cached
        assert sorted(s.attrs["netlist"] for s in got) == [
            "softmax2", f"trunc_s{SCALE}"]
        built = {n.name: n for n in p._netlist_cache.values()}
        for s in got:
            assert s.path == path and set(s.attrs) == keys
            n = built[s.attrs["netlist"]]
            assert (s.attrs["and_gates"], s.attrs["gates"]) == (
                n.and_count, n.num_gates)
        return
    assert [s.path for s in got] == [path]
    attrs = got[0].attrs
    assert set(attrs) == keys and attrs["instances"] == I
    if name == "garble.draw":
        plan = get_executor(net, I, "cpu", garbling=True).plan
        assert attrs["words"] == I * (len(plan.source_ids) + 1) * 4
    elif name == "gc_online.encode":
        assert attrs["bits"] == (len(net.garbler_inputs)
                                 + len(net.evaluator_inputs))
    else:
        assert attrs["n_out"] == 1


def test_decode_follows_the_walk_inside_gc_online(traced):
    spans = {s.path: s for s in traced[0].finished_spans()}
    enc = spans["online/gc_online/gc_online.encode"]
    walk = spans["online/gc_online/gc_exec.evaluate"]
    dec = spans["online/gc_online/gc_online.decode"]
    assert enc.t1_ns <= walk.t0_ns and walk.t1_ns <= dec.t0_ns
    draw, garble = spans["garble.draw"], spans["gc_exec.garble"]
    assert draw.t1_ns <= garble.t0_ns


def test_tracing_off_records_no_span_and_changes_nothing(traced, off):
    class Counting(obs.NullTracer):
        def __init__(self):
            self.names = []

        def span(self, name, **attrs):
            self.names.append(name)
            return super().span(name, **attrs)

    recording = obs.enable()
    counting = Counting()
    obs.install(counting)
    try:
        _, _, out = _gc_calls()
    finally:
        obs.disable()
    assert recording.finished_spans() == []
    assert counting.finished_spans() == []
    assert {name for name, _, _ in GC_SPANS} <= set(counting.names)
    np.testing.assert_array_equal(out, traced[3])
