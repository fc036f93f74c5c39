"""The port's device-resident GC executor against the JAX package's
(``impl="jit"``), bit for bit: the same netlist (each package builds its
own, and they must agree gate for gate), the same ``(src_labels, R)``,
then input zero-labels, tables, output colour bits and evaluated output
labels. Both instance regimes (I=1 and I=8 latency, I=16 throughput),
the protocol's full-width trunc, GeLU and softmax netlists (a short
softmax row: the latency-width plan with wide free lanes that dominates
serving) and small circuit generators, plus ``keep_wires`` on an
append-only plan. The port's executor runs the plain walks over its
packed per-chunk records here, so these tests also cover the packing
the walk kernels read."""

import numpy as np
import pytest
import torch

from repro.config import PrivacyConfig as JConfig
from repro.core import gc_exec as JX
from repro.core.circuits import arith as JA
from repro.core.circuits.builder import CircuitBuilder as JB
from repro.core.protocol import PiTProtocol as JProtocol
from repro_torch.config import PrivacyConfig as TConfig
from repro_torch.core import garble as TG
from repro_torch.core import gc_exec as TX
from repro_torch.core.circuits import arith as TA
from repro_torch.core.circuits.builder import CircuitBuilder as TB
from repro_torch.core.netlist import LATENCY_MAX_INSTANCES
from repro_torch.core.protocol import PiTProtocol as TProtocol


def _adder(CB, A):
    cb = CB("adder")
    a, b = cb.g_input_word(8), cb.e_input_word(8)
    c = cb.const_word(0b1010, 8)
    cb.output(A.add(cb, a, A.add(cb, b, c)))
    return cb.build()


def _comparator(CB, A):
    cb = CB("comparator")
    a, b = cb.g_input_word(12), cb.e_input_word(12)
    lt = A.lt_signed(cb, a, b)
    cb.output(A.mux(cb, lt, a, b))
    cb.output(cb.INV(lt))
    return cb.build()


def _protocol_net(kind):
    def build(CB, A):
        p = (JProtocol(JConfig(), seed=0) if CB is JB
             else TProtocol(TConfig(), seed=0, device="cpu"))
        if kind == "softmax":
            return p.softmax_net(2, 24)
        return p.trunc_net(24) if kind == "trunc" else \
            p.activation_net("gelu", 24)
    return build


NETS = {"adder": _adder, "comparator": _comparator,
        "trunc": _protocol_net("trunc"), "gelu": _protocol_net("gelu"),
        "softmax": _protocol_net("softmax")}


@pytest.fixture(scope="module")
def nets():
    out = {}
    for name, build in NETS.items():
        jn, tn = build(JB, JA), build(TB, TA)
        for f in ("op", "in0", "in1", "out", "garbler_inputs",
                  "evaluator_inputs", "outputs"):
            assert np.array_equal(getattr(jn, f), getattr(tn, f)), (name, f)
        assert jn.const_bits == tn.const_bits
        out[name] = (jn, tn)
    return out


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u(x):
    return np.asarray(x.cpu().numpy()).view(np.uint32)


def _inputs(plan, I, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 1 << 32, (I, len(plan.source_ids), 4),
                       dtype=np.uint32)
    r = rng.integers(0, 1 << 32, (I, 4), dtype=np.uint32)
    r[:, 0] |= 1
    return src, r


def _active(net, plan, in_zero, r, I, seed):
    """Active source labels for random input bits (and the const bits)."""
    rng = np.random.default_rng(seed + 1)
    gb = rng.integers(0, 2, (I, len(net.garbler_inputs)))
    eb = rng.integers(0, 2, (I, len(net.evaluator_inputs)))
    bits = np.zeros((I, net.num_wires), np.uint32)
    bits[:, net.garbler_inputs] = gb
    bits[:, net.evaluator_inputs] = eb
    for w, v in net.const_bits.items():
        bits[:, w] = v
    sb = bits[:, plan.source_ids]
    act = in_zero ^ (r[:, None, :] & (0 - sb[..., None]).astype(np.uint32))
    return act, net.eval_plain(gb, eb)


@pytest.mark.parametrize("instances", [1, 8, 16])
@pytest.mark.parametrize("name", list(NETS))
def test_executor_matches_jax_executor(nets, name, instances):
    jn, tn = nets[name]
    I = instances
    jg = JX.get_executor(jn, I, "jit", garbling=True)
    tg = TX.get_executor(tn, I, "cpu", garbling=True)
    assert (jg.plan.n_chunks, jg.plan.widths) == \
        (tg.plan.n_chunks, tg.plan.widths)
    assert tg.plan.widths == TX.compile_level_plan(
        tn, instances=I, garbling=True).widths
    src, r = _inputs(jg.plan, I, seed=I)
    jz, jt, jp = (np.asarray(x) for x in jg.garble(src, r))
    tz, tt, tp = tg.garble(_t(src), _t(r))
    assert np.array_equal(_u(tz), jz)
    assert np.array_equal(_u(tt), jt)
    assert np.array_equal(tp.numpy().astype(np.uint32), jp)

    je = JX.get_executor(jn, I, "jit")
    te = TX.get_executor(tn, I, "cpu")
    act, want_bits = _active(jn, je.plan, jz, r, I, seed=I)
    j_out = np.asarray(je.evaluate(act, jt))
    t_out = te.evaluate(_t(act), tt)
    assert np.array_equal(_u(t_out), j_out)
    got_bits = (_u(t_out)[..., 0] & 1) ^ _u(tp)
    assert np.array_equal(got_bits, want_bits)
    assert te.n_eval_calls == 1 and tg.n_garble_calls >= 1
    # the regime switch of the plan widths follows the instance count
    assert (I <= LATENCY_MAX_INSTANCES) == (I in (1, 8))
    assert te.plan.widths == TX.compile_level_plan(tn, instances=I).widths


@pytest.mark.parametrize("name", ["comparator", "trunc"])
def test_keep_wires_matches_jax_executor(nets, name):
    jn, tn = nets[name]
    I = 4
    jg = JX.get_executor(jn, I, "jit", compact=False, garbling=True)
    tg = TX.get_executor(tn, I, "cpu", compact=False, garbling=True)
    src, r = _inputs(jg.plan, I, seed=3)
    jres = [np.asarray(x) for x in jg.garble(src, r, keep_wires=True)]
    tres = tg.garble(_t(src), _t(r), keep_wires=True)
    assert tres[3].shape == (I, tn.num_wires, 4)
    for t_, j_ in zip(tres, jres):
        assert np.array_equal(_u(t_), j_)
    with pytest.raises(ValueError):
        TX.get_executor(tn, I, "cpu").garble(_t(src), _t(r), keep_wires=True)


def test_garble_round_trip_matches_plain_eval(nets):
    _, tn = nets["comparator"]
    rng = np.random.default_rng(5)
    gb = rng.integers(0, 2, (9, len(tn.garbler_inputs)))
    eb = rng.integers(0, 2, (9, len(tn.evaluator_inputs)))
    got = TG.run_garbled(tn, torch.Generator().manual_seed(0), gb, eb,
                         device="cpu")
    assert np.array_equal(got, tn.eval_plain(gb, eb))
