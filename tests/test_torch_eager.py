"""The port's eager path against the JAX package's, at the same seed and
on the same inputs: ``PrivateTransformer.forward_private`` (revealed
output bit for bit, every metered byte equal), the protocol's six
single-call wrappers (both output shares bit for bit), ``const_labels``,
and the Bristol Fashion codec (the same text for the same netlist, and a
round trip). The JAX protocol evaluates through its host oracle
(``impl="ref"``), the port's on the CPU through the kernels' plain
versions. Tolerance 0: shares are integers mod t."""

import numpy as np
import pytest
import torch

from repro.config import PrivacyConfig as JConfig
from repro.core.circuits import arith as JA
from repro.core.circuits import bristol as JBristol
from repro.core.circuits.builder import CircuitBuilder as JB
from repro.core.engine import PrivateTransformer as JModel
from repro.core.engine import random_weights
from repro.core.protocol import PiTProtocol as JProtocol
from repro_torch.analysis import NetlistError
from repro_torch.config import PrivacyConfig as TConfig
from repro_torch.core import garble as TG
from repro_torch.core import secret_sharing as SS
from repro_torch.core.circuits import arith as TA
from repro_torch.core.circuits import bristol as TBristol
from repro_torch.core.circuits.builder import CircuitBuilder as TB
from repro_torch.core.engine import PrivateTransformer as TModel
from repro_torch.core.engine import weights_from_reference
from repro_torch.core.protocol import PiTProtocol as TProtocol

D, HEADS, DFF, S = 8, 2, 16, 4
PCFG = dict(he_poly_n=256, he_num_primes=3, he_t_bits=40, frac_bits=6)


@pytest.fixture(scope="module")
def eager():
    ws = random_weights(np.random.default_rng(0), D, DFF, 1)
    jm = JModel(JConfig(**PCFG), D, HEADS, DFF, ws, seed=0)
    tm = TModel(TConfig(**PCFG), D, HEADS, DFF, weights_from_reference(ws),
                seed=0, device="cpu")
    x = np.random.default_rng(1).normal(0, 1, (S, D))
    return dict(jm=jm, tm=tm, x=x, jy=jm.forward_private(x),
                ty=tm.forward_private(x))


def test_forward_private_bit_identical(eager):
    assert eager["ty"].shape == (S, D)
    assert np.array_equal(eager["ty"], eager["jy"])
    want = eager["tm"].forward_float(eager["x"])
    assert np.abs(eager["ty"] - want).max() < 0.25


def test_forward_private_meters_the_same_bytes(eager):
    j, t = eager["jm"].p.stats, eager["tm"].p.stats
    assert t.comm_snapshot() == j.comm_snapshot()
    assert t.per_fn == j.per_fn
    assert t.gc_instances_ands == j.gc_instances_ands > 0


def _shares(p, seed, shape, scale):
    rng = np.random.default_rng(seed)
    enc = SS.encode_fx(rng.normal(0, 1, shape), scale, p.t)
    return SS.share(rng, enc, p.t)


def _call(p, name):
    f = p.frac
    if name == "matmul_private":
        xc, xs = _shares(p, 1, (S, 3), f)
        yc, ys = _shares(p, 2, (3, 2), f)
        return p.matmul_private(xc, xs, yc, ys)
    if name == "gc_apply":
        xc, xs = _shares(p, 3, (5, 1), 2 * f)
        return p.gc_apply(p.trunc_net(2 * f), xc, xs, 1)
    if name == "softmax_rows":
        xc, xs = _shares(p, 4, (3, S), 2 * f)
        return p.softmax_rows(xc, xs, S, in_scale=2 * f)
    if name == "activation":
        xc, xs = _shares(p, 5, (S, 2), 2 * f)
        return p.activation("gelu", xc, xs, in_scale=2 * f)
    if name == "trunc":
        xc, xs = _shares(p, 6, (S, 3), 2 * f)
        return p.trunc(xc, xs, 2 * f)
    xc, xs = _shares(p, 7, (2, D), f)
    rng = np.random.default_rng(8)
    gamma, beta = rng.normal(1, 0.1, D), rng.normal(0, 0.1, D)
    return p.layernorm(xc, xs, gamma, beta, in_scale=f)


@pytest.mark.parametrize("name", ["matmul_private", "gc_apply",
                                  "softmax_rows", "activation", "trunc",
                                  "layernorm"])
def test_wrapper_matches_reference(name):
    jp = JProtocol(JConfig(**PCFG), seed=11)
    tp = TProtocol(TConfig(**PCFG), seed=11, device="cpu")
    (jc, js), (tc, ts) = _call(jp, name), _call(tp, name)
    assert np.array_equal(tc, np.asarray(jc)) and np.array_equal(ts, js)
    assert tp.stats.comm_snapshot() == jp.stats.comm_snapshot()


def test_const_labels_are_the_constants_active_labels():
    cb = TB("adder")
    a, b = cb.g_input_word(4), cb.e_input_word(4)
    cb.output(TA.add(cb, a, TA.add(cb, b, cb.const_word(0b1010, 4))))
    net = cb.build()
    gc = TG.garble(net, torch.Generator().manual_seed(3), 2, device="cpu")
    got = TG.const_labels(gc)
    assert sorted(got) == sorted(int(w) for w in net.const_bits)
    for w, lab in got.items():
        zero = TG.input_zeros(gc, [w])[:, 0]
        want = zero ^ gc.r if net.const_bits[w] else zero
        assert lab.shape == (2, 4) and torch.equal(lab, want)


def _cmp(CB, A):
    cb = CB("cmp")
    a, b = cb.g_input_word(6), cb.e_input_word(6)
    lt = A.lt_signed(cb, a, b)
    cb.output(A.mux(cb, lt, a, cb.const_word(5, 6)))
    cb.output(cb.INV(lt))
    return cb.build()


def test_bristol_emits_the_reference_text_and_round_trips():
    tnet, jnet = _cmp(TB, TA), _cmp(JB, JA)
    text = TBristol.emit(tnet)
    assert text == JBristol.emit(jnet)
    back = TBristol.parse(text, name="cmp")
    for f in ("op", "in0", "in1", "out", "garbler_inputs",
              "evaluator_inputs", "outputs"):
        assert np.array_equal(getattr(back, f),
                              getattr(JBristol.parse(text), f)), f
    assert back.const_bits == JBristol.parse(text).const_bits
    assert TBristol.emit(back) == text
    rng = np.random.default_rng(0)
    g = rng.integers(0, 2, (16, len(tnet.garbler_inputs)))
    e = rng.integers(0, 2, (16, len(tnet.evaluator_inputs)))
    assert np.array_equal(back.eval_plain(g, e), tnet.eval_plain(g, e))


def test_bristol_parse_refuses_malformed_files():
    text = TBristol.emit(_cmp(TB, TA)).splitlines()
    gates = [i for i, ln in enumerate(text) if ln.endswith("AND")]
    bad = list(text)
    bad[gates[0]] = bad[gates[0]].replace("AND", "NAND")
    with pytest.raises(ValueError, match="unsupported gate"):
        TBristol.parse("\n".join(bad))
    swapped = list(text)  # a gate that reads a wire before it is driven
    swapped[gates[0]], swapped[gates[-1]] = swapped[gates[-1]], \
        swapped[gates[0]]
    with pytest.raises(NetlistError, match="not topological"):
        TBristol.parse("\n".join(swapped))
    TBristol.parse("\n".join(swapped), verify=False)
