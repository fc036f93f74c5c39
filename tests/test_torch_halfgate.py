"""The port's plain Half-Gate cipher (int32 torch) against the JAX
package's jnp oracle and its numpy mirror, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.halfgate import ref as HJ
from repro.kernels.halfgate import ref_np as HN
from repro_torch.kernels.halfgate import ref as HT

N = 10_000


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u(x):
    return x.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(7)
    a, b, tg, te = (rng.integers(0, 1 << 32, (N, 4), dtype=np.uint32)
                    for _ in range(4))
    # words at and above 2^31 (negative as int32) and the edge values
    a[:4] = [[0xFFFFFFFF] * 4, [0x80000000] * 4, [0x7FFFFFFF] * 4, [0] * 4]
    assert (a >= 1 << 31).any() and (b >= 1 << 31).any()
    tw = rng.integers(0, 1 << 32, (N,), dtype=np.uint32)
    tw[:3] = [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    r = rng.integers(0, 1 << 32, (1, 4), dtype=np.uint32)
    r[:, 0] |= 1
    return dict(a=a, b=b, tg=tg, te=te, tw=tw, r=r)


def _cases(v):
    return {
        "arx_perm": ((v["a"],), HT.arx_perm, HJ.arx_perm, HN.arx_perm),
        "expand_tweak": ((v["tw"],), HT.expand_tweak, HJ.expand_tweak,
                         HN.expand_tweak),
        "hash_labels": ((v["a"], v["tw"]), HT.hash_labels, HJ.hash_labels,
                        HN.hash_labels),
        "garble_and_gates": ((v["a"], v["b"], v["r"], v["tw"]),
                             HT.garble_and_gates, HJ.garble_and_gates,
                             HN.garble_and_gates),
        "eval_and_gates": ((v["a"], v["b"], v["tg"], v["te"], v["tw"]),
                           HT.eval_and_gates, HJ.eval_and_gates,
                           HN.eval_and_gates),
    }


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("oracle", ["jnp", "numpy"])
@pytest.mark.parametrize("fn", ["arx_perm", "expand_tweak", "hash_labels",
                                "garble_and_gates", "eval_and_gates"])
def test_plain_cipher_matches_reference(blocks, fn, oracle):
    args, port, ref_jnp, ref_np = _cases(blocks)[fn]
    got = _flat(port(*(_t(x) for x in args)))
    if oracle == "jnp":
        want = _flat(ref_jnp(*(jnp.asarray(x) for x in args)))
    else:
        want = _flat(ref_np(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(_u(g), np.asarray(w, np.uint32))


def test_arx_perm_keeps_leading_shape(blocks):
    x = blocks["a"].reshape(100, 25, 4, 4).transpose(0, 2, 1, 3)
    got = HT.arx_perm(torch.from_numpy(x.view(np.int32)))  # non-contiguous
    assert got.shape == x.shape
    assert np.array_equal(_u(got.contiguous()), HN.arx_perm(x))


def test_as_i32_round_trips_constants():
    for c in HT.RC:
        v = HT.as_i32(c)
        assert -(1 << 31) <= v < (1 << 31)
        assert np.array([v], np.int32).view(np.uint32)[0] == c


# ---------------------------------------------------------------------------
# the entry points (repro_torch.kernels.halfgate) against the Pallas
# kernels in interpret mode and their dispatch
# ---------------------------------------------------------------------------

from repro.kernels.halfgate import ops as HO  # noqa: E402
from repro.kernels.halfgate.halfgate import eval_pallas, garble_pallas  # noqa: E402
from repro_torch.kernels import halfgate as HP  # noqa: E402
from repro_torch.kernels.halfgate import halfgate as HK  # noqa: E402


@pytest.mark.parametrize("g", [1, 777, 2049])
def test_gate_kernels_match_pallas(blocks, g):
    a, b, tg, te, tw = (blocks[k][:g] for k in ("a", "b", "tg", "te", "tw"))
    r = np.broadcast_to(blocks["r"], (g, 4)).copy()
    want = garble_pallas(*(jnp.asarray(x) for x in (a, b, r, tw)),
                         interpret=True)
    got = HK.garble_gates(_t(a), _t(b), _t(r), _t(tw))
    assert all(np.array_equal(_u(x), np.asarray(y)) for x, y in zip(got, want))
    want = eval_pallas(*(jnp.asarray(x) for x in (a, b, tg, te, tw)),
                       interpret=True)
    got = HK.eval_gates(_t(a), _t(b), _t(tg), _t(te), _t(tw))
    assert np.array_equal(_u(got), np.asarray(want))


def test_entry_points_broadcast_as_the_dispatch_does(blocks):
    lead = (10, 50)
    a, b, tg, te = (blocks[k][:500].reshape(*lead, 4)
                    for k in ("a", "b", "tg", "te"))
    r = blocks["r"].reshape(1, 1, 4)  # one R for every gate
    tw = blocks["tw"][:50]  # one tweak per column, broadcast over rows
    want = HO.garble_and_gates(*(jnp.asarray(x) for x in (a, b, r, tw)),
                               impl="pallas_interpret")
    got = HP.garble_and_gates(_t(a), _t(b), _t(r), _t(tw))
    assert all(x.shape == (*lead, 4) for x in got)
    assert all(np.array_equal(_u(x), np.asarray(y)) for x, y in zip(got, want))
    want = HO.eval_and_gates(*(jnp.asarray(x) for x in (a, b, tg, te, tw)),
                             impl="pallas_interpret")
    got = HP.eval_and_gates(_t(a), _t(b), _t(tg), _t(te), _t(tw))
    assert np.array_equal(_u(got), np.asarray(want))
    assert np.array_equal(
        _u(HP.hash_labels(_t(a), _t(tw))),
        np.asarray(HO.hash_labels(jnp.asarray(a), jnp.asarray(tw))))


def test_gate_wrappers_refuse_wrong_operands(blocks):
    a = _t(blocks["a"][:8])
    tw = _t(blocks["tw"][:8])
    with pytest.raises(TypeError, match="int32"):
        HK.eval_gates(a.long(), a, a, a, tw)
    with pytest.raises(ValueError, match="expected \\(8,\\)"):
        HK.garble_gates(a, a, a, tw[:7])
    with pytest.raises(ValueError, match="contiguous"):
        HK.eval_gates(a, a, a, a, _t(blocks["tw"][:16])[::2])
    assert (HK.garble_gates.launches, HK.eval_gates.launches) == (0, 0)
