"""The port's active-label encoding (plain version, through the kernel
wrapper on the CPU) against the JAX package's Pallas kernel in interpret
mode and its dispatch, including words at and above 2^31; and the
protocol's two callers (OT label choice, garbler input encoding) routed
through it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.label_select.label_select import select_labels_pallas
from repro.kernels.label_select.ops import select_labels as j_select
from repro_torch.core import garble as G
from repro_torch.core import ot
from repro_torch.core.circuits import arith
from repro_torch.core.circuits.builder import CircuitBuilder
from repro_torch.kernels.label_select import label_select as LS
from repro_torch.kernels.label_select import select_labels


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u(x):
    return x.numpy().view(np.uint32)


def _words(rng, *shape):
    w = rng.integers(0, 1 << 32, (*shape, 4), dtype=np.uint32)
    w.reshape(-1, 4)[:2] = [[0xFFFFFFFF] * 4, [0x80000000] * 4][:w.size // 4]
    return w


@pytest.mark.parametrize("g", [3, 100, 4097])
def test_matches_pallas_kernel(g):
    rng = np.random.default_rng(g)
    w0, r = _words(rng, g), _words(rng, g)
    bits = rng.integers(0, 2, g).astype(np.uint32)
    want = select_labels_pallas(jnp.asarray(w0), jnp.asarray(r),
                                jnp.asarray(bits), interpret=True)
    assert np.array_equal(_u(select_labels(_t(w0), _t(r), bits)),
                          np.asarray(want))
    assert np.array_equal(_u(select_labels(_t(w0), _t(r), _t(bits))),
                          np.asarray(want))


@pytest.mark.parametrize("r_shape", [(5, 1), (1, 1), (5, 7), (1, 7)])
def test_broadcast_r_matches_dispatch(r_shape):
    rng = np.random.default_rng(sum(r_shape))
    w0 = _words(rng, 5, 7)
    r = _words(rng, *r_shape)
    bits = rng.integers(0, 2, (5, 7)).astype(np.uint32)
    want = j_select(jnp.asarray(w0), jnp.asarray(r), jnp.asarray(bits),
                    impl="pallas_interpret")
    got = select_labels(_t(w0), _t(r), bits)
    assert got.shape == (5, 7, 4)
    assert np.array_equal(_u(got), np.asarray(want))


def test_r_rows_shares_rows_where_it_can():
    lead = (3, 5)
    r = torch.arange(12, dtype=torch.int32).view(3, 1, 4)
    rows, group = LS.r_rows(r, lead)
    assert rows.shape == (3, 4) and group == 5
    rows, group = LS.r_rows(r[:1, 0], lead)  # (1, 4): one R for all
    assert rows.shape == (1, 4) and group == 15
    full = torch.zeros((3, 5, 4), dtype=torch.int32)
    assert LS.r_rows(full, lead)[1] == 1
    rows, group = LS.r_rows(torch.zeros((1, 5, 4), dtype=torch.int32), lead)
    assert rows.shape == (15, 4) and group == 1  # materialised
    with pytest.raises(ValueError, match="broadcast"):
        LS.r_rows(torch.zeros((2, 3, 5, 4), dtype=torch.int32), lead)


def test_refuses_wrong_operands():
    w = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        select_labels(w.long(), w, np.zeros(4))
    with pytest.raises(ValueError):
        select_labels(w[:, :3], w, np.zeros(4))
    assert select_labels.launches == 0  # the CPU runs the plain version


def test_protocol_callers_go_through_select_labels():
    cb = CircuitBuilder("cmp")
    x, y = cb.g_input_word(6), cb.e_input_word(6)
    cb.output(arith.lt_signed(cb, x, y))
    net = cb.build()
    I = 3
    gc = G.garble(net, torch.Generator().manual_seed(0), I, device="cpu")
    rng = np.random.default_rng(0)
    gb = rng.integers(0, 2, (I, len(net.garbler_inputs)))
    eb = rng.integers(0, 2, (I, len(net.evaluator_inputs)))
    zg = G.input_zeros(gc, net.garbler_inputs)
    ze = G.input_zeros(gc, net.evaluator_inputs)
    mask = lambda b: -torch.from_numpy(b.astype(np.int32))[..., None]  # noqa: E731
    assert torch.equal(G.encode_inputs(gc, net.garbler_inputs, gb),
                       zg ^ (gc.r[:, None, :] & mask(gb)))
    assert torch.equal(ot.choose_labels(ze, gc.r[:, None, :], eb),
                       ze ^ (gc.r[:, None, :] & mask(eb)))
    assert np.array_equal(G.run_garbled(net, torch.Generator().manual_seed(1),
                                        gb, eb, device="cpu"),
                          net.eval_plain(gb, eb))
