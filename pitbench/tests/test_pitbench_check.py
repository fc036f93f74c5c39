"""The comparison that decides ``correct``, at a tiny width on the CPU.

One set-up of the tiny cell drives requests through the harness's own
window and check, as a run does, with the card's look skipped: the
program's outputs pass; with the timed path broken underneath (a bit of
an answer flipped where it is produced, half of the batch left out, an
op that hands back its input unchanged) the run is not correct; and the
control, the reference one fractional bit lower in the program's place,
is not correct either, where the reference at the configuration's own
fixed point, in the same place, passes the same check."""

from __future__ import annotations

import numpy as np
import pytest

import pitbench_tiny as tiny
from pitbench import control as CT
from pitbench import harness
from pitbench import workload as W


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain walks' small ops
    try:
        root = tiny.make_checkout(tmp_path_factory.mktemp("ck"))
        yield root, harness.set_up(tiny.args(), device="cpu", root=root)
    finally:
        torch.set_num_threads(threads)


def _flip_bit(out, xc, xs):
    oc, os_ = out
    os_ = os_.copy()
    os_.flat[os_.size // 2] ^= np.uint64(1)
    return oc, os_


def _half_batch(out, xc, xs):
    # the second half of the instances is never evaluated: it repeats
    # the first half's shares
    oc, os_ = (a.copy() for a in out)
    h = oc.shape[0] // 2
    oc[-h:], os_[-h:] = oc[:h], os_[:h]
    return oc, os_


def _unchanged(out, xc, xs):
    n = out[0].shape[1]
    return (np.asarray(xc).reshape(out[0].shape[0], -1)[:, :n].copy(),
            np.asarray(xs).reshape(out[0].shape[0], -1)[:, :n].copy())


@pytest.mark.parametrize("fault,correct", [
    (None, True), (_flip_bit, False), (_half_batch, False),
    (_unchanged, False)], ids=["program", "flipped_bit", "half_batch",
                               "state_unchanged"])
def test_window_outputs_against_the_reference(cell, monkeypatch, fault,
                                              correct):
    _, st = cell
    if fault is not None:
        real = type(st.p).gc_online

        def broken(corr, xc, xs, raw_e=None):
            return fault(real(st.p, corr, xc, xs, raw_e=raw_e), xc, xs)

        monkeypatch.setattr(st.p, "gc_online", broken)
    served, _ = harness.serve_window(st, 0.0)
    got, failed, checks = harness.check(served, st.ops, st.inputs, t=st.t,
                                        frac=st.frac)
    assert got is correct, checks
    # six truncations of 2 x 4, one softmax of 2 x 2, the GeLU over 2 x 4,
    # two LayerNorms of 2 x 4
    assert checks["words_compared"]["value"] == 6 * 8 + 4 + 8 + 2 * 8
    assert (checks["mismatched_words"]["value"] == 0) is correct
    assert failed == (0 if correct else 1)


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**33 + 1])
def test_control_one_fractional_bit_lower_is_not_correct(cell, seed):
    root, st = cell
    got = CT.control(tiny.CELL, seed, root=root)
    assert got["correct"] is False
    assert got["checks"]["mismatched_words"]["value"] > 0
    inputs = W.Inputs(seed, st.t)
    ops = W.frozen(tiny.OPS)
    same = CT.reference_served(ops, inputs, 0, t=st.t, frac=st.frac)
    correct, failed, checks = harness.check([same], ops, inputs, t=st.t,
                                            frac=st.frac)
    assert correct is True and failed == 0, checks
    assert checks["mismatched_words"]["value"] == 0


def test_a_plan_that_departs_from_the_frozen_ops_is_refused(tmp_path):
    ops = [list(op) for op in tiny.OPS]
    ops[7][3] //= 2  # half of the GeLU's instances
    root = tiny.make_checkout(tmp_path / "ck", ops=ops)
    with pytest.raises(harness.SpecError, match="op 7: planned"):
        harness.set_up(tiny.args(), device="cpu", root=root)
