"""The frozen yardstick against hand-worked cases."""

from __future__ import annotations

import pytest

import pitbench_tiny  # noqa: F401  (puts the checkout on the path)
from pitbench import yardstick as Y

#: AND gates per instance of the netlists at PrivacyConfig() (40-bit t,
#: 12 fractional bits), counted from the program's netlists
SOFTMAX128, GELU, LAYERNORM768, TRUNC = 549_615, 1_499, 858_858, 507


def test_per_lane_operations_and_peaks():
    assert (Y.EVAL_OPS, Y.GARBLE_OPS) == (279, 549)
    assert Y.INT32_OPS_PER_S == 16_727_040_000_000.0
    assert Y.bound_s(3.35e12, 0) == (1.0, "bytes")
    assert Y.bound_s(0, Y.INT32_OPS_PER_S * 2) == (2.0, "operations")


def test_bert_base_s128_garbles_1952_5_million_and_gates():
    # softmax: 12 heads x 128 rows; GeLU: 128 x 3,072; LayerNorm: 2 x 128
    # rows; truncations: q, k, v, wo, w2 at 128 x 768 and 12 heads' outputs
    # at 128 x 64
    work = [(SOFTMAX128, 12 * 128), (GELU, 128 * 3072),
            (LAYERNORM768, 2 * 128), (TRUNC, 5 * 128 * 768 + 12 * 128 * 64)]
    assert Y.and_gates(work) == 1_952_547_840


def test_instance_counts_follow_the_programs_plan():
    from pitbench import harness
    from pitbench import workload as W

    ops = W.frozen(harness.load_spec("bert-base.gc.s128")["ops"])
    per_kind = {}
    for op in ops:
        per_kind[op.kind] = per_kind.get(op.kind, 0) + op.instances
    assert len(ops) == 32
    assert per_kind == {"trunc": 589_824, "softmax": 1_536,
                        "layernorm": 256, "gelu": 393_216}


@pytest.mark.parametrize("cell,n_ops", [
    ("bert-base.gc.s128", 32), ("bert-large.gc.s128", 40),
    ("bert-base.gc.s32", 32)])
def test_frozen_ops_are_the_programs_plan(cell, n_ops):
    from repro_torch.config import PrivacyConfig

    from pitbench import harness
    from pitbench import workload as W

    spec = harness.load_spec(cell)
    ops = W.frozen(spec["ops"])
    planned = W.layer_ops(spec["config"], spec["traffic"]["seq_len"],
                          PrivacyConfig())
    assert len(ops) == n_ops
    assert W.differences(ops, planned) == []


@pytest.mark.parametrize("garble,ops,nbytes", [
    (False, 2 * 279, 10 * 4 + 3 * 16 + 2 * 32 + 16),
    (True, 2 * 549, 10 * 4 + 3 * 16 + 2 * 32 + 16 + 16),
])
def test_walk_bound_counts_each_byte_once(garble, ops, nbytes):
    # one instance of a walk with 10 record words, 3 sources, 2 ANDs and
    # 1 output
    got, _ = Y.walk_bound_s(10, 3, 2, 1, 1, garble)
    assert got == pytest.approx(max(nbytes / Y.HBM_BYTES_PER_S,
                                    ops / Y.INT32_OPS_PER_S))


def test_gc_phase_bound_sums_ops():
    # two ops: (ANDs, inputs, outputs, instances)
    work = [(100, 4, 2, 10), (1, 1, 1, 1000)]
    ands = 100 * 10 + 1 * 1000
    nbytes = 10 * (4 * 16 + 100 * 32 + 2 * 16) + 1000 * (16 + 32 + 16)
    for garble, per in ((False, 279), (True, 549)):
        got, by = Y.gc_phase_bound_s(work, garble)
        want = max(nbytes / Y.HBM_BYTES_PER_S, ands * per / Y.INT32_OPS_PER_S)
        assert got == pytest.approx(want)
        assert by == ("bytes" if nbytes / Y.HBM_BYTES_PER_S
                      >= ands * per / Y.INT32_OPS_PER_S else "operations")
