"""The packed walk records and the walk launch rule, on the CPU.

``core/gc_exec.py::pack_walk`` packs one int32 record per plan chunk and
side; the plain walks (``kernels/level_eval/ref.py``) and the walk
kernels (``csrc/level_eval.cu``) read only those records. These tests
hold the records to the plan they were packed from, show that the
serving plans do exercise the two hazards the kernels' barriers guard
(a chunk committing over a row it reads; pad table rows spilling into
the next chunk's), and check ``walk_shape`` at the serving shapes and
at both ends. The executor's results through the plain walks are held
to the JAX package's in ``test_torch_gc_exec.py``; the kernels to the
plain walks in ``test_torch_cuda.py`` (card only).
"""

import numpy as np
import pytest
import torch

from repro_torch.config import PrivacyConfig
from repro_torch.core import gc_exec as X
from repro_torch.core.netlist import OP_AND, OP_PAD, compile_level_plan
from repro_torch.core.protocol import PiTProtocol
from repro_torch.kernels.level_eval import level_eval as LE
from repro_torch.kernels.level_eval import ref


@pytest.fixture(scope="module")
def nets():
    p = PiTProtocol(PrivacyConfig(), seed=0, device="cpu")
    return {"softmax2": p.softmax_net(2, 24),
            "gelu": p.activation_net("gelu", 24),
            "trunc": p.trunc_net(24)}


def _fields(meta):
    o = ref.walk_offsets(meta.and_width, meta.free_width)
    rec = meta.records.numpy()
    return rec, {k: rec[:, o[a]:o[b]] for k, a, b in (
        ("gather", "gather", "dest"), ("dest", "dest", "tweak"),
        ("tweak", "tweak", "op"), ("op", "op", "extra"))}, o


@pytest.mark.parametrize("garble", [False, True], ids=["evaluate", "garble"])
@pytest.mark.parametrize("instances", [1, 16])
@pytest.mark.parametrize("name", ["softmax2", "gelu", "trunc"])
def test_records_pack_the_plan(nets, name, instances, garble):
    plan = compile_level_plan(nets[name], instances=instances,
                              garbling=garble)
    meta = X.pack_walk(plan, garble, "cpu")
    ca, cf, K = plan.and_width, plan.free_width, plan.n_chunks
    assert meta.records.dtype == torch.int32
    assert meta.records.is_contiguous()
    assert meta.records.shape == (K, ref.walk_stride(ca, cf, garble))
    assert meta.stride % 4 == 0
    assert (meta.store_rows, meta.garble) == (plan.n_rows + 1, garble)
    rec, f, o = _fields(meta)
    end = o["extra"] + (1 if garble else ca)
    assert not rec[:, end:].any()  # padding words are zero
    # every gather row inside the store (R row = n_rows on garble only)
    assert f["gather"].min() >= 0
    assert f["gather"].max() < meta.store_rows - (0 if garble else 1)
    inv = f["gather"][:, 2 * ca + cf:] == plan.n_rows
    assert np.array_equal(inv, (plan.free_inv != 0) if garble
                          else np.zeros_like(inv))
    # commit rows: base + argsort(perm), distinct within each chunk
    assert np.array_equal(f["dest"], plan.base[:, None]
                          + np.argsort(plan.perm, axis=1))
    assert all(len(np.unique(d)) == ca + cf for d in f["dest"])
    assert f["dest"].max() < plan.n_rows
    assert np.array_equal(f["tweak"], plan.and_slot)
    assert np.array_equal(f["op"], np.where(plan.and_slot < plan.n_and,
                                            OP_AND, OP_PAD))
    if garble:
        tb = rec[:, o["extra"]]
        assert np.array_equal(tb, plan.table_base)
        assert meta.table_rows == plan.n_table_rows
        assert tb.min() >= 0 and (tb + ca).max() <= plan.n_table_rows
    else:
        slot = rec[:, o["extra"]:o["extra"] + ca]
        assert meta.table_rows == max(plan.n_and, 1)
        assert slot.min() >= 0 and slot.max() < meta.table_rows
        real = plan.and_slot < plan.n_and
        assert np.array_equal(slot[real], plan.and_slot[real])


@pytest.mark.parametrize("name", ["softmax2", "gelu", "trunc"])
def test_plans_exercise_the_walk_hazards(nets, name):
    """Chunks commit over rows they read themselves (besides the dummy
    row), and pad AND lanes spill table rows into the next chunk's: the
    two orders the walk kernels' barriers keep."""
    for instances in (1, 16):
        plan = compile_level_plan(nets[name], instances=instances,
                                  garbling=True)
        _, f, _ = _fields(X.pack_walk(plan, False, "cpu"))
        dummy = plan.n_rows - 1
        clobbered = sum(
            bool((set(g) & set(d)) - {dummy})
            for g, d in zip(f["gather"], f["dest"]))
        spills = np.sum(plan.table_base[:-1] + plan.and_width
                        > plan.table_base[1:])
        assert clobbered > 0 and spills > 0, (instances, clobbered, spills)


# the serving walks at BERT-base width, 1 layer, S=8 (and, free widths;
# instances) and both ends of the instance range
SHAPES = [(64, 352, 8, False), (8, 8, 6144, False), (8, 8, 512, False),
          (1024, 4096, 8, False), (8, 16, 24_576, False),
          (8, 64, 192, True), (512, 2736, 32, True), (8, 16, 49_152, True),
          (8, 8, 73_728, True), (8, 8, 1, False), (8, 8, 4097, True),
          (1024, 4096, 1, True), (32, 256, 3, False)]


@pytest.mark.parametrize("ca,cf,instances,garble", SHAPES)
def test_walk_shape_rule(ca, cf, instances, garble):
    stride = ref.walk_stride(ca, cf, garble)
    s = LE.walk_shape(ca, cf, stride, instances)
    assert s.cluster in (1, 2, 4, 8)
    assert s.tiles == -(-instances // s.tile)
    assert s.tiles * s.tile >= instances > (s.tiles - 1) * s.tile
    # the cluster's blocks hold every item of a tile
    assert s.per_and * s.cluster >= ca * s.tile
    assert s.per_free * s.cluster >= cf * s.tile
    assert s.smem == 16 * (s.per_and + s.per_free) + 8 * stride
    assert s.smem <= LE.SMEM_MAX
    # one tile per block-pair of SMs at most, and the cluster only where
    # the tiles leave SMs idle
    assert s.tiles <= 2 * LE.SMS or s.tile == instances
    if s.cluster > 1:
        assert s.tiles * s.cluster <= LE.SMS
    if instances <= 8 and ca + cf >= 416:
        assert s.cluster == 8  # softmax8 and LayerNorm at I=8 split 8 ways


def test_walk_shape_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        LE.walk_shape(4096, 16384, ref.walk_stride(4096, 16384, False), 8)
    with pytest.raises(ValueError, match="instance"):
        LE.walk_shape(8, 8, 72, 0)


def test_walk_wrappers_check_operands(nets):
    plan = compile_level_plan(nets["trunc"], instances=2)
    ev = X.pack_walk(plan, False, "cpu")
    ga = X.pack_walk(plan, True, "cpu")
    I = 2
    store = torch.zeros((ev.store_rows, I, 4), dtype=torch.int32)
    tab = torch.zeros((ev.table_rows, I, 4), dtype=torch.int32)
    r = torch.zeros((I, 4), dtype=torch.int32)
    tstore = torch.zeros((ga.table_rows, I, 4), dtype=torch.int32)
    LE.reset_launches()
    LE.eval_walk(ev, store.clone(), tab, tab)
    LE.garble_walk(ga, store.clone(), r, tstore, tstore.clone())
    assert (LE.eval_walk.launches, LE.garble_walk.launches) == (0, 0)
    with pytest.raises(ValueError, match="other side"):
        LE.eval_walk(ga, store, tab, tab)
    with pytest.raises(ValueError, match="rows"):
        LE.eval_walk(ev, store[1:].contiguous(), tab, tab)
    with pytest.raises(ValueError, match="tg_rows"):
        LE.eval_walk(ev, store, tab[:, :1].contiguous(), tab)
    with pytest.raises(TypeError, match="int32"):
        LE.eval_walk(ev, store.long(), tab, tab)
    with pytest.raises(ValueError, match="contiguous"):
        LE.garble_walk(ga, store, r.t().contiguous().t(), tstore, tstore)
    with pytest.raises(ValueError, match="r must be"):
        LE.garble_walk(ga, store, r[:1], tstore, tstore)
    bad = ga._replace(records=ga.records[:, :-4].contiguous())
    with pytest.raises(ValueError, match="widths"):
        LE.garble_walk(bad, store, r, tstore, tstore)
