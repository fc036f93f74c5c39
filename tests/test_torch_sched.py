"""The port's scheduling and accelerator model (``repro_torch.sched``,
``repro_torch.accel``) against the JAX package's on the same netlists: the
port builds its copies of the shipped circuit generators, the reference
builds its own, and every gate order, schedule cost, speculation program
(with its ``SpecStats``), simulated run and energy report must be equal —
exactly, since both are the same numpy code. Also the coarse schedule of a
compiled plan (``Plan.coarse_schedule``, ``PrivateServeEngine.
schedule_info``) against the reference's, on the CPU at the reference
tests' toy width; and the level-plan compiler, the GC executor's chunk
schedule, whose walk and row allocator the port rewrote for speed: every
field of every ``LevelPlan`` and every level of ``Netlist.levels`` equal
to the reference's."""

import dataclasses

import numpy as np
import pytest

from repro.accel import energy as JE
from repro.accel import sim as JS
from repro.analysis.netcheck import generator_registry as j_registry
from repro.config import PrivacyConfig as JConfig
from repro.core.circuits import nonlinear as JNL
from repro.core.engine import PrivateTransformer as JModel
from repro.core.engine import random_weights
from repro.core import netlist as JNET
from repro.sched import schedulers as JSC
from repro.sched import speculation as JSP
from repro.serve import PrivateServeEngine as JEngine
from repro_torch.accel import energy as TE
from repro_torch.accel import sim as TS
from repro_torch.analysis.netcheck import generator_registry as t_registry
from repro_torch.config import PrivacyConfig as TConfig
from repro_torch.core.circuits import nonlinear as TNL
from repro_torch.core.engine import PrivateTransformer as TModel
from repro_torch.core.engine import weights_from_reference
from repro_torch.core import netlist as TNET
from repro_torch.core.netlist import OP_AND
from repro_torch.sched import schedulers as TSC
from repro_torch.sched import speculation as TSP
from repro_torch.serve import PrivateServeEngine as TEngine

#: generators whose netlists the schedulers see in serving (softmax,
#: GeLU, LayerNorm) plus an adder and a multiplier; kept small so the
#: cycle model stays seconds-scale
NETS = ["add16", "mul_xfbq16", "softmax4", "gelu", "layernorm_reduced4"]
CAP = 1024  # wire-memory capacity in labels for the speculation runs


def _pair(name):
    if name == "softmax4_k20":  # the reference tests' fixture netlist
        return (JNL.softmax_circuit(4, k=20, frac=8, style="xfbq").build(),
                TNL.softmax_circuit(4, k=20, frac=8, style="xfbq").build())
    return j_registry()[name](), t_registry()[name]()


def _same_net(jn, tn):
    for f in ("op", "in0", "in1", "out", "garbler_inputs",
              "evaluator_inputs", "outputs"):
        assert np.array_equal(getattr(jn, f), getattr(tn, f)), f
    assert jn.num_wires == tn.num_wires and jn.const_bits == tn.const_bits


def _orders(SC, net):
    return {
        "df": SC.depth_first_order(net),
        "fr": SC.full_reorder(net),
        "sr": SC.segment_reorder(net, CAP // 2),
        "fine": SC.fine_grained_order(net, CAP // 2),
        "fine_garble": SC.fine_grained_order(net, CAP // 2, garbling=True),
    }


def _spec(prog):
    return (prog.order, prog.is_oorw_read0, prog.is_oorw_read1, prog.live,
            dataclasses.asdict(prog.stats), prog.stats.dram_wire_bytes)


@pytest.mark.parametrize("name", NETS + ["softmax4_k20"])
def test_schedules_programs_and_simulation_equal_reference(name):
    jn, tn = _pair(name)
    _same_net(jn, tn)
    jo, to = _orders(JSC, jn), _orders(TSC, tn)
    for k in jo:
        assert np.array_equal(jo[k], to[k]), k
        assert TSC.check_topological(tn, to[k]), k
    for garbling in (False, True):
        assert TSC.schedule_cost(tn, garbling=garbling) == \
            JSC.schedule_cost(jn, garbling=garbling)
        assert TS.program_compute_cycles(tn, garbling=garbling) == \
            JS.program_compute_cycles(jn, garbling=garbling)
    n_and = int(np.sum(tn.op == OP_AND))
    for order, policy, coal in (("sr", "haac", False), ("sr", "haac", True),
                                ("fine", "haac", True),
                                ("fine", "apint", True)):
        jp = JSP.speculate(jn, jo[order], CAP, policy=policy)
        tp = TSP.speculate(tn, to[order], CAP, policy=policy)
        for a, b in zip(_spec(jp), _spec(tp)):
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) \
                else a == b, (order, policy)
        jc, tc = JS.AccelConfig(coalesced=coal), TS.AccelConfig(coalesced=coal)
        jr = JS.simulate([jn, jn], [jp, jp], jc)
        tr = TS.simulate([tn, tn], [tp, tp], tc)
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
        assert TE.energy_report(tr, n_and, tn.num_gates - n_and) == \
            JE.energy_report(jr, n_and, jn.num_gates - n_and)


def test_coarse_partition_equals_reference():
    for n, cores in ((37, 16), (5, 16), (64, 8)):
        items = list(range(n))
        assert TSC.coarse_grained_partition(items, cores) == \
            JSC.coarse_grained_partition(items, cores)


@pytest.mark.parametrize("cores", [16, 3])
def test_coarse_schedule_of_a_plan_equals_reference(cores):
    """``Plan.coarse_schedule`` and ``PrivateServeEngine.schedule_info``
    on the same model and bucket: the port's GC-op → core assignment is
    the reference's, and every GC op of the plan lands on exactly one
    core. Compiling a plan builds no netlist, so this stays cheap."""
    D, HEADS, DFF, S = 8, 2, 16, 4
    pcfg = dict(he_poly_n=256, he_num_primes=2, he_t_bits=16, frac_bits=5)
    ws = random_weights(np.random.default_rng(5), D, DFF, 2)
    jm = JModel(JConfig(**pcfg), D, HEADS, DFF, ws, seed=5)
    tm = TModel(TConfig(**pcfg), D, HEADS, DFF, weights_from_reference(ws),
                seed=5, device="cpu")
    je = JEngine(jm, num_cores=cores)
    te = TEngine(tm, num_cores=cores)
    assert te.num_cores == cores
    got = te.schedule_info(S)
    assert got == je.schedule_info(S)
    assert got == te.session(S).plan.coarse_schedule(cores)
    names = [op.name for op in te.session(S).plan.gc_ops()]
    assert sorted(n for core in got for n in core) == sorted(names)
    assert len(got) == min(cores, len(names))


def _rand_pair(seed, n_gates=600):
    """A random netlist (XOR/AND/INV over 8 inputs, wide fanout) in both
    packages: many short-lived and a few long-lived wires, so chunks fill
    unevenly and rows are recycled out of order."""
    rng = np.random.default_rng(seed)
    n_in = 8
    op = rng.choice([0, 1, 2], n_gates, p=[0.45, 0.45, 0.1]).astype(np.uint8)
    in0 = np.empty(n_gates, np.int32)
    in1 = np.empty(n_gates, np.int32)
    for g in range(n_gates):
        hi = n_in + g
        lo = max(0, hi - 40) if rng.random() < 0.8 else 0
        in0[g] = rng.integers(lo, hi)
        in1[g] = in0[g] if op[g] == 2 else rng.integers(lo, hi)
    kw = dict(num_wires=n_in + n_gates, op=op, in0=in0, in1=in1,
              out=np.arange(n_in, n_in + n_gates, dtype=np.int32),
              garbler_inputs=np.arange(4, dtype=np.int32),
              evaluator_inputs=np.arange(4, 8, dtype=np.int32),
              outputs=np.arange(n_in + n_gates - 16, n_in + n_gates,
                                dtype=np.int32), name=f"rand{seed}")
    return JNET.Netlist(**kw), TNET.Netlist(**kw)


def _same_plan(jp, tp):
    for f in dataclasses.fields(jp):
        if f.name in ("_executors", "_net"):
            continue
        a, b = getattr(tp, f.name), getattr(jp, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("name", ["softmax4_k20", "gelu",
                                  "layernorm_reduced4", "rand0", "rand1"])
def test_level_plans_equal_reference(name):
    jn, tn = _rand_pair(int(name[-1])) if name.startswith("rand") \
        else _pair(name)
    jl, tl = jn.levels(), tn.levels()
    assert len(tl) == len(jl)
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(tl, jl))
    configs = [dict(instances=i, garbling=g) for i in (1, 8, 64, 4096)
               for g in (False, True)]
    configs += [dict(and_width=8, free_width=8), dict(and_width=16,
                                                      free_width=24)]
    for kw in configs:
        for compact in (True, False):
            _same_plan(JNET.compile_level_plan(jn, compact=compact, **kw),
                       TNET.compile_level_plan(tn, compact=compact, **kw))
