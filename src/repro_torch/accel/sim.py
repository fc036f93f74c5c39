"""Cycle-level model of the APINT / HAAC GC accelerators (§3.4, Fig. 10).

16 cores, each a pipelined PE (Half-Gate 18 cy eval / 21 cy garble, FreeXOR
1 cy), a Wire Memory (128 KiB = 8192 labels), an OoRW prefetch buffer and a
shared DRAM channel. Per instruction the model accounts:

  * pipeline stalls — waiting for an in-flight producer (wire dependency);
  * memory stalls   — waiting for an OoRW or a garbled-table line from DRAM.

DRAM: bandwidth-shared bus (bytes/cycle) with a fixed per-burst latency.
Coarse-grained scheduling makes the per-core streams identical, so the 16
concurrent requests of one instruction slot coalesce into one burst
(row-locality); without it every request pays the burst overhead alone —
this reproduces the paper's bandwidth-utilization argument (Fig. 6).

The model is parameterized, not RTL; EXPERIMENTS.md validates the paper's
*relative* claims (stall reductions, OoRW/DRAM counts, energy ratios).

A copy of the JAX package's ``accel/sim.py`` (numpy only) with
its imports rewritten: orders, programs and reports of a netlist are
the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.netlist import Netlist, OP_AND, OP_INV, OP_XOR
from repro_torch.sched.speculation import SpecProgram

HALFGATE_EVAL_CY = 18
HALFGATE_GARBLE_CY = 21
FREEXOR_CY = 1
TABLE_BYTES = 32
LABEL_BYTES = 16


@dataclass
class AccelConfig:
    num_cores: int = 16
    wire_mem_kb: int = 128
    dram_bytes_per_cycle: float = 64.0  # HBM2-class @ compute clock
    dram_burst_latency: int = 24  # cycles per independent burst
    coalesced: bool = True  # coarse-grained: aligned cross-core requests
    garbling: bool = False

    @property
    def capacity_wires(self) -> int:
        return self.wire_mem_kb * 1024 // LABEL_BYTES


@dataclass
class SimResult:
    cycles: int = 0
    compute_cycles: int = 0
    pipeline_stall_cycles: int = 0
    memory_stall_cycles: int = 0
    dram_bytes: int = 0
    oorw_count: int = 0
    dram_accesses: int = 0
    per_core_cycles: List[int] = field(default_factory=list)

    def merge_parallel(self, other: "SimResult") -> "SimResult":
        out = SimResult()
        out.cycles = max(self.cycles, other.cycles)
        out.compute_cycles = self.compute_cycles + other.compute_cycles
        out.pipeline_stall_cycles = (
            self.pipeline_stall_cycles + other.pipeline_stall_cycles
        )
        out.memory_stall_cycles = (
            self.memory_stall_cycles + other.memory_stall_cycles
        )
        out.dram_bytes = self.dram_bytes + other.dram_bytes
        out.oorw_count = self.oorw_count + other.oorw_count
        out.dram_accesses = self.dram_accesses + other.dram_accesses
        out.per_core_cycles = self.per_core_cycles + other.per_core_cycles
        return out


def _gate_cycles(op: int, garbling: bool) -> int:
    if op == OP_AND:
        return HALFGATE_GARBLE_CY if garbling else HALFGATE_EVAL_CY
    return FREEXOR_CY


def program_compute_cycles(net: Netlist, garbling: bool = False) -> int:
    """Pure PE compute cycles of one instruction stream over ``net``.

    The stall-free floor every schedule is measured against — and the
    accelerator-side twin of ``repro_torch.sched.schedulers.schedule_cost``
    (same per-op latency table: 21 cy garble / 18 cy eval Half-Gate with
    a dense 2-row table write per AND, 1 cy FreeXOR/INV). The regression
    test in ``test_sched`` pins the two models to each other so the
    scheduler can never cost a netlist differently than the simulator
    executes it.
    """
    n_and = int(np.sum(net.op == OP_AND))
    and_cy = HALFGATE_GARBLE_CY if garbling else HALFGATE_EVAL_CY
    return n_and * and_cy + (net.num_gates - n_and) * FREEXOR_CY


def simulate_core(
    net: Netlist,
    prog: SpecProgram,
    cfg: AccelConfig,
    dram_penalty_per_burst: float,
) -> SimResult:
    """One core walking one instruction stream."""
    order = prog.order
    ready_at: Dict[int, float] = {}
    t = 0.0
    res = SimResult()
    bw = cfg.dram_bytes_per_cycle * (
        1.0 if not cfg.coalesced else 1.0 / cfg.num_cores
    )
    # per-core effective bandwidth share: coalesced -> 1/num_cores of the
    # bus but zero extra burst latency; uncoalesced -> full bus contention
    # modeled as burst latency per request (dram_penalty_per_burst).
    for pos in range(len(order)):
        g = int(order[pos])
        op = int(net.op[g])
        # pipeline: wait for producers
        dep_t = 0.0
        for w in (int(net.in0[g]), int(net.in1[g])):
            dep_t = max(dep_t, ready_at.get(w, 0.0))
        stall_pipe = max(0.0, dep_t - t)
        # memory: OoRW fetches + table line for AND gates
        mem_bytes = 0
        bursts = 0
        if prog.is_oorw_read0[pos]:
            mem_bytes += LABEL_BYTES
            bursts += 1
            res.oorw_count += 1
        if prog.is_oorw_read1[pos]:
            mem_bytes += LABEL_BYTES
            bursts += 1
            res.oorw_count += 1
        if op == OP_AND and not cfg.garbling:
            mem_bytes += TABLE_BYTES  # table streamed in
            bursts += 1
        if op == OP_AND and cfg.garbling:
            mem_bytes += TABLE_BYTES  # table streamed out
            bursts += 1
        if prog.live[pos]:
            mem_bytes += LABEL_BYTES
            bursts += 1
        mem_cycles = mem_bytes / max(bw, 1e-9)
        if not cfg.coalesced:
            mem_cycles += bursts * dram_penalty_per_burst
        # prefetching hides table/OoRW latency while compute proceeds;
        # the visible stall is the excess of memory time over compute time
        comp = _gate_cycles(op, cfg.garbling)
        issue = t + stall_pipe
        visible_mem = max(0.0, mem_cycles - comp - stall_pipe)
        t = issue + 1  # pipelined issue
        done = issue + comp + visible_mem
        ready_at[int(net.out[g])] = done
        res.compute_cycles += 1
        res.pipeline_stall_cycles += int(stall_pipe)
        res.memory_stall_cycles += int(visible_mem)
        res.dram_bytes += mem_bytes
        res.dram_accesses += bursts
        t = max(t, done - comp)  # next issue can overlap the tail
    res.cycles = int(t + max(ready_at.values(), default=0) - t)
    res.cycles = int(max(t, max(ready_at.values(), default=t)))
    res.per_core_cycles = [res.cycles]
    return res


def simulate(
    nets: Sequence[Netlist],
    progs: Sequence[SpecProgram],
    cfg: AccelConfig,
) -> SimResult:
    """Synchronous multi-core run: cores process their streams in parallel;
    total latency = max core latency (they share DRAM via the bw model)."""
    assert len(nets) == len(progs)
    per_core: List[SimResult] = []
    for net, prog in zip(nets, progs):
        per_core.append(
            simulate_core(net, prog, cfg, cfg.dram_burst_latency)
        )
    total = SimResult()
    for r in per_core:
        total = total.merge_parallel(r)
    return total
