"""Compiler speculation (§3.4.2): cycle-accurate address pre-assignment.

Given a per-core gate order and a wire-memory capacity, simulate the Wire
Memory and assign, per instruction:

  * write address (blank slot, else evict the LBUW — the Last-to-Be-Used
    Wire, i.e. Belady-optimal replacement),
  * read addresses (in-memory hit or an OoRW fetch from DRAM),
  * Live bit   (an evicted-but-still-needed wire must go to DRAM),
  * OoRW-fetch / WEN bits (transfer timing + overwrite protection).

Two policies:
  * "apint": LBUW eviction; fetched OoRWs are installed in Wire Memory and
    reused by later reads.
  * "haac":  sequential (round-robin) write addresses ignoring reusability;
    fetched OoRWs are consumed once (queue-style) — every out-of-memory
    read is a fresh DRAM fetch. (HAAC §3.4 critique.)

A copy of the JAX package's ``sched/speculation.py`` (numpy only) with
its imports rewritten: orders, programs and reports of a netlist are
the reference's.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.netlist import Netlist, OP_INV

INF = 1 << 60


@dataclass
class SpecStats:
    instructions: int = 0
    oorw_fetches: int = 0
    dram_wire_reads: int = 0
    dram_wire_writes: int = 0  # Live-bit writes
    hits: int = 0
    evictions: int = 0

    @property
    def dram_wire_bytes(self) -> int:
        return 16 * (self.dram_wire_reads + self.dram_wire_writes)


@dataclass
class SpecProgram:
    """Instruction stream annotations for the accelerator model."""

    order: np.ndarray
    is_oorw_read0: np.ndarray  # bool per instr: in0 comes from DRAM
    is_oorw_read1: np.ndarray
    live: np.ndarray  # bool: output must be written to DRAM
    stats: SpecStats = field(default_factory=SpecStats)


def _next_uses(net: Netlist, order: np.ndarray) -> Dict[int, List[int]]:
    uses: Dict[int, List[int]] = {}
    for pos, g in enumerate(order):
        gi = int(g)
        uses.setdefault(int(net.in0[gi]), []).append(pos)
        if net.op[gi] != OP_INV:
            uses.setdefault(int(net.in1[gi]), []).append(pos)
    return uses


def speculate(
    net: Netlist,
    order: np.ndarray,
    capacity_wires: int,
    policy: str = "apint",
) -> SpecProgram:
    assert policy in ("apint", "haac")
    n = len(order)
    uses = _next_uses(net, order)
    use_ptr: Dict[int, int] = {w: 0 for w in uses}

    def next_use(w: int, after: int) -> int:
        lst = uses.get(w)
        if not lst:
            return INF
        i = use_ptr.get(w, 0)
        while i < len(lst) and lst[i] <= after:
            i += 1
        use_ptr[w] = i
        return lst[i] if i < len(lst) else INF

    in_mem: Dict[int, int] = {}  # wire -> slot
    free: List[int] = list(range(capacity_wires))
    heap: List[Tuple[int, int]] = []  # (-next_use, wire) lazy
    in_dram: set = set()
    rr = [0]  # haac round-robin pointer
    slot_wire: Dict[int, Optional[int]] = {}

    st = SpecStats(instructions=n)
    o0 = np.zeros(n, bool)
    o1 = np.zeros(n, bool)
    live = np.zeros(n, bool)
    producer_pos: Dict[int, int] = {}

    def evict_for(pos: int, protect: set) -> int:
        """Free one slot; returns slot id."""
        if free:
            return free.pop()
        st.evictions += 1
        if policy == "apint":
            skipped = []
            while True:
                nu_neg, w = heapq.heappop(heap)
                if w not in in_mem:
                    continue  # stale entry for an evicted wire
                if w in protect:
                    skipped.append((nu_neg, w))
                    continue
                # lazy check: stale next-use?
                actual = next_use(w, pos - 1)
                if -nu_neg != actual:
                    heapq.heappush(heap, (-actual, w))
                    continue
                break
            for item in skipped:
                heapq.heappush(heap, item)
        else:  # haac: sequential overwrite, reusability ignored
            cap = capacity_wires
            for _ in range(cap + 1):
                slot = rr[0] % cap
                rr[0] += 1
                w = slot_wire.get(slot)
                if w is None or w not in protect:
                    break
            if w is None:
                return slot
        slot = in_mem.pop(w)
        # Live: evicted wire still needed later -> must persist to DRAM
        if next_use(w, pos - 1) < INF and w not in in_dram:
            in_dram.add(w)
            st.dram_wire_writes += 1
            p = producer_pos.get(w)
            if p is not None:
                live[p] = True
        return slot

    def install(w: int, slot: int, pos: int):
        in_mem[w] = slot
        slot_wire[slot] = w
        if policy == "apint":
            heapq.heappush(heap, (-next_use(w, pos), w))

    # inputs/constants arrive over the wire into DRAM; the compiler preloads
    # Wire Memory "as much as possible with operable input wires" (§3.4.2),
    # earliest-used first.
    inputs = [int(w) for w in list(net.garbler_inputs)
              + list(net.evaluator_inputs) + list(net.const_bits)]
    for w in inputs:
        in_dram.add(w)
    by_first_use = sorted(
        (uses[w][0], w) for w in inputs if w in uses
    )
    for _, w in by_first_use[:capacity_wires]:
        slot = free.pop()
        install(w, slot, -1)

    for pos in range(n):
        g = int(order[pos])
        ins = [int(net.in0[g])]
        if net.op[g] != OP_INV:
            ins.append(int(net.in1[g]))
        protect = set(ins) | {int(net.out[g])}
        for j, w in enumerate(ins):
            if w in in_mem:
                st.hits += 1
                if policy == "apint":
                    heapq.heappush(heap, (-next_use(w, pos), w))
            else:
                st.oorw_fetches += 1
                st.dram_wire_reads += 1
                (o0 if j == 0 else o1)[pos] = True
                if policy == "apint":
                    slot = evict_for(pos, protect)
                    install(w, slot, pos)
                # haac: consumed once, not installed
        wout = int(net.out[g])
        slot = evict_for(pos, protect)
        install(wout, slot, pos)
        producer_pos[wout] = pos

    return SpecProgram(order=order, is_oorw_read0=o0, is_oorw_read1=o1,
                       live=live, stats=st)
