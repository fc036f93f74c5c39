"""Netlist scheduling (§3.3): gate orderings fed to the accelerator model.

  depth_first_order   — EMP-tool style (the builder's natural emission order)
  full_reorder        — HAAC FR: global BFS levelization
  segment_reorder     — HAAC SR: DF segments (half wire-memory each) with FR
                        applied inside every segment
  fine_grained_order  — APINT: DF segments + Critical-Path-First-Execution
                        (recursive critical-path priorities [34, 35]) +
                        cycle-accurate list scheduling inside each segment
  coarse_grained_partition — APINT coarse scheduling: one independent unit
                        operation (e.g. a softmax row) per core

All return gate-index permutations of the netlist (and per-core lists for
the coarse partition); correctness = every permutation is topological.

A copy of the JAX package's ``sched/schedulers.py`` (numpy only) with
its imports rewritten: orders, programs and reports of a netlist are
the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.netlist import Netlist, OP_AND, OP_INV, OP_XOR

# the paper's PE latencies; values must match accel/sim.py (which cannot
# be imported here — accel.sim already imports repro_torch.sched)
HALFGATE_EVAL_CY = 18
HALFGATE_GARBLE_CY = 21


def gate_cycles(garbling: bool = False) -> Dict[int, int]:
    """Per-op cycle weights for schedule costing.

    Garbling pays 21 cy per Half-Gate AND (4 hash lanes) vs 18 cy for
    evaluation (2 lanes) — a garble-side schedule costed with the eval
    table underestimates every AND on the critical path by ~17%.
    """
    return {
        OP_AND: HALFGATE_GARBLE_CY if garbling else HALFGATE_EVAL_CY,
        OP_XOR: 1,
        OP_INV: 1,
    }


# compatibility view: the evaluation-side table (pre-garbling-aware API)
GATE_CYCLES = gate_cycles(garbling=False)


def schedule_cost(net: Netlist, garbling: bool = False) -> int:
    """Total PE compute cycles of a schedule under :func:`gate_cycles`.

    Schedule-independent (every topological order issues each gate once);
    what matters is the latency table. The 21 cy/AND garble constant
    assumes a *dense* table write — exactly 2 rows per real AND gate.
    That assumption now matches the device executor bit for bit: packed
    table emission writes ``table_base[k] + lane`` rows, one per valid
    AND lane (the old ys-stack emission amortized K×and_width padded
    rows per walk, i.e. MORE than 2 rows per AND at preprocessing
    scale, which this costing never modeled). ``accel/sim.py`` prices
    the same dense write per AND (TABLE_BYTES streamed out);
    ``test_sched`` pins the two models to each other.
    """
    cyc = gate_cycles(garbling)
    ops = net.op
    return int(sum(int(np.sum(ops == op)) * c for op, c in cyc.items()))


def depth_first_order(net: Netlist) -> np.ndarray:
    return np.arange(net.num_gates, dtype=np.int64)


def full_reorder(net: Netlist) -> np.ndarray:
    levels = net.levels()
    if not levels:
        return np.empty(0, np.int64)
    return np.concatenate(levels).astype(np.int64)


def _segments(net: Netlist, seg_gates: int) -> List[np.ndarray]:
    order = np.arange(net.num_gates, dtype=np.int64)
    return [order[i: i + seg_gates] for i in range(0, len(order), seg_gates)]


def segment_reorder(net: Netlist, seg_gates: int) -> np.ndarray:
    """HAAC SR: FR (levelize) within each DF segment."""
    out = []
    for seg in _segments(net, seg_gates):
        out.append(_levelize_subset(net, seg))
    return np.concatenate(out) if out else np.empty(0, np.int64)


def _levelize_subset(net: Netlist, seg: np.ndarray) -> np.ndarray:
    """BFS levels of the sub-DAG induced by `seg` (external inputs ready)."""
    in_seg = {int(g): i for i, g in enumerate(seg)}
    prod = {}  # wire -> producing gate within segment
    for g in seg:
        prod[int(net.out[g])] = int(g)
    level: Dict[int, int] = {}
    order = []
    for g in seg:
        gi = int(g)
        lv = 0
        for w in (net.in0[gi], net.in1[gi]):
            pw = prod.get(int(w))
            if pw is not None:
                lv = max(lv, level[pw] + 1)
        level[gi] = lv
    segl = sorted((level[int(g)], int(g)) for g in seg)
    return np.array([g for _, g in segl], dtype=np.int64)


# ---------------------------------------------------------------------------
# CPFE (fine-grained)
# ---------------------------------------------------------------------------


def _cpfe_priorities(net: Netlist, seg: np.ndarray,
                     cycles: Dict[int, int] = None) -> Dict[int, int]:
    """Recursive critical-path priorities within one segment.

    Lower rank = scheduled first among operable gates. ``cycles`` is the
    PE latency table (:func:`gate_cycles`); defaults to evaluation.
    """
    cycles = cycles if cycles is not None else GATE_CYCLES
    seg = [int(g) for g in seg]
    seg_set = set(seg)
    prod = {int(net.out[g]): g for g in seg}
    children: Dict[int, List[int]] = {g: [] for g in seg}
    parents: Dict[int, List[int]] = {g: [] for g in seg}
    for g in seg:
        for w in (int(net.in0[g]), int(net.in1[g])):
            p = prod.get(w)
            if p is not None and p != g:
                parents[g].append(p)
                children[p].append(g)

    weight = {g: cycles[int(net.op[g])] for g in seg}
    rank: Dict[int, int] = {}
    counter = [0]

    def longest_path(nodes: List[int]) -> List[int]:
        """Critical (max-weight) path within `nodes` (already topological)."""
        nset = set(nodes)
        dist: Dict[int, int] = {}
        pred: Dict[int, int] = {}
        best, best_d = None, -1
        for g in nodes:  # nodes kept in topological (emission) order
            d = weight[g]
            for p in parents[g]:
                if p in nset and dist.get(p, -1) + weight[g] > d:
                    d = dist[p] + weight[g]
                    pred[g] = p
            dist[g] = d
            if d > best_d:
                best, best_d = g, d
        path = []
        cur = best
        while cur is not None:
            path.append(cur)
            cur = pred.get(cur)
        return list(reversed(path))

    def descendants(g: int, allowed: set) -> List[int]:
        out, stack, seen = [], [c for c in children[g]], set()
        while stack:
            n = stack.pop()
            if n in seen or n not in allowed or n in rank:
                continue
            seen.add(n)
            out.append(n)
            stack.extend(children[n])
        return sorted(out)  # emission order = topological

    def assign(nodes: List[int]):
        nodes = [n for n in nodes if n not in rank]
        if not nodes:
            return
        path = longest_path(nodes)
        for g in path:
            if g not in rank:
                rank[g] = counter[0]
                counter[0] += 1
        allowed = set(nodes)
        for g in path:
            sub = descendants(g, allowed)
            assign(sub)

    assign(seg)
    for g in seg:  # stragglers (disconnected)
        if g not in rank:
            rank[g] = counter[0]
            counter[0] += 1
    return rank


def fine_grained_order(net: Netlist, seg_gates: int,
                       garbling: bool = False) -> np.ndarray:
    """Segmentation + CPFE + cycle-accurate list scheduling (§3.3.2).

    ``garbling=True`` costs the schedule with the garble-side PE latency
    (21 cy per AND, matching ``accel/sim.py``) so offline/preprocessing
    schedules are priced correctly; the default is evaluation (18 cy).
    """
    cycles = gate_cycles(garbling)
    out = []
    for seg in _segments(net, seg_gates):
        rank = _cpfe_priorities(net, seg, cycles)
        order = _list_schedule(net, seg, rank, cycles)
        out.append(order)
    return np.concatenate(out) if out else np.empty(0, np.int64)


def _list_schedule(net: Netlist, seg: np.ndarray, rank: Dict[int, int],
                   cycles: Dict[int, int] = None) -> np.ndarray:
    """Pick the operable gate with the best CPFE rank each issue slot,
    modeling the PE latency: a gate's output is ready ``cycles[op]`` after
    issue; a gate is operable when both in-segment producers are done."""
    import heapq

    cycles = cycles if cycles is not None else GATE_CYCLES

    seg = [int(g) for g in seg]
    prod = {int(net.out[g]): g for g in seg}
    remaining: Dict[int, int] = {}
    children: Dict[int, List[int]] = {g: [] for g in seg}
    for g in seg:
        deps = 0
        for w in (int(net.in0[g]), int(net.in1[g])):
            p = prod.get(w)
            if p is not None and p != g:
                deps += 1
                children[p].append(g)
        if int(net.op[g]) == OP_INV:
            # single input counted twice when in1 == in0
            pass
        remaining[g] = deps

    ready = [(rank[g], g) for g in seg if remaining[g] == 0]
    heapq.heapify(ready)
    # events: (completion_time, gate)
    t = 0
    order = []
    pending: List[Tuple[int, int]] = []
    done = set()
    while ready or pending:
        if ready:
            _, g = heapq.heappop(ready)
            t += 1  # one issue slot per cycle
            fin = t + cycles[int(net.op[g])]
            heapq.heappush(pending, (fin, g))
            order.append(g)
        else:
            # stall until next completion
            fin, g = heapq.heappop(pending)
            t = max(t, fin)
            done.add(g)
            for c in children[g]:
                remaining[c] -= 1
                if remaining[c] == 0:
                    heapq.heappush(ready, (rank[c], c))
            continue
        # retire completions at current time
        while pending and pending[0][0] <= t:
            fin, g2 = heapq.heappop(pending)
            done.add(g2)
            for c in children[g2]:
                remaining[c] -= 1
                if remaining[c] == 0:
                    heapq.heappush(ready, (rank[c], c))
    return np.array(order, dtype=np.int64)


# ---------------------------------------------------------------------------
# coarse-grained partition
# ---------------------------------------------------------------------------


def coarse_grained_partition(nets: Sequence[Netlist], num_cores: int
                             ) -> List[List[int]]:
    """Map independent unit operations (row circuits) onto cores
    round-robin: core i gets rows i, i+C, ... (§3.3.1)."""
    assign: List[List[int]] = [[] for _ in range(num_cores)]
    for i in range(len(nets)):
        assign[i % num_cores].append(i)
    return assign


def check_topological(net: Netlist, order: np.ndarray) -> bool:
    pos = {int(net.out[g]): i for i, g in enumerate(order)}
    for i, g in enumerate(order):
        for w in (int(net.in0[g]), int(net.in1[g])):
            if w in pos and pos[w] > i:
                return False
    return True
