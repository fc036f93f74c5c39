"""Netlist: the gate-level DAG consumed by garbling, scheduling and the
accelerator simulator.

Gate ops: 0 = XOR, 1 = AND, 2 = INV. Wires are dense ints. Constants are
garbler-supplied input wires with recorded bits (free under garbling).
Gates are stored in topological order (the builder emits them that way).

The JAX package's ``core/netlist.py`` with its imports rewritten, except
that the level walk (``Netlist.levels``) and the level-plan compiler's
chunk scheduler and row allocator (``_schedule_chunks``,
``_first_window``) are the port's own faster versions: they run the
walks on Python lists, skip full chunks through pointers and find a
free row window without scanning every offset, and produce every field
of every ``LevelPlan`` exactly as the reference does
(``tests/test_torch_sched.py`` holds them to it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

OP_XOR, OP_AND, OP_INV = 0, 1, 2
OP_PAD = 3  # padding lane in a compiled level plan (reads/writes dummies)
OP_NAMES = {OP_XOR: "XOR", OP_AND: "AND", OP_INV: "INV", OP_PAD: "PAD"}


@dataclass
class Netlist:
    num_wires: int
    op: np.ndarray  # (G,) uint8
    in0: np.ndarray  # (G,) int32
    in1: np.ndarray  # (G,) int32 (INV: == in0)
    out: np.ndarray  # (G,) int32
    garbler_inputs: np.ndarray  # wire ids
    evaluator_inputs: np.ndarray
    outputs: np.ndarray
    const_bits: Dict[int, int] = field(default_factory=dict)  # wire -> 0/1
    name: str = ""

    # ---- stats -----------------------------------------------------------
    @property
    def num_gates(self) -> int:
        return len(self.op)

    @property
    def and_count(self) -> int:
        return int(np.sum(self.op == OP_AND))

    @property
    def xor_count(self) -> int:
        return int(np.sum(self.op == OP_XOR))

    @property
    def inv_count(self) -> int:
        return int(np.sum(self.op == OP_INV))

    def stats(self) -> Dict:
        lv = self.levels()
        st = {
            "name": self.name,
            "wires": self.num_wires,
            "gates": self.num_gates,
            "and": self.and_count,
            "xor": self.xor_count,
            "inv": self.inv_count,
            "depth": len(lv),
            "max_level_width": max((len(l) for l in lv), default=0),
            "garbled_table_bytes": self.and_count * 32,  # 2 rows x 16B
        }
        # dataflow counters (dead/foldable/duplicate gates, removable
        # ANDs) from the static analyzer — the measurement front-end of
        # the AND-minimization work; cached on the netlist
        from repro_torch.analysis.netcheck import dataflow_summary
        st.update(dataflow_summary(self))
        return st

    # ---- levelization (TPU-plane schedule) --------------------------------
    def levels(self) -> List[np.ndarray]:
        """Topological layers of gate indices: every gate's inputs are
        produced strictly earlier. This is the level-synchronous schedule the
        TPU plane evaluates (gather -> cipher -> scatter per level)."""
        # the walk runs on Python lists: indexing a numpy array one
        # element at a time costs several times more
        op, in0 = self.op.tolist(), self.in0.tolist()
        in1, outw = self.in1.tolist(), self.out.tolist()
        wire_level = [0] * self.num_wires
        gate_level = [0] * self.num_gates
        for g in range(self.num_gates):
            lv = wire_level[in0[g]]
            if op[g] != OP_INV:
                lb = wire_level[in1[g]]
                if lb > lv:
                    lv = lb
            lv += 1
            gate_level[g] = lv
            wire_level[outw[g]] = lv
        if not self.num_gates:
            return []
        # every level from 1 to the deepest holds a gate (a gate at level
        # L reads a wire of level L - 1), listed in gate order
        gl = np.asarray(gate_level, np.int32)
        order = np.argsort(gl, kind="stable").astype(np.int32)
        cuts = np.cumsum(np.bincount(gl)[1:])[:-1]
        return [lv for lv in np.split(order, cuts) if len(lv)]

    def and_gate_index(self) -> np.ndarray:
        """Per-gate index among AND gates (for garbled-table addressing)."""
        idx = np.cumsum(self.op == OP_AND) - 1
        return idx.astype(np.int32)

    # ---- plaintext oracle --------------------------------------------------
    def eval_plain(self, garbler_bits: np.ndarray, evaluator_bits: np.ndarray):
        """Vectorized plaintext evaluation.

        garbler_bits: (I, len(garbler_inputs)); evaluator_bits likewise.
        Returns (I, len(outputs)) uint8.
        """
        garbler_bits = np.atleast_2d(np.asarray(garbler_bits, np.uint8))
        evaluator_bits = np.atleast_2d(np.asarray(evaluator_bits, np.uint8))
        I = garbler_bits.shape[0]
        w = np.zeros((I, self.num_wires), np.uint8)
        if len(self.garbler_inputs):
            w[:, self.garbler_inputs] = garbler_bits
        if len(self.evaluator_inputs):
            w[:, self.evaluator_inputs] = evaluator_bits
        for wire, bit in self.const_bits.items():
            w[:, wire] = bit
        op, in0, in1, out = self.op, self.in0, self.in1, self.out
        for g in range(self.num_gates):
            a = w[:, in0[g]]
            if op[g] == OP_XOR:
                w[:, out[g]] = a ^ w[:, in1[g]]
            elif op[g] == OP_AND:
                w[:, out[g]] = a & w[:, in1[g]]
            else:
                w[:, out[g]] = a ^ 1
        return w[:, self.outputs]


# ---------------------------------------------------------------------------
# compiled level plan (device-resident execution)
# ---------------------------------------------------------------------------


@dataclass
class LevelPlan:
    """Device-ready execution plan for a netlist.

    Gates are list-scheduled (respecting wire dependencies) into
    ``n_chunks`` fixed-shape *chunks*, each holding up to ``and_width``
    AND lanes and ``free_width`` XOR/INV lanes — the level schedule
    bucketed to two padded widths, so ONE scan body covers the whole
    netlist and the executable contains a single level shape regardless
    of depth. Spare lanes read the zero *dummy* row (``n_rows - 1``).

    Wires are renumbered into executor *rows*: sources (inputs +
    constants) occupy rows ``[0, n_src)`` in ascending-wire order; gate
    outputs land at ``base[k] + lane`` (AND lanes first, then free
    lanes). The executor commits one full fixed-width block per chunk — a
    SINGLE ``dynamic_update_slice`` of the computed lanes permuted by
    ``perm`` so valid lanes come first (one dynamic write per scan carry
    is what lets XLA alias the carry in place; a second write on the same
    carry forces a full-store copy every chunk). The pad-lane tail
    clobbers only rows whose current value is dead, which is safe because
    every clobbered row is rewritten before its next read.

    Two row-numbering modes:

    * ``compact=True`` (default) — the **liveness pass**: each gate row's
      last-use chunk is computed from the fanout, and chunk ``k``'s
      ``stride``-row block is placed at the lowest window containing no
      *live* row, so rows are recycled as soon as their fanout is
      consumed. The store size tracks the peak live label set (typically
      a small multiple of the chunk width) instead of the gate count —
      the paper's wire-memory reuse, applied to the scan carry. Sources,
      netlist outputs and the dummy row are pinned (never recycled).
      ``wire_rows`` gives each wire's row *during its live range only*;
      a full ``keep_wires`` snapshot needs ``compact=False``.
    * ``compact=False`` — append-only: ``base[k+1] = base[k] + valid_k``,
      exactly one row per gate for the store's whole life (escape hatch,
      and what ``keep_wires`` garbling uses).

    INV lanes are encoded as XOR-with-dummy: their second input reads the
    zero row, so the evaluator needs no per-lane select at all (INV labels
    pass through; the garbler XORs R on lanes flagged in ``free_inv``).

    ``and_slot`` holds the dense garbled-table index per AND lane (also
    the Half-Gate tweak, matching the host oracle bit-for-bit). Garbled
    tables are emitted **packed**: chunk ``k``'s valid AND lanes write
    table rows ``[table_base[k], table_base[k] + and_valid[k])`` — one
    contiguous slice per chunk into a dense ``n_table_rows``-row store
    (``n_and`` real rows + an ``and_width`` spill tail), no ys-stack
    padding. Pad lanes spill into rows owned by later chunks, which
    rewrite them before the store is read. ``and_rows`` maps dense slot
    -> packed table-store row (``table_base[chunk] + lane``).
    """

    num_wires: int
    n_and: int
    n_gates: int
    n_levels: int  # natural (unconstrained) levelization depth
    n_chunks: int
    and_width: int
    free_width: int
    n_rows: int  # wire-store rows (incl. spill scratch + dummy)
    base: np.ndarray  # (K,) first output row of each chunk
    and_valid: np.ndarray  # (K,) live AND lanes per chunk
    free_valid: np.ndarray  # (K,) live free lanes per chunk
    and_in0: np.ndarray  # (K, Ca) row ids (pad -> dummy)
    and_in1: np.ndarray
    and_slot: np.ndarray  # (K, Ca) dense table slot (pad -> n_and)
    free_in0: np.ndarray  # (K, Cf) row ids (pad -> dummy)
    free_in1: np.ndarray  # (K, Cf) row ids (INV and pad -> dummy)
    free_inv: np.ndarray  # (K, Cf) uint32 1 on INV lanes (garbler XORs R)
    free_ops: np.ndarray  # (K, Cf) uint32 XOR/INV/PAD (fused-kernel path)
    perm: np.ndarray  # (K, Ca+Cf) write order: valid AND, valid free, pads
    source_ids: np.ndarray  # (n_src,) original wire ids, ascending
    out_rows: np.ndarray  # (n_out,) rows of the netlist outputs
    wire_rows: np.ndarray  # (W,) original wire -> row (at write time)
    and_rows: np.ndarray  # (nA,) dense slot -> packed table-store row
    table_base: np.ndarray = None  # (K,) first packed table row per chunk
    n_table_rows: int = 0  # packed table store: n_and + and_width spill
    compact: bool = False  # liveness-compacted rows?
    store_rows_naive: int = 0  # store size the append-only numbering needs
    _executors: Dict = field(default_factory=dict)  # (I, impl) -> executor
    _net: Optional["Netlist"] = None  # source netlist (stats counters)

    @property
    def widths(self) -> Tuple[int, int]:
        return (self.and_width, self.free_width)

    @property
    def padded_gate_lanes(self) -> int:
        """Total kernel lanes including padding (wasted-work metric)."""
        return self.n_chunks * (self.and_width + self.free_width)

    @property
    def padded_and_lanes(self) -> int:
        return self.n_chunks * self.and_width

    def stats(self) -> Dict:
        """Plan-shape metrics: wire-store rows before/after the liveness
        pass and real-vs-padded garble table rows (what the ys-stack
        emission used to materialize). Surfaced by ``bench_gc_eval`` so
        reuse wins are visible per netlist."""
        padded_tables = self.n_chunks * self.and_width
        st = {
            "chunks": self.n_chunks,
            "and_width": self.and_width,
            "free_width": self.free_width,
            "compact": self.compact,
            "store_rows": self.n_rows,
            "store_rows_naive": self.store_rows_naive,
            "store_row_reduction": round(
                self.store_rows_naive / max(self.n_rows, 1), 2),
            "table_rows_real": self.n_and,
            "table_rows_padded": padded_tables,
            "table_pad_ratio": round(
                padded_tables / max(self.n_and, 1), 2),
        }
        net = self._net
        if net is not None:
            # removable-AND / dead-gate counters of the *source netlist*
            # (compile_level_plan pins it): how much of the plan's lane
            # and table volume the dataflow analyzer can still prove away
            from repro_torch.analysis.netcheck import dataflow_summary
            st.update(dataflow_summary(net))
        return st

    def source_positions(self, wire_ids) -> np.ndarray:
        """Positions of ``wire_ids`` inside the ``source_ids`` ordering."""
        pos = np.searchsorted(self.source_ids, wire_ids)
        if len(wire_ids) and (
            pos.max(initial=0) >= len(self.source_ids)
            or not np.array_equal(self.source_ids[pos], np.asarray(wire_ids))
        ):
            raise KeyError("wire ids are not source wires of this netlist")
        return pos.astype(np.int64)


#: instance count at or below which the latency regime applies — wider
#: chunks (here) and the row-major store layout (``gc_exec``)
LATENCY_MAX_INSTANCES = 8


def _ceil8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def _chunk_widths(net: Netlist, depth: int,
                  instances: Optional[int] = None,
                  garbling: bool = False) -> Tuple[int, int]:
    """Bucket the level profile to one AND width and one free width.

    Two regimes, selected by the executor batch size:

    * **throughput** (default / large batches): widths sized just above
      the average per-level population. The compact row numbering makes
      lane padding cheap (pad lanes read the cache-hot dummy row and
      clobber rows that are rewritten anyway), so the only real cost of
      slack is gather/store volume — keep the widths tight and let wide
      levels spill into extra chunks.
    * **latency** (``instances`` <= 8, e.g. a single online request):
      per-chunk volume is negligible, the scan's fixed per-chunk cost
      dominates — widen ~4x so the chunk count approaches the natural
      levelization depth.

    ``garbling`` requests the garble walk's variant: every padded AND
    lane costs the garbler 4 hash lanes (vs the evaluator's 2), so
    AND-rich netlists whose default width sits above the /8 floor get
    their AND width halved and the free width trimmed to 2/3 — more,
    narrower chunks with much less dead hashing. Netlists already at
    the floor keep the shared shape (tightening the free width alone
    just adds scan steps). Garbled tables are dense-slot ordered, so a
    garble plan and an eval plan of different widths interoperate
    bit-exactly.
    """
    depth = max(depth, 1)
    n_and = net.and_count
    n_free = net.num_gates - n_and
    # AND lanes floor to /8 (hash + table traffic: keep tight, spill
    # instead); free lanes ceil to /8 of the per-level average
    ca = min(max((n_and // depth) // 8 * 8, 8), 1024)
    cf = min(_ceil8(-(-n_free // depth)), 4096)
    if instances is not None and instances <= LATENCY_MAX_INSTANCES:
        ca = min(4 * ca, 1024)
        cf = min(4 * cf, 4096)
    elif garbling and ca > 8:
        ca = max(ca // 2, 8)
        cf = _ceil8(2 * cf // 3)
    return ca, cf


def _first_window(release: np.ndarray, k: int, stride: int) -> int:
    """The lowest start of ``stride`` consecutive rows all dead by chunk
    ``k`` (``release <= k``), or -1: the start of the first run of dead
    rows that is at least ``stride`` long.

    Every such run holds a whole aligned block of ``h = stride // 2``
    rows, so only runs of all-dead aligned blocks are candidates: each
    extends into the block before it (which holds a live row) up to that
    block's last live row, and into the block after it up to that block's
    first. One pass over the rows, then work per candidate."""
    n = len(release)
    if n < stride:
        return -1
    h = max(stride // 2, 1)
    nb = n // h
    blocked = release > k
    blk = blocked[: nb * h].reshape(nb, h)
    edges = np.diff(np.concatenate(
        ([False], ~blk.any(axis=1), [False])).view(np.int8))
    j0 = np.flatnonzero(edges == 1)  # first all-dead block of each run
    j1 = np.flatnonzero(edges == -1)  # one past its last
    if not len(j0):
        return -1
    start = j0 * h
    left = j0 > 0
    # back over the dead rows that close the block before
    start[left] -= blk[j0[left] - 1][:, ::-1].argmax(axis=1)
    end = j1 * h
    inner = j1 < nb
    end[inner] += blk[j1[inner]].argmax(axis=1)
    if not inner[-1]:  # the last run reaches the rows past the blocks
        tail = np.flatnonzero(blocked[nb * h:])
        end[-1] = nb * h + tail[0] if len(tail) else n
    fit = np.flatnonzero(end - start >= stride)
    return int(start[fit[0]]) if len(fit) else -1


def _allocate_rows_liveness(net: Netlist, K: int, stride: int, n_src: int,
                            chunk_of: np.ndarray, row_off: np.ndarray,
                            ) -> Tuple[np.ndarray, int]:
    """The liveness pass: reuse-aware placement of the per-chunk blocks.

    Each gate row's last-use chunk comes from the fanout (readers of its
    output wire); netlist outputs and sources are pinned forever. Chunk
    ``k`` still commits ONE contiguous ``stride``-row block, placed
    first-fit at the lowest window of rows whose occupants are all dead
    by chunk ``k`` (last read at chunk <= k — the scan body gathers
    before it writes, so a row read by chunk ``k`` itself may sit in its
    window). Rows are recycled as soon as their fanout is consumed, so
    the store tracks the peak live label set instead of the gate count.

    Returns ``(base (K,), n_rows)`` with the dummy row appended past the
    highest window (never inside one, so pad/INV reads always see zero).
    """
    INF = K + 2
    last_read = np.full(net.num_wires, -1, np.int64)
    if net.num_gates:
        np.maximum.at(last_read, net.in0, chunk_of)
        ni = net.op != OP_INV
        np.maximum.at(last_read, net.in1[ni], chunk_of[ni])
    if len(net.outputs):
        last_read[np.asarray(net.outputs, np.int64)] = INF
    # per-gate release chunk, grouped by chunk in lane order
    live_until = (last_read[net.out] if net.num_gates
                  else np.zeros(0, np.int64))
    order = np.argsort(chunk_of, kind="stable") if net.num_gates else \
        np.zeros(0, np.int64)
    counts = np.bincount(chunk_of, minlength=K) if net.num_gates else \
        np.zeros(K, np.int64)
    bounds = np.concatenate([[0], np.cumsum(counts)])

    release = np.zeros(n_src + 4 * stride, np.int64)
    release[:n_src] = INF  # sources pinned: garble reads them at the end
    base = np.empty(K, np.int64)
    for k in range(K):
        while True:
            s = _first_window(release[n_src:], k, stride)
            if s >= 0:
                break
            release = np.concatenate(
                [release,
                 np.zeros(max(stride, len(release) // 4), np.int64)])
        b = int(n_src + s)
        base[k] = b
        g_k = order[bounds[k]: bounds[k + 1]]
        release[b + row_off[g_k]] = live_until[g_k]
    n_rows = int(base.max(initial=n_src) + stride) + 1 if K else \
        n_src + stride + 1
    return base, n_rows


def _validate_plan(net: Netlist, plan: LevelPlan,
                   chunk_of: np.ndarray, lane_of: np.ndarray) -> None:
    """Host-side simulation of the store discipline (plan invariants).

    Walks the chunks tracking which wire each row currently holds and
    checks every read — including the dummy reads of pad/INV lanes —
    sees exactly the wire the schedule expects ("no row rewritten while
    live"), that no write block touches the dummy row, and that sources
    and netlist outputs survive to the end. A renumbering that recycles
    a row before its last reader fails here at compile time. Raises
    explicitly (never bare ``assert``): this guard must survive
    ``python -O`` — a bad plan is a silent wrong-label disaster.
    """
    def _check(ok: bool, msg: str) -> None:
        if not ok:
            raise AssertionError(f"level plan invariant violated: {msg}")

    K, ca, cf = plan.n_chunks, plan.and_width, plan.free_width
    stride = ca + cf
    dummy = plan.n_rows - 1
    GARBAGE, DUMMY = -3, -1
    _check(bool((plan.base + stride <= dummy).all()),
           "write block hits dummy row")

    is_and_g = net.op == OP_AND
    ag = np.nonzero(is_and_g)[0]
    fg = np.nonzero(~is_and_g)[0]
    exp_a0 = np.full((K, ca), DUMMY, np.int64)
    exp_a1 = np.full((K, ca), DUMMY, np.int64)
    exp_f0 = np.full((K, cf), DUMMY, np.int64)
    exp_f1 = np.full((K, cf), DUMMY, np.int64)
    exp_a0[chunk_of[ag], lane_of[ag]] = net.in0[ag]
    exp_a1[chunk_of[ag], lane_of[ag]] = net.in1[ag]
    exp_f0[chunk_of[fg], lane_of[fg]] = net.in0[fg]
    exp_f1[chunk_of[fg], lane_of[fg]] = np.where(
        net.op[fg] == OP_INV, DUMMY, net.in1[fg])
    outw = np.full((K, stride), GARBAGE, np.int64)
    if net.num_gates:
        row_off = np.where(is_and_g, lane_of,
                           plan.and_valid[chunk_of] + lane_of)
        outw[chunk_of, row_off] = net.out

    owner = np.full(plan.n_rows, GARBAGE, np.int64)
    owner[dummy] = DUMMY
    owner[np.arange(len(plan.source_ids))] = plan.source_ids
    for k in range(K):
        for rows, exp in ((plan.and_in0[k], exp_a0[k]),
                          (plan.and_in1[k], exp_a1[k]),
                          (plan.free_in0[k], exp_f0[k]),
                          (plan.free_in1[k], exp_f1[k])):
            _check(np.array_equal(owner[rows], exp),
                   f"chunk {k}: read of a recycled/garbage row")
        # the executor writes concat([AND, free])[perm] at base[k]; the
        # owner bookkeeping above places gates by row_off, so pin the
        # two to each other: perm must put the valid lanes, in lane
        # order, exactly at positions [0, valid_k)
        va, vf = plan.and_valid[k], plan.free_valid[k]
        _check(np.array_equal(
            plan.perm[k][: va + vf],
            np.concatenate([np.arange(va), ca + np.arange(vf)])),
            f"chunk {k}: perm does not land valid lanes at the "
            "row_off placement")
        b = plan.base[k]
        owner[b: b + stride] = outw[k]
    n_src = len(plan.source_ids)
    _check(np.array_equal(owner[:n_src], plan.source_ids),
           "a source row was clobbered")
    if len(net.outputs):
        _check(np.array_equal(owner[plan.out_rows],
                              np.asarray(net.outputs, np.int64)),
               "a netlist output row was clobbered before the end")


def _next_open(skip: List[int], c: int) -> int:
    """The first chunk at or after ``c`` that still has a spare lane of
    one class (``skip[c] == c`` for an open chunk; a full chunk points
    further on). Compresses the path it walks."""
    root = c
    n = len(skip)
    while root < n and skip[root] != root:
        root = skip[root]
    while c < n and skip[c] != c:
        skip[c], c = root, skip[c]
    return root


def _schedule_chunks(net: Netlist, ca: int, cf: int):
    """Greedy list scheduling under per-class lane capacity: every gate
    lands in the earliest chunk after all its inputs with a spare lane of
    its class (AND or free), in gate order. Returns ``(chunk_of, lane_of,
    fill_and, fill_free)``. Full chunks are skipped through a pointer per
    class instead of one step at a time, and the walk runs on Python
    lists; the placement is the plain scan's, gate for gate."""
    G = net.num_gates
    op, in0 = net.op.tolist(), net.in0.tolist()
    in1, out = net.in1.tolist(), net.out.tolist()
    wire_chunk = [-1] * net.num_wires
    fill_and: List[int] = []
    fill_free: List[int] = []
    skip_and: List[int] = []
    skip_free: List[int] = []
    chunk_of = [0] * G
    lane_of = [0] * G
    n = 0  # chunks opened so far
    for g in range(G):
        o = op[g]
        e = wire_chunk[in0[g]] + 1
        if o != OP_INV:
            e1 = wire_chunk[in1[g]] + 1
            if e1 > e:
                e = e1
        if o == OP_AND:
            fill, skip, cap = fill_and, skip_and, ca
        else:
            fill, skip, cap = fill_free, skip_free, cf
        c = e
        if e < n and skip[e] != e:
            c = _next_open(skip, e)
        while c >= n:
            skip_and.append(n)
            skip_free.append(n)
            fill_and.append(0)
            fill_free.append(0)
            n += 1
        lane = fill[c]
        lane_of[g] = lane
        fill[c] = lane + 1
        if lane + 1 >= cap:
            skip[c] = c + 1
        chunk_of[g] = c
        wire_chunk[out[g]] = c
    return (np.asarray(chunk_of, np.int64), np.asarray(lane_of, np.int64),
            fill_and, fill_free)


def compile_level_plan(net: Netlist,
                       and_width: Optional[int] = None,
                       free_width: Optional[int] = None,
                       instances: Optional[int] = None,
                       compact: bool = True,
                       garbling: bool = False) -> LevelPlan:
    """Compile (and cache on the netlist, per width config) a level plan.

    ``instances`` and ``garbling`` only steer the default width choice
    (latency vs throughput regime; garble-tightened AND width — see
    :func:`_chunk_widths`); explicit ``and_width``/``free_width`` win.
    ``compact`` selects the liveness-compacted wire store (default; see
    :class:`LevelPlan`) — ``compact=False`` keeps the append-only
    one-row-per-gate numbering, which ``keep_wires`` garbling needs.
    Plans are cached per (and_width, free_width, compact) — source
    ordering, dense table slots and output order are width-independent,
    so any plan of the same netlist is interchangeable for
    packing/encoding purposes (a garble-width plan's tables feed an
    eval-width plan's evaluate bit-exactly).
    """
    W, nA, G = net.num_wires, net.and_count, net.num_gates
    depth = getattr(net, "_plan_depth", None)
    if depth is None:
        depth = len(net.levels())
        net._plan_depth = depth  # type: ignore[attr-defined]
    ca, cf = _chunk_widths(net, depth, instances, garbling)
    ca = and_width or ca
    cf = free_width or cf
    plans = getattr(net, "_level_plans", None)
    if plans is None:
        plans = net._level_plans = {}  # type: ignore[attr-defined]
    cached = plans.get((ca, cf, bool(compact)))
    if cached is not None:
        return cached

    op, in0, in1, out = net.op, net.in0, net.in1, net.out
    chunk_of, lane_of, fill_and, fill_free = _schedule_chunks(net, ca, cf)

    K = max(len(fill_and), 1)
    stride = ca + cf
    and_valid = np.zeros(K, np.int64)
    and_valid[: len(fill_and)] = fill_and
    free_valid = np.zeros(K, np.int64)
    free_valid[: len(fill_free)] = fill_free

    src = np.ones(W, bool)
    src[out] = False
    source_ids = np.nonzero(src)[0].astype(np.int64)
    n_src = len(source_ids)
    is_and_g = op == OP_AND
    # per-gate row offset inside its chunk's write block (AND lanes first)
    row_off = (np.where(is_and_g, lane_of,
                        and_valid[chunk_of] + lane_of).astype(np.int64)
               if G else np.zeros(0, np.int64))
    naive_rows = n_src + G + stride + 1
    if compact:
        base, n_rows = _allocate_rows_liveness(
            net, K, stride, n_src, chunk_of, row_off)
    else:
        # append-only: exactly one live row per gate + scratch tail
        base = n_src + np.concatenate(
            [[0], np.cumsum(and_valid + free_valid)[:-1]])
        n_rows = naive_rows
    dummy = n_rows - 1

    wire_rows = np.full(W, dummy, np.int64)
    wire_rows[source_ids] = np.arange(n_src)
    if G:
        wire_rows[out] = base[chunk_of] + row_off

    and_in0 = np.full((K, ca), dummy, np.int64)
    and_in1 = np.full((K, ca), dummy, np.int64)
    and_slot = np.full((K, ca), nA, np.int64)
    free_in0 = np.full((K, cf), dummy, np.int64)
    free_in1 = np.full((K, cf), dummy, np.int64)
    free_inv = np.zeros((K, cf), np.uint32)
    free_ops = np.full((K, cf), OP_PAD, np.uint32)

    and_idx = net.and_gate_index()
    r0 = wire_rows[in0]
    r1 = np.where(op == OP_INV, dummy, wire_rows[in1])  # INV: b reads zero
    ag = np.nonzero(is_and_g)[0]
    and_in0[chunk_of[ag], lane_of[ag]] = r0[ag]
    and_in1[chunk_of[ag], lane_of[ag]] = wire_rows[in1[ag]]
    and_slot[chunk_of[ag], lane_of[ag]] = and_idx[ag]
    fg = np.nonzero(~is_and_g)[0]
    free_in0[chunk_of[fg], lane_of[fg]] = r0[fg]
    free_in1[chunk_of[fg], lane_of[fg]] = r1[fg]
    free_inv[chunk_of[fg], lane_of[fg]] = (op[fg] == OP_INV).astype(np.uint32)
    free_ops[chunk_of[fg], lane_of[fg]] = op[fg]

    # packed garble-table layout: chunk k's valid AND lanes write table
    # rows [table_base[k], table_base[k] + and_valid[k]); pad-lane spill
    # lands in rows owned by LATER chunks (table_base is the cumsum of
    # and_valid, so row t of owner chunk j satisfies t < table_base[m]
    # for every m > j — later chunks never clobber an owned row) plus an
    # and_width scratch tail for the last chunk
    table_base = np.concatenate(
        [[0], np.cumsum(and_valid)[:-1]]).astype(np.int64)
    n_table_rows = int(nA + ca)
    and_rows = np.empty(max(nA, 0), np.int64)
    if nA:
        and_rows[and_idx[ag]] = table_base[chunk_of[ag]] + lane_of[ag]

    # write permutation over concat([AND lanes, free lanes]): valid lanes
    # first (so the block lands compactly at base[k]), pads trailing
    perm = np.empty((K, stride), np.int64)
    for k in range(K):
        va_k, vf_k = and_valid[k], free_valid[k]
        pads = np.concatenate(
            [np.arange(va_k, ca), ca + np.arange(vf_k, cf)])
        perm[k] = np.concatenate(
            [np.arange(va_k), ca + np.arange(vf_k), pads])

    plan = LevelPlan(
        num_wires=W,
        n_and=nA,
        n_gates=G,
        n_levels=depth,
        n_chunks=K,
        and_width=ca,
        free_width=cf,
        n_rows=n_rows,
        base=base,
        and_valid=and_valid,
        free_valid=free_valid,
        and_in0=and_in0,
        and_in1=and_in1,
        and_slot=and_slot,
        free_in0=free_in0,
        free_in1=free_in1,
        free_inv=free_inv,
        free_ops=free_ops,
        perm=perm,
        source_ids=source_ids,
        out_rows=wire_rows[np.asarray(net.outputs, np.int64)]
        if len(net.outputs) else np.array([], np.int64),
        wire_rows=wire_rows,
        and_rows=and_rows,
        table_base=table_base,
        n_table_rows=n_table_rows,
        compact=bool(compact),
        store_rows_naive=naive_rows,
        _net=net,
    )
    # always-on invariant check: a bad renumber is a silent wrong-label
    # disaster, so every freshly compiled plan is simulated once
    _validate_plan(net, plan, chunk_of, lane_of)
    plans[(ca, cf, bool(compact))] = plan
    return plan


def wire_fanout(net: Netlist) -> np.ndarray:
    """Number of reads per wire (used by scheduling / LBUW policy)."""
    fan = np.zeros(net.num_wires, np.int64)
    np.add.at(fan, net.in0, 1)
    not_inv = net.op != OP_INV
    np.add.at(fan, net.in1[not_inv], 1)
    return fan
