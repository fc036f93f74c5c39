"""Device-resident execution of a compiled netlist level plan.

The executor walks the fixed-shape *chunks* of a
:class:`~repro_torch.core.netlist.LevelPlan` (the same plan, built by the
same ``compile_level_plan``, as the JAX package's executor) over a wire
store ``(n_rows + 1, I, 4)`` that lives on the executor's device. Per
chunk the walk

* gathers the chunk's ``[a | b | fa | fb]`` input rows;
* runs the AND lanes through the Half-Gate (evaluate online, garble
  offline, writing the table rows at the plan's ``table_base``);
* computes the free lanes as ``fa ^ fb``. INV lanes read the zero dummy
  row as their second input, so on evaluate they pass ``a`` through; on
  garble their second input is redirected to an extra store row that
  holds R, so the same XOR yields ``a0 ^ R``;
* commits the chunk's outputs to the rows the plan's ``perm`` puts them
  at (``base + argsort(perm)``), after every gather of the chunk.

``__init__`` packs, once per executor, one int32 record per chunk and
side (:class:`~repro_torch.kernels.level_eval.ref.WalkMeta`: gather rows,
commit rows, tweaks, ops, table slots or ``table_base``), and each walk
is ONE call of ``eval_walk`` / ``garble_walk``
(:mod:`repro_torch.kernels.level_eval.level_eval`): on the card one
kernel launch that walks every chunk, on the CPU the plain walk over the
same records. Around it stay a few PyTorch calls per walk: the store's
set-up, the table transposes and the output gathers.

Garble returns the tables in dense AND-slot order ``(I, nAND, 2, 4)``,
with the input zero-labels and the output colour bits, plus every wire's
zero-label on a ``compact=False`` plan (``keep_wires``).

One row-major store serves both instance regimes. The JAX package's
planar store, split hashes and prefetch were workarounds for XLA on the
CPU; the results here are bit-identical to its executor given the same
``(src_labels, R)`` — which is what ``tests/test_torch_gc_exec.py`` holds
the port to — not its structure.

``n_eval_calls`` / ``n_garble_calls`` count invocations. Spans:
``gc_exec.get_executor`` around each lookup (building a plan and
executor on a miss), ``gc_exec.evaluate`` / ``gc_exec.garble`` around
each walk (``netlist``, ``instances``). The labels a garble walk starts
from are drawn before it, in :func:`repro_torch.core.garble.garble`'s
``garble.draw`` span.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.netlist import (
    LevelPlan,
    Netlist,
    OP_AND,
    OP_PAD,
    compile_level_plan,
)
from repro_torch.kernels.level_eval.level_eval import (
    eval_walk,
    garble_walk,
)
from repro_torch.kernels.level_eval.ref import (
    WalkMeta,
    walk_offsets,
    walk_stride,
)

I32 = torch.int32
I64 = torch.int64


def pack_walk(plan: LevelPlan, garble: bool, device) -> WalkMeta:
    """One side's per-chunk records of ``plan`` (see :class:`WalkMeta`).

    Garble points the INV lanes' second input at the R row (``n_rows``);
    table slots clamp pad lanes onto a real row (their output is zeroed
    and lands in a dead row).
    """
    ca, cf, K = plan.and_width, plan.free_width, plan.n_chunks
    o = walk_offsets(ca, cf)
    rec = np.zeros((K, walk_stride(ca, cf, garble)), np.int32)
    g = rec[:, :o["dest"]]
    g[:] = np.concatenate(
        [plan.and_in0, plan.and_in1, plan.free_in0, plan.free_in1], axis=1)
    if garble:
        g[:, 2 * ca + cf:][plan.free_inv != 0] = plan.n_rows
    # concat([AND, free]) lane j lands at row base + argsort(perm)[j]
    rec[:, o["dest"]:o["tweak"]] = (plan.base[:, None]
                                    + np.argsort(plan.perm, axis=1))
    rec[:, o["tweak"]:o["op"]] = plan.and_slot
    rec[:, o["op"]:o["extra"]] = np.where(plan.and_slot < plan.n_and,
                                          OP_AND, OP_PAD)
    if garble:
        rec[:, o["extra"]] = plan.table_base
        table_rows = plan.n_table_rows
    else:
        rec[:, o["extra"]:o["extra"] + ca] = np.minimum(
            plan.and_slot, max(plan.n_and - 1, 0))
        table_rows = max(plan.n_and, 1)
    return WalkMeta(torch.from_numpy(rec).to(device), ca, cf, garble,
                    plan.n_rows + 1, table_rows)


class LevelExecutor:
    """One evaluate/garble walk for a fixed (plan, instances, device)."""

    def __init__(self, plan: LevelPlan, instances: int, device="cuda"):
        self.plan = plan
        self.instances = int(instances)
        self.device = torch.device(device)
        self.n_eval_calls = 0
        self.n_garble_calls = 0
        self.n_src = len(plan.source_ids)
        dev = self.device

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=I64,
                                   device=dev)

        # the store carries one row past the plan's rows: R, read by the
        # garbler's INV lanes in place of the zero dummy row
        self._r_row = plan.n_rows
        self._eval_meta = pack_walk(plan, False, dev)
        self._garble_meta = pack_walk(plan, True, dev)
        self._outs = t(plan.out_rows)
        self._wire_rows = t(plan.wire_rows)
        self._and_rows = t(plan.and_rows)

    # ------------------------------------------------------------------
    def _store(self, labels: torch.Tensor) -> torch.Tensor:
        """labels (I, n_src, 4) -> (n_rows + 1, I, 4) store, sources filled."""
        I = self.instances
        w = torch.zeros((self.plan.n_rows + 1, I, 4), dtype=I32,
                        device=self.device)
        w[: self.n_src] = labels.to(self.device, I32).transpose(0, 1)
        return w

    # ------------------------------------------------------------------
    # evaluate
    # ------------------------------------------------------------------
    def evaluate(self, active: torch.Tensor, tables: torch.Tensor
                 ) -> torch.Tensor:
        """active (I, n_src, 4); tables (I, >=nAND, 2, 4) -> (I, n_out, 4)."""
        self.n_eval_calls += 1
        with obs.span("gc_exec.evaluate",
                      netlist=getattr(self.plan._net, "name", "") or "",
                      instances=self.instances):
            return self._evaluate(active, tables)

    def _evaluate(self, active, tables):
        w = self._store(active)
        tables = tables.to(self.device, I32)
        # (nT, I, 4) row stores of each table half
        tg_rows = tables[:, :, 0].transpose(0, 1).contiguous()
        te_rows = tables[:, :, 1].transpose(0, 1).contiguous()
        eval_walk(self._eval_meta, w, tg_rows, te_rows)
        return w[self._outs].transpose(0, 1).contiguous()

    # ------------------------------------------------------------------
    # garble
    # ------------------------------------------------------------------
    def garble(self, src_labels: torch.Tensor, r: torch.Tensor, *,
               keep_wires: bool = False):
        """src_labels (I, n_src, 4) fresh zero-labels; r (I, 4) offset.

        Returns (input_zero at source order (I, n_src, 4), tables
        (I, max(nAND, 1), 2, 4), output color bits (I, n_out)[, every
        wire's zero-label (I, W, 4)]).
        """
        if keep_wires and self.plan.compact:
            raise ValueError(
                "keep_wires needs the full wire store: use a "
                "compact=False plan (rows are recycled here)")
        self.n_garble_calls += 1
        with obs.span("gc_exec.garble",
                      netlist=getattr(self.plan._net, "name", "") or "",
                      instances=self.instances):
            return self._garble(src_labels, r, keep_wires)

    def _garble(self, src_labels, r, keep_wires):
        plan, I, dev = self.plan, self.instances, self.device
        nA = plan.n_and
        r = r.to(dev, I32).contiguous()
        w = self._store(src_labels)
        w[self._r_row] = r
        tg_store = torch.zeros((plan.n_table_rows, I, 4), dtype=I32,
                               device=dev)
        te_store = torch.zeros_like(tg_store)
        garble_walk(self._garble_meta, w, r, tg_store, te_store)
        in_zero = w[: self.n_src].transpose(0, 1).contiguous()
        out_perm = (w[self._outs, :, 0] & 1).transpose(0, 1).contiguous()
        tables = torch.zeros((I, max(nA, 1), 2, 4), dtype=I32, device=dev)
        if nA:
            tables[:, :, 0] = tg_store[self._and_rows].transpose(0, 1)
            tables[:, :, 1] = te_store[self._and_rows].transpose(0, 1)
        if keep_wires:
            wires = w[self._wire_rows].transpose(0, 1).contiguous()
            return in_zero, tables, out_perm, wires
        return in_zero, tables, out_perm


_NET_LOCKS = threading.Lock()


def _net_lock(net: Netlist) -> threading.Lock:
    """The lock that guards ``net``'s plan and executor caches (made once
    per netlist object, under a module lock)."""
    with _NET_LOCKS:
        lock = getattr(net, "_exec_lock", None)
        if lock is None:
            lock = net._exec_lock = threading.Lock()  # type: ignore[attr-defined]
        return lock


def get_executor(net: Netlist, instances: int, device="cuda",
                 compact: bool = True,
                 garbling: bool = False) -> LevelExecutor:
    """Executor cache: one per (netlist plan, instances, device).

    The plan (and thus the cache) hangs off the netlist object, so its
    lifetime matches the protocol's netlist cache. ``instances`` picks the
    plan's width regime and ``garbling`` the garble-tightened widths,
    exactly as in the JAX package (plans of any width interoperate
    bit-exactly: tables are in dense slot order). ``compact=False`` keeps
    one row per gate, which ``keep_wires`` garbling needs. The
    ``gc_exec.get_executor`` span shows what building a plan costs the
    first walk of a (netlist, widths).

    Thread-safe: the two endpoints of a pipelined pair (and the evaluator
    threads of one server) may first-use one netlist at the same time, so
    building its plans and executors is serialised per netlist; the
    second caller waits and then finds them cached.
    """
    with obs.span("gc_exec.get_executor", netlist=net.name or "",
                  instances=int(instances)), _net_lock(net):
        plan = compile_level_plan(net, instances=instances, compact=compact,
                                  garbling=garbling)
        key = (int(instances), str(torch.device(device)))
        exe = plan._executors.get(key)
        if exe is None:
            exe = LevelExecutor(plan, instances, device)
            plan._executors[key] = exe
        return exe
