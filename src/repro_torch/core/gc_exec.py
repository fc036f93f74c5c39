"""Device-resident execution of a compiled netlist level plan.

The executor walks the fixed-shape *chunks* of a
:class:`~repro_torch.core.netlist.LevelPlan` (the same plan, built by the
same ``compile_level_plan``, as the JAX package's executor) over a wire
store that lives on the executor's device. Per chunk it

* gathers the chunk's ``[a | b | fa | fb]`` input rows with ONE
  ``index_select`` of the row-major ``(n_rows + 1, I, 4)`` store;
* runs the AND block through the level kernel
  (:mod:`repro_torch.kernels.level_eval.level_eval`): ``garble_level``
  offline, ``eval_level`` online, on the ``(and_width * I, 4)`` lanes;
* computes the free block as one XOR ``fa ^ fb``. INV lanes read the zero
  dummy row as their second input, so on evaluate they pass ``a``
  through; on garble their second input is redirected to an extra store
  row that holds R, so the same XOR yields ``a0 ^ R``;
* commits the chunk's outputs to the rows the plan's ``perm`` puts them
  at (``base + argsort(perm)``) with two ``index_copy_`` calls.

Garble writes the Half-Gate table rows straight into packed table stores
at the plan's ``table_base`` (the kernel's ``out=``) and returns them in
dense AND-slot order ``(I, nAND, 2, 4)``, with the input zero-labels and
the output colour bits, plus every wire's zero-label on a
``compact=False`` plan (``keep_wires``).

One row-major store serves both instance regimes. The JAX package's
planar store, split hashes and prefetch were workarounds for XLA on the
CPU; the results here are bit-identical to its executor given the same
``(src_labels, R)`` — which is what ``tests/test_torch_gc_exec.py`` holds
the port to — not its structure. Every chunk still costs a handful of
PyTorch launches plus one kernel launch (folding the walk into fewer
launches is later work; see ``PERF.md``).

``n_eval_calls`` / ``n_garble_calls`` count invocations; the
``gc_exec.evaluate`` / ``gc_exec.garble`` spans wrap each walk.
"""

from __future__ import annotations

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
    eval_level,
    garble_level,
)

I32 = torch.int32
I64 = torch.int64

#: walks whose per-lane tweak/op vectors stay under this many lanes keep
#: them expanded on the device for the executor's lifetime (one launch
#: fewer per vector and chunk); larger walks expand them chunk by chunk
LANE_CACHE_MAX = 1 << 24


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
        ca, cf = plan.and_width, plan.free_width

        def t(x, dtype=I64):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=dev)

        # the store carries one row past the plan's rows: R, read by the
        # garbler's INV lanes in place of the zero dummy row
        self._r_row = plan.n_rows
        widx = np.concatenate(
            [plan.and_in0, plan.and_in1, plan.free_in0, plan.free_in1],
            axis=1)
        gidx = widx.copy()
        gidx[:, 2 * ca + cf:][plan.free_inv != 0] = self._r_row
        self._widx = t(widx)
        self._gidx = t(gidx)
        # concat([AND, free]) lane j lands at row base + argsort(perm)[j]
        dest = plan.base[:, None] + np.argsort(plan.perm, axis=1)
        self._dest_and = t(dest[:, :ca])
        self._dest_free = t(dest[:, ca:])
        # table rows per AND lane (pad slots clamp onto a real row: their
        # output is zeroed by the kernel and lands in a garbage row)
        self._slot = t(np.minimum(plan.and_slot, max(plan.n_and - 1, 0)))
        self._tweak = t(plan.and_slot.astype(np.int64), I32)
        self._and_ops = t(np.where(plan.and_slot < plan.n_and, OP_AND,
                                   OP_PAD), I32)
        self._table_base = plan.table_base.tolist()
        self._outs = t(plan.out_rows)
        self._wire_rows = t(plan.wire_rows)
        self._and_rows = t(plan.and_rows)
        self._lanes_cached = (plan.n_chunks * ca * self.instances
                              <= LANE_CACHE_MAX)
        if self._lanes_cached:
            self._tweak_lanes = self._tweak.repeat_interleave(
                self.instances, dim=1)
            self._op_lanes = self._and_ops.repeat_interleave(
                self.instances, dim=1)

    # ------------------------------------------------------------------
    def _lanes(self, k: int):
        """Chunk k's per-lane (ops, tweaks), lane-major over instances."""
        if self._lanes_cached:
            return self._op_lanes[k], self._tweak_lanes[k]
        I = self.instances
        return (self._and_ops[k].repeat_interleave(I),
                self._tweak[k].repeat_interleave(I))

    def _store(self, labels: torch.Tensor) -> torch.Tensor:
        """labels (I, n_src, 4) -> (n_rows + 1, I, 4) store, sources filled."""
        I = self.instances
        w = torch.zeros((self.plan.n_rows + 1, I, 4), dtype=I32,
                        device=self.device)
        w[: self.n_src] = labels.to(self.device, I32).transpose(0, 1)
        return w

    def _commit(self, w, k, and_out, free_out):
        w.index_copy_(0, self._dest_and[k], and_out)
        w.index_copy_(0, self._dest_free[k], free_out)

    # ------------------------------------------------------------------
    # evaluate
    # ------------------------------------------------------------------
    def evaluate(self, active: torch.Tensor, tables: torch.Tensor
                 ) -> torch.Tensor:
        """active (I, n_src, 4); tables (I, >=nAND, 2, 4) -> (I, n_out, 4)."""
        self.n_eval_calls += 1
        with obs.span("gc_exec.evaluate",
                      netlist=getattr(self.plan._net, "name", "") or "",
                      instances=self.instances, device=str(self.device)):
            return self._evaluate(active, tables)

    def _evaluate(self, active, tables):
        plan, I = self.plan, self.instances
        ca, cf = plan.and_width, plan.free_width
        w = self._store(active)
        tables = tables.to(self.device, I32)
        # (nT, I, 4) row stores of each table half: one gather per chunk
        tg_rows = tables[:, :, 0].transpose(0, 1).contiguous()
        te_rows = tables[:, :, 1].transpose(0, 1).contiguous()
        for k in range(plan.n_chunks):
            g = w.index_select(0, self._widx[k])
            ops, tw = self._lanes(k)
            out = eval_level(
                ops, g[:ca].view(-1, 4), g[ca:2 * ca].view(-1, 4),
                tg_rows.index_select(0, self._slot[k]).view(-1, 4),
                te_rows.index_select(0, self._slot[k]).view(-1, 4), tw)
            self._commit(w, k, out.view(ca, I, 4),
                         g[2 * ca:2 * ca + cf] ^ g[2 * ca + cf:])
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
                      instances=self.instances, device=str(self.device)):
            return self._garble(src_labels, r, keep_wires)

    def _garble(self, src_labels, r, keep_wires):
        plan, I, dev = self.plan, self.instances, self.device
        ca, cf, nA = plan.and_width, plan.free_width, plan.n_and
        r = r.to(dev, I32)
        w = self._store(src_labels)
        w[self._r_row] = r
        r_lanes = r.repeat(ca, 1)  # lane l * I + i holds r[i]
        tg_store = torch.zeros((plan.n_table_rows, I, 4), dtype=I32,
                               device=dev)
        te_store = torch.zeros_like(tg_store)
        c0 = torch.empty((ca * I, 4), dtype=I32, device=dev)
        for k in range(plan.n_chunks):
            g = w.index_select(0, self._gidx[k])
            ops, tw = self._lanes(k)
            tb = self._table_base[k]
            garble_level(
                ops, g[:ca].view(-1, 4), g[ca:2 * ca].view(-1, 4),
                r_lanes, tw,
                out=(c0, tg_store[tb:tb + ca].view(-1, 4),
                     te_store[tb:tb + ca].view(-1, 4)))
            self._commit(w, k, c0.view(ca, I, 4),
                         g[2 * ca:2 * ca + cf] ^ g[2 * ca + cf:])
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
    """
    with obs.span("gc_exec.get_executor", netlist=net.name or "",
                  instances=int(instances)):
        plan = compile_level_plan(net, instances=instances, compact=compact,
                                  garbling=garbling)
        key = (int(instances), str(torch.device(device)))
        exe = plan._executors.get(key)
        if exe is None:
            exe = LevelExecutor(plan, instances, device)
            plan._executors[key] = exe
        return exe
