"""Garble / evaluate netlist levels: CUDA kernels and wrappers.

Two pairs of kernels replace the JAX package's Pallas kernels
``kernels/level_eval/level_eval.py:59`` (``eval_level_pallas``) and
``kernels/level_eval/level_eval.py:83`` (``garble_level_pallas``):

* ``eval_level`` / ``garble_level`` — their one-to-one counterparts, one
  padded level per launch, with the same operands in the same ``(G, 4)``
  layout;
* ``eval_walk`` / ``garble_walk`` — their redesign for the main path: ONE
  launch walks every chunk of a level plan over the wire store, reading
  the packed per-chunk records of :class:`~.ref.WalkMeta`
  (``core/gc_exec.py`` builds them). :func:`walk_shape` picks the
  launch's instance tile and cluster size.

The kernels are in ``csrc/level_eval.cu`` (hash in
``kernels/csrc/halfgate.cuh``); see that file for what bounds them on the
H100 and how the design answers it.

Wrapper rules:

* a CPU tensor runs the plain PyTorch version (``ref.py``);
* a CUDA tensor launches the kernel, building it with ``nvcc`` on first
  use, or raises — there is no fallback;
* device, dtype (int32), shape, contiguity and, on the card, 16-byte
  alignment are checked before the launch;
* each wrapper counts its launches in a plain integer attribute
  (``eval_level.launches``, ``garble_level.launches``,
  ``eval_walk.launches``, ``garble_walk.launches``), incremented only
  where the kernel is launched.

Work per lane, for a roofline bound: ``EVAL_BYTES`` / ``GARBLE_BYTES``
are the bytes each lane must move (each input read once, each output
written once) and ``EVAL_OPS`` / ``GARBLE_OPS`` its 32-bit integer
operations (115 per hash, see ``halfgate.cuh``, plus the Half-Gate
algebra and the op select).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, operands
from repro_torch.kernels.level_eval import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "level_eval.cu"

HASH_OPS = 115
EVAL_OPS = 2 * HASH_OPS + 49  # tweaks 2, masks 4, algebra 24, xor 4, select 15
GARBLE_OPS = 4 * HASH_OPS + 89  # tweaks 2, r-xors 8, masks 4, algebra 44, selects 31
EVAL_BYTES = 4 + 4 + 4 * 16 + 16  # op, tweak, a, b, tg, te in; out
GARBLE_BYTES = 4 + 4 + 3 * 16 + 3 * 16  # op, tweak, a0, b0, r in; c0, tg, te

_P = ctypes.c_void_p
_SIGNATURES = {
    "eval_level": (ctypes.c_int, (_P,) * 7 + (ctypes.c_longlong, _P)),
    "garble_level": (ctypes.c_int, (_P,) * 8 + (ctypes.c_longlong, _P)),
    "eval_walk": (ctypes.c_int, (_P, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, _P,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, _P, _P, _P)),
    "garble_walk": (ctypes.c_int, (_P, ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, _P,
                                   ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _P, _P, _P, _P)),
    "error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = build.load(SOURCE, _SIGNATURES)
    return _LIB


def eval_level(ops, a, b, tg, te, tweaks) -> torch.Tensor:
    """ops (G,); a/b/tg/te (G, 4); tweaks (G,), all int32. -> (G, 4)."""
    dev, g = operands.check("eval_level", (ops, tweaks), (a, b, tg, te))
    if dev.type == "cpu":
        return ref.eval_level(ops, a, b, tg, te, tweaks)
    lib = _lib()
    out = torch.empty_like(a)
    with torch.cuda.device(dev):
        rc = lib.eval_level(ops.data_ptr(), a.data_ptr(), b.data_ptr(),
                            tg.data_ptr(), te.data_ptr(), tweaks.data_ptr(),
                            out.data_ptr(), g,
                            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "eval_level", lib)
    if g:
        eval_level.launches += 1
    return out


eval_level.launches = 0


def garble_level(ops, a0, b0, r, tweaks,
                 out: Optional[Tuple[torch.Tensor, ...]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ops (G,); a0/b0/r (G, 4); tweaks (G,), all int32.

    Returns (c0, tg, te), each (G, 4): output zero-labels and the two
    Half-Gate table rows (zero off the AND lanes). ``out`` may name three
    (G, 4) tensors to write into (the executor points the table rows
    straight into its packed table store).
    """
    dev, g = operands.check("garble_level", (ops, tweaks), (a0, b0, r))
    if out is not None:
        operands.check("garble_level", (), tuple(out))
        if any(o.shape[0] != g or o.device != dev for o in out):
            raise ValueError("garble_level: out must be three (G, 4) "
                             "tensors on the operands' device")
    if dev.type == "cpu":
        res = ref.garble_level(ops, a0, b0, r, tweaks)
        if out is None:
            return res
        for o, v in zip(out, res):
            o.copy_(v)
        return tuple(out)
    lib = _lib()
    c0, tg, te = out if out is not None else \
        tuple(torch.empty_like(a0) for _ in range(3))
    with torch.cuda.device(dev):
        rc = lib.garble_level(ops.data_ptr(), a0.data_ptr(), b0.data_ptr(),
                              r.data_ptr(), tweaks.data_ptr(), c0.data_ptr(),
                              tg.data_ptr(), te.data_ptr(), g,
                              torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "garble_level", lib)
    if g:
        garble_level.launches += 1
    return c0, tg, te


garble_level.launches = 0


# ---------------------------------------------------------------------------
# whole walks
# ---------------------------------------------------------------------------

#: H100 SXM: streaming multiprocessors, and the shared memory one block
#: may use (dynamic, after cudaFuncSetAttribute)
SMS = 132
SMEM_MAX = 232_448
WALK_THREADS = 256  # kWalkThreads in csrc/level_eval.cu
MAX_CLUSTER = 8  # the portable cluster size


class WalkShape(NamedTuple):
    """How one walk is launched: ``tiles * cluster`` blocks; block b
    of cluster t owns instances ``[t * tile, (t + 1) * tile)`` and its
    ``b``-th share of each chunk's (lane, instance) items, ``per_and``
    AND items and ``per_free`` free items, staged in ``smem`` bytes of
    shared memory beside two chunk records."""

    tile: int
    cluster: int
    tiles: int
    per_and: int
    per_free: int
    smem: int


def walk_shape(and_width: int, free_width: int, stride: int,
               instances: int) -> WalkShape:
    """The launch rule of the walk kernels, from the chunk widths, the
    record stride (int32 words) and the instance count I.

    * Instance tile: at least 8 instances (128 contiguous bytes of a
      store row, one cache line) or all of I, grown so that the tiles
      are at most 2 per SM (264): large-I walks get one tile per block
      and one block per tile.
    * Cluster: while the tiles leave SMs idle, each tile's lanes are
      split over a cluster of up to 8 blocks — the largest power of two
      with ``tiles * cluster <= SMS`` that leaves each block at least
      ``WALK_THREADS`` items of the wider lane block (softmax8 and the
      LayerNorm at I = 8 get 8).
    * Shared memory: the block's staged outputs (16 bytes per item) and
      two records; where that exceeds ``SMEM_MAX`` the cluster grows,
      then the tile halves. A walk that does not fit even at tile 1 and
      cluster 8 raises.
    """
    I = int(instances)
    if I < 1:
        raise ValueError("walk: needs at least one instance")
    ca, cf = and_width, free_width
    tile = min(I, max(8, -(-I // (2 * SMS * 8)) * 8))
    tiles = -(-I // tile)
    cluster = 1
    while (cluster < MAX_CLUSTER and tiles * cluster * 2 <= SMS
           and max(ca, cf) * tile >= cluster * 2 * WALK_THREADS):
        cluster *= 2

    def smem(tile, cluster):
        return 16 * (-(-ca * tile // cluster) + -(-cf * tile // cluster)) \
            + 8 * stride

    while smem(tile, cluster) > SMEM_MAX:
        if cluster < MAX_CLUSTER:
            cluster *= 2
        elif tile > 1:
            tile = -(-tile // 2)
        else:
            raise ValueError(f"walk: chunks of {ca} + {cf} lanes (record "
                             f"of {stride} words) exceed shared memory")
        tiles = -(-I // tile)
    return WalkShape(tile, cluster, tiles, -(-ca * tile // cluster),
                     -(-cf * tile // cluster), smem(tile, cluster))


def _check_walk(fn, meta: ref.WalkMeta, store, operands):
    """Operands of a walk: int32, contiguous, on one device, at the
    shapes the records address (``operands``: (name, tensor, shape with
    I for the instance count)); returns (device, I)."""
    if store.dim() != 3 or store.shape[2] != 4:
        raise ValueError(f"{fn}: store must be (rows, I, 4), got "
                         f"{tuple(store.shape)}")
    I = store.shape[1]
    rec = meta.records
    if meta.garble != (fn == "garble_walk"):
        raise ValueError(f"{fn}: records were packed for the other side")
    if rec.dim() != 2 or rec.shape[1] != ref.walk_stride(
            meta.and_width, meta.free_width, meta.garble):
        raise ValueError(f"{fn}: records do not match the walk's widths")
    if store.shape[0] != meta.store_rows:
        raise ValueError(f"{fn}: store has {store.shape[0]} rows, the "
                         f"records address {meta.store_rows}")
    for name, t, shape in operands:
        shape = tuple(I if d == "I" else d for d in shape)
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    dev = store.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")
    for x in (rec, store, *(t for _, t, _ in operands)):
        if x.device != dev:
            raise ValueError(f"{fn}: operands on {x.device} and {dev}")
        if x.dtype != torch.int32:
            raise TypeError(f"{fn}: operands must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: operands must be contiguous")
        if dev.type == "cuda" and x.data_ptr() % 16:
            raise ValueError(f"{fn}: operands must be 16-byte aligned")
    return dev, I


def _launch_walk(fn, meta, store, I, ptrs):
    shape = walk_shape(meta.and_width, meta.free_width, meta.stride, I)
    lib = _lib()
    dev = store.device
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(
            meta.records.data_ptr(), meta.n_chunks, meta.stride,
            meta.and_width, meta.free_width, store.data_ptr(), I,
            shape.tile, shape.cluster, shape.per_and, shape.per_free,
            shape.smem, *ptrs, torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, fn, lib)


def eval_walk(meta: ref.WalkMeta, store, tg_rows, te_rows) -> None:
    """Evaluate a whole level plan in place on ``store`` ``(rows, I, 4)``
    from the evaluate records ``meta``; ``tg_rows``/``te_rows`` are the
    ``(table_rows, I, 4)`` row stores of the two table halves."""
    rows = (meta.table_rows, "I", 4)
    dev, I = _check_walk("eval_walk", meta, store,
                         (("tg_rows", tg_rows, rows),
                          ("te_rows", te_rows, rows)))
    if dev.type == "cpu":
        return ref.eval_walk(meta, store, tg_rows, te_rows)
    if meta.n_chunks == 0 or I == 0:
        return None
    _launch_walk("eval_walk", meta, store, I,
                 (tg_rows.data_ptr(), te_rows.data_ptr()))
    eval_walk.launches += 1
    return None


eval_walk.launches = 0


def garble_walk(meta: ref.WalkMeta, store, r, tg_store, te_store) -> None:
    """Garble a whole level plan in place on ``store`` ``(rows, I, 4)``
    (its last row holds ``r``, read by INV lanes) from the garble records
    ``meta``; ``r`` is ``(I, 4)`` and the table rows land in
    ``tg_store``/``te_store`` ``(table_rows, I, 4)``."""
    rows = (meta.table_rows, "I", 4)
    dev, I = _check_walk("garble_walk", meta, store,
                         (("r", r, ("I", 4)), ("tg_store", tg_store, rows),
                          ("te_store", te_store, rows)))
    if dev.type == "cpu":
        return ref.garble_walk(meta, store, r, tg_store, te_store)
    if meta.n_chunks == 0 or I == 0:
        return None
    _launch_walk("garble_walk", meta, store, I,
                 (r.data_ptr(), tg_store.data_ptr(), te_store.data_ptr()))
    garble_walk.launches += 1
    return None


garble_walk.launches = 0


def reset_launches() -> None:
    eval_level.launches = 0
    garble_level.launches = 0
    eval_walk.launches = 0
    garble_walk.launches = 0
