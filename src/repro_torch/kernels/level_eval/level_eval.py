"""Garble / evaluate one padded netlist level: CUDA kernels and wrappers.

Replaces the JAX package's Pallas kernels
``kernels/level_eval/level_eval.py:59`` (``eval_level_pallas``) and
``kernels/level_eval/level_eval.py:83`` (``garble_level_pallas``), with the
same operands in the same ``(G, 4)`` layout. The kernels are in
``csrc/level_eval.cu`` (hash in ``kernels/csrc/halfgate.cuh``); see that
file for what bounds them on the H100 and how the design answers it.

Wrapper rules:

* a CPU tensor runs the plain PyTorch version (``ref.py``);
* a CUDA tensor launches the kernel, building it with ``nvcc`` on first
  use, or raises — there is no fallback;
* device, dtype (int32), shape, contiguity and, on the card, 16-byte
  alignment are checked before the launch;
* each wrapper counts its launches in a plain integer attribute
  (``eval_level.launches``, ``garble_level.launches``), incremented only
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
from typing import Optional, Tuple

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


def reset_launches() -> None:
    eval_level.launches = 0
    garble_level.launches = 0
