"""Half-Gate garbling / evaluation of independent AND gates: the CUDA
kernels' wrappers and the entry points that flatten to them.

Replaces the JAX package's Pallas kernels
``kernels/halfgate/halfgate.py:64`` (``garble_pallas``) and ``:95``
(``eval_pallas``), and their dispatch (``kernels/halfgate/ops.py``):

* :func:`garble_gates` / :func:`eval_gates` take the kernels' own
  (G, 4) operands (per-gate r, (G,) tweaks), as the Pallas functions do;
* :func:`garble_and_gates` / :func:`eval_and_gates` take labels (..., 4)
  with r and tweaks broadcastable to them, flatten, and restore the
  caller's shape, as ``ops.py`` does;
* :func:`hash_labels` is the plain hash, as in ``ops.py``.

The kernels are in ``csrc/halfgate.cu`` (cipher in
``kernels/csrc/halfgate.cuh``). Wrapper rules, as for every kernel of the
port: a CPU tensor runs the plain PyTorch version (``ref.py``); a CUDA
tensor launches the kernel (built with ``nvcc`` on first use) or raises;
operands are checked before the launch; launches are counted in
``garble_gates.launches`` and ``eval_gates.launches``.

Work per gate, for a roofline bound: ``GARBLE_BYTES`` / ``EVAL_BYTES``
(each input read once, each output written once) and ``GARBLE_OPS`` /
``EVAL_OPS`` 32-bit integer operations (115 per hash, see
``halfgate.cuh``, plus the Half-Gate algebra).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, operands
from repro_torch.kernels.halfgate import ref
from repro_torch.kernels.halfgate.ref import hash_labels  # noqa: F401

SOURCE = Path(__file__).resolve().parent / "csrc" / "halfgate.cu"

HASH_OPS = 115
GARBLE_OPS = 4 * HASH_OPS + 58  # tweaks 2, r-xors 8, masks 4, tg 12, te 8, wg 8, we 12, c0 4
EVAL_OPS = 2 * HASH_OPS + 30  # tweaks 2, masks 4, wg 8, we 12, c 4
GARBLE_BYTES = 3 * 16 + 4 + 3 * 16  # a0, b0, r, tweak in; c0, tg, te out
EVAL_BYTES = 4 * 16 + 4 + 16  # a, b, tg, te, tweak in; c out

_P = ctypes.c_void_p
_SIGNATURES = {
    "garble_and": (ctypes.c_int, (_P,) * 7 + (ctypes.c_longlong, _P)),
    "eval_and": (ctypes.c_int, (_P,) * 6 + (ctypes.c_longlong, _P)),
    "error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = build.load(SOURCE, _SIGNATURES)
    return _LIB


def garble_gates(a0, b0, r, tweaks
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """a0, b0, r (G, 4); tweaks (G,), all int32 -> (c0, tg, te), each
    (G, 4): output zero-labels and the two garbled table rows."""
    dev, g = operands.check("garble_gates", (tweaks,), (a0, b0, r))
    if dev.type == "cpu":
        return ref.garble_and_gates(a0, b0, r, tweaks)
    c0, tg, te = (torch.empty_like(a0) for _ in range(3))
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.garble_and(a0.data_ptr(), b0.data_ptr(), r.data_ptr(),
                            tweaks.data_ptr(), c0.data_ptr(), tg.data_ptr(),
                            te.data_ptr(), g,
                            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "garble_gates", lib)
    if g:
        garble_gates.launches += 1
    return c0, tg, te


def eval_gates(a, b, tg, te, tweaks) -> torch.Tensor:
    """a, b, tg, te (G, 4); tweaks (G,), all int32 -> output labels (G, 4)."""
    dev, g = operands.check("eval_gates", (tweaks,), (a, b, tg, te))
    if dev.type == "cpu":
        return ref.eval_and_gates(a, b, tg, te, tweaks)
    out = torch.empty_like(a)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.eval_and(a.data_ptr(), b.data_ptr(), tg.data_ptr(),
                          te.data_ptr(), tweaks.data_ptr(), out.data_ptr(), g,
                          torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "eval_gates", lib)
    if g:
        eval_gates.launches += 1
    return out


garble_gates.launches = 0
eval_gates.launches = 0


def _rows(x: torch.Tensor, lead) -> torch.Tensor:
    return x.expand(*lead, 4).reshape(-1, 4).contiguous()


def _tweaks(tweaks: torch.Tensor, lead) -> torch.Tensor:
    return tweaks.to(torch.int32).expand(lead).reshape(-1).contiguous()


def garble_and_gates(a0, b0, r, tweaks):
    """a0, b0 (..., 4); r broadcastable (..., 4); tweaks broadcastable
    (...,). Returns (c0, tg, te), each (..., 4)."""
    lead = tuple(a0.shape[:-1])
    out = garble_gates(_rows(a0, lead), _rows(b0, lead), _rows(r, lead),
                       _tweaks(tweaks, lead))
    return tuple(x.reshape(*lead, 4) for x in out)


def eval_and_gates(a, b, tg, te, tweaks):
    """a, b, tg, te (..., 4); tweaks broadcastable (...,). -> (..., 4)."""
    lead = tuple(a.shape[:-1])
    out = eval_gates(*(_rows(x, lead) for x in (a, b, tg, te)),
                     _tweaks(tweaks, lead))
    return out.reshape(*lead, 4)


def reset_launches() -> None:
    garble_gates.launches = 0
    eval_gates.launches = 0
