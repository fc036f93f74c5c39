"""Active-label encoding: the CUDA kernel's wrapper.

Replaces the JAX package's Pallas kernel
``kernels/label_select/label_select.py:37`` (``select_labels_pallas``) and
its dispatch (``kernels/label_select/ops.py``): :func:`select_labels`
takes the dispatch's operands (labels (..., 4), R broadcastable to them,
bits (...)), flattens them to the kernel's (G, 4) rows and restores the
caller's shape. The kernel is ``csrc/label_select.cu``.

Wrapper rules, as for every kernel of the port: a CPU tensor runs the
plain PyTorch version (``ref.py``); a CUDA tensor launches the kernel
(built with ``nvcc`` on first use) or raises; operands are checked
before the launch; launches are counted in ``select_labels.launches``.

R is passed as a table of rows, each shared by ``group`` consecutive
label rows, when its shape allows (R of shape (I, 1, 4) against labels
(I, n, 4), as the protocol passes it, is I rows with group n); any other
broadcast is materialised to one row per label. ``BYTES_PER_ROW`` and
``OPS_PER_ROW`` are the work per label row, for a roofline bound.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.label_select import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "label_select.cu"

BYTES_PER_ROW = 16 + 4 + 16  # label and bit in, label out (R rows: 16 B each)
OPS_PER_ROW = 1 + 4 + 4  # mask, 4 ANDs, 4 XORs

_P = ctypes.c_void_p
_SIGNATURES = {
    "select_labels": (ctypes.c_int, (_P, _P, _P, _P, ctypes.c_longlong,
                                     ctypes.c_longlong, _P)),
    "error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = build.load(SOURCE, _SIGNATURES)
    return _LIB


def r_rows(r: torch.Tensor, lead: Tuple[int, ...]
           ) -> Tuple[torch.Tensor, int]:
    """(R rows (m, 4), group): label row g reads R row g // group."""
    shape = (1,) * (len(lead) - (r.dim() - 1)) + tuple(r.shape[:-1])
    if len(shape) != len(lead):
        raise ValueError(f"R of shape {tuple(r.shape)} does not broadcast "
                         f"to labels of lead shape {lead}")
    j = len(lead)
    while j and shape[j - 1] == 1:
        j -= 1
    if shape[:j] == lead[:j]:
        return r.reshape(-1, 4).contiguous(), math.prod(lead[j:])
    return r.expand(*lead, 4).reshape(-1, 4).contiguous(), 1


def select_labels(zero_labels: torch.Tensor, r: torch.Tensor, bits
                  ) -> torch.Tensor:
    """zero_labels (..., 4) int32; r broadcastable (..., 4) int32; bits
    (...,) {0, 1} (a tensor or numpy array). Returns (..., 4)."""
    dev = zero_labels.device
    if zero_labels.dtype != torch.int32 or r.dtype != torch.int32:
        raise TypeError("select_labels: labels and R must be int32")
    if zero_labels.shape[-1:] != (4,) or r.shape[-1:] != (4,):
        raise ValueError("select_labels: labels and R must end in 4 words")
    if r.device != dev:
        raise ValueError(f"select_labels: operands on {r.device} and {dev}")
    if not isinstance(bits, torch.Tensor):
        bits = torch.from_numpy(np.asarray(bits).astype(np.int32))
    lead = tuple(zero_labels.shape[:-1])
    bits = bits.to(device=dev, dtype=torch.int32).expand(lead)
    if dev.type == "cpu":
        return ref.select_labels(zero_labels, r, bits)
    if dev.type != "cuda":
        raise ValueError(f"select_labels: unsupported device {dev}")
    w0 = zero_labels.reshape(-1, 4).contiguous()
    rr, group = r_rows(r, lead)
    bits = bits.reshape(-1).contiguous()
    g = w0.shape[0]
    out = torch.empty_like(w0)
    for x in (w0, rr, out):
        if x.data_ptr() % 16:
            raise ValueError("select_labels: labels must be 16-byte aligned")
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.select_labels(w0.data_ptr(), rr.data_ptr(), bits.data_ptr(),
                               out.data_ptr(), g, max(group, 1),
                               torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on(rc, "select_labels", lib)
    if g:
        select_labels.launches += 1
    return out.reshape(*lead, 4)


select_labels.launches = 0


def reset_launches() -> None:
    select_labels.launches = 0
