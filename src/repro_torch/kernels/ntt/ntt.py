"""Negacyclic NTT: the CUDA kernel's wrappers.

Replaces the JAX package's Pallas kernel ``kernels/ntt/ntt.py:89``
(``ntt_pallas``) and its dispatch (``kernels/ntt/ops.py``). The kernel is
``csrc/ntt.cu`` (32-bit Shoup products, stages merged in registers,
16-byte loads and stores; its header note says how each serves the
bytes bound); it takes any prime q < 2^31 (the Pallas kernel only limb
primes q <= 46340), so the ~30-bit primes of ``core/he.py`` run on the
card too.

``q`` is one prime, or a sequence of P primes with ``a`` shaped
(P, ..., N): the rows of ``a[i]`` are taken mod ``q[i]``, and one launch
transforms every row of every prime.

Wrapper rules, as for every kernel of the port:

* a CPU tensor runs the plain PyTorch version (``ref.py``);
* a CUDA tensor launches the kernel, building it with ``nvcc`` on first
  use, or raises — there is no fallback;
* device, dtype (int64), shape (N a power of two up to 32768), contiguity,
  16-byte alignment (the kernel moves rows as 16-byte vectors) and the
  primes are checked before the launch; the C entry point's error code is
  raised on;
* launches are counted in ``ntt_forward.launches`` and
  ``ntt_inverse.launches``, incremented only where the kernel launches:
  by two for a row of 32768 (the top-stage kernel and the in-block one).

Work, for a roofline bound: ``BYTES_PER_COEFF`` (an int64 read and an
int64 write) and ``OPS_PER_BUTTERFLY`` int32 instructions for each of the
N/2 · log2 N butterflies of a row; the inverse's last stage adds
``OPS_PER_SCALE`` per butterfly for the n^-1 scale folded into it. The
pointwise product between the transforms stays a torch op, as it is a
host-side combine in the reference (``kernels/ntt/ops.py:50``).

Rows up to ``MAX_ROW_N`` run in one block's shared memory. A row of
32768 runs as two launches through a scratch tensor the wrapper
allocates: the top stage over device memory, and the in-block kernel on
its two halves of 16384 (``csrc/ntt.cu``, note 6). That moves the row
twice: the bound, 16 B per coefficient, is the function's, not the
kernel's.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ntt import ref
from repro_torch.kernels.ntt.ref import Primes, primes_of

SOURCE = Path(__file__).resolve().parent / "csrc" / "ntt.cu"
MAX_N = 32768
#: the longest row one block transforms in shared memory
MAX_ROW_N = 16384

BYTES_PER_COEFF = 8 + 8
#: a forward butterfly: the Shoup product (umulhi, mul, mul-add, sub, min)
#: and a modular add and subtract (add, sub, min each); the inverse's is
#: one fewer (its difference goes to the product unreduced)
OPS_PER_BUTTERFLY = 11
#: the inverse's last stage: a second Shoup product replaces the sum's
#: reduction (12 instructions against 10)
OPS_PER_SCALE = 2

_P = ctypes.c_void_p
_SIGNATURES = {
    "ntt": (ctypes.c_int, (_P, _P, _P, _P, _P, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P)),
    "error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}

_LIB: Optional[ctypes.CDLL] = None
_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = build.load(SOURCE, _SIGNATURES)
    return _LIB


def device_tables(qs: Tuple[int, ...], n: int, inverse: bool,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, n, 2) int32 table of {w, w'}: the psi (or inverse psi) powers
    and their Shoup companions w' = floor(w · 2^32 / q), and (P, 8) int32
    constants (q, n^-1, its companion, w[1] · n^-1, its companion, 0, 0,
    0), all as uint32 bit patterns; built once per (primes, n, direction,
    device)."""
    key = (qs, n, inverse, str(device))
    hit = _TABLES.get(key)
    if hit is None:
        tabs = [ref.kernel_tables(q, n, inverse) for q in qs]
        table = np.stack([t for t, _ in tabs]).astype(np.uint32)
        consts = np.stack([c for _, c in tabs]).astype(np.uint32)
        hit = _TABLES[key] = (torch.from_numpy(table.view(np.int32)).to(device),
                              torch.from_numpy(consts.view(np.int32)).to(device))
    return hit


def _launch(fn, a: torch.Tensor, q: Primes, inverse: bool) -> torch.Tensor:
    qs = primes_of(q)
    name = fn.__name__
    if a.dtype != torch.int64:
        raise TypeError(f"{name}: residues must be int64, got {a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {a.device}")
    n = a.shape[-1] if a.dim() else 0
    if a.device.type == "cpu":
        return (ref.ntt_inverse if inverse else ref.ntt_forward)(a, qs)
    if not a.is_contiguous():
        raise ValueError(f"{name}: residues must be contiguous")
    if a.data_ptr() % 16:
        raise ValueError(f"{name}: residues must be 16-byte aligned")
    if not 2 <= n <= MAX_N or n & (n - 1):
        raise ValueError(f"{name}: N must be a power of two in [2, {MAX_N}],"
                         f" got {n}")
    if len(qs) > 1 and a.shape[0] != len(qs):
        raise ValueError(f"{name}: {len(qs)} primes need a leading dimension"
                         f" of {len(qs)}, got shape {tuple(a.shape)}")
    for p in qs:
        ref.check_prime(p, n)
    rows = a.numel() // n
    table, consts = device_tables(qs, n, inverse, a.device)
    out = torch.empty_like(a)
    scratch = torch.empty_like(a) if n > MAX_ROW_N and rows else None
    lib = _lib()
    with torch.cuda.device(a.device):
        rc = lib.ntt(a.data_ptr(), out.data_ptr(),
                     None if scratch is None else scratch.data_ptr(),
                     table.data_ptr(),
                     consts.data_ptr(), rows, rows // len(qs), n, int(inverse),
                     torch.cuda.current_stream(a.device).cuda_stream)
    build.raise_on(rc, name, lib)
    if rows:
        fn.launches += 2 if n > MAX_ROW_N else 1
    return out


def ntt_forward(a: torch.Tensor, q: Primes) -> torch.Tensor:
    """(..., N) int64 residues in [0, q) -> NTT domain (bit-reversed)."""
    return _launch(ntt_forward, a, q, False)


def ntt_inverse(a: torch.Tensor, q: Primes) -> torch.Tensor:
    """NTT domain -> (..., N) coefficients, n^-1 scaled."""
    return _launch(ntt_inverse, a, q, True)


ntt_forward.launches = 0
ntt_inverse.launches = 0


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor, q: Primes
                   ) -> torch.Tensor:
    """a * b mod (X^N + 1, q): two forward launches, a pointwise torch
    product, one inverse launch."""
    return ntt_inverse(ref.mul_pointwise(ntt_forward(a, q), ntt_forward(b, q),
                                         q), q)


def reset_launches() -> None:
    ntt_forward.launches = 0
    ntt_inverse.launches = 0
