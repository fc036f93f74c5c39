"""Negacyclic NTT over Z_q[X]/(X^N+1): the plain PyTorch version.

Bit for bit the JAX package's ``kernels/ntt/ref.py``: Longa–Naehrig
iterative butterflies with merged, bit-reversed psi tables, so the
forward and inverse transforms need no separate twisting; the forward
output is in bit-reversed order and the inverse ends with the n^-1 scale.

Residues are ``int64`` tensors in [0, q). Torch has no unsigned 64-bit
arithmetic on the CPU, so every prime must be below 2^31: a product of
two residues is then below 2^62 and fits int64 exactly. This is also the
reference's own limit (its products are uint64); where the reference
would overflow silently, :func:`check_prime` raises.

A batch may span several primes (the RNS limbs of a ciphertext): with
``q`` a sequence of P primes, ``a`` has shape (P, ..., N) and the rows of
``a[i]`` are transformed modulo ``q[i]``. The CUDA kernel in
``csrc/ntt.cu`` takes the same layout.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

#: every prime must be below this: products of two residues fit int64
MAX_PRIME = 1 << 31
#: q^2 < 2^31: the JAX package's Pallas kernel's limit (exact int32 products)
INT32_PRODUCT_BOUND = 46340

Primes = Union[int, Sequence[int]]


# ---------------------------------------------------------------------------
# parameter search (host-side, python ints)
# ---------------------------------------------------------------------------


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_primes(bits: int, count: int, n: int,
                    max_q: Optional[int] = None) -> list:
    """`count` primes q ≡ 1 (mod 2n) just below min(2^bits, max_q)."""
    out = []
    step = 2 * n
    hi = (1 << bits) - 1
    if max_q is not None:
        hi = min(hi, max_q)
    q = hi // step * step + 1
    if q > hi:
        q -= step
    while len(out) < count and q > 2 * n:
        if _is_prime(q):
            out.append(q)
        q -= step
    assert len(out) == count, f"not enough {bits}-bit NTT primes for N={n}"
    return out


def find_primitive_root(q: int, order: int) -> int:
    """An element of exact multiplicative order `order` mod prime q."""
    assert (q - 1) % order == 0
    for g in range(2, 10000):
        x = pow(g, (q - 1) // order, q)
        if pow(x, order // 2, q) != 1:  # order does not divide order/2
            return x
    raise RuntimeError("no root found")


def _bit_reverse(x: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(bits):
        out = (out << 1) | ((x >> i) & 1)
    return out


def check_prime(q: int, n: int) -> None:
    """Raise unless q is a usable NTT prime for length n here."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"NTT length must be a power of two >= 2, got {n}")
    if not 2 * n < q < MAX_PRIME:
        raise ValueError(
            f"NTT modulus {q} must lie in (2N, 2^31): residue products must "
            "fit int64 (the JAX reference needs q < 2^31 for uint64 too)")
    if (q - 1) % (2 * n):
        raise ValueError(f"NTT modulus {q} is not 1 mod 2N = {2 * n}")


@functools.lru_cache(maxsize=64)
def ntt_tables(q: int, n: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(psi_br, ipsi_br, n_inv): bit-reversed powers of psi (2n-th root),
    as int64 arrays."""
    check_prime(q, n)
    psi = find_primitive_root(q, 2 * n)
    assert pow(psi, n, q) == q - 1  # psi^n = -1 (negacyclic)
    bits = n.bit_length() - 1
    br = _bit_reverse(np.arange(n, dtype=np.int64), bits)
    powers = np.array([pow(psi, i, q) for i in range(n)], dtype=np.int64)
    ipowers = np.array([pow(psi, (-i) % (2 * n), q) for i in range(n)],
                       dtype=np.int64)
    return powers[br], ipowers[br], pow(n, q - 2, q)


# ---------------------------------------------------------------------------
# torch butterflies
# ---------------------------------------------------------------------------


def primes_of(q: Primes) -> Tuple[int, ...]:
    return (int(q),) if isinstance(q, (int, np.integer)) else \
        tuple(int(x) for x in q)


def _layout(a: torch.Tensor, qs: Tuple[int, ...]) -> torch.Tensor:
    """View ``a`` as (P, R, N): R rows under each of the P primes."""
    if a.dtype != torch.int64:
        raise TypeError(f"NTT residues must be int64, got {a.dtype}")
    n = a.shape[-1]
    for q in qs:
        check_prime(q, n)
    if len(qs) > 1 and (a.dim() < 2 or a.shape[0] != len(qs)):
        raise ValueError(f"{len(qs)} primes need a leading dimension of "
                         f"{len(qs)}, got shape {tuple(a.shape)}")
    return a.reshape(len(qs), -1, n)


def _col(vals, device) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.int64, device=device)


def _tables(qs, n, inverse, device):
    tabs = [ntt_tables(q, n) for q in qs]
    table = torch.from_numpy(np.stack([t[1 if inverse else 0] for t in tabs]))
    return table.to(device), _col([t[2] for t in tabs], device)


def _addmod(u, v, q):
    s = u + v
    return torch.where(s >= q, s - q, s)


def _submod(u, v, q):
    d = u - v
    return torch.where(d < 0, d + q, d)


def ntt_forward(a: torch.Tensor, q: Primes) -> torch.Tensor:
    """a: (..., N) int64 residues -> NTT domain (bit-reversed order)."""
    qs = primes_of(q)
    x = _layout(a, qs)
    P, R, n = x.shape
    psi, _ = _tables(qs, n, False, a.device)
    qv = _col(qs, a.device).view(P, 1, 1, 1)
    t, m = n, 1
    while m < n:
        t //= 2
        x = x.reshape(P, R, m, 2 * t)
        u, v = x[..., :t], x[..., t:]
        v = v * psi[:, m:2 * m].view(P, 1, m, 1) % qv
        x = torch.cat([_addmod(u, v, qv), _submod(u, v, qv)], dim=-1)
        m *= 2
    return x.reshape(a.shape)


def ntt_inverse(a: torch.Tensor, q: Primes) -> torch.Tensor:
    """NTT domain (bit-reversed) -> (..., N) coefficients, n^-1 scaled."""
    qs = primes_of(q)
    x = _layout(a, qs)
    P, R, n = x.shape
    ipsi, n_inv = _tables(qs, n, True, a.device)
    qv = _col(qs, a.device).view(P, 1, 1, 1)
    t, m = 1, n
    while m > 1:
        h = m // 2
        x = x.reshape(P, R, h, 2 * t)
        u, v = x[..., :t], x[..., t:]
        nu = _addmod(u, v, qv)
        nv = _submod(u, v, qv) * ipsi[:, h:2 * h].view(P, 1, h, 1) % qv
        x = torch.cat([nu, nv], dim=-1)
        t *= 2
        m = h
    x = x.reshape(P, R, n) * n_inv.view(P, 1, 1) % qv.view(P, 1, 1)
    return x.reshape(a.shape)


def mul_pointwise(fa: torch.Tensor, fb: torch.Tensor, q: Primes
                  ) -> torch.Tensor:
    """fa * fb mod q, broadcasting; with P primes the leading dimension
    of both is P."""
    qs = primes_of(q)
    fa, fb = torch.broadcast_tensors(fa, fb)
    qv = _col(qs, fa.device).view(len(qs), *([1] * (fa.dim() - 1))) \
        if len(qs) > 1 else qs[0]
    return fa * fb % qv


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor, q: Primes
                   ) -> torch.Tensor:
    """a * b mod (X^N + 1, q) via NTT -> pointwise -> INTT."""
    return ntt_inverse(mul_pointwise(ntt_forward(a, q), ntt_forward(b, q), q),
                       q)


def negacyclic_mul_naive(a: np.ndarray, b: np.ndarray, q: int, n: int
                         ) -> np.ndarray:
    """O(N^2) oracle for tests (python ints, no overflow)."""
    a = np.asarray(a, dtype=object)
    b = np.asarray(b, dtype=object)
    out = np.zeros(n, dtype=object)
    for i in range(n):
        if int(a[i]) == 0:
            continue
        for j in range(n):
            k = i + j
            v = int(a[i]) * int(b[j])
            if k >= n:
                out[k - n] = (out[k - n] - v) % q
            else:
                out[k] = (out[k] + v) % q
    return out.astype(np.int64)
