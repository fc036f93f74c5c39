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


# ---------------------------------------------------------------------------
# 32-bit Shoup products, and a schedule model of the CUDA kernel
# ---------------------------------------------------------------------------

_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def shoup_companion(w, q: int) -> np.ndarray:
    """w' = floor(w * 2^32 / q) of residues w < q < 2^31 (uint64)."""
    return (np.asarray(w, np.uint64) << _S32) // np.uint64(q)


def shoup_mul32(a, w, wp, q) -> np.ndarray:
    """a * w mod q as the kernel computes it in uint32 arithmetic:
    r = a*w - umulhi(a, w')*q mod 2^32, in [0, 2q), then min(r, r - q).
    Exact for a < 2^32, w < q < 2^31 (emulated in uint64 with masks)."""
    a, w, wp, q = (np.asarray(v, np.uint64) for v in (a, w, wp, q))
    hi = (a * wp) >> _S32
    r = (a * w - hi * q) & _M32
    return np.minimum(r, (r - q) & _M32)


def kernel_tables(q: int, n: int, inverse: bool
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's per-prime tables: (n, 2) uint64 {w, w'} of the psi (or
    inverse psi) table, and 8 uint64 constants: q, n^-1, its companion,
    w[1] * n^-1 (the inverse's last-stage twiddle with the scale folded
    in) and its companion, then zeros."""
    psi, ipsi, n_inv = ntt_tables(q, n)
    w = (ipsi if inverse else psi).astype(np.uint64)
    last = int(w[1]) * n_inv % q
    consts = [q, n_inv, int(shoup_companion(n_inv, q)), last,
              int(shoup_companion(last, q)), 0, 0, 0]
    return (np.stack([w, shoup_companion(w, q)], -1),
            np.array(consts, dtype=np.uint64))


# The functions below are a model of ``csrc/ntt.cu`` for the tests only:
# the kernel cannot run without a card, so they replay its launch shape,
# its thread / register / round index mapping, its swizzled shared-memory
# exchanges, its twiddle indices and its 32-bit arithmetic on the CPU, line
# for line, for a test to hold against ntt_forward / ntt_inverse. Nothing
# else calls them.

#: log2 of the coefficients a thread holds, and threads per block, as in
#: the kernel (kLogR, kBlock)
KERNEL_LOG_R = 4
KERNEL_BLOCK = 128


def kernel_shape(n: int) -> Tuple[int, int, int]:
    """(log2 R, log2 threads per row, rows per block) of a launch."""
    log_n = n.bit_length() - 1
    log_r = min(KERNEL_LOG_R, log_n)
    lt = log_n - log_r
    return log_r, lt, max(1 << lt, KERNEL_BLOCK) >> lt


def _swz(a):
    h = a >> 5
    return a ^ ((h ^ (h >> 1) ^ (h >> 2) ^ (h << 1)) & 31)


def kernel_addresses(n: int, layout: int, t, rib) -> list:
    """Shared-memory words of registers 0..R-1 of threads (rib, t) in a
    layout (-1: io; else the mid layout's base), as ``addresses``
    computes them: the thread's part and r basis words swizzled, the rest
    by XOR."""
    log_r, lt, _ = kernel_shape(n)
    row_off = rib << (n.bit_length() - 1)
    if layout < 0:
        tpart = row_off | (t << 1)
        basis = [1] + [_swz(1 << (lt + i)) for i in range(1, log_r)]
    else:
        tpart = (row_off | (t & ((1 << layout) - 1))
                 | ((t >> layout) << (layout + log_r)))
        basis = [_swz(1 << (layout + i)) for i in range(log_r)]
    a0 = _swz(tpart)
    out = []
    for k in range(1 << log_r):
        a = a0
        for i in range(log_r):
            if (k >> i) & 1:
                a = a ^ basis[i]
        out.append(a)
    return out


class _Rows:
    """Per-thread state of a model launch: registers ``x`` (R arrays of
    shape (groups, rows per block, threads per row)) and the row's prime."""

    def __init__(self, data, p, qs, tables, n, inverse):
        self.log_r, self.lt, self.rpb = kernel_shape(n)
        self.n, self.log_n, self.inverse = n, n.bit_length() - 1, inverse
        self.t = np.arange(1 << self.lt, dtype=np.int64)
        self.rib = np.arange(self.rpb, dtype=np.int64)[:, None]
        self.p = p[..., None]                      # (G, rpb, 1)
        self.q = np.asarray(qs, np.uint64)[self.p]
        self.tw = np.stack([t for t, _ in tables])   # (P, n, 2)
        self.consts = np.stack([c for _, c in tables])[self.p]
        self.x = []
        for c2 in range(1 << (self.log_r - 1)):
            e = 2 * self.t + (c2 << (self.lt + 1))
            self.x += [data[:, :, e], data[:, :, e + 1]]
        self.exchanges = []

    def twiddle(self, widx):
        w = self.tw[self.p, np.broadcast_to(widx, self.x[0].shape)]
        return w[..., 0], w[..., 1]

    def butterfly(self, k, k2, w, wp):
        a, b, q = self.x[k], self.x[k2], self.q
        if not self.inverse:
            v = shoup_mul32(b, w, wp, q)
            d, s = (a - v) & _M32, (a + v) & _M32
            self.x[k2] = np.minimum(d, (d + q) & _M32)
            self.x[k] = np.minimum(s, (s - q) & _M32)
        else:
            d, s = (a + q - b) & _M32, (a + b) & _M32
            self.x[k] = np.minimum(s, (s - q) & _M32)
            self.x[k2] = shoup_mul32(d, w, wp, q)

    def butterfly_scaled(self, k, k2):
        a, b, q, c = self.x[k], self.x[k2], self.q, self.consts
        s, d = (a + b) & _M32, (a + q - b) & _M32
        self.x[k] = shoup_mul32(s, c[..., 1], c[..., 2], q)
        self.x[k2] = shoup_mul32(d, c[..., 3], c[..., 4], q)

    def _order(self):
        r = self.log_r
        return range(r) if self.inverse else range(r - 1, -1, -1)

    def io_stages(self, i_lo, i_hi):
        r, lt, t = self.log_r, self.lt, self.t
        for i in self._order():
            if i < i_lo or i > i_hi:
                continue
            for k in range(1 << r):
                if k & (1 << i):
                    continue
                if self.inverse and i == r - 1:
                    self.butterfly_scaled(k, k | (1 << i))
                    continue
                widx = ((1 << (lt + r - 1)) + t + ((k >> 1) << lt) if i == 0
                        else np.int64((1 << (r - 1 - i)) + (k >> (i + 1))))
                self.butterfly(k, k | (1 << i), *self.twiddle(widx))

    def mid_stages(self, i_lo, i_hi, base):
        r, thigh = self.log_r, self.t >> base
        for i in self._order():
            if i < i_lo or i > i_hi:
                continue
            wbase = (1 << (self.log_n - 1 - base - i)) + (thigh << (r - 1 - i))
            for k in range(1 << r):
                if not k & (1 << i):
                    self.butterfly(k, k | (1 << i),
                                   *self.twiddle(wbase + (k >> (i + 1))))

    def exchange(self, frm, to):
        """Write every register at its ``frm`` word, read at its ``to``
        word; each word of the block's buffer is written exactly once."""
        self.exchanges.append((frm, to))
        G = self.x[0].shape[0]
        words = self.rpb << self.log_n
        buf = np.full((G, words), np.uint64(1) << np.uint64(40))
        src = kernel_addresses(self.n, frm, self.t, self.rib)
        flat = np.concatenate([np.broadcast_to(a, self.x[0].shape[1:]).ravel()
                               for a in src])
        assert np.array_equal(np.sort(flat), np.arange(words)), \
            "an exchange must write each word once"
        for a, v in zip(src, self.x):
            buf[:, np.broadcast_to(a, v.shape[1:])] = v
        self.x = [buf[:, np.broadcast_to(a, self.x[0].shape[1:])]
                  for a in kernel_addresses(self.n, to, self.t, self.rib)]


def kernel_model(a: torch.Tensor, q: Primes, inverse: bool):
    """Schedule model of the CUDA kernel (tests only): the transform of
    ``a`` as ``csrc/ntt.cu`` computes it, and the (from, to) layouts of
    the exchanges one row went through."""
    qs = primes_of(q)
    x = _layout(a, qs)
    P, R, n = x.shape
    log_r, lt, rpb = kernel_shape(n)
    rows = P * R
    groups = -(-rows // rpb)
    data = np.zeros((groups * rpb, n), np.uint64)
    data[:rows] = x.reshape(rows, n).numpy().astype(np.uint64)
    row = np.arange(groups * rpb)
    p = np.minimum(row, rows - 1) // R
    m = _Rows(data.reshape(groups, rpb, n), p.reshape(groups, rpb), qs,
              [kernel_tables(qq, n, inverse) for qq in qs], n, inverse)

    m.io_stages(0 if inverse else 1, 0 if inverse else log_r - 1)
    if lt > 0:
        frm = -1
        if not inverse:
            hi = lt
            while hi >= 1:
                lo, base = max(1, hi - log_r + 1), max(0, hi - log_r + 1)
                m.exchange(frm, base)
                m.mid_stages(lo - base, hi - base, base)
                frm, hi = base, lo - 1
        else:
            lo = 1
            while lo <= lt:
                hi = min(lt, lo + log_r - 1)
                base = max(0, hi - log_r + 1)
                m.exchange(frm, base)
                m.mid_stages(lo - base, hi - base, base)
                frm, lo = base, hi + 1
        m.exchange(frm, -1)
    m.io_stages(1 if inverse else 0, log_r - 1 if inverse else 0)

    out = np.zeros((groups, rpb, n), np.uint64)
    for c2 in range(1 << (log_r - 1)):
        e = 2 * m.t + (c2 << (lt + 1))
        out[:, :, e], out[:, :, e + 1] = m.x[2 * c2], m.x[2 * c2 + 1]
    res = torch.from_numpy(out.reshape(-1, n)[:rows].astype(np.int64))
    return res.reshape(a.shape), m.exchanges
