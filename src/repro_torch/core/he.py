"""BFV-lite parameters: the part of the HE layer the protocol reads.

The private serving path meters every homomorphic message but, at the
widths it serves, computes the masked products with exact modular math
on the host (see ``PiTProtocol.linear_offline``). So this slice of the
port needs only the parameter set: the plaintext modulus t (the share
modulus) and the ciphertext modulus chain that sizes each metered
ciphertext. ``find_ntt_primes`` and ``make_params`` are the JAX
package's (``kernels/ntt/ref.py``, ``core/he.py``), so both packages pick
the same primes. Key generation, encryption, ``he_matvec`` and the NTT
kernel come with the port's HE slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


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


@dataclass(frozen=True)
class BFVParams:
    n: int
    qs: Tuple[int, ...]
    t: int


def make_params(n: int = 2048, log_q: int = 30, num_primes: int = 4,
                t_bits: int = 30) -> BFVParams:
    qs = tuple(find_ntt_primes(log_q, num_primes, n))
    # slot batching needs t ≡ 1 (mod 2n); pick a prime disjoint from qs
    cands = find_ntt_primes(t_bits, num_primes + 2, n)
    t = next(c for c in cands if c not in qs)
    return BFVParams(n=n, qs=qs, t=t)
