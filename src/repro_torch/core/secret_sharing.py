"""Additive secret sharing over Z_t (prime t, matching BFV slot batching)
with fixed-point encoding and Beaver-triple private×private matmul.

Fixed point: value v -> round(v·2^frac) mod t (negatives wrap). Products
carry scale 2^frac·2^frac; truncation is deferred into the GC input stage
(exact, free rewiring) — see circuits/shares.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


def encode_fx(x: np.ndarray, frac: int, t: int) -> np.ndarray:
    v = np.round(np.asarray(x, np.float64) * (1 << frac)).astype(np.int64)
    return np.mod(v, t).astype(np.uint64)


def decode_fx(v: np.ndarray, frac: int, t: int, scale_bits: Optional[int] = None) -> np.ndarray:
    v = np.asarray(v, np.uint64).astype(np.int64)
    centered = np.where(v > t // 2, v - t, v)
    return centered.astype(np.float64) / (1 << (scale_bits if scale_bits is not None else frac))


def share(rng: np.random.Generator, x: np.ndarray, t: int) -> Tuple[np.ndarray, np.ndarray]:
    x = np.mod(np.asarray(x, dtype=np.int64), t).astype(np.uint64)
    s1 = rng.integers(0, t, x.shape, dtype=np.uint64)
    s2 = (x.astype(object) - s1.astype(object)) % t
    return s1, s2.astype(np.uint64)


def reconstruct(s1: np.ndarray, s2: np.ndarray, t: int) -> np.ndarray:
    return ((s1.astype(object) + s2.astype(object)) % t).astype(np.uint64)


def add_mod(a, b, t):
    return ((a.astype(object) + b.astype(object)) % t).astype(np.uint64)


def sub_mod(a, b, t):
    return ((a.astype(object) - b.astype(object)) % t).astype(np.uint64)


def matmul_mod(A, B, t):
    """Exact modular matmul via object dtype (sizes are protocol-small)."""
    return np.asarray(
        (np.asarray(A, dtype=object) @ np.asarray(B, dtype=object)) % t
    ).astype(np.uint64)


def scalar_mul_mod(c, A, t):
    return ((int(c) * A.astype(object)) % t).astype(np.uint64)


# ---------------------------------------------------------------------------
# Beaver triples (matmul form): private × private products
# ---------------------------------------------------------------------------


@dataclass
class BeaverTriple:
    """Shares of (A, B, C=A@B) with A:(m,k), B:(k,n)."""

    a1: np.ndarray
    a2: np.ndarray
    b1: np.ndarray
    b2: np.ndarray
    c1: np.ndarray
    c2: np.ndarray


def deal_matmul_triple(rng, m: int, k: int, n: int, t: int) -> BeaverTriple:
    """Offline dealer. In production the triple is generated with the same
    BFV machinery (client encrypts A-share, server mul_plains its B-share);
    bytes for that path are accounted analytically in the benchmarks."""
    A = rng.integers(0, t, (m, k), dtype=np.uint64)
    B = rng.integers(0, t, (k, n), dtype=np.uint64)
    C = matmul_mod(A, B, t)
    a1, a2 = share(rng, A, t)
    b1, b2 = share(rng, B, t)
    c1, c2 = share(rng, C, t)
    return BeaverTriple(a1, a2, b1, b2, c1, c2)


def beaver_matmul(
    x1, x2, y1, y2, trip: BeaverTriple, t: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Shares of X@Y from shares of X, Y. Returns (z1, z2, opened_bytes).

    Each party opens (X−A) and (Y−B); z = C + (X−A)B + A(Y−B) + (X−A)(Y−B),
    the last term computed by party 1 (standard convention).
    """
    e1 = sub_mod(x1, trip.a1, t)
    e2 = sub_mod(x2, trip.a2, t)
    f1 = sub_mod(y1, trip.b1, t)
    f2 = sub_mod(y2, trip.b2, t)
    E = add_mod(e1, e2, t)  # opened
    F = add_mod(f1, f2, t)
    z1 = add_mod(
        add_mod(trip.c1, matmul_mod(E, trip.b1, t), t),
        add_mod(matmul_mod(trip.a1, F, t), matmul_mod(E, F, t), t),
        t,
    )
    z2 = add_mod(
        add_mod(trip.c2, matmul_mod(E, trip.b2, t), t),
        matmul_mod(trip.a2, F, t),
        t,
    )
    opened_bytes = (E.size + F.size) * 8 * 2  # both directions
    return z1, z2, opened_bytes
