"""BFV-lite: exactly the homomorphic surface the APINT protocol needs.

The JAX package's ``core/he.py`` on torch tensors:

  * RNS ciphertext modulus Q = Π q_i (NTT primes ~30 bits); a ciphertext
    is a pair (c0, c1) of (k, n) int64 residue tensors on one device, or
    (k, B, n) for B ciphertexts stacked along dimension 1
  * plaintext modulus t: prime ≡ 1 (mod 2n) -> slot batching (the
    plaintext NTT over Z_t reuses the same butterflies, so it needs
    t < 2^31 here; :func:`encode_slots` raises above that, where the
    reference's uint64 products would overflow silently)
  * enc / dec / ct+ct / ct+pt / ct×pt — no ct×ct, no relinearization
  * coefficient-packed matvec (Cheetah-style inner-product packing) for
    the offline Linear(R) evaluation

Every negacyclic product goes through the NTT of
``repro_torch.kernels.ntt``: on a CUDA tensor that is the CUDA kernel, one
forward and one inverse launch per operation, covering every RNS limb and
every ciphertext of a batch at once (the reference transforms one
polynomial per call and redoes the ciphertext's transform for every
plaintext; the NTT is exact, so the results are the same).

Randomness comes from an explicit CPU ``torch.Generator`` and follows the
reference's distributions (ternary s and u, centred binomial errors with
η = 3, ``a`` uniform mod each q_i); draws are made on the host and moved
to the device, so a seed gives the same keys on every device. Decryption
reconstructs each coefficient by CRT in Python integers (numpy object
dtype; Q is about 2^90) and rounds exactly as the reference does.
:func:`from_reference` / :func:`to_reference` carry keys and ciphertexts
across from and back to the reference's numpy arrays.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ntt import ntt as NTT
from repro_torch.kernels.ntt.ref import find_ntt_primes

Ciphertext = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class BFVParams:
    n: int
    qs: Tuple[int, ...]
    t: int

    @property
    def Q(self) -> int:
        out = 1
        for q in self.qs:
            out *= q
        return out

    @functools.cached_property
    def delta_rns(self) -> np.ndarray:
        d = self.Q // self.t
        return np.array([d % q for q in self.qs], dtype=np.int64)

    @functools.cached_property
    def crt_weights(self):
        """(Q_i_hat, inv) pairs for CRT reconstruction (python ints)."""
        out = []
        for q in self.qs:
            qh = self.Q // q
            out.append((qh, pow(qh % q, q - 2, q)))
        return out


def make_params(n: int = 2048, log_q: int = 30, num_primes: int = 4,
                t_bits: int = 30) -> BFVParams:
    qs = tuple(find_ntt_primes(log_q, num_primes, n))
    # slot batching needs t ≡ 1 (mod 2n); pick a prime disjoint from qs
    cands = find_ntt_primes(t_bits, num_primes + 2, n)
    t = next(c for c in cands if c not in qs)
    return BFVParams(n=n, qs=qs, t=t)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _qcol(params: BFVParams, device, dims: int) -> torch.Tensor:
    """The primes as a (k, 1, ..., 1) int64 column of ``dims`` dims."""
    return torch.tensor(params.qs, dtype=torch.int64,
                        device=device).view(-1, *([1] * (dims - 1)))


def _as_tensor(x, device) -> torch.Tensor:
    """numpy (any integer dtype, values < 2^63) or tensor -> int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


def _to_rns(poly: torch.Tensor, params: BFVParams) -> torch.Tensor:
    """(..., n) signed int64 -> (k, ..., n) residues mod each q_i."""
    return torch.remainder(poly.unsqueeze(0), _qcol(params, poly.device,
                                                    poly.dim() + 1))


def _ternary(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.randint(-1, 2, (n,), dtype=torch.int64, generator=gen)


def _cbd(gen: torch.Generator, n: int, eta: int = 3) -> torch.Tensor:
    """Centered binomial error, var = eta/2."""
    bits = torch.randint(0, 2, (2 * eta, n), dtype=torch.int64, generator=gen)
    return bits[:eta].sum(0) - bits[eta:].sum(0)


def _products(params: BFVParams, left: torch.Tensor, right: torch.Tensor,
              pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Negacyclic products left[:, i] * right[:, j] for each (i, j) of
    ``pairs`` mod every q: one forward launch over the rows of both, one
    inverse launch over the products. left (k, L, n), right (k, R, n);
    returns (k, len(pairs), n)."""
    L = left.shape[1]
    f = NTT.ntt_forward(torch.cat([left, right], 1).contiguous(), params.qs)
    li = torch.tensor([i for i, _ in pairs], device=f.device)
    ri = torch.tensor([L + j for _, j in pairs], device=f.device)
    prod = f[:, li] * f[:, ri] % _qcol(params, f.device, 3)
    return NTT.ntt_inverse(prod, params.qs)


# ---------------------------------------------------------------------------
# keys / encrypt / decrypt
# ---------------------------------------------------------------------------


def keygen(params: BFVParams, gen: torch.Generator, device="cuda"
           ) -> Tuple[torch.Tensor, Ciphertext]:
    """(s, pk = (b, a)): s (n,) ternary, b = −(a·s + e) mod each q_i."""
    n = params.n
    s = _ternary(gen, n)
    a = torch.stack([torch.randint(0, q, (n,), dtype=torch.int64,
                                   generator=gen) for q in params.qs])
    e = _cbd(gen, n)
    s, a, e = s.to(device), a.to(device), e.to(device)
    qv = _qcol(params, device, 2)
    as_ = _products(params, a.unsqueeze(1), _to_rns(s, params).unsqueeze(1),
                    [(0, 0)])[:, 0]
    b = torch.remainder(-as_ - _to_rns(e, params), qv)
    return s, (b, a)


def encrypt(params: BFVParams, pk: Ciphertext, pt_poly,
            gen: torch.Generator) -> Ciphertext:
    """pt_poly: (n,) integers in [0, t). Returns ct = (c0, c1), each (k, n),
    on the public key's device."""
    b, a = pk
    dev = b.device
    n = params.n
    u = _to_rns(_ternary(gen, n), params).to(dev)
    e1 = _to_rns(_cbd(gen, n), params).to(dev)
    e2 = _to_rns(_cbd(gen, n), params).to(dev)
    qv = _qcol(params, dev, 2)
    pt = _as_tensor(pt_poly, dev)
    d = torch.from_numpy(params.delta_rns).to(dev).view(-1, 1)
    dm = d * torch.remainder(pt, qv) % qv
    bu, au = _products(params, torch.stack([b, a], 1), u.unsqueeze(1),
                       [(0, 0), (1, 0)]).unbind(1)
    return (bu + e1 + dm) % qv, (au + e2) % qv


def matvec_coeffs(params: BFVParams, d_in: int, d_out: int) -> np.ndarray:
    """Coefficient of each packed output within one matvec ciphertext."""
    per_ct, _ = matvec_plan(params, d_in, d_out)
    return np.arange(per_ct) * d_in + d_in - 1


def decrypt(params: BFVParams, s: torch.Tensor, ct: Ciphertext,
            coeffs: Optional[np.ndarray] = None) -> np.ndarray:
    """Plaintext polys in [0, t) as numpy uint64: (n,) for one (k, n)
    ciphertext, (B, n) for B stacked ones. Exact CRT scaling.

    ``coeffs`` restricts the CRT and rounding (host work) to those
    coefficient positions, e.g. :func:`matvec_coeffs`: the result is
    then (..., len(coeffs)), equal to the full result at those positions.
    """
    c0, c1 = ct
    one = c0.dim() == 2
    if one:
        c0, c1 = c0.unsqueeze(1), c1.unsqueeze(1)
    B = c1.shape[1]
    s_rns = _to_rns(s.to(c1.device), params).unsqueeze(1)
    cs = _products(params, c1, s_rns, [(j, 0) for j in range(B)])
    phase = ((c0 + cs) % _qcol(params, c0.device, 3)).cpu().numpy()
    if coeffs is not None:
        phase = phase[..., np.asarray(coeffs, np.int64)]
    # CRT reconstruct to python ints, then m = round(t * c / Q) mod t
    Q, t = params.Q, params.t
    c = np.zeros(phase.shape[1:], dtype=object)
    for i, (q, (qh, inv)) in enumerate(zip(params.qs, params.crt_weights)):
        c = c + (phase[i] * inv % q).astype(object) * qh
    c %= Q
    out = ((c * t + Q // 2) // Q % t).astype(np.uint64)
    return out[0] if one else out


# ---------------------------------------------------------------------------
# homomorphic ops
# ---------------------------------------------------------------------------


def add_ct(params: BFVParams, ct_a: Ciphertext, ct_b: Ciphertext
           ) -> Ciphertext:
    qv = _qcol(params, ct_a[0].device, ct_a[0].dim())
    return tuple((x + y) % qv for x, y in zip(ct_a, ct_b))


def add_plain(params: BFVParams, ct: Ciphertext, pt_poly) -> Ciphertext:
    c0, c1 = ct
    qv = _qcol(params, c0.device, 2)
    d = torch.from_numpy(params.delta_rns).to(c0.device).view(-1, 1)
    pt = _as_tensor(pt_poly, c0.device)
    return (c0 + d * torch.remainder(pt, qv) % qv) % qv, c1


def mul_plain(params: BFVParams, ct: Ciphertext, pt_poly,
              center: bool = True) -> Ciphertext:
    """ct × pt (negacyclic poly product per RNS prime, NTT-based).

    ``pt_poly`` is (n,) in [0, t), giving a (k, n) ciphertext, or (B, n),
    giving B products stacked as (k, B, n) — one forward and one inverse
    NTT launch for the whole batch. ``center`` lifts plaintext residues to
    [−t/2, t/2) before reducing mod each q_i: same result mod t, but noise
    grows with the *signed* magnitude.
    """
    c0, c1 = ct
    v = np.asarray(pt_poly.cpu() if isinstance(pt_poly, torch.Tensor)
                   else pt_poly).astype(np.uint64).astype(np.int64)
    if center:
        v = np.where(v > params.t // 2, v - params.t, v)
    one = v.ndim == 1
    p = _to_rns(_as_tensor(v.reshape(-1, params.n), c0.device), params)
    B = p.shape[1]
    out = _products(params, torch.stack([c0, c1], 1), p,
                    [(i, j) for i in (0, 1) for j in range(B)])
    o0, o1 = out[:, :B], out[:, B:]
    return (o0[:, 0], o1[:, 0]) if one else (o0, o1)


# ---------------------------------------------------------------------------
# plaintext encodings
# ---------------------------------------------------------------------------


def encode_slots(params: BFVParams, values, device="cuda") -> torch.Tensor:
    """values (n,) mod t -> poly whose slot products are elementwise.
    Needs t < 2^31 (raises otherwise)."""
    v = np.asarray(values, dtype=np.uint64) % np.uint64(params.t)
    return NTT.ntt_inverse(_as_tensor(v, device), params.t)


def decode_slots(params: BFVParams, poly, device="cuda") -> np.ndarray:
    dev = poly.device if isinstance(poly, torch.Tensor) else device
    out = NTT.ntt_forward(_as_tensor(poly, dev), params.t)
    return out.cpu().numpy().astype(np.uint64)


def encode_coeffs(params: BFVParams, values, device="cuda") -> torch.Tensor:
    vv = np.asarray(values, dtype=np.int64) % params.t
    v = np.zeros(params.n, dtype=np.int64)
    v[: len(vv)] = vv
    return torch.from_numpy(v).to(device)


# ---------------------------------------------------------------------------
# coefficient-packed matvec (Cheetah-style): offline Linear(R)
# ---------------------------------------------------------------------------


def matvec_plan(params: BFVParams, d_in: int, d_out: int):
    per_ct = max(1, params.n // d_in)
    blocks = math.ceil(d_out / per_ct)
    return per_ct, blocks


def matvec_plaintexts(params: BFVParams, W: np.ndarray) -> np.ndarray:
    """(blocks, n) plaintexts in [0, t): row ``b·per_ct + slot`` of W,
    reversed, at offset ``slot·d_in`` of block b, so the product's
    coefficient ``slot·d_in + d_in − 1`` is ⟨W_row, r⟩."""
    d_out, d_in = W.shape
    per_ct, blocks = matvec_plan(params, d_in, d_out)
    if per_ct * d_in > params.n:
        raise IndexError(f"he_matvec packs rows of length d_in <= n; got "
                         f"d_in={d_in}, n={params.n}")
    rows = np.zeros((blocks * per_ct, d_in), np.int64)
    rows[:d_out] = np.asarray(W, np.int64)
    pt = np.zeros((blocks, params.n), np.int64)
    pt[:, : per_ct * d_in] = rows[:, ::-1].reshape(blocks, per_ct * d_in)
    return pt % params.t


def he_matvec(params: BFVParams, ct_r: Ciphertext, W: np.ndarray
              ) -> Ciphertext:
    """Enc(r) (coeff-packed, len d_in) × W (d_out, d_in) -> ``blocks``
    ciphertexts stacked as (k, blocks, n) (the reference returns them as a
    list); coefficient (i·d_in + d_in − 1) of ciphertext b holds
    ⟨W_row, r⟩ for row b·per_ct + i."""
    return mul_plain(params, ct_r, matvec_plaintexts(params, W))


def he_matvec_extract(params: BFVParams, pt_polys: np.ndarray,
                      d_in: int, d_out: int) -> np.ndarray:
    """(blocks, n) decrypted polys -> the d_out packed inner products."""
    polys = np.asarray(pt_polys, np.uint64)
    return polys[:, matvec_coeffs(params, d_in, d_out)].reshape(-1)[:d_out]


# ---------------------------------------------------------------------------
# carrying the reference's keys and ciphertexts across
# ---------------------------------------------------------------------------


def from_reference(x, device="cuda"):
    """The reference's numpy arrays (a secret key, a public key or a
    ciphertext; nested tuples and lists of them) -> int64 tensors."""
    if isinstance(x, (tuple, list)):
        return type(x)(from_reference(v, device) for v in x)
    return _as_tensor(np.asarray(x), device)


def to_reference(x):
    """Port residue tensors (a public key or a ciphertext) -> the
    reference's uint64 numpy arrays. (The secret key is signed int64 in
    both packages: ``s.cpu().numpy()``.)"""
    if isinstance(x, (tuple, list)):
        return type(x)(to_reference(v) for v in x)
    return x.cpu().numpy().astype(np.uint64)
