"""Plain PyTorch version of the Half-Gate cipher (int32 bit patterns).

Hash: Davies–Meyer over a 128-bit ARX permutation (SipRound-style on four
32-bit lanes, 8 rounds, round constants), bit for bit the JAX package's
``kernels/halfgate/ref.py``. Words are ``int32`` tensors holding ``uint32``
bit patterns: additions and left shifts wrap the same way in both, the
constants at or above 2^31 are stored as their negative int32 twins, and
the logical right shift of a rotation is an arithmetic shift with the
sign-extended bits masked off.

Half-Gate (Zahur–Rosulek–Evans, "two halves make a whole"):
  garbling an AND gate costs 4 hash calls and emits 2 table rows;
  evaluation costs 2 hash calls.

The CUDA kernels compute the same functions in
``kernels/csrc/halfgate.cuh``.
"""

from __future__ import annotations

import torch

NUM_ROUNDS = 8

#: round constants as uint32 python ints (the reference's ``_RC``)
RC = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F,
      0x165667B1, 0xD3A2646C, 0xFD7046C5, 0xB55A4F09)


def as_i32(c: int) -> int:
    """uint32 python int -> the int32 value with the same bit pattern."""
    c &= 0xFFFFFFFF
    return c - (1 << 32) if c >= (1 << 31) else c


def _pair(x: int, y: int):
    """(2, 1) column: one constant per word of a stacked pair."""
    return [[as_i32(x)], [as_i32(y)]]


# the permutation runs on two stacked word pairs, A = (v0, v2) and
# B = (v1, v3): each round is two pair-wise add / rotate / XOR steps, so
# every torch op below does the work of two of the reference's
_CONSTS = {
    "rc": [_pair(c, 0) for c in RC],
    # v1 <<< 13, v3 <<< 16 and v1 <<< 17, v3 <<< 21: left, right, low mask
    "rot1": [_pair(13, 16), _pair(32 - 13, 32 - 16),
             _pair((1 << 13) - 1, (1 << 16) - 1)],
    "rot2": [_pair(17, 21), _pair(32 - 17, 32 - 21),
             _pair((1 << 17) - 1, (1 << 21) - 1)],
    "tw1": as_i32(0x9E3779B9),
    "tw3": as_i32(0x85EBCA6B),
    "one": 1,
    "two": 2,
}
_ON_DEVICE = {}


def _c(device: torch.device):
    """The constants as int32 tensors on ``device`` (built once per
    device; a tensor operand costs less per op than a python scalar)."""
    c = _ON_DEVICE.get(device)
    if c is None:
        c = _ON_DEVICE[device] = {
            k: torch.tensor(v, dtype=torch.int32, device=device)
            for k, v in _CONSTS.items()}
    return c


def _rotl(x: torch.Tensor, rot) -> torch.Tensor:
    """Rotate each row of a stacked pair left by its own amount. The
    right shift is arithmetic on int32, so the sign-extended bits are
    masked off."""
    left, right, low = rot
    return (x << left) | ((x >> right) & low)


def arx_perm(x: torch.Tensor) -> torch.Tensor:
    """x: (..., 4) int32 -> permuted (..., 4)."""
    c = _c(x.device)
    lead = x.shape[:-1]
    v = x.reshape(-1, 4).T  # (4, N) word planes
    A = v[0::2].contiguous()  # (v0, v2)
    B = v[1::2].contiguous()  # (v1, v3)
    for r in range(NUM_ROUNDS):
        A = A + B + c["rc"][r]  # v0 += v1 + rc; v2 += v3
        B = _rotl(B, c["rot1"]) ^ A  # v1 = v1<<<13 ^ v0; v3 = v3<<<16 ^ v2
        A = A + B.flip(0)  # v0 += v3; v2 += v1
        B = _rotl(B, c["rot2"]) ^ A.flip(0)  # v1 = v1<<<17 ^ v2; v3 = v3<<<21 ^ v0
    return torch.stack([A[0], B[0], A[1], B[1]], dim=-1).reshape(*lead, 4)


def expand_tweak(tweak: torch.Tensor) -> torch.Tensor:
    """tweak (...,) int32 gate counter -> (..., 4) int32 block."""
    c = _c(tweak.device)
    t = tweak.to(torch.int32)
    return torch.stack([t, t ^ c["tw1"], ~t, t + c["tw3"]], dim=-1)


def hash_labels(labels: torch.Tensor, tweaks: torch.Tensor) -> torch.Tensor:
    """H(x, t) = P(x ⊕ t̂) ⊕ (x ⊕ t̂). labels (..., 4); tweaks (...,)."""
    xin = labels ^ expand_tweak(tweaks)
    return arx_perm(xin) ^ xin


def _lsb_mask(label: torch.Tensor) -> torch.Tensor:
    """(..., 1) int32 0x0/0xFFFFFFFF from the color bit."""
    return -(label[..., 0:1] & _c(label.device)["one"])


def garble_and_gates(a0, b0, r, tweaks):
    """Vectorized Half-Gate garbling.

    a0, b0: (..., 4) zero-labels of the two inputs; r broadcastable (..., 4);
    tweaks (...,) int32 per-gate counter (two tweaks derived as 2t, 2t+1).
    Returns (c0, tg, te): output zero-label + the two garbled table rows.
    The four hashes run as one stacked pass.
    """
    a0, b0, r = torch.broadcast_tensors(a0, b0, r)
    c = _c(a0.device)
    t1 = tweaks.to(torch.int32) * c["two"]
    t2 = t1 + c["one"]
    ha0, ha1, hb0, hb1 = hash_labels(
        torch.stack([a0, a0 ^ r, b0, b0 ^ r]),
        torch.stack([t1, t1, t2, t2]))
    pa = _lsb_mask(a0)
    pb = _lsb_mask(b0)
    tg = ha0 ^ ha1 ^ (r & pb)
    wg = ha0 ^ (tg & pa)
    te = hb0 ^ hb1 ^ a0
    we = hb0 ^ ((te ^ a0) & pb)
    return wg ^ we, tg, te


def eval_and_gates(a, b, tg, te, tweaks):
    """Vectorized Half-Gate evaluation: 2 hash calls per gate, run as one
    stacked pass.

    a, b: active labels (..., 4); tg/te: table rows; tweaks as in garbling.
    """
    a, b = torch.broadcast_tensors(a, b)
    c = _c(a.device)
    t1 = tweaks.to(torch.int32) * c["two"]
    ha, hb = hash_labels(torch.stack([a, b]), torch.stack([t1, t1 + c["one"]]))
    sa = _lsb_mask(a)
    sb = _lsb_mask(b)
    wg = ha ^ (tg & sa)
    we = hb ^ ((te ^ a) & sb)
    return wg ^ we
