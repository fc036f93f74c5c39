"""Simulated oblivious transfer + channel accounting.

Honest-but-curious simulation: both endpoints live in-process, but every
protocol message is metered so the benchmarks reproduce the paper's
communication columns. Cost model follows IKNP OT extension [11]: κ=128
bits per extended OT plus the chosen 128-bit label.

The byte constants are those of the JAX package's ``core/ot.py``, which
the two-party runtime frames on the wire at exactly the metered sizes.
:func:`choose_labels` is the OT functionality on int32 label tensors.
:class:`IknpReceiver` / :class:`IknpSender` are the reference's real IKNP
extension (Chou–Orlandi base OTs, Philox PRG, the ARX hash as CRH),
copied: they run on the host, in numpy, and take and return the port's
int32 label tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.halfgate import ref as HR
from repro_torch.kernels.label_select.label_select import select_labels


@dataclass
class Channel:
    client_to_server: int = 0
    server_to_client: int = 0
    rounds: int = 0
    by_tag: Dict[str, int] = field(default_factory=dict)

    def c2s(self, nbytes: int, tag: str = ""):
        self.client_to_server += int(nbytes)
        self.rounds += 1
        if tag:
            self.by_tag[tag] = self.by_tag.get(tag, 0) + int(nbytes)

    def s2c(self, nbytes: int, tag: str = ""):
        self.server_to_client += int(nbytes)
        self.rounds += 1
        if tag:
            self.by_tag[tag] = self.by_tag.get(tag, 0) + int(nbytes)

    @property
    def total(self) -> int:
        return self.client_to_server + self.server_to_client

    def time_s(self, bandwidth_bps: float = 9.6e9, latency_s: float = 0.165e-3,
               max_rounds: int = 0) -> float:
        """LAN model from the paper's setup (9.6 Gb/s, 0.165 ms)."""
        rounds = max_rounds if max_rounds else self.rounds
        return self.total * 8 / bandwidth_bps + rounds * latency_s


OT_MSG_BYTES = 16  # receiver's per-transfer IKNP column message
OT_BYTES_PER_TRANSFER = 2 * 16 + 16  # IKNP: 2 masked labels + correction


def ot_request_bytes(n: int) -> int:
    """Bytes of the receiver's choice-derived messages for ``n`` OTs."""
    return n * OT_MSG_BYTES


def ot_response_bytes(n: int) -> int:
    """Bytes of the sender's masked label pairs for ``n`` OTs."""
    return n * OT_BYTES_PER_TRANSFER


def choose_labels(zero_labels, r, choice_bits):
    """The OT functionality itself: labels for the receiver's choice bits.

    zero_labels: (..., 4) int32 tensor; r: broadcastable; choice_bits
    (...,) numpy or tensor bits. Pure label algebra (no metering): on the
    card, one launch of the label-select kernel.
    """
    return select_labels(zero_labels, r, choice_bits)


def ot_labels(channel: Channel, zero_labels, r, choice_bits, tag="ot"):
    """Evaluator obtains labels for its choice bits; garbler learns nothing."""
    n = int(np.prod(choice_bits.shape))
    channel.c2s(ot_request_bytes(n), tag)  # receiver's OT messages
    channel.s2c(ot_response_bytes(n), tag)
    return choose_labels(zero_labels, r, choice_bits)


# ---------------------------------------------------------------------------
# IKNP OT extension (v2 wire format): real base OT + extension matrix
# ---------------------------------------------------------------------------
#
# Roles follow the GC protocol: the evaluator endpoint is the OT
# *receiver* (choice bits = its masked-input bits), the garbler the OT
# *sender* — so in IKNP's base phase the roles reverse: the receiver acts
# as base-OT sender of κ=128 seed pairs, the garbler as base-OT receiver
# with a secret selection string s.
#
# Base OTs are Chou–Orlandi over the RFC 3526 2048-bit MODP group
# (g = 2); H is SHA-256 truncated to a 16-byte PRG seed. The extension
# PRG is counter-mode Philox, the correlation-robust hash is the repo's
# ARX label hash — the same primitive stack as garbling itself.
#
# Wire cost per batch of n OTs: the column matrix u is exactly
# κ bits = 16 B per OT (receiver→sender, same as the old sim-OT request)
# and the masked pair (y0, y1) is 32 B per OT (sender→receiver, down
# from the sim's 48 B block) — plus the one-time base exchange below.

KAPPA = 128  # IKNP security parameter / number of base OTs
BASE_OT_MSG_BYTES = 256  # one 2048-bit group element
BASE_OT_A_BYTES = BASE_OT_MSG_BYTES
BASE_OT_B_BYTES = KAPPA * BASE_OT_MSG_BYTES
OT_V2_PAIR_BYTES = 2 * 16  # two masked 128-bit labels

# RFC 3526, group 14 (2048-bit MODP), generator 2.
_MODP_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
_MODP_G = 2


def _h_group(x: int) -> bytes:
    import hashlib

    return hashlib.sha256(x.to_bytes(BASE_OT_MSG_BYTES, "big")).digest()[:16]


# Short-exponent DH: 2·κ = 256-bit exponents in the 2048-bit group give
# the κ=128 target (Pollard-λ on an ℓ-bit exponent costs 2^{ℓ/2}), and
# cut the pure-python modexp cost ~8x versus full-size exponents.
_EXP_BYTES = 32


class _FixedBase:
    """Fixed-base modexp: precompute base^(2^i) once, then each random
    exponent costs ~ℓ/2 modmuls instead of a full square-and-multiply
    (the sender exponentiates the same two bases κ times)."""

    def __init__(self, base: int, p: int, bits: int = 8 * _EXP_BYTES):
        self.p = p
        pows = [base % p]
        for _ in range(bits - 1):
            pows.append(pows[-1] * pows[-1] % p)
        self.pows = pows

    def pow(self, e: int) -> int:
        acc, p, i = 1, self.p, 0
        while e:
            if e & 1:
                acc = acc * self.pows[i] % p
            e >>= 1
            i += 1
        return acc


def _prg_bits(seed: bytes, word_offset: int, n: int) -> np.ndarray:
    """n pseudorandom bits (uint8) from a 16-byte seed at a 64-bit-word
    offset (one Philox counter block = four 64-bit words)."""
    nw = -(-n // 64)
    bg = np.random.Philox(key=int.from_bytes(seed, "little"))
    if word_offset:
        bg.advance(word_offset // 4)
    skip = word_offset % 4
    words = np.random.Generator(bg).integers(
        0, 1 << 64, size=nw + skip, dtype=np.uint64, endpoint=False)
    return np.unpackbits(words[skip:].view(np.uint8),
                         bitorder="little")[:n]


def _pack_cols(bits: np.ndarray) -> np.ndarray:
    """Bit matrix (KAPPA, n) -> per-OT 128-bit columns (n, 4) uint32."""
    cols = np.packbits(np.ascontiguousarray(bits.T), axis=1,
                       bitorder="little")
    return np.ascontiguousarray(cols).view(np.uint32)


def _unpack_cols(cols: np.ndarray) -> np.ndarray:
    """(n, 4) uint32 columns -> bit matrix (KAPPA, n) uint8."""
    rows = np.unpackbits(np.ascontiguousarray(cols).view(np.uint8),
                         axis=1, bitorder="little")
    return np.ascontiguousarray(rows.T)


def _host_u32(x) -> np.ndarray:
    """A label tensor (int32 bit patterns, any device) as host uint32,
    reinterpreted, not converted by value."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().numpy().view(np.uint32)
    return np.asarray(x, np.uint32)


def _crh(blocks: np.ndarray, tweak0: int) -> np.ndarray:
    """Correlation-robust hash of (n, 4) uint32 blocks (ARX label hash,
    the plain torch version on the host)."""
    n = blocks.shape[0]
    tweaks = (np.arange(tweak0, tweak0 + n) & 0xFFFFFFFF).astype(np.uint32)
    h = HR.hash_labels(
        torch.from_numpy(np.ascontiguousarray(blocks, np.uint32)
                         .view(np.int32)),
        torch.from_numpy(tweaks.view(np.int32)))
    return h.numpy().view(np.uint32)


class IknpReceiver:
    """Evaluator side: base-OT sender, extension-matrix producer."""

    def __init__(self, rng: np.random.Generator):
        self._a = int.from_bytes(rng.bytes(_EXP_BYTES), "little") | 1
        self._k0 = self._k1 = None
        self._word_off = 0
        self._tweak = 0

    def base_msg_a(self) -> bytes:
        return pow(_MODP_G, self._a, _MODP_P).to_bytes(
            BASE_OT_MSG_BYTES, "big")

    def absorb_base_b(self, data: bytes) -> None:
        a, p = self._a, _MODP_P
        A = pow(_MODP_G, a, p)
        # k1 = (B/A)^a = B^a · A^{-a}: one modmul per OT on top of the
        # shared B^a, instead of a second full modexp
        A_neg_a = pow(pow(A, p - 2, p), a, p)
        k0, k1 = [], []
        for i in range(KAPPA):
            B = int.from_bytes(
                data[i * BASE_OT_MSG_BYTES: (i + 1) * BASE_OT_MSG_BYTES],
                "big")
            Ba = pow(B, a, p)
            k0.append(_h_group(Ba))
            k1.append(_h_group(Ba * A_neg_a % p))
        self._k0, self._k1 = k0, k1

    def extend(self, choice_bits: np.ndarray):
        """Choice bits -> (u column matrix bytes, private t columns)."""
        x = np.asarray(choice_bits, np.uint8).reshape(-1)
        n = x.size
        t_rows = np.stack([_prg_bits(k, self._word_off, n)
                           for k in self._k0])
        v_rows = np.stack([_prg_bits(k, self._word_off, n)
                           for k in self._k1])
        self._word_off += -(-n // 64)
        u_rows = t_rows ^ v_rows ^ x[None, :]
        return _pack_cols(u_rows).tobytes(), _pack_cols(t_rows)

    def receive(self, y_data: bytes, choice_bits: np.ndarray,
                t_cols: np.ndarray) -> torch.Tensor:
        """Unmask the chosen labels: flat (n, 4) int32 (uint32 bit
        patterns) on the host."""
        x = np.asarray(choice_bits, np.uint8).reshape(-1)
        n = x.size
        pairs = np.frombuffer(y_data, np.uint32).reshape(n, 2, 4)
        mask = _crh(t_cols, self._tweak)
        self._tweak += n
        lab = pairs[np.arange(n), x.astype(np.int64)] ^ mask
        return torch.from_numpy(lab.view(np.int32))


class IknpSender:
    """Garbler side: base-OT receiver (secret s), masked-pair producer."""

    def __init__(self, rng: np.random.Generator):
        self._s_bits = np.unpackbits(
            np.frombuffer(rng.bytes(KAPPA // 8), np.uint8),
            bitorder="little")
        self._b = [int.from_bytes(rng.bytes(_EXP_BYTES), "little") | 1
                   for _ in range(KAPPA)]
        self._A = None
        self._ks = None
        self._s_block = None
        self._word_off = 0
        self._tweak = 0

    def base_msg_b(self, a_data: bytes) -> bytes:
        p = _MODP_P
        self._A = int.from_bytes(a_data, "big")
        # both bases are fixed across the κ exponentiations — amortize
        # the squaring chains once
        fb_g = _FixedBase(_MODP_G, p)
        fb_a = _FixedBase(self._A, p)
        out = bytearray()
        ks = []
        for i in range(KAPPA):
            B = fb_g.pow(self._b[i])
            if self._s_bits[i]:
                B = B * self._A % p
            out += B.to_bytes(BASE_OT_MSG_BYTES, "big")
            ks.append(_h_group(fb_a.pow(self._b[i])))
        self._ks = ks
        self._s_block = _pack_cols(
            self._s_bits[:, None].astype(np.uint8)).reshape(4)
        return bytes(out)

    def respond(self, u_data: bytes, n: int, zero_labels,
                r) -> bytes:
        """u matrix + the (zero, one) label pairs -> masked pairs bytes.

        ``zero_labels``: (..., 4) int32 tensor with n leading elements,
        on any device; ``r`` the broadcastable FreeXOR offset, likewise.
        Both come to the host once per batch (the hash and the masking
        run there, as in the reference). Output: n × (y0, y1) 32-byte
        pairs.
        """
        u_rows = _unpack_cols(np.frombuffer(u_data, np.uint32).reshape(n, 4))
        g_rows = np.stack([
            _prg_bits(self._ks[i], self._word_off, n) for i in range(KAPPA)])
        self._word_off += -(-n // 64)
        q_rows = g_rows ^ (self._s_bits[:, None] & u_rows)
        q_cols = _pack_cols(q_rows)
        z = _host_u32(zero_labels)
        one = z ^ np.broadcast_to(_host_u32(r), z.shape)
        lab0 = z.reshape(n, 4)
        lab1 = one.reshape(n, 4)
        y0 = lab0 ^ _crh(q_cols, self._tweak)
        y1 = lab1 ^ _crh(q_cols ^ self._s_block[None, :], self._tweak)
        self._tweak += n
        out = np.empty((n, 2, 4), np.uint32)
        out[:, 0] = y0
        out[:, 1] = y1
        return out.tobytes()


def ot_v2_request_bytes(n: int) -> int:
    """Receiver→sender extension-matrix bytes (κ bits per OT)."""
    return n * OT_MSG_BYTES


def ot_v2_response_bytes(n: int) -> int:
    """Sender→receiver masked-pair bytes (two 128-bit labels per OT)."""
    return n * OT_V2_PAIR_BYTES
