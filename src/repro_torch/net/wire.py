"""Versioned wire format for the two-party PiT runtime.

Two frame families share one header:

* **PROTO** frames carry protocol-metered traffic: a batch of raw,
  tag-addressed segments. A segment's payload length is *exactly* the
  byte count the in-process ``ot.Channel`` meters for that message (the
  simulation is the size oracle), so the per-tag wire ledger can be
  asserted equal to the metered ledger. Payloads are raw bytes with **no
  per-array metadata** — both endpoints walk the same compiled plan in
  lockstep, so every shape is known statically. This is also what makes
  the encoding deterministic ("golden bytes"): same plan + same arrays →
  same frame bytes.

* **CONTROL / SIM** frames carry a tag plus one typed payload (None,
  bool, int, float, str, bytes, list, dict, numpy array — torch tensors
  are converted). CONTROL drives the session state machine (hello,
  preprocess, run, error); SIM is the simulation sideband: data the
  metered oracle treats as implicit (garbled-circuit decode metadata,
  the final output shares) — counted separately as overhead, never in
  the protocol ledger.

Layout (all integers little-endian)::

    frame   := magic "PW" | version u8 | kind u8 | phase u8 | body
    PROTO   := nseg u32 | seg*
    seg     := dir u8 | taglen u16 | tag utf8 | len u64 | raw bytes
    CONTROL := taglen u16 | tag utf8 | obj
    SIM     := same as CONTROL

Typed object encoding (``obj``) uses a one-byte type marker; arrays are
``'A' | dtype-str | ndim u8 | dims u64* | C-order raw bytes``.

Version 2 (negotiated at hello, v1 remains fully supported) revises the
PROTO payload encodings only — the frame layout is unchanged except for
the version byte:

* **seed streams** — label streams whose receiver is *entitled* to the
  whole stream (the garbler's mask-input labels, which are active labels
  by construction) ship as a 32-byte ``(seed, counter)`` record; the
  receiver replays the PRG (:func:`repro_torch.core.labels.stream_labels`).
* **delta-encoded table batches** — a slab of per-instance garbled
  tables ships as one full anchor instance plus 8 B/AND-gate
  per-instance delta records. The 24 B/AND residual needed to invert the
  delta code travels on the SIM sideband and is ledgered as simulation
  overhead, like every other stand-in the size oracle models
  (identity-HE blocks, the reveal sideband).
* **IKNP OT** — the sim-OT blocks are replaced by a real base-OT +
  extension-matrix exchange (:mod:`repro_torch.core.ot`): κ=128
  Chou–Orlandi base OTs at hello-follow-up, then per-batch a 16 B/OT
  column matrix (receiver→sender) and a 32 B/OT masked-pair response.

A copy of the JAX package's ``net/wire.py`` with its imports rewritten:
frames from the two packages are byte-identical, so an endpoint of one
talks to an endpoint of the other. The packers take the port's label
and table tensors (int32 bit patterns, on any device) and reinterpret
their memory as uint32 (:func:`as_u32`), never converting by value.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

WIRE_VERSION = 1
WIRE_V2 = 2
SUPPORTED_VERSIONS = (WIRE_VERSION, WIRE_V2)
MAGIC = b"PW"

KIND_CONTROL = 0
KIND_PROTO = 1
KIND_SIM = 2

PHASE_NONE = 0
PHASE_OFFLINE = 1
PHASE_ONLINE = 2

DIR_C2S = 0
DIR_S2C = 1


class WireError(ValueError):
    """Malformed or version-incompatible frame."""


def as_u32(x) -> np.ndarray:
    """Labels or tables as host uint32: a torch tensor (int32 bit
    patterns, on any device) is copied to the host and reinterpreted;
    anything else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise WireError(f"label tensors are int32, got {x.dtype}")
        return x.detach().cpu().contiguous().numpy().view(np.uint32)
    return np.asarray(x, np.uint32)


# ---------------------------------------------------------------------------
# typed object codec (CONTROL / SIM payloads)
# ---------------------------------------------------------------------------


def _enc_obj(out: bytearray, obj) -> None:
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif isinstance(obj, int):
        raw = obj.to_bytes((obj.bit_length() + 8) // 8 + 1, "little",
                           signed=True)
        out += b"I" + struct.pack("<H", len(raw)) + raw
    elif isinstance(obj, float):
        out += b"D" + struct.pack("<d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += b"S" + struct.pack("<I", len(raw)) + raw
    elif isinstance(obj, (bytes, bytearray)):
        out += b"B" + struct.pack("<Q", len(obj)) + bytes(obj)
    elif isinstance(obj, (list, tuple)):
        out += b"L" + struct.pack("<I", len(obj))
        for v in obj:
            _enc_obj(out, v)
    elif isinstance(obj, dict):
        out += b"M" + struct.pack("<I", len(obj))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise WireError(f"dict keys must be str, got {type(k)}")
            kr = k.encode("utf-8")
            out += struct.pack("<H", len(kr)) + kr
            _enc_obj(out, v)
    elif isinstance(obj, np.generic):  # numpy scalar → python scalar
        _enc_obj(out, obj.item())
    else:
        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(obj))
        ds = a.dtype.str.encode("ascii")
        out += b"A" + struct.pack("<B", len(ds)) + ds
        out += struct.pack("<B", a.ndim)
        out += struct.pack(f"<{a.ndim}Q", *a.shape) if a.ndim else b""
        raw = a.tobytes()
        out += struct.pack("<Q", len(raw)) + raw


def _dec_obj(buf: memoryview, pos: int):
    t = bytes(buf[pos: pos + 1])
    pos += 1
    if t == b"N":
        return None, pos
    if t == b"T":
        return True, pos
    if t == b"F":
        return False, pos
    if t == b"I":
        (n,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        return int.from_bytes(bytes(buf[pos: pos + n]), "little",
                              signed=True), pos + n
    if t == b"D":
        (v,) = struct.unpack_from("<d", buf, pos)
        return v, pos + 8
    if t == b"S":
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        return bytes(buf[pos: pos + n]).decode("utf-8"), pos + n
    if t == b"B":
        (n,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        return bytes(buf[pos: pos + n]), pos + n
    if t == b"L":
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        out = []
        for _ in range(n):
            v, pos = _dec_obj(buf, pos)
            out.append(v)
        return out, pos
    if t == b"M":
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        out = {}
        for _ in range(n):
            (kl,) = struct.unpack_from("<H", buf, pos)
            pos += 2
            k = bytes(buf[pos: pos + kl]).decode("utf-8")
            pos += kl
            out[k], pos = _dec_obj(buf, pos)
        return out, pos
    if t == b"A":
        (dl,) = struct.unpack_from("<B", buf, pos)
        pos += 1
        dt = np.dtype(bytes(buf[pos: pos + dl]).decode("ascii"))
        pos += dl
        (nd,) = struct.unpack_from("<B", buf, pos)
        pos += 1
        shape = struct.unpack_from(f"<{nd}Q", buf, pos) if nd else ()
        pos += 8 * nd
        (n,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        arr = np.frombuffer(buf[pos: pos + n], dt).reshape(shape).copy()
        return arr, pos + n
    raise WireError(f"unknown type marker {t!r}")


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


@dataclass
class Seg:
    """One protocol-metered message: raw payload addressed by ledger tag."""

    tag: str
    dir: int  # DIR_C2S | DIR_S2C — the *logical* direction the oracle meters
    data: bytes


@dataclass
class Msg:
    """A decoded frame."""

    kind: int
    phase: int = PHASE_NONE
    tag: str = ""
    payload: object = None
    segs: List[Seg] = field(default_factory=list)
    version: int = WIRE_VERSION


def _enc_tag(tag: str) -> bytes:
    raw = tag.encode("utf-8")
    return struct.pack("<H", len(raw)) + raw


def encode_msg(kind: int, tag: str = "", payload=None,
               phase: int = PHASE_NONE,
               version: int = WIRE_VERSION) -> bytes:
    """Encode a CONTROL or SIM frame."""
    if kind not in (KIND_CONTROL, KIND_SIM):
        raise WireError("encode_msg is for CONTROL/SIM frames")
    out = bytearray()
    out += MAGIC + struct.pack("<BBB", version, kind, phase)
    out += _enc_tag(tag)
    _enc_obj(out, payload)
    return bytes(out)


def encode_proto(segs: Sequence[Seg], phase: int,
                 version: int = WIRE_VERSION) -> bytes:
    """Encode a PROTO frame: a batch of raw tagged segments.

    nseg is u32: a preprocess response batches one segment per
    (op × bundle), which clears u16 at production batch sizes.
    """
    out = bytearray()
    out += MAGIC + struct.pack("<BBB", version, KIND_PROTO, phase)
    out += struct.pack("<I", len(segs))
    for s in segs:
        out += struct.pack("<B", s.dir) + _enc_tag(s.tag)
        out += struct.pack("<Q", len(s.data)) + s.data
    return bytes(out)


def decode_frame(data: bytes) -> Msg:
    buf = memoryview(data)
    if bytes(buf[:2]) != MAGIC:
        raise WireError("bad magic")
    ver, kind, phase = struct.unpack_from("<BBB", buf, 2)
    if ver not in SUPPORTED_VERSIONS:
        raise WireError(
            f"wire version {ver} not in {SUPPORTED_VERSIONS}")
    pos = 5
    if kind == KIND_PROTO:
        (nseg,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        segs = []
        for _ in range(nseg):
            (d,) = struct.unpack_from("<B", buf, pos)
            pos += 1
            (tl,) = struct.unpack_from("<H", buf, pos)
            pos += 2
            tag = bytes(buf[pos: pos + tl]).decode("utf-8")
            pos += tl
            (n,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
            segs.append(Seg(tag, d, bytes(buf[pos: pos + n])))
            pos += n
        return Msg(kind=kind, phase=phase, segs=segs, version=ver)
    (tl,) = struct.unpack_from("<H", buf, pos)
    pos += 2
    tag = bytes(buf[pos: pos + tl]).decode("utf-8")
    pos += tl
    payload, pos = _dec_obj(buf, pos)
    return Msg(kind=kind, phase=phase, tag=tag, payload=payload,
               version=ver)


# ---------------------------------------------------------------------------
# raw payload packers (shape-oracle encodings; sizes match the meter)
# ---------------------------------------------------------------------------


def pack_u64(arr: np.ndarray) -> bytes:
    """Share residues: 8 bytes/element (the meter's ``size * 8``)."""
    return np.ascontiguousarray(np.asarray(arr, np.uint64)).tobytes()


def unpack_u64(data: bytes, shape: Tuple[int, ...]) -> np.ndarray:
    return np.frombuffer(data, np.uint64).reshape(shape).copy()


def pack_labels(lab) -> bytes:
    """GC labels (..., 4) uint32: 16 bytes/label."""
    return np.ascontiguousarray(as_u32(lab)).tobytes()


def unpack_labels(data: bytes, shape: Tuple[int, ...]) -> np.ndarray:
    return np.frombuffer(data, np.uint32).reshape(*shape, 4).copy()


def pack_tables(tables) -> bytes:
    """Garbled tables (I, nAND, 2, 4) uint32: the meter's ``size * 4``."""
    return np.ascontiguousarray(as_u32(tables)).tobytes()


def unpack_tables(data: bytes, instances: int, n_and: int) -> np.ndarray:
    return np.frombuffer(data, np.uint32).reshape(
        instances, max(n_and, 1), 2, 4).copy()


def ct_pack(arr: np.ndarray, ct_bytes: int, poly_n: int) -> bytes:
    """Pack uint64 coefficients into BFV-ciphertext-sized blocks.

    The simulation's stand-in for encryption is the identity with
    padding: a block is exactly ``ct_bytes`` (2 polys × RNS limbs ×
    ``poly_n`` × 8B) and carries up to ``poly_n`` plaintext coefficients
    at its head — so wire sizes equal the metered ``ct_count *
    ct_bytes`` while the receiving party can still run the oracle math.
    """
    a = np.ascontiguousarray(np.asarray(arr, np.uint64))
    ct_count = max(1, -(-a.size // poly_n)) if a.size else 0
    out = bytearray(ct_count * ct_bytes)
    raw = a.tobytes()
    out[: len(raw)] = raw
    return bytes(out)


def ct_unpack(data: bytes, shape: Tuple[int, ...]) -> np.ndarray:
    n = int(np.prod(shape)) if shape else 1
    return np.frombuffer(data[: n * 8], np.uint64).reshape(shape).copy()


def ct_blocks(nelems: int, poly_n: int) -> int:
    return max(1, -(-nelems // poly_n)) if nelems else 0


def ct_pack_rows(arr: np.ndarray, ct_bytes: int) -> bytes:
    """One ciphertext block per leading-dim row (the meter's ``I *
    ct_bytes`` shape, e.g. the per-row LayerNorm inner-product cts)."""
    a = np.ascontiguousarray(np.asarray(arr, np.uint64))
    a = a.reshape(a.shape[0], -1)
    if a.shape[1] * 8 > ct_bytes:
        raise WireError("row does not fit one ciphertext block")
    out = np.zeros((a.shape[0], ct_bytes), np.uint8)
    out[:, : a.shape[1] * 8] = a.view(np.uint8).reshape(a.shape[0], -1)
    return out.tobytes()


def ct_unpack_rows(data: bytes, rows: int, ct_bytes: int,
                   row_elems: int = 1) -> np.ndarray:
    blocks = np.frombuffer(data, np.uint8).reshape(rows, ct_bytes)
    vals = np.ascontiguousarray(blocks[:, : row_elems * 8]).view(np.uint64)
    shape = (rows,) if row_elems == 1 else (rows, row_elems)
    return vals.reshape(shape).copy()


def pack_ot_request(bits: np.ndarray, msg_bytes: int = None) -> bytes:
    """Receiver's OT messages: one ``msg_bytes`` block per choice bit.

    The real IKNP column message is κ masked bits; the simulation embeds
    the choice bit in byte 0 of an otherwise-zero block so the garbler
    can run the OT functionality, at exactly the metered size (block
    sizes come from ``core/ot.py`` — the meter and the wire share one
    cost model by construction).
    """
    from repro_torch.core.ot import OT_MSG_BYTES

    msg_bytes = OT_MSG_BYTES if msg_bytes is None else msg_bytes
    flat = np.asarray(bits, np.uint8).reshape(-1)
    out = np.zeros((flat.size, msg_bytes), np.uint8)
    out[:, 0] = flat
    return out.tobytes()


def unpack_ot_request(data: bytes, shape: Tuple[int, ...],
                      msg_bytes: int = None) -> np.ndarray:
    from repro_torch.core.ot import OT_MSG_BYTES

    msg_bytes = OT_MSG_BYTES if msg_bytes is None else msg_bytes
    n = int(np.prod(shape))
    return (np.frombuffer(data, np.uint8).reshape(n, msg_bytes)[:, 0]
            .reshape(shape).copy())


def pack_ot_response(labels, per_transfer: int = None) -> bytes:
    """Sender's masked pairs: chosen label (16B) + IKNP padding."""
    from repro_torch.core.ot import OT_BYTES_PER_TRANSFER

    per_transfer = OT_BYTES_PER_TRANSFER if per_transfer is None \
        else per_transfer
    lab = np.ascontiguousarray(as_u32(labels))
    n = lab.size // 4
    out = np.zeros((n, per_transfer), np.uint8)
    out[:, :16] = lab.reshape(n, 4).view(np.uint8)
    return out.tobytes()


def unpack_ot_response(data: bytes, shape: Tuple[int, ...],
                       per_transfer: int = None) -> np.ndarray:
    from repro_torch.core.ot import OT_BYTES_PER_TRANSFER

    per_transfer = OT_BYTES_PER_TRANSFER if per_transfer is None \
        else per_transfer
    n = int(np.prod(shape))
    blocks = np.frombuffer(data, np.uint8).reshape(n, per_transfer)
    lab = np.ascontiguousarray(blocks[:, :16]).view(np.uint32)
    return lab.reshape(*shape, 4).copy()


# ---------------------------------------------------------------------------
# v2 payload packers: seed streams + delta-encoded table batches
# ---------------------------------------------------------------------------
# The byte-size model is shared with the in-process oracle and lives in
# repro_torch.core.wireformat (a pure struct/arith module — no cycle); the
# packers here are the codec side of the same format.

from repro_torch.core.wireformat import (  # noqa: E402  (re-exported)
    SEED_STREAM_BYTES,
    TABLE_DELTA_HDR as _TABLE_DELTA_HDR,
    TABLE_DELTA_WORDS,
    tables_delta_anchor_bytes,
    tables_delta_wire_bytes,
    tables_resid_bytes,
)


def pack_seed_stream(seed: bytes, counter: int, count: int) -> bytes:
    """A PRG-seeded label stream: replaces ``count`` raw labels.

    ``seed`` is the 16-byte stream seed, ``counter`` the stream offset of
    the first label, ``count`` how many labels the receiver derives.
    """
    if len(seed) != 16:
        raise WireError("seed stream seed must be 16 bytes")
    return seed + struct.pack("<QQ", counter, count)


def unpack_seed_stream(data: bytes) -> Tuple[bytes, int, int]:
    if len(data) != SEED_STREAM_BYTES:
        raise WireError("bad seed stream segment length")
    counter, count = struct.unpack_from("<QQ", data, 16)
    return bytes(data[:16]), counter, count


def pack_tables_delta(tables) -> Tuple[bytes, bytes]:
    """Delta-encode a table slab → (PROTO wire bytes, SIM residual).

    Instance 0 ships verbatim as the anchor; instances ``i > 0`` ship
    their XOR against instance ``i-1``, split into an on-wire head
    (``TABLE_DELTA_WORDS`` uint32 per AND row pair — the modeled delta
    record) and a sideband tail. The split is lossless: the receiver
    reassembles head+tail and undoes the running XOR, so reconstruction
    is exact while the PROTO channel carries the modeled batch size.
    """
    t = np.ascontiguousarray(as_u32(tables))
    inst, rows = int(t.shape[0]), int(t.shape[1])
    words = t.reshape(inst, rows, 8)
    d = words.copy()
    if inst > 1:
        d[1:] ^= words[:-1]
    wire = bytearray()
    wire += _TABLE_DELTA_HDR.pack(inst, rows, TABLE_DELTA_WORDS)
    wire += d[0].tobytes()
    resid = b""
    if inst > 1:
        wire += np.ascontiguousarray(d[1:, :, :TABLE_DELTA_WORDS]).tobytes()
        resid = np.ascontiguousarray(d[1:, :, TABLE_DELTA_WORDS:]).tobytes()
    return bytes(wire), resid


def unpack_tables_delta(wire: bytes, resid: bytes, instances: int,
                        n_and: int) -> np.ndarray:
    """Invert :func:`pack_tables_delta` → tables ``(I, rows, 2, 4)``."""
    inst, rows, dw = _TABLE_DELTA_HDR.unpack_from(wire, 0)
    if inst != instances or rows != max(n_and, 1) or dw != TABLE_DELTA_WORDS:
        raise WireError("table delta header does not match the plan")
    pos = _TABLE_DELTA_HDR.size
    d = np.empty((inst, rows, 8), np.uint32)
    d[0] = np.frombuffer(wire, np.uint32, rows * 8, pos).reshape(rows, 8)
    if inst > 1:
        pos += rows * 32
        head = np.frombuffer(wire, np.uint32, (inst - 1) * rows * dw, pos)
        d[1:, :, :dw] = head.reshape(inst - 1, rows, dw)
        tail = np.frombuffer(resid, np.uint32).reshape(inst - 1, rows, 8 - dw)
        d[1:, :, dw:] = tail
    # the running XOR over instances, one contiguous instance at a time:
    # the same words as ``np.bitwise_xor.accumulate(d, axis=0)`` (the
    # reference's), which walks each word across all instances at an
    # instance-sized stride and took minutes at serving slab sizes
    for i in range(1, inst):
        np.bitwise_xor(d[i], d[i - 1], out=d[i])
    return d.reshape(inst, rows, 2, 4)
