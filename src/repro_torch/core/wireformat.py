"""Byte-size model for the v2 wire format's compressed streams.

The v2 frame codec itself lives in :mod:`repro.net.wire`; this module
holds only the *size arithmetic* shared between the codec and the
in-process oracle (:mod:`repro.core.protocol`), mirroring how
:mod:`repro.core.ot` owns the OT byte model. Keeping it in ``core`` with
zero intra-repo imports avoids a ``core -> net -> core`` cycle: the
oracle meters exactly these sizes and the ledger test asserts the wire
matches them byte-for-byte.

Two compressed stream kinds exist in v2:

* **seed streams** — a raw per-instance label batch is replaced by a
  fixed 32-byte (seed, counter, count) record; the receiver replays the
  labels with :func:`repro.core.labels.stream_labels`.
* **delta table batches** — a garbled-table slab ships one full anchor
  instance plus ``TABLE_DELTA_WORDS`` words per AND gate for every
  further instance; the remaining XOR-residual words travel on the SIM
  sideband (ledgered as overhead, like identity-HE blocks).
"""

from __future__ import annotations

import struct

#: bytes of a packed seed-stream record: 16-byte seed + u64 counter + u64 count
SEED_STREAM_BYTES = 32

#: uint32 words per AND gate kept on the wire for non-anchor instances
TABLE_DELTA_WORDS = 2

#: delta table batch header: instances u32 | rows u32 | delta words u8
TABLE_DELTA_HDR = struct.Struct("<IIB")


def tables_delta_wire_bytes(instances: int, n_and: int) -> int:
    """PROTO bytes of a v2 delta-encoded table batch.

    One full anchor instance (32 B/AND) plus ``TABLE_DELTA_WORDS`` words
    per AND for each remaining instance.
    """
    rows = max(n_and, 1)
    return (TABLE_DELTA_HDR.size + rows * 32
            + max(instances - 1, 0) * rows * 4 * TABLE_DELTA_WORDS)


def tables_resid_bytes(instances: int, n_and: int) -> int:
    """SIM-sideband residual bytes of a v2 table batch."""
    rows = max(n_and, 1)
    return max(instances - 1, 0) * rows * 4 * (8 - TABLE_DELTA_WORDS)


def tables_delta_anchor_bytes(n_and: int) -> int:
    """Per-batch fixed cost of a v2 table batch (header + anchor excess).

    ``tables_delta_wire_bytes(I, a) == tables_delta_anchor_bytes(a)
    + I * max(a, 1) * 4 * TABLE_DELTA_WORDS`` — the affine split that
    lets the oracle meter per-op instance slices while the party frames
    one segment per garbled slab: each op contributes its linear share,
    the slab's fixed anchor cost is metered once at the slab site.
    """
    rows = max(n_and, 1)
    return TABLE_DELTA_HDR.size + rows * 4 * (8 - TABLE_DELTA_WORDS)
