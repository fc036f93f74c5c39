"""Simulated oblivious transfer + channel accounting.

Honest-but-curious simulation: both endpoints live in-process, but every
protocol message is metered so the benchmarks reproduce the paper's
communication columns. Cost model follows IKNP OT extension [11]: κ=128
bits per extended OT plus the chosen 128-bit label.

The byte constants are those of the JAX package's ``core/ot.py``, which
the two-party runtime frames on the wire at exactly the metered sizes.
:func:`choose_labels` is the OT functionality on int32 label tensors. The
IKNP extension classes wait for the port's two-party slice; only the v2
byte model they are metered by is kept here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

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
# IKNP OT extension (v2 wire format): byte model
# ---------------------------------------------------------------------------

KAPPA = 128  # IKNP security parameter / number of base OTs
BASE_OT_MSG_BYTES = 256  # one 2048-bit group element
BASE_OT_A_BYTES = BASE_OT_MSG_BYTES
BASE_OT_B_BYTES = KAPPA * BASE_OT_MSG_BYTES
OT_V2_PAIR_BYTES = 2 * 16  # two masked 128-bit labels


def ot_v2_request_bytes(n: int) -> int:
    """Receiver→sender extension-matrix bytes (κ bits per OT)."""
    return n * OT_MSG_BYTES


def ot_v2_response_bytes(n: int) -> int:
    """Sender→receiver masked-pair bytes (two 128-bit labels per OT)."""
    return n * OT_V2_PAIR_BYTES
