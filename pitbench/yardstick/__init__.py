"""The benchmark's frozen yardstick: the card's peaks, the work a garbled
AND gate costs, and the least time a walk or a whole GC phase can take.

Copied, not imported, so that a change to the program cannot move the
yardstick it is measured with. Every figure names where it was copied
from. The peaks are the published ones of an NVIDIA H100 SXM at its full
700 W power limit; a run records the card's own limit beside its numbers.
"""

from __future__ import annotations

from typing import Iterable, Tuple

#: HBM3 bandwidth of an H100 SXM, bytes per second (NVIDIA data sheet;
#: copied from ``chip_smoke.py``: ``HBM_BYTES_PER_S``). At 700 W.
HBM_BYTES_PER_S = 3.35e12
#: int32 operations per second: 132 SMs x 64 int32 lanes per clock x
#: 1.98 GHz boost clock (data sheet and Hopper white paper; copied from
#: ``chip_smoke.py``: ``INT32_OPS_PER_S``). At 700 W.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: the power limit the two peaks above assume, watts
PEAK_POWER_LIMIT_W = 700.0

#: 32-bit integer operations of one Half-Gate AND lane: 115 per hash
#: (the ARX Davies-Meyer hash of ``kernels/csrc/halfgate.cuh``), 2 hashes
#: and 49 other operations to evaluate, 4 hashes and 89 others to garble
#: (copied from ``src/repro_torch/kernels/level_eval/level_eval.py``:
#: ``HASH_OPS``, ``EVAL_OPS``, ``GARBLE_OPS``)
HASH_OPS = 115
EVAL_OPS = 2 * HASH_OPS + 49
GARBLE_OPS = 4 * HASH_OPS + 89

#: bytes of one wire label and of one AND gate's garbled table
#: (4 int32 words; two labels' worth of rows)
LABEL_BYTES = 16
TABLE_BYTES = 32


def bound_s(nbytes: float, nops: float) -> Tuple[float, str]:
    """Least time for the work, in seconds: bytes over HBM bandwidth or
    integer operations over the int32 rate, whichever is larger, and
    which (copied from ``chip_smoke.py``: ``_bound``, in seconds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / INT32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def walk_bound_s(record_words: int, n_src: int, n_and: int, n_out: int,
                 instances: int, garble: bool) -> Tuple[float, str]:
    """Least time of one executor walk: its int32 records, the source
    labels, the tables (read to evaluate, written to garble), R (garble)
    and the output labels, each moved once, against ``EVAL_OPS`` /
    ``GARBLE_OPS`` per real AND gate and instance (copied from
    ``chip_smoke.py``: ``_walk_bound``, which reads the same sizes off an
    executor)."""
    I = instances
    nbytes = (record_words * 4 + n_src * I * LABEL_BYTES
              + n_and * I * TABLE_BYTES + n_out * I * LABEL_BYTES
              + (I * LABEL_BYTES if garble else 0))
    nops = n_and * I * (GARBLE_OPS if garble else EVAL_OPS)
    return bound_s(nbytes, nops)


def gc_phase_bound_s(ops: Iterable[Tuple[int, int, int, int]],
                     garble: bool) -> Tuple[float, str]:
    """Least time of one phase of a request's garbled circuits, counted
    from what the work needs and nothing an executor adds: for each op
    ``(and_gates, inputs, outputs, instances)``, its AND gates times
    ``EVAL_OPS`` or ``GARBLE_OPS`` per instance, and its input labels,
    tables and output labels, each moved once."""
    nbytes = nops = 0
    per_and = GARBLE_OPS if garble else EVAL_OPS
    for n_and, n_in, n_out, I in ops:
        nops += n_and * I * per_and
        nbytes += I * (n_in * LABEL_BYTES + n_and * TABLE_BYTES
                       + n_out * LABEL_BYTES)
    return bound_s(nbytes, nops)


def and_gates(ops: Iterable[Tuple[int, int]]) -> int:
    """AND gates garbled (or evaluated) by ops given as
    ``(and_gates_per_instance, instances)``."""
    return sum(n_and * I for n_and, I in ops)
