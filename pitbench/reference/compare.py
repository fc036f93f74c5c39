"""The comparison that decides a run's ``correct``.

Every garbled op of a request reveals ``(client share + server share)
mod t``. The reference (:mod:`pitbench.reference.gc_ops`) works the same
value out again from the inputs the benchmark drew and gave the program.
The comparison is exact: one output word that differs is a failure, so
the limit is 0 mismatched words. A run whose outputs all match, on every
op of every request checked, is correct.

This module and :mod:`gc_ops` import NumPy and nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional

import numpy as np

from pitbench.reference import gc_ops

#: the limit on mismatched words: the comparison is exact
MISMATCH_LIMIT = 0


@dataclass
class OpCase:
    """One garbled op as the benchmark ran it: its kind and scale, the
    two input shares it drew, and the two output shares the program
    returned (client first). LayerNorm carries gamma and beta."""

    kind: str  # trunc | softmax | gelu | layernorm
    in_scale: int
    xc: np.ndarray
    xs: np.ndarray
    out_c: np.ndarray
    out_s: np.ndarray
    gamma: Optional[np.ndarray] = None
    beta: Optional[np.ndarray] = None


def expected(case: OpCase, *, t: int, frac: int) -> np.ndarray:
    """What the op must reveal, by the reference, at ``frac`` bits."""
    kw = dict(t=t, frac=frac, in_scale=case.in_scale)
    c = np.asarray(case.out_c, np.uint64).reshape(np.shape(case.xc))
    if case.kind == "trunc":
        return gc_ops.reveal_trunc(case.xc, case.xs, c, **kw)
    if case.kind == "softmax":
        return gc_ops.reveal_softmax(case.xc, case.xs, c, **kw)
    if case.kind == "gelu":
        return gc_ops.reveal_gelu(case.xc, case.xs, c, **kw)
    if case.kind == "layernorm":
        return gc_ops.reveal_layernorm(case.xc, case.xs, c, case.gamma,
                                       case.beta, **kw)
    raise ValueError(f"no reference for op kind {case.kind!r}")


def revealed(case: OpCase, t: int) -> np.ndarray:
    """What the program's two output shares reveal."""
    tw = np.uint64(t)
    c = np.asarray(case.out_c, np.uint64).reshape(np.shape(case.xc))
    s = np.asarray(case.out_s, np.uint64).reshape(np.shape(case.xc))
    return (c % tw + s % tw) % tw


def mismatches(case: OpCase, *, t: int, frac: int) -> int:
    """Output words of one op that differ from the reference's."""
    return int(np.count_nonzero(revealed(case, t)
                                != expected(case, t=t, frac=frac)))


def compare(cases: Iterable[OpCase], *, t: int, frac: int
            ) -> Dict[str, int]:
    """Mismatched and compared words, and ops with a mismatch."""
    words = bad = bad_ops = 0
    for case in cases:
        n = mismatches(case, t=t, frac=frac)
        words += int(np.size(case.xc))
        bad += n
        bad_ops += n > 0
    return {"mismatched_words": bad, "words_compared": words,
            "ops_with_mismatch": bad_ops}
