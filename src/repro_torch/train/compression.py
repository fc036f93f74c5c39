"""Gradient compression: int8 quantisation with error feedback.

The port of the one-rank half of ``src/repro/train/compression.py``:
``_quant`` / ``_dequant`` (one f32 scale per tensor, values rounded half
to even into [-127, 127], as ``jnp.round`` and ``torch.round`` both
round) and ``ErrorFeedback``, which carries each leaf's quantisation
error into the next step. The int8 ring all-reduce that sends the
quantised payload between ranks (``_ring_allreduce_int8``,
``compressed_psum``) comes with the multi-rank slice.
"""

from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_map


def _quant(x):
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.float() * scale


class ErrorFeedback:
    """Per-leaf residual accumulator: g' = Q(g + e); e = (g + e) − g'."""

    def __init__(self, params_like):
        self.residual = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params_like)

    def apply(self, grads, reduce_fn):
        reduced, residual = {}, {}

        def one(g, e):
            x = g.float() + e
            q, scale = _quant(x)
            sent = _dequant(q, scale)
            return reduce_fn(sent), x - sent

        def rec(g, e, red, res):
            for k in g:
                if isinstance(g[k], dict):
                    red[k], res[k] = {}, {}
                    rec(g[k], e[k], red[k], res[k])
                else:
                    red[k], res[k] = one(g[k], e[k])

        rec(grads, self.residual, reduced, residual)
        self.residual = residual
        return reduced
