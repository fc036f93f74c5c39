"""Sequence-chunked cross-entropy so (B, S, V) logits are never resident.

The port of ``src/repro/train/losses.py``. The unembed and logsumexp of
each sequence chunk run under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), so the backward pass recomputes a chunk's logits
instead of keeping them: the peak is one (B, S/nc, V) f32 buffer.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models.layers import f32_einsum
from repro_torch.models.sharding import shard, whole_rows


def _chunk_loss(h, lab, table, z_coef: float):
    """Sum of (nll + z-loss) over the chunk's unmasked labels, and their
    count; f32 logits against the table in ``h``'s dtype."""
    logits = f32_einsum("bsd,vd->bsv", h, table.to(h.dtype))
    logits = shard(logits, "batch", None, "vocab")
    logz = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp_min(lab, 0)
    picked = torch.gather(logits, -1, safe[..., None])
    # subtract before dropping the gathered dim: with the vocab sharded,
    # the gather's partial sum must be reduced at its own shape
    nll = (logz[..., None] - picked)[..., 0]
    mask = (lab >= 0).float()
    zl = z_coef * torch.square(logz)
    return torch.sum((nll + zl) * mask), torch.sum(mask)


def chunked_lm_loss(cfg: ModelConfig, out_head, hidden, labels, *,
                    z_coef=1e-4, num_chunks: int = 0):
    """hidden (B,S,d) -> (mean_nll, metrics). labels: integers, -1 = ignored.

    Labels index the *unpadded* vocab; padded logits rows can never win.
    """
    B, S, d = hidden.shape
    if num_chunks <= 0:
        num_chunks = max(1, S // 1024)
    while S % num_chunks != 0:
        num_chunks -= 1
    sc = S // num_chunks
    table = out_head["table"]

    # the rows in order (a sequence-parallel stash gathered), so that
    # chunks of the sequence are plain slices
    hs = whole_rows(hidden).reshape(B, num_chunks, sc, d)
    ls = labels.long().reshape(B, num_chunks, sc)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(num_chunks):
        s, c = checkpoint(_chunk_loss, hs[:, i], ls[:, i], table, z_coef,
                          use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + s, cnt + c
    mean = tot / torch.clamp_min(cnt, 1.0)
    return mean, {"tokens": cnt}
