"""Core transformer building blocks, in PyTorch.

The port of ``src/repro/models/layers.py``, function for function.
Conventions are the reference's:
  * params are nested dicts of f32 tensors; compute casts to ``cfg.dtype``;
  * norms, softmax and the running attention statistics are f32;
  * every activation names its logical dims through ``models.sharding.shard``
    (the identity on one device).

Where the reference asks XLA for ``preferred_element_type=float32`` on
operands of the compute type (scores, PV, logits), the port upcasts the
operands to f32 before the product: bf16 products are exact in f32, so
the sum is the reference's f32 accumulation and nothing is rounded to
bf16 between the QK product and the softmax. f32 products run in full
f32 on the card (TF32 is off by default for matmuls).

Attention runs in the reference's two shapes:
  * full (train / prefill): the flash-style two-level chunking of
    ``_flash_chunks`` (q chunks batched, kv chunks walked with a running
    max and sum) — never the S×S score matrix;
  * decode: one query token against a KV cache, scores (B, KV, q/kv, T).
GQA throughout. These are torch ops; a hand-written Hopper attention
kernel is later work (the reference's attention is jnp, not Pallas).

Init functions draw from an explicit ``torch.Generator`` on its own
device, with the reference's distributions and shapes (not its bits).
``lead`` prepends stack dims, so a stack of blocks is drawn at once (the
reference vmaps the init over split keys).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.config import ModelConfig
from repro_torch.models.sharding import (active_rules, axis_size_of,
                                         local_apply, merge_last,
                                         rows_whole_grad, shard, split_last,
                                         whole_dim, whole_rows)

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """``scale`` × standard normal f32 draws of ``shape`` on ``gen``'s device."""
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def dense_init(gen, in_dim: int, out_dim: int, *,
               scale: Optional[float] = None, lead: Tuple[int, ...] = ()):
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    return {"w": normal(gen, (*lead, in_dim, out_dim), scale)}


def _ones(gen, *shape):
    return torch.ones(shape, dtype=torch.float32, device=gen.device)


def _zeros(gen, *shape):
    return torch.zeros(shape, dtype=torch.float32, device=gen.device)


def norm_init(gen, cfg: ModelConfig, d: int, lead: Tuple[int, ...] = ()):
    p = {"scale": _ones(gen, *lead, d)}
    if cfg.norm_type == "layernorm":
        p["bias"] = _zeros(gen, *lead, d)
    return p


def apply_norm(cfg: ModelConfig, p, x):
    xf = whole_dim(x).float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(scale, x):
    """qk-norm: RMS over the head dim."""
    xf = whole_dim(x).float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)


def linear(p, x, dtype):
    return rows_whole_grad(whole_rows(x).to(dtype) @ p["w"].to(dtype))


def f32_einsum(eq: str, *ops):
    """``einsum`` with f32 accumulation and an f32 result, whatever the
    operands' type: the reference's ``preferred_element_type=float32``."""
    return torch.einsum(eq, *(o.float() for o in ops))


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(cfg: ModelConfig, positions):
    """positions: (...,) int -> (cos, sin) with shape (..., head_dim//2)."""
    half = cfg.head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    inv = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                       device=positions.device), ar / half)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., hd); cos/sin broadcastable (..., hd//2). Rotates the two
    concatenated halves of the head dim (not interleaved pairs)."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    cos, sin = cos.float(), sin.float()
    o1 = x1f * cos - x2f * sin
    o2 = x2f * cos + x1f * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, h * hd, lead=lead),
        "wk": dense_init(gen, d, kv * hd, lead=lead),
        "wv": dense_init(gen, d, kv * hd, lead=lead),
        "wo": dense_init(gen, h * hd, d, scale=1.0 / math.sqrt(h * hd),
                         lead=lead),
    }
    if cfg.qk_norm:
        p["qn"] = {"scale": _ones(gen, *lead, hd)}
        p["kn"] = {"scale": _ones(gen, *lead, hd)}
    return p


def init_attention_lora(gen, cfg: ModelConfig, rank: int,
                        lead: Tuple[int, ...] = ()):
    """Per-invocation LoRA for the zamba2 shared attention block."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "lora_a": dense_init(gen, d, rank, lead=lead),
        "lora_b": {"w": _zeros(gen, *lead, rank, h * hd)},
    }


def _expand_kv(t, qpk: int):
    """GQA: (B, T, KV, hd) -> (B, T, KV*qpk, hd), each kv head repeated
    ``qpk`` times in place (``jnp.repeat`` on the head axis)."""
    return torch.repeat_interleave(t, qpk, dim=2) if qpk > 1 else t


def _flash_chunks(cfg, q, k, v, q_offset, causal):
    """Flash-style attention: q (B,S,H,hd); k/v (B,T,KV,hd) full.

    q is processed in parallel chunks; kv chunks are walked in order with a
    running (m, l, acc). GQA expansion (KV -> H) happens per kv chunk, so
    the expanded buffer never exceeds one chunk. Returns (B, S, H, hd).

    Under sharding rules the walk runs on each rank's block
    (``local_apply``): q chunks split over batch and ``attn_seq`` or
    ``heads``, keys and values expanded to H heads and whole along time,
    so no rank needs another's scores.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qpk = H // KV

    # the q-chunk count is a multiple of the attn_seq shard count
    seq_shards = axis_size_of("attn_seq")
    nq = seq_shards * max(1, -(-S // (cfg.attn_chunk * seq_shards)))
    while S % nq != 0:
        nq += seq_shards
    qc = S // nq
    kc = min(cfg.attn_chunk, T)
    while T % kc:  # non-power-of-two prompt lengths (serving)
        kc -= 1

    q5 = shard(q.reshape(B, nq, qc, H, hd), "batch", "attn_seq", None,
               "heads", None)
    q_pos = (q_offset + torch.arange(S, dtype=torch.int64, device=q.device)
             ).reshape(nq, qc)
    q5_names = ("batch", "attn_seq", None, "heads", None)
    if active_rules() is not None:
        k, v, qpk = _expand_kv(k, qpk), _expand_kv(v, qpk), 1
    kv_names = ("batch", None, "heads", None)
    out = local_apply(
        lambda q5, k, v, q_pos: _flash_walk(q5, k, v, q_pos, qpk, kc,
                                            causal),
        (q5, k, v, q_pos), (q5_names, kv_names, kv_names,
                            ("attn_seq", None)), (q5_names,))
    return out.reshape(B, S, H, hd).to(q.dtype)


def _flash_walk(q5, k, v, q_pos, qpk: int, kc: int, causal: bool):
    """The kv-chunk walk of ``_flash_chunks`` on plain tensors: q5 (B, nq,
    qc, H, hd), k/v (B, T, H/qpk, hd), q_pos (nq, qc) -> f32 (B, nq, qc,
    H, hd)."""
    B, nq, qc, H, hd = q5.shape
    scale = 1.0 / math.sqrt(hd)
    dev = q5.device
    m = torch.full((B, nq, qc, H), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, nq, qc, H), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, nq, qc, H, hd), dtype=torch.float32, device=dev)
    for j in range(k.shape[1] // kc):
        kj, vj = k[:, j * kc:(j + 1) * kc], v[:, j * kc:(j + 1) * kc]
        k_pos = j * kc + torch.arange(kc, dtype=torch.int64, device=dev)
        kx = _expand_kv(kj, qpk)
        vx = _expand_kv(vj, qpk)
        # scores: (B, nq, qc, H, kc), f32
        s = f32_einsum("bnqhd,bkhd->bnqhk", q5, kx) * scale
        if causal:
            mask = q_pos[None, :, :, None, None] >= k_pos
            s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = f32_einsum("bnqhk,bkhd->bnqhd", p.to(vx.dtype), vx)
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc / torch.clamp_min(l[..., None], 1e-30)


def _decode_attn(cfg, q, k_cache, v_cache, cache_len: int):
    """q: (B, 1, H, hd); caches (B, T, KV, hd); attends to [0, cache_len].

    Under sharding rules each rank attends for its batch rows and heads
    (``local_apply``), with the caches whole along time and expanded to
    the H query heads."""
    H, KV = q.shape[2], k_cache.shape[2]
    qpk = H // KV
    if active_rules() is not None:
        k_cache, v_cache, qpk = (_expand_kv(k_cache, qpk),
                                 _expand_kv(v_cache, qpk), 1)
    heads = ("batch", None, "heads", None)
    return local_apply(
        lambda q, k, v: _decode_core(q, k, v, cache_len, qpk),
        (q, k_cache, v_cache), (heads, heads, heads), (heads,))


def _decode_core(q, k_cache, v_cache, cache_len: int, qpk: int):
    """``_decode_attn`` on plain tensors (KV · qpk = H)."""
    B, _, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(hd)
    q4 = q.reshape(B, KV, qpk, hd)
    s = f32_einsum("bgph,btgh->bgpt", q4, k_cache) * scale
    t_pos = torch.arange(T, device=q.device)
    mask = t_pos <= cache_len  # current token included
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = f32_einsum("bgpt,btgh->bgph", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attention(
    cfg: ModelConfig,
    p,
    x,
    *,
    pos_offset: int,
    cache: Optional[dict] = None,
    mode: str = "train",
    lora: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (y, new_cache). Modes: train (no cache), prefill (build
    cache), decode (read+append cache). ``pos_offset`` and ``cache["len"]``
    are host ints."""
    B, S, d = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    x = whole_rows(x)  # gathered once for the q, k and v products

    q = linear(p["wq"], x, dt)
    if lora is not None:  # zamba2 per-invocation LoRA on the q projection
        q = q + linear(lora["lora_b"], linear(lora["lora_a"], x, dt), dt)
    k = linear(p["wk"], x, dt)
    v = linear(p["wv"], x, dt)
    q = split_last(q, H, hd)
    k = split_last(k, KV, hd)
    v = split_last(v, KV, hd)

    if cfg.qk_norm:
        q = rms_head_norm(p["qn"]["scale"], q)
        k = rms_head_norm(p["kn"]["scale"], k)

    if cfg.rope_theta > 0:
        pos = pos_offset + torch.arange(S, dtype=torch.int64, device=x.device)
        cos, sin = rope_freqs(cfg, pos)  # (S, hd/2)
        q = apply_rope(q, cos[None, :, None, :], sin[None, :, None, :])
        k = apply_rope(k, cos[None, :, None, :], sin[None, :, None, :])

    q = shard(q, "batch", "attn_seq", "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)

    new_cache = None
    if mode == "decode":
        assert cache is not None and S == 1
        T = cache["k"].shape[1]
        pos_idx = int(cache["len"])  # number of valid tokens
        if not 0 <= pos_idx < T:
            # the reference's dynamic_update_slice clamps the index and
            # overwrites the last slot; the port refuses instead
            raise ValueError(f"KV cache full: writing position {pos_idx} "
                             f"of a cache with capacity {T}")
        # functional, as the reference: the caller's cache is not written.
        # A select over time rather than an indexed write: the cache's time
        # dim may be sharded over ranks (``kv_seq``), where an indexed
        # write into a DTensor would land at the local index
        at = (torch.arange(T, device=x.device) == pos_idx)[None, :, None,
                                                            None]
        k_cache = torch.where(at, k.to(cache["k"].dtype), cache["k"])
        v_cache = torch.where(at, v.to(cache["v"].dtype), cache["v"])
        k_cache = shard(k_cache, "batch", "kv_seq", None, None)
        v_cache = shard(v_cache, "batch", "kv_seq", None, None)
        out = _decode_attn(cfg, q, k_cache, v_cache, pos_idx)
        new_cache = {"k": k_cache, "v": v_cache, "len": pos_idx + 1}
    else:
        out = _flash_chunks(cfg, q, k, v, pos_offset, cfg.causal)
        if mode == "prefill":
            kc = shard(k.to(dt), "batch", "kv_seq", None, None)
            vc = shard(v.to(dt), "batch", "kv_seq", None, None)
            new_cache = {"k": kc, "v": vc, "len": S}

    out = shard(out, "batch", "attn_seq", "heads", None)
    y = rows_whole_grad(whole_rows(merge_last(out)) @ p["wo"]["w"].to(dt))
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _act(cfg, x):
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.activation == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None,
             lead: Tuple[int, ...] = ()):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w1": dense_init(gen, d, f, lead=lead),
        "w2": dense_init(gen, f, d, lead=lead),
    }
    if cfg.gated_mlp:
        p["w3"] = dense_init(gen, d, f, lead=lead)
    return p


def mlp(cfg: ModelConfig, p, x):
    dt = x.dtype
    x = whole_rows(x)  # gathered once for both input products
    h = _act(cfg, linear(p["w1"], x, dt))
    if cfg.gated_mlp:
        h = h * linear(p["w3"], x, dt)
    h = shard(h, "batch", None, "d_ff")
    return linear(p["w2"], h, dt)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d: int):
    return {"table": normal(gen, (vocab, d), 0.02)}


def embed(p, tokens, dtype):
    # gather, then cast: the same values as casting the whole table first.
    # A sharded table that needs a gradient is read whole on each rank for
    # its batch rows (``local_apply``): the backward of an indexed read of
    # a sharded table (``index_put``) has no DTensor rule on every torch
    # version, and ``F.embedding``'s masked partial sums clash with a
    # batch split
    table = p["table"]
    if isinstance(table, DTensor) and table.requires_grad:
        return local_apply(lambda t, i: t[i], (table, tokens),
                           ((None, None), ("batch", None)),
                           (("batch", None, None),)).to(dtype)
    return table[tokens].to(dtype)


def unembed(p, x, dtype=torch.float32):
    """logits = x @ table^T, accumulated in f32 for loss stability."""
    return rows_whole_grad(f32_einsum("bsd,vd->bsv", whole_rows(x),
                                      p["table"].to(x.dtype))).to(dtype)
