"""Analytic per-device HBM traffic model (true dtypes).

The port of ``src/repro/roofline/analytic.py``, term for term. The
reference wrote it because byte counts from a compiled program overstate
bf16 models where a backend emulates bf16 in f32; the port has no
compiled program to read, so this first-principles model is its memory
term. The device layouts are the reference's: 256 devices (``multi_pod``:
512) with a 16-way model axis.

Assumptions (documented per term):
  * bf16 compute / f32 master + Adam (train), bf16 weights (serve)
  * full remat: block activations recomputed in bwd; only the per-layer
    (B,S,d) stash is stored between fwd and bwd
  * flash attention: score tiles stay in on-chip memory (shared memory
    and registers; no HBM score traffic)
  * FSDP gathers land once per device per pass (fwd, bwd-recompute,
    bwd-grad) at bf16
"""

from __future__ import annotations

from typing import Dict

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.roofline.analysis import active_params


def _devices(multi_pod: bool):
    return 512 if multi_pod else 256, 16  # total, model-axis size


def traffic_train(cfg: ModelConfig, shape: ShapeConfig, *, multi_pod: bool,
                  microbatches: int = 1) -> Dict[str, float]:
    D, M = _devices(multi_pod)
    N = float(cfg.num_params())
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.num_layers
    tokens_dev = B * S / (D / M)  # per model-replica data shard
    # optimizer: read p,m,v,g (4x4B) + write p,m,v (3x4B) on the shard
    opt = N / D * (7 * 4)
    # grads: written once (f32) per microbatch
    grads = N / D * 4 * microbatches
    # weights: each device reads its gathered bf16 copy 3x (fwd, recompute,
    # grad pass); gathered footprint = N / M per device
    weights = 3 * (N / M) * 2 * microbatches
    # activation stash: (B,S,d) per layer, sharded over data x model
    stash_bytes = L * tokens_dev / microbatches * d * 2 / M * microbatches
    stash = 2 * stash_bytes  # write fwd + read bwd
    # recompute intermediates (qkv/h/gate...) ~6x the stash, write+read
    recompute = 6 * 2 * stash_bytes
    # logits chunks: (B,S,V/M) f32 write+read, fwd+bwd
    logits = 4 * tokens_dev * cfg.padded_vocab / M * 4 / 1  # 2 passes x w+r
    total = opt + grads + weights + stash + recompute + logits
    return {
        "opt": opt, "grads": grads, "weights": weights, "stash": stash,
        "recompute": recompute, "logits": logits, "total": total,
    }


def traffic_prefill(cfg: ModelConfig, shape: ShapeConfig, *,
                    multi_pod: bool) -> Dict[str, float]:
    D, M = _devices(multi_pod)
    N = float(active_params(cfg))
    B, S = shape.global_batch, shape.seq_len
    tokens_dev = B * S / (D / M)
    acts = cfg.num_layers * tokens_dev * cfg.d_model * 2 / M * 8  # interms
    weights = (N / M) * 2  # one bf16 pass
    kv = (cfg.num_layers * B * S * cfg.num_kv_heads * cfg.head_dim * 2 * 2
          / D)  # cache write
    total = acts + weights + kv
    return {"weights": weights, "acts": acts, "kv_write": kv, "total": total}


def traffic_decode(cfg: ModelConfig, shape: ShapeConfig, *,
                   multi_pod: bool) -> Dict[str, float]:
    D, M = _devices(multi_pod)
    N = float(active_params(cfg))
    B, T = shape.global_batch, shape.seq_len
    # every parameter shard read once per token step (bf16)
    weights = N / D * 2 * (D / M)  # each model-replica reads its TP slice
    # KV cache read fully + one-token write
    if cfg.uses_attention:
        layers_attn = (cfg.num_layers if cfg.family != "hybrid"
                       else cfg.num_layers // max(cfg.attn_every, 1))
        kv = layers_attn * B * T * cfg.num_kv_heads * cfg.head_dim * 2 * 2 / D
    else:
        kv = 0.0
    # recurrent state read+write (f32)
    state = 0.0
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * cfg.d_model if cfg.family == "hybrid" else 2 * cfg.d_model
        h = d_in // 64 if cfg.family == "hybrid" else cfg.num_heads
        p = d_in // max(h, 1)
        n = cfg.ssm_state if cfg.family == "hybrid" else p
        state = 2 * cfg.num_layers * B * h * n * p * 4 / D
    total = weights + kv + state
    return {"weights": weights, "kv_read": kv, "state": state, "total": total}


def traffic(cfg: ModelConfig, shape: ShapeConfig, *, multi_pod: bool,
            microbatches: int = 1) -> Dict[str, float]:
    if shape.kind == "train":
        return traffic_train(cfg, shape, multi_pod=multi_pod,
                             microbatches=microbatches)
    if shape.kind == "prefill":
        return traffic_prefill(cfg, shape, multi_pod=multi_pod)
    return traffic_decode(cfg, shape, multi_pod=multi_pod)
