"""Shape-and-dtype stand-ins for every model input, per (arch × shape).

The port of the one-device half of ``src/repro/launch/specs.py``. Where
the reference builds ``jax.ShapeDtypeStruct``s, the port builds tensors on
PyTorch's ``meta`` device: they carry a shape and a dtype and allocate
nothing, so the full-size shapes (a 500k-token decode cache included)
cost no memory. The shardings for these structs (``batch_specs``,
``cache_specs``) come with the multi-rank slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.transformer import init_caches


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` (a torch dtype or its name)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The batch dict for one step (no caches)."""
    B, S = shape.global_batch, shape.seq_len
    act = cfg.dtype
    if shape.kind == "decode":
        if cfg.input_mode == "embeddings":
            return {"embeddings": sds((B, 1, cfg.d_model), act)}
        return {"tokens": sds((B, 1), torch.int32)}
    out: Dict = {}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = sds((B, S, cfg.d_model), act)
    elif cfg.input_mode == "tokens+image":
        n_img = cfg.num_image_tokens
        out["tokens"] = sds((B, S - n_img), torch.int32)
        out["image_embeds"] = sds((B, n_img, cfg.d_model), act)
    else:
        out["tokens"] = sds((B, S), torch.int32)
    if shape.kind == "train":
        out["labels"] = sds((B, S), torch.int32)
    return out


def cache_struct(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Decode caches sized for a full context of shape.seq_len (``"len"``
    is the port's host int)."""
    return init_caches(cfg, shape.global_batch, shape.seq_len,
                       dtype=getattr(torch, cfg.dtype), device="meta")
