"""Shape-and-dtype stand-ins for every model input, per (arch × shape).

The port of ``src/repro/launch/specs.py``. Where the reference builds
``jax.ShapeDtypeStruct``s, the port builds tensors on PyTorch's ``meta``
device: they carry a shape and a dtype and allocate nothing, so the
full-size shapes (a 500k-token decode cache included) cost no memory.
``batch_specs`` / ``cache_specs`` give the structs' ``NamedSharding``s
(``models/sharding.py``: a spec on the rules' mesh, with its DTensor
placements).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.sharding import NamedSharding, P, Rules
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


# ---------------------------------------------------------------------------
# shardings for the structs
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, rules: Rules, shape: ShapeConfig):
    ns = lambda spec: NamedSharding(rules.mesh, spec)
    b = rules.spec("batch")[0] if rules.table.get("batch") else None
    out = {}
    for name, st in batch_struct(cfg, shape).items():
        if st.ndim == 2:
            out[name] = ns(P(b, None))
        else:
            out[name] = ns(P(b, None, None))
    return out


def cache_specs(cfg: ModelConfig, rules: Rules, shape: ShapeConfig):
    """NamedSharding tree mirroring init_caches structure."""
    mesh = rules.mesh
    b = rules.spec("batch")[0] if rules.table.get("batch") else None
    kv = rules.table.get("kv_seq")
    kv = kv[0] if kv and len(kv) == 1 else kv
    sh = rules.table.get("ssm_heads")
    sh = sh[0] if sh and len(sh) == 1 else (tuple(sh) if sh else None)

    def spec_for_path(path, st):
        leaf = path[-1]
        if leaf == "len":  # a host int in the port
            return NamedSharding(mesh, P())
        nd = st.ndim
        if leaf in ("k", "v"):  # (ns, B, T, KV, hd)
            return NamedSharding(mesh, P(None, b, kv, None, None))
        if leaf in ("ssm", "norm"):  # (ns[, inner], B, H, N, P)
            lead = (None,) * (nd - 4)
            return NamedSharding(mesh, P(*lead, b, sh, None, None))
        if leaf == "conv":  # (ns[, inner], B, W-1, C)
            lead = (None,) * (nd - 3)
            return NamedSharding(mesh, P(*lead, b, None, None))
        # slstm states (ns, B, d)
        return NamedSharding(mesh, P(None, b, None))

    def rec(tree, path):
        if isinstance(tree, dict):
            return {k: rec(v, path + (k,)) for k, v in tree.items()}
        return spec_for_path(path, tree)

    return rec(cache_struct(cfg, shape), ())
