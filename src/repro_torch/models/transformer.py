"""Model assembly: init / forward / caches for every registered family.

The port of ``src/repro/models/transformer.py``. The parameter tree is
the reference's, nested dicts with the blocks stacked on a leading axis:

  * dense/moe/audio/vlm : super-block = [attn + (mlp|moe)]         × L
  * ssm (xlstm)         : super-block = [(per-1) × mLSTM + sLSTM]  × L/per
  * hybrid (zamba2)     : super-block = [per × mamba2 + shared-attn] × L/per
                          (the shared attention weights are *not* stacked;
                          each use gets its own LoRA adapter, Zamba2-style)

  {"embed": ..., "out_head": ..., "final_norm": ..., ["pos_embed": ...],
   "stacked": <one leading stack dim on every leaf>, "shared": <unstacked>}

``forward`` walks the stack with a Python loop over the leading axis (the
reference's ``lax.scan``) and returns:
  * mode="train":   (hidden (B,S,d), aux_loss)
  * mode="prefill": (last_logits (B,V), caches)
  * mode="decode":  (logits (B,V), caches)

Caches are the reference's tree with ``"len"`` a host int. Forward passes
are functional: a decode returns new caches and leaves the given ones as
they were. In train mode with ``cfg.remat == "block"`` (every config's
default) each step of the stack (a block; a super-block for ssm and
hybrid, as the reference's scan body) runs under
``torch.utils.checkpoint``: the backward pass recomputes the block from
its input, so only the (B, S, d) stream between blocks is kept — the
reference's ``jax.checkpoint(..., nothing_saveable)``. The recomputation
replays the same ops on the same inputs, so the numbers are unchanged.

``params_from_reference`` / ``caches_from_reference`` carry a tree of the
JAX package (leaves as numpy arrays, or anything ``np.asarray`` takes)
across, so the tests run both packages on the same weights and states.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.sharding import shard, whole_rows
from repro_torch.utils.tree import tree_map

# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def _unstack(tree, n: int) -> list:
    """The ``n`` blocks of a stacked tree, as views (``torch.unbind``):
    one backward node per leaf, which stacks the blocks' gradients once."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _at(tree, *idx):
    """The slice ``[idx]`` of every leaf: one block of a stacked tree."""
    return tree_map(lambda a: a[idx], tree)


def _stack(trees):
    """Stack a list of equal trees on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# block init/apply per family
# ---------------------------------------------------------------------------


def _init_attn_mlp_block(gen, cfg: ModelConfig, lead=()):
    p = {
        "ln1": L.norm_init(gen, cfg, cfg.d_model, lead),
        "attn": L.init_attention(gen, cfg, lead),
        "ln2": L.norm_init(gen, cfg, cfg.d_model, lead),
    }
    if cfg.family == "moe":
        p["moe"] = M.init_moe(gen, cfg, lead)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, lead=lead)
    return p


def _apply_attn_mlp_block(cfg, p, x, *, pos_offset, cache, mode, lora=None):
    h, new_cache = L.attention(
        cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x),
        pos_offset=pos_offset, cache=cache, mode=mode, lora=lora,
    )
    x = shard(x + h, "batch", "act_seq", "act_embed")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        h, aux = M.moe_ffn(cfg, p["moe"], L.apply_norm(cfg, p["ln2"], x))
    else:
        h = L.mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
    x = shard(x + h, "batch", "act_seq", "act_embed")
    return x, new_cache, aux


def _apply_mamba_block(cfg, p, x, *, cache, mode):
    h, new_cache = S.mamba2(cfg, p["mamba"], L.apply_norm(cfg, p["ln"], x),
                            cache=cache, mode=mode)
    return shard(x + h, "batch", "act_seq", "act_embed"), new_cache


def _apply_mlstm_block(cfg, p, x, *, cache, mode):
    h, new_cache = S.mlstm(cfg, p["mlstm"], L.apply_norm(cfg, p["ln"], x),
                           cache=cache, mode=mode)
    return shard(x + h, "batch", "act_seq", "act_embed"), new_cache


def _apply_slstm_block(cfg, p, x, *, cache, mode):
    h, new_cache = S.slstm(cfg, p["slstm"], L.apply_norm(cfg, p["ln_pre"], x),
                           cache=cache, mode=mode)
    return shard(x + h, "batch", "act_seq", "act_embed"), new_cache


# ---------------------------------------------------------------------------
# stack layout
# ---------------------------------------------------------------------------


def _stack_info(cfg: ModelConfig):
    """(num_super, inner_counts) per family."""
    if cfg.family == "hybrid":
        per = cfg.attn_every
        assert cfg.num_layers % per == 0
        return cfg.num_layers // per, per
    if cfg.family == "ssm":
        per = cfg.slstm_every
        assert cfg.num_layers % per == 0
        return cfg.num_layers // per, per - 1  # inner mLSTM count
    return cfg.num_layers, 1


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random f32 master params from ``generator`` (drawn on its device,
    then moved to ``device`` if another is given): the reference's
    distributions and shapes, not its bits."""
    gen = generator
    d = cfg.d_model
    V = cfg.padded_vocab
    params: dict = {
        "final_norm": L.norm_init(gen, cfg, d),
        "out_head": L.init_embedding(gen, V, d),
    }
    if cfg.input_mode in ("tokens", "tokens+image"):
        params["embed"] = L.init_embedding(gen, V, d)
    if cfg.rope_theta == 0 and cfg.uses_attention:
        params["pos_embed"] = L.init_embedding(gen, 512, d)  # bert-style

    ns, inner = _stack_info(cfg)
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        params["stacked"] = {"block": _init_attn_mlp_block(gen, cfg, (ns,))}
    elif cfg.family == "ssm":
        n_m = ns * inner
        params["stacked"] = {
            "mlstm": {"ln": L.norm_init(gen, cfg, d, (n_m,)),
                      "mlstm": S.init_mlstm(gen, cfg, (n_m,))},
            "slstm": {"ln_pre": L.norm_init(gen, cfg, d, (ns,)),
                      "slstm": S.init_slstm(gen, cfg, (ns,))},
        }
    elif cfg.family == "hybrid":
        n_m = ns * inner
        params["stacked"] = {
            "mamba": {"ln": L.norm_init(gen, cfg, d, (n_m,)),
                      "mamba": S.init_mamba2(gen, cfg, (n_m,))},
            "lora": L.init_attention_lora(gen, cfg, cfg.shared_attn_lora_rank,
                                          (ns,)),
        }
        params["shared"] = {"block": _init_attn_mlp_block(gen, cfg)}
    else:
        raise ValueError(cfg.family)
    if device is not None and torch.device(device) != gen.device:
        params = tree_map(lambda a: a.to(device), params)
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, capacity: int,
                dtype=torch.bfloat16, device="cuda"):
    """Empty decode caches with time capacity ``capacity``."""
    ns, inner = _stack_info(cfg)
    KV, hd = cfg.num_kv_heads, cfg.head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn_cache(n):
        return {"k": zeros(n, batch, capacity, KV, hd),
                "v": zeros(n, batch, capacity, KV, hd)}

    f32 = torch.float32
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        layers = {"attn": attn_cache(ns)}
    elif cfg.family == "hybrid":
        d_in, H, P, N = S.mamba2_dims(cfg)
        layers = {
            "mamba": {
                "ssm": zeros(ns, inner, batch, H, N, P, dt=f32),
                "conv": zeros(ns, inner, batch, cfg.ssm_conv - 1,
                              d_in + 2 * N),
            },
            "attn": attn_cache(ns),
        }
    elif cfg.family == "ssm":
        d_in, H, P = S.mlstm_dims(cfg)
        layers = {
            "mlstm": {
                "ssm": zeros(ns, inner, batch, H, P, P, dt=f32),
                "norm": zeros(ns, inner, batch, H, P, 1, dt=f32),
                "conv": zeros(ns, inner, batch, 3, d_in),
            },
            "slstm": {
                "c": zeros(ns, batch, cfg.d_model, dt=f32),
                "n": torch.full((ns, batch, cfg.d_model), 1e-6, dtype=f32,
                                device=device),
                "h": zeros(ns, batch, cfg.d_model, dt=f32),
                "m": zeros(ns, batch, cfg.d_model, dt=f32),
            },
        }
    else:
        raise ValueError(cfg.family)
    return {"layers": layers, "len": 0}


def _attn_layer_cache(layer_slice, length):
    if layer_slice is None:
        return None
    return {"k": layer_slice["k"], "v": layer_slice["v"], "len": length}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _embed_inputs(cfg: ModelConfig, params, batch, dtype):
    if cfg.input_mode == "embeddings":
        x = batch["embeddings"].to(dtype)
    elif cfg.input_mode == "tokens+image":
        tok = L.embed(params["embed"], batch["tokens"], dtype)
        img = batch["image_embeds"].to(dtype)
        x = torch.cat([img, tok], dim=1)
    else:
        x = L.embed(params["embed"], batch["tokens"], dtype)
    if "pos_embed" in params:
        Spos = x.shape[1]
        x = x + params["pos_embed"]["table"][:Spos].to(dtype)[None]
    return x


def forward(
    cfg: ModelConfig,
    params,
    batch: dict,
    *,
    mode: str = "train",
    caches: Optional[dict] = None,
):
    assert mode in ("train", "prefill", "decode")
    dtype = getattr(torch, cfg.dtype)
    if mode == "decode":
        assert caches is not None
        if cfg.input_mode == "embeddings":
            x = batch["embeddings"].to(dtype)
        else:
            x = L.embed(params["embed"], batch["tokens"], dtype)
        if "pos_embed" in params:
            x = x + params["pos_embed"]["table"][int(caches["len"])
                                                 ].to(dtype)[None, None]
        pos_offset = int(caches["len"])
    else:
        x = _embed_inputs(cfg, params, batch, dtype)
        pos_offset = 0
    x = shard(x, "batch", "act_seq", "act_embed")

    cache_len = int(caches["len"]) if caches is not None else None
    layer_caches = caches["layers"] if caches is not None else None
    decode = mode == "decode"
    keep = mode in ("prefill", "decode")

    ns, inner = _stack_info(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_layer_caches = None

    def run(step, *args):
        """One step of the stack; under block remat its activations are
        recomputed in the backward pass instead of kept."""
        if mode == "train" and cfg.remat == "block":
            return checkpoint(step, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return step(*args)

    if cfg.family in ("dense", "moe", "audio", "vlm"):
        blocks = _unstack(params["stacked"]["block"], ns)
        ys = []
        for i in range(ns):
            c_in = _attn_layer_cache(
                _at(layer_caches["attn"], i) if decode else None, cache_len)

            def block(x, p, c_in=c_in):
                return _apply_attn_mlp_block(cfg, p, x, pos_offset=pos_offset,
                                             cache=c_in, mode=mode)

            x, new_c, a = run(block, x, blocks[i])
            aux_total = aux_total + a
            if new_c is not None:
                ys.append({"k": new_c["k"], "v": new_c["v"]})
        if keep:
            new_layer_caches = {"attn": _stack(ys)}

    elif cfg.family == "hybrid":
        shared = params["shared"]["block"]
        mamba_p = _unstack(params["stacked"]["mamba"], ns * inner)
        lora_p = _unstack(params["stacked"]["lora"], ns)
        mamba_ys, attn_ys = [], []
        for i in range(ns):

            def super_block(x, mps, lora, i=i):
                inner_ys = []
                for j in range(inner):
                    c_in = _at(layer_caches["mamba"], i, j) if decode else None
                    x, new_c = _apply_mamba_block(cfg, mps[j], x, cache=c_in,
                                                  mode=mode)
                    inner_ys.append(new_c)
                c_in = _attn_layer_cache(
                    _at(layer_caches["attn"], i) if decode else None,
                    cache_len)
                x, new_ac, a = _apply_attn_mlp_block(
                    cfg, shared, x, pos_offset=pos_offset, cache=c_in,
                    mode=mode, lora=lora)
                return x, inner_ys, new_ac, a

            x, inner_ys, new_ac, a = run(
                super_block, x, mamba_p[i * inner:(i + 1) * inner], lora_p[i])
            aux_total = aux_total + a
            if keep:
                mamba_ys.append(_stack(inner_ys))
                attn_ys.append({"k": new_ac["k"], "v": new_ac["v"]})
        if keep:
            new_layer_caches = {"mamba": _stack(mamba_ys),
                                "attn": _stack(attn_ys)}

    elif cfg.family == "ssm":
        mlstm_p = _unstack(params["stacked"]["mlstm"], ns * inner)
        slstm_p = _unstack(params["stacked"]["slstm"], ns)
        mlstm_ys, slstm_ys = [], []
        for i in range(ns):

            def super_block(x, mps, sp, i=i):
                inner_ys = []
                for j in range(inner):
                    c_in = _at(layer_caches["mlstm"], i, j) if decode else None
                    x, new_c = _apply_mlstm_block(cfg, mps[j], x, cache=c_in,
                                                  mode=mode)
                    inner_ys.append(new_c)
                sc = _at(layer_caches["slstm"], i) if decode else None
                x, new_sc = _apply_slstm_block(cfg, sp, x, cache=sc,
                                               mode=mode)
                return x, inner_ys, new_sc

            x, inner_ys, new_sc = run(
                super_block, x, mlstm_p[i * inner:(i + 1) * inner], slstm_p[i])
            if keep:
                mlstm_ys.append(_stack(inner_ys))
                slstm_ys.append(new_sc)
        if keep:
            new_layer_caches = {"mlstm": _stack(mlstm_ys),
                                "slstm": _stack(slstm_ys)}

    else:
        raise ValueError(cfg.family)

    x = L.apply_norm(cfg, params["final_norm"], x)

    if mode == "train":
        return x, aux_total

    new_len = cache_len + 1 if decode else x.shape[1]
    new_caches = {"layers": new_layer_caches, "len": new_len}
    x = whole_rows(x)  # the rows in order for the last position's pick
    last = x[:, -1] if mode == "prefill" else x[:, 0]
    logits = L.f32_einsum("bd,vd->bv", last,
                          params["out_head"]["table"].to(last.dtype))
    logits = shard(logits, "batch", "vocab")
    return logits, new_caches


# ---------------------------------------------------------------------------
# trees carried across from the JAX package
# ---------------------------------------------------------------------------


def _leaf_from_reference(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: numpy has no bf16 of its own
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_reference(cfg: ModelConfig, tree, device="cuda") -> dict:
    """The JAX package's param tree of ``cfg`` (nested dicts; numpy or
    array leaves) as the port's: the same keys, shapes and dtypes."""
    if set(tree) - {"embed", "out_head", "final_norm", "pos_embed",
                    "stacked", "shared"}:
        raise ValueError(f"not a {cfg.name} param tree: {sorted(tree)}")
    return tree_map(lambda a: _leaf_from_reference(a, device), tree)


def caches_from_reference(cfg: ModelConfig, tree, device="cuda") -> dict:
    """The JAX package's cache tree (``{"layers": ..., "len": ...}``) as
    the port's, with ``"len"`` a host int."""
    return {"layers": tree_map(lambda a: _leaf_from_reference(a, device),
                               tree["layers"]),
            "len": int(np.asarray(tree["len"]))}


def state_from_reference(cfg: ModelConfig, state, device="cuda") -> dict:
    """The JAX package's train state (``params``, ``opt.m``, ``opt.v``,
    ``step``) as the port's: the trees as ``params_from_reference``
    carries them, ``step`` a 0-d int32 tensor."""
    return {"params": params_from_reference(cfg, state["params"], device),
            "opt": {k: params_from_reference(cfg, state["opt"][k], device)
                    for k in ("m", "v")},
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}
