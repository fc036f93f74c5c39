"""Mixture-of-Experts FFN (OLMoE 64e/top-8, Llama4-Scout 16e/top-1).

The port of ``src/repro/models/moe.py``'s one-device half:

* ``_moe_dense`` — every expert runs on every token, masked combine;
* ``_router`` — f32 softmax top-k with probability renormalisation and the
  Switch-style load-balancing auxiliary loss.

``moe_ffn`` dispatches as the reference does: the expert-parallel path
only when sharding rules are active. On one device no rules are, so
``moe_impl="a2a"`` configs (olmoe, llama4-scout) run the dense path here
exactly as the JAX package runs them without a mesh. The expert-parallel
path (``_moe_ep`` / ``_moe_ep_local`` / ``_fsdp_gather``, capacity
buffers over ``torch.distributed``) comes with the multi-device slice.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import _act, dense_init, normal
from repro_torch.models.sharding import active_rules


def init_moe(gen, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s1 = 1.0 / math.sqrt(d)
    s2 = 1.0 / math.sqrt(f)
    p = {
        "router": dense_init(gen, d, E, scale=s1, lead=lead),
        "expert_w1": normal(gen, (*lead, E, d, f), s1),
        "expert_w2": normal(gen, (*lead, E, f, d), s2),
    }
    if cfg.gated_mlp:
        p["expert_w3"] = normal(gen, (*lead, E, d, f), s1)
    return p


def _router(cfg, p, x):
    """x: (B,S,d) -> (gates (B,S,k), idx (B,S,k), aux_loss scalar).

    ``torch.topk(sorted=True)`` orders as ``jax.lax.top_k`` when no two
    probabilities tie."""
    logits = x.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.num_experts_per_token, dim=-1,
                            sorted=True)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # Switch aux loss: E * sum_e f_e * p_e
    E = cfg.num_experts
    me = probs.mean(dim=(0, 1))  # mean router prob per expert
    ce = F.one_hot(idx, E).float().sum(2).mean(dim=(0, 1)) \
        / cfg.num_experts_per_token
    aux = E * (me * ce).sum()
    return gates, idx, aux


def _moe_dense(cfg, p, x):
    dt = x.dtype
    gates, idx, aux = _router(cfg, p, x)
    w1 = p["expert_w1"].to(dt)
    w2 = p["expert_w2"].to(dt)
    w3 = p.get("expert_w3")
    h = _act(cfg, torch.einsum("bsd,edf->bsef", x, w1))
    if w3 is not None:
        h = h * torch.einsum("bsd,edf->bsef", x, w3.to(dt))
    y_all = torch.einsum("bsef,efd->bsed", h, w2)
    comb = (F.one_hot(idx, cfg.num_experts).float()
            * gates[..., None]).sum(2)  # (B,S,E)
    y = torch.einsum("bse,bsed->bsd", comb.to(dt), y_all)
    return y, aux


def moe_ffn(cfg: ModelConfig, p, x):
    """Returns (y, aux_loss)."""
    if cfg.moe_impl == "a2a" and active_rules() is not None:
        raise NotImplementedError(
            "expert-parallel MoE waits for the port's multi-device slice")
    return _moe_dense(cfg, p, x)
