"""Mixture-of-Experts FFN (OLMoE 64e/top-8, Llama4-Scout 16e/top-1).

The port of ``src/repro/models/moe.py``. Two implementations
(``cfg.moe_impl``):

* ``dense`` — every expert runs on every token, masked combine;
* ``a2a`` — expert parallelism over the mesh's ``model`` axis
  (``_moe_ep``): activations arrive replicated across ``model``; each
  model-rank routes all tokens but gathers into capacity buffers only for
  its own E/|model| experts, runs the expert GEMMs locally and
  scatter-adds its contribution; the contributions are summed over
  ``model`` (an all-reduce, or a reduce-scatter into the sequence-parallel
  layout with ``moe_combine="psum_scatter"``). Expert weights are also
  FSDP-sharded over the data axes in training and all-gathered in bf16,
  after the cast, inside the body (``_fsdp_gather``). Tokens over an
  expert's capacity are dropped, so this path differs from the dense one
  whenever a buffer overflows.

The reference writes the body with ``shard_map``; the port runs it under
``torch.distributed.tensor.experimental.local_map`` on each rank's local
blocks. The body returns its partial output as a ``Partial`` DTensor over
``model`` and DTensor's redistribute makes the sum, so the backward pass
gets the reduction's transpose without a collective of its own; the FSDP
gather is an autograd function whose backward is the reduce-scatter.

``_router`` — f32 softmax top-k with probability renormalisation and the
Switch-style load-balancing auxiliary loss. ``moe_ffn`` dispatches as the
reference does: the expert-parallel path only when sharding rules are
active, so on one device ``moe_impl="a2a"`` configs (olmoe, llama4-scout)
run the dense path.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import _act, dense_init, normal
from repro_torch.models.sharding import (P, active_rules, local_apply,
                                         placements)


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

    Under sharding rules the router runs whole on every rank (its input
    and weight replicated, ``local_apply``): top-k, the renormalisation
    and the aux loss's means over the batch then see every expert and
    every token, and no rank's result depends on how DTensor would split
    these small reductions."""
    rep = (None, None, None)
    return local_apply(lambda x, w: _route(cfg, x, w),
                       (x, p["router"]["w"]), (rep, (None, None)),
                       (rep, rep, ()))


def _route(cfg, x, w):
    """``torch.topk(sorted=True)`` orders as ``jax.lax.top_k`` when no two
    probabilities tie."""
    logits = x.float() @ w.float()
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


def _expert_ffn(cfg, w1, w2, w3, xs, dtype):
    """xs: (E_loc, cap, d) -> (E_loc, cap, d), products in ``dtype``."""
    h = _act(cfg, torch.einsum("ecd,edf->ecf", xs, w1.to(dtype)))
    if w3 is not None:
        h = h * torch.einsum("ecd,edf->ecf", xs, w3.to(dtype))
    return torch.einsum("ecf,efd->ecd", h, w2.to(dtype))


# ---------------------------------------------------------------------------
# expert-parallel path
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim`` over ``group``; its backward is the
    reduce-scatter of the gradient (each rank keeps the sum of its block)."""

    @staticmethod
    def forward(ctx, w, dim, group):
        import torch.distributed._functional_collectives as fc

        ctx.dim, ctx.group = dim, group
        return fc.wait_tensor(fc.all_gather_tensor(w.contiguous(), dim,
                                                   group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as fc

        return fc.wait_tensor(fc.reduce_scatter_tensor(
            g.contiguous(), "sum", ctx.dim, ctx.group)), None, None


def _fsdp_gather(w, groups, axis):
    for g in groups:
        w = _AllGather.apply(w, axis, g)
    return w


def _moe_ep_local(cfg, fsdp_groups, r, cap, x, gates, idx, w1, w2, w3=None):
    """The local_map body. x/gates/idx replicated over ``model``; weights
    sharded: w* (E_loc, d_fsdp_loc, f). ``r`` is this rank's ``model``
    coordinate. Returns this rank's partial output (B,S,d)."""
    dt = x.dtype
    B, S, d = x.shape
    k = idx.shape[-1]
    E_loc = w1.shape[0]
    dev = x.device

    # FSDP all-gather of this rank's expert weights (bf16 on the wire)
    if fsdp_groups:
        w1 = _fsdp_gather(w1.to(dt), fsdp_groups, axis=1)
        w2 = _fsdp_gather(w2.to(dt), fsdp_groups, axis=2)
        w3 = _fsdp_gather(w3.to(dt), fsdp_groups, axis=1) \
            if w3 is not None else None
    else:
        w1 = w1.to(dt)
        w2 = w2.to(dt)
        w3 = w3.to(dt) if w3 is not None else None

    tokens = x.reshape(B * S, d)
    flat_idx = idx.reshape(B * S * k)  # expert id per assignment
    flat_gate = gates.reshape(B * S * k)
    tok_of_assign = torch.arange(B * S, device=dev).repeat_interleave(k)

    local_e = flat_idx - r * E_loc  # in [0, E_loc) if ours
    mine = (local_e >= 0) & (local_e < E_loc)

    # position of each assignment within its expert's capacity buffer
    onehot = F.one_hot(torch.where(mine, local_e, E_loc), E_loc + 1
                       ).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot  # exclusive cumsum
    slot = (pos_in_e * onehot).sum(1)  # (BSk,)
    keep = mine & (slot < cap)
    dst = torch.where(keep, local_e * cap + slot, E_loc * cap)  # overflow row

    gathered = torch.zeros((E_loc * cap + 1, d), dtype=dt, device=dev)
    gathered = gathered.index_add(0, dst, tokens[tok_of_assign])
    xs = gathered[:-1].reshape(E_loc, cap, d)

    ys = _expert_ffn(cfg, w1, w2, w3, xs, dt).reshape(E_loc * cap, d)
    ys = torch.cat([ys, torch.zeros((1, d), dtype=dt, device=dev)])
    contrib = ys[dst] * flat_gate[:, None].to(dt)
    y = torch.zeros((B * S, d), dtype=dt, device=dev).index_add(
        0, tok_of_assign, torch.where(keep[:, None], contrib,
                                      torch.zeros((), dtype=dt, device=dev)))
    return y.reshape(B, S, d)


def _moe_ep(cfg, p, x):
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    rules = active_rules()
    assert rules is not None, "a2a MoE requires active sharding rules (mesh)"
    mesh = rules.mesh
    axis_sizes = rules.axis_sizes
    dp_axes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    B, S, d = x.shape
    k = cfg.num_experts_per_token
    E = cfg.num_experts
    model_sz = axis_sizes.get("model", 1)
    assert E % model_sz == 0, (E, model_sz)

    gates, idx, aux = _router(cfg, p, x)
    gates = gates.to(x.dtype)

    dp_sz = 1
    for a in dp_axes:
        dp_sz *= axis_sizes[a]
    b_loc = B // dp_sz if B % dp_sz == 0 else B
    tokens_loc = b_loc * S
    cap = int(tokens_loc * k * cfg.capacity_factor / E) + 1

    batch_ax = rules.table.get("batch")
    bspec = batch_ax if batch_ax is None else (
        batch_ax[0] if len(batch_ax) == 1 else batch_ax
    )
    # FSDP axes for expert weights: training only (rules carry the policy)
    # and dims must divide
    fsdp_rule = rules.table.get("fsdp")
    fsdp_ok = fsdp_rule and (cfg.d_model % dp_sz == 0)
    fsdp_axes = tuple(fsdp_rule) if fsdp_ok else ()
    fs = fsdp_axes if fsdp_axes else None
    wspec = P("model", fs, None)
    w2spec = P("model", None, fs)

    use_scatter = (
        cfg.moe_combine == "psum_scatter" and S % model_sz == 0
        and rules.table.get("act_seq") is not None
    )
    w3 = p.get("expert_w3")
    act_pl = placements(P(bspec, None, None), mesh)
    w_pl = [placements(wspec, mesh), placements(w2spec, mesh)]
    weights = [p["expert_w1"], p["expert_w2"]]
    if w3 is not None:
        w_pl.append(w_pl[0])
        weights.append(w3)
    names = list(mesh.mesh_dim_names)
    m_model = names.index("model")
    # gradients: activations are replicated over ``model`` but each rank
    # adds only its experts' part, so theirs are partial sums over it;
    # weights replicated over a data axis the batch is split over get
    # partial sums over that axis (the FSDP gather's backward reduces its
    # own)
    act_grad = [Partial() if m == m_model else pl
                for m, pl in enumerate(act_pl)]

    def w_grad(pl):
        return [Partial() if pl[m].is_replicate() and
                not act_pl[m].is_replicate() else pl[m]
                for m in range(len(pl))]

    out_pl = [Partial() if m == m_model else pl
              for m, pl in enumerate(act_pl)]
    groups = [mesh.get_group(a) for a in fsdp_axes]
    r = mesh.get_local_rank("model")

    def body(x, gates, idx, *ws):
        return _moe_ep_local(cfg, groups, r, cap, x, gates, idx, *ws)

    args = [a.redistribute(mesh, pl) for a, pl in
            zip([x, gates, idx, *weights], [act_pl] * 3 + w_pl)]
    y = local_map(
        body, out_placements=out_pl,
        in_placements=tuple([act_pl] * 3 + w_pl),
        in_grad_placements=tuple([act_grad, act_grad, act_pl]
                                 + [w_grad(pl) for pl in w_pl]),
        device_mesh=mesh)(*args)
    out_spec = (P(bspec, "model", None) if use_scatter
                else P(bspec, None, None))
    # the sum over ``model``: a reduce-scatter or an all-reduce
    y = y.redistribute(mesh, placements(out_spec, mesh))
    return y, aux


def moe_ffn(cfg: ModelConfig, p, x):
    """Returns (y, aux_loss)."""
    if cfg.moe_impl == "a2a" and active_rules() is not None:
        return _moe_ep(cfg, p, x)
    return _moe_dense(cfg, p, x)
