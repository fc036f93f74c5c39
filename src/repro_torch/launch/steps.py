"""Step builders: train_step / prefill_step / decode_step.

The port of ``src/repro/launch/steps.py``. Each builder returns the
reference's ``(fn, in_shardings, out_shardings, rules)``. On one device
(``mesh=None``) the last three are ``None``. With a mesh (a
``DeviceMesh`` over the running process group, ``launch/mesh.py``) the
shardings are trees of the port's ``NamedSharding`` (a spec on the mesh;
its ``.placements`` are the DTensor layout, one placement per mesh dim),
and the rules are active while the step runs, so ``shard`` lays every
annotated activation out as the reference's ``with_sharding_constraint``
does.

With a mesh each step takes its inputs as DTensors or as plain tensors
holding the same global value on every rank (each rank keeps its block:
the reference's ``jit(in_shardings=)`` placing host arrays), lays them
out by ``in_shardings`` and runs the model on DTensors; plain tensors the
model code makes meet them as replicated values
(``implicit_replication``). Results are DTensors, global values as in
JAX (``full_tensor()`` gathers one).

``train_step(state, batch)`` runs the forward and ``chunked_lm_loss`` +
``router_aux_coef · aux`` per microbatch, accumulating f32 gradients in
the parameters' ``.grad`` in microbatch order, divides by the microbatch
count and applies ``adamw_update`` in place: the state's tensors are
overwritten (the reference donates them) and it returns
``(state, metrics)`` with ``step`` advanced and the metrics ``loss``,
``aux``, ``grad_norm`` and ``lr`` as 0-d tensors on the state's device.
With a mesh each gradient is laid out as its parameter before the
update, and with ``tc.param_gather_dtype == "bfloat16"`` the matrices are
cast to bf16 on their master shards before the FSDP all-gather
(``_cast_params_for_compute``), as the reference pins.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import specs as SP
from repro_torch.launch.specs import sds
from repro_torch.models import forward
from repro_torch.models.sharding import (P, NamedSharding, make_rules,
                                         named_sharding_tree, use_rules)
from repro_torch.models.transformer import init_params
from repro_torch.train.losses import chunked_lm_loss
from repro_torch.train.optimizer import adamw_update, init_opt_state
from repro_torch.utils.tree import tree_leaves, tree_map


def _param_struct(cfg: ModelConfig) -> dict:
    """``init_params``' tree as meta tensors: traced under a fake-tensor
    mode, so no parameter is drawn or allocated."""
    with FakeTensorMode():
        fake = init_params(cfg, torch.Generator())
    return tree_map(lambda a: sds(a.shape, a.dtype), fake)


def serve_param_struct(cfg: ModelConfig) -> dict:
    """Serving checkpoints store weights in the inference dtype (bf16):
    matrices take cfg.dtype, vectors stay f32."""
    dt = getattr(torch, cfg.dtype)
    return tree_map(lambda s: sds(s.shape, dt)
                    if s.dtype == torch.float32 and s.ndim >= 2 else s,
                    _param_struct(cfg))


def abstract_state(cfg: ModelConfig, tc: TrainConfig) -> dict:
    """The train state's tree as meta tensors (no allocation)."""
    params = _param_struct(cfg)
    return {"params": params, "opt": init_opt_state(params),
            "step": sds((), torch.int32)}


def state_shardings(cfg: ModelConfig, state_struct, mesh) -> dict:
    pspecs = named_sharding_tree(cfg, state_struct["params"], mesh)
    return {
        "params": pspecs,
        "opt": {"m": pspecs, "v": pspecs},
        "step": NamedSharding(mesh, P()),
    }


# ---------------------------------------------------------------------------
# laying trees out on a mesh
# ---------------------------------------------------------------------------


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def lay_out(tree, shardings, mesh):
    """Every leaf of ``tree`` as a DTensor laid out by the matching
    ``NamedSharding`` of ``shardings``: DTensors are redistributed, plain
    tensors (the same global value on every rank) cut to this rank's
    block; non-tensor leaves (a cache's ``"len"``) pass as they are."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, sh):
        pl = sh.placements
        if isinstance(x, DTensor):
            return x if list(x.placements) == list(pl) \
                else x.redistribute(mesh, pl)
        if isinstance(x, torch.Tensor):
            d = distribute_tensor(x, mesh, pl, src_data_rank=None)
            local = d.to_local()
            if local.untyped_storage().nbytes() > local.nbytes:
                # a view of the global tensor: keep the block alone
                d = DTensor.from_local(local.clone(), mesh, pl,
                                       run_check=False, shape=d.shape,
                                       stride=d.stride())
            return d
        return x

    return _zip_map(one, tree, shardings)


def _run_on(mesh):
    """The context a step body runs in: with a mesh, plain tensors that
    model code makes (positions, masks, accumulators) take part in DTensor
    ops as replicated values."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _local_metric(x):
    """A DTensor's global value as a plain tensor (others as they are)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------


def _cast_params_for_compute(cfg: ModelConfig, params, mesh,
                             fsdp_params: bool = True):
    """bf16 cast of each matrix's local f32 shard, laid out as its master
    param, so the cast runs *before* the FSDP all-gather (halves gather
    wire bytes). Vectors (norm scales, a_log, biases) stay f32 — model
    code handles their precision."""
    from torch.distributed.tensor import DTensor

    shardings = named_sharding_tree(cfg, params, mesh,
                                    fsdp_params=fsdp_params)
    dt = getattr(torch, cfg.dtype)

    def one(p, sh):
        pl = sh.placements
        if p.ndim >= 2 and p.dtype == torch.float32:
            p = p.to(dt)
            return p.redistribute(mesh, pl) if isinstance(p, DTensor) \
                and list(p.placements) != list(pl) else p
        return p

    return _zip_map(one, params, shardings)


def build_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None,
                     shape: Optional[ShapeConfig] = None):
    rules = None
    if mesh is not None:
        assert shape is not None
        rules = make_rules(cfg, mesh, kind="train",
                           global_batch=shape.global_batch,
                           seq_len=shape.seq_len)
    cast_early = mesh is not None and tc.param_gather_dtype == "bfloat16"

    def loss_fn(params, batch):
        if cast_early:
            params = _cast_params_for_compute(cfg, params, mesh)
        hidden, aux = forward(cfg, params, batch, mode="train")
        loss, _ = chunked_lm_loss(cfg, params["out_head"], hidden,
                                  batch["labels"], z_coef=tc.z_loss)
        return loss + cfg.router_aux_coef * aux, loss, aux

    in_sh = out_sh = None
    if mesh is not None:
        ssh = state_shardings(cfg, abstract_state(cfg, tc), mesh)
        bsh = SP.batch_specs(cfg, rules, shape)
        in_sh = (ssh, bsh)
        out_sh = (ssh, None)

    def microbatch(batch, i, mb, B):
        """Rows [i·B/mb, (i+1)·B/mb) of every batch tensor (the
        reference's ``reshape(mb, B // mb, ...)[i]``); with a mesh, cut
        from the global batch and laid out as the batch."""
        part = {k: v.reshape(mb, B // mb, *v.shape[1:])[i]
                for k, v in batch.items()}
        return lay_out(part, bsh, mesh) if mesh is not None else part

    def train_step(state, batch):
        mb = tc.microbatches
        if mesh is not None:
            state = lay_out(state, ssh, mesh)
            # microbatches are cut from the global batch, whose rows may
            # sit on other ranks
            batch = {k: _local_metric(v) for k, v in batch.items()} \
                if mb > 1 else lay_out(batch, bsh, mesh)
        params = state["params"]
        leaves = tree_leaves(params)
        B = batch[next(iter(batch))].shape[0]
        assert B % mb == 0, (B, mb)
        ce = aux = 0.0
        with use_rules(rules), _run_on(mesh):
            try:
                for p in leaves:
                    p.requires_grad_(True)
                for i in range(mb):
                    part = microbatch(batch, i, mb, B) if mb > 1 else batch
                    total, l_i, a_i = loss_fn(params, part)
                    total.backward()
                    ce, aux = ce + l_i.detach(), aux + a_i.detach()
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                             else p.grad, params)
            if mesh is not None:  # each gradient laid out as its param
                grads = _zip_map(lambda g, p: g.redistribute(
                    mesh, p.placements), grads, params)
            if mb > 1:
                for g in tree_leaves(grads):
                    g.div_(mb)
                ce, aux = ce / mb, aux / mb
            params, opt, met = adamw_update(tc, params, grads, state["opt"],
                                            state["step"])
        for p in leaves:
            p.grad = None
        metrics = {"loss": ce, "aux": aux, **met}
        if mesh is not None:
            metrics = {k: _local_metric(v) for k, v in metrics.items()}
        return {"params": params, "opt": opt, "step": state["step"] + 1}, \
            metrics

    return train_step, in_sh, out_sh, rules


def _serve_shardings(cfg, mesh, rules, shape, fsdp_params, decode):
    psh = named_sharding_tree(cfg, _param_struct(cfg), mesh,
                              fsdp_params=fsdp_params)
    bsh = SP.batch_specs(cfg, rules, shape)
    cash = SP.cache_specs(cfg, rules, shape)
    b = rules.spec("batch")[0] if rules.table.get("batch") else None
    logit_sh = NamedSharding(mesh, P(b, rules.spec("vocab")[0]))
    in_sh = (psh, bsh, cash) if decode else (psh, bsh)
    return in_sh, (logit_sh, cash)


def build_prefill_step(cfg: ModelConfig, mesh=None,
                       shape: Optional[ShapeConfig] = None,
                       fsdp_params: bool = False):
    """Serving default: TP-only weight sharding (fsdp_params=False) — FSDP
    weights would re-pay their all-gather every step."""
    rules = in_sh = out_sh = None
    if mesh is not None:
        rules = make_rules(cfg, mesh, kind="prefill",
                           global_batch=shape.global_batch,
                           seq_len=shape.seq_len)
        in_sh, out_sh = _serve_shardings(cfg, mesh, rules, shape,
                                         fsdp_params, decode=False)

    @torch.no_grad()
    def prefill_step(params, batch):
        if mesh is not None:
            params = lay_out(params, in_sh[0], mesh)
            batch = lay_out(batch, in_sh[1], mesh)
        with use_rules(rules), _run_on(mesh):
            if mesh is not None:
                params = _cast_params_for_compute(cfg, params, mesh,
                                                  fsdp_params=fsdp_params)
            logits, caches = forward(cfg, params, batch, mode="prefill")
            if mesh is not None:
                logits = lay_out(logits, out_sh[0], mesh)
                caches = lay_out(caches, out_sh[1], mesh)
        return logits, caches

    return prefill_step, in_sh, out_sh, rules


def build_decode_step(cfg: ModelConfig, mesh=None,
                      shape: Optional[ShapeConfig] = None,
                      fsdp_params: bool = False):
    rules = in_sh = out_sh = None
    if mesh is not None:
        rules = make_rules(cfg, mesh, kind="decode",
                           global_batch=shape.global_batch,
                           seq_len=shape.seq_len)
        in_sh, out_sh = _serve_shardings(cfg, mesh, rules, shape,
                                         fsdp_params, decode=True)

    @torch.no_grad()
    def decode_step(params, batch, caches):
        if mesh is not None:
            params = lay_out(params, in_sh[0], mesh)
            batch = lay_out(batch, in_sh[1], mesh)
            caches = lay_out(caches, in_sh[2], mesh)
        with use_rules(rules), _run_on(mesh):
            if mesh is not None:
                params = _cast_params_for_compute(cfg, params, mesh,
                                                  fsdp_params=fsdp_params)
            logits, caches = forward(cfg, params, batch, mode="decode",
                                     caches=caches)
            if mesh is not None:
                logits = lay_out(logits, out_sh[0], mesh)
                caches = lay_out(caches, out_sh[1], mesh)
        return logits, caches

    return decode_step, in_sh, out_sh, rules
