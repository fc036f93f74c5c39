"""Step builders: train_step / prefill_step / decode_step.

The port of the one-device half of ``src/repro/launch/steps.py``. Each
builder returns the reference's ``(fn, in_shardings, out_shardings,
rules)``; on one device the last three are ``None``, and a mesh raises
until the multi-rank slice brings the sharded layouts
(``state_shardings``, ``_cast_params_for_compute``).

``train_step(state, batch)`` runs the forward and ``chunked_lm_loss`` +
``router_aux_coef · aux`` per microbatch, accumulating f32 gradients in
the parameters' ``.grad`` in microbatch order, divides by the microbatch
count and applies ``adamw_update`` in place: the state's tensors are
overwritten (the reference donates them) and it returns
``(state, metrics)`` with ``step`` advanced and the metrics ``loss``,
``aux``, ``grad_norm`` and ``lr`` as 0-d tensors on the state's device.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.specs import sds
from repro_torch.models import forward
from repro_torch.models.transformer import init_params
from repro_torch.train.losses import chunked_lm_loss
from repro_torch.train.optimizer import adamw_update, init_opt_state
from repro_torch.utils.tree import tree_leaves, tree_map


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "sharded steps wait for the port's multi-rank slice")


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


def build_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None,
                     shape: Optional[ShapeConfig] = None):
    _no_mesh(mesh)

    def loss_fn(params, batch):
        hidden, aux = forward(cfg, params, batch, mode="train")
        loss, _ = chunked_lm_loss(cfg, params["out_head"], hidden,
                                  batch["labels"], z_coef=tc.z_loss)
        return loss + cfg.router_aux_coef * aux, loss, aux

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        mb = tc.microbatches
        B = batch[next(iter(batch))].shape[0]
        assert B % mb == 0, (B, mb)
        ce = aux = 0.0
        try:
            for p in leaves:
                p.requires_grad_(True)
            for i in range(mb):
                part = {k: v.reshape(mb, B // mb, *v.shape[1:])[i]
                        for k, v in batch.items()} if mb > 1 else batch
                total, l_i, a_i = loss_fn(params, part)
                total.backward()
                ce, aux = ce + l_i.detach(), aux + a_i.detach()
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                         else p.grad, params)
        if mb > 1:
            for g in tree_leaves(grads):
                g.div_(mb)
            ce, aux = ce / mb, aux / mb
        params, opt, met = adamw_update(tc, params, grads, state["opt"],
                                        state["step"])
        for p in leaves:
            p.grad = None
        metrics = {"loss": ce, "aux": aux, **met}
        return {"params": params, "opt": opt, "step": state["step"] + 1}, \
            metrics

    return train_step, None, None, None


def build_prefill_step(cfg: ModelConfig, mesh=None,
                       shape: Optional[ShapeConfig] = None,
                       fsdp_params: bool = False):
    _no_mesh(mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        return forward(cfg, params, batch, mode="prefill")

    return prefill_step, None, None, None


def build_decode_step(cfg: ModelConfig, mesh=None,
                      shape: Optional[ShapeConfig] = None,
                      fsdp_params: bool = False):
    _no_mesh(mesh)

    @torch.no_grad()
    def decode_step(params, batch, caches):
        return forward(cfg, params, batch, mode="decode", caches=caches)

    return decode_step, None, None, None
