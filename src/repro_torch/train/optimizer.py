"""AdamW with linear-warmup cosine decay, on trees of tensors.

The port of ``src/repro/train/optimizer.py``. The optimizer state has the
parameters' tree structure. ``adamw_update`` writes the new parameters,
``m`` and ``v`` into the given tensors (under ``torch.no_grad``), which
takes the place of the reference's donated buffers; every quantity is f32.

Two details keep the numbers the reference's: ``global_norm`` sums the
leaves in sorted key order (``jax.tree_util``'s order for a dict), and the
schedule and the bias corrections ``beta ** t`` are computed on f32
tensors, as the reference's f32 arrays are, not in Python doubles.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.utils.tree import tree_leaves, tree_map


def init_opt_state(params):
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params)}


def lr_schedule(tc: TrainConfig, step):
    """The learning rate at ``step`` (an integer tensor) as an f32 tensor."""
    step = step.float()
    warm = torch.clamp_max(step / max(tc.warmup_steps, 1), 1.0)
    prog = torch.clamp(
        (step - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def _decay_mask(path: str) -> bool:
    """Weight decay on matrices only (no norms / biases / vectors)."""
    leaf = path.split("/")[-1]
    return leaf not in ("scale", "bias", "a_log", "dt_bias", "d_skip", "m", "v")


def _leaves_with_path(*trees, prefix=""):
    """(path, leaf of each tree) in the first tree's key order."""
    if isinstance(trees[0], dict):
        for k in trees[0]:
            yield from _leaves_with_path(*[t[k] for t in trees],
                                         prefix=f"{prefix}/{k}")
    else:
        yield (prefix, *trees)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(tc: TrainConfig, params, grads, opt_state,
                 step) -> Tuple[dict, dict, dict]:
    """One AdamW step, in place: returns (params, opt_state, metrics), the
    first two the given trees with their tensors updated."""
    gnorm = global_norm(grads)
    clip = torch.clamp_max(
        gnorm.new_tensor(tc.grad_clip) / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_schedule(tc, step)
    t = step.float() + 1.0
    f32 = dict(dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.tensor(tc.beta1, **f32) ** t
    bc2 = 1.0 - torch.tensor(tc.beta2, **f32) ** t
    for path, p, g, m, v in _leaves_with_path(params, grads, opt_state["m"],
                                              opt_state["v"]):
        g = g.float() * clip
        m.mul_(tc.beta1).add_((1 - tc.beta1) * g)
        v.mul_(tc.beta2).add_((1 - tc.beta2) * g.square_())
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(tc.eps))
        if _decay_mask(path) and p.ndim >= 2:
            delta.add_(tc.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
