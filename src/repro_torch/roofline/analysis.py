"""Three-term roofline for one step on NVIDIA H100 cards.

The port of ``src/repro/roofline/analysis.py`` (all but
``parse_collectives``, which reads XLA HLO and has no counterpart here)::

    compute    = FLOPs per device            / peak FLOP/s
    memory     = HBM bytes per device        / HBM bandwidth
    collective = collective bytes per device / NVLink bandwidth

``HW`` holds the H100 SXM's published figures (NVIDIA data sheet, dense
rates without sparsity, at the full 700 W power limit), in place of the
reference's TPU v5e constants; a card set to a lower limit runs slower
under load, so a share of these peaks names the card and its limit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.config import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class HW:
    """One NVIDIA H100 80GB HBM3 (SXM) at 700 W."""

    peak_flops: float = 989e12  # bf16 dense, tensor cores
    hbm_bw: float = 3.35e12  # bytes/s
    link_bw: float = 450e9  # bytes/s each way, NVLink 4 (18 links)


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    wire_bytes_per_device: float,
    hw: HW = HW(),
) -> Dict[str, float]:
    t_c = flops_per_device / hw.peak_flops
    t_m = bytes_per_device / hw.hbm_bw
    t_x = wire_bytes_per_device / hw.link_bw
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    bound = max(t_c, t_m, t_x)
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "dominant": dom,
        "step_lower_bound_s": bound,
        # fraction of the bound that is useful compute (roofline fraction)
        "compute_fraction_of_bound": t_c / bound if bound > 0 else 0.0,
    }


def active_params(cfg: ModelConfig) -> float:
    """Parameters touched per token (MoE: only routed experts)."""
    n = cfg.num_params()
    if cfg.num_experts:
        per_mlp = (3 if cfg.gated_mlp else 2) * cfg.d_model * cfg.d_ff
        total_exp = cfg.num_layers * cfg.num_experts * per_mlp
        active_exp = cfg.num_layers * cfg.num_experts_per_token * per_mlp
        n = n - total_exp + active_exp
    return float(n)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference).

    Embedding-table flops excluded (standard convention); the attention's
    quadratic term is not counted.
    """
    n = active_params(cfg)
    n -= cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens
