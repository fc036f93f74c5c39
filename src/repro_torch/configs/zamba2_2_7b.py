"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention block.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
One *shared* attention+MLP block (single weight set) is applied every 6
Mamba2 blocks with per-invocation LoRA adapters (rank 64), following the
Zamba2 design.
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_chunk=256,
        attn_every=6,
        shared_attn_lora_rank=64,
        rope_theta=10000.0,
    )
)
