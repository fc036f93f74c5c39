"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B; unverified].

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="llama3.2-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500000.0,
    )
)
