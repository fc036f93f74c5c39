"""SmolLM-360M [hf:HuggingFaceTB/SmolLM family; hf] — small llama arch.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
15 heads not divisible by model=16: sequence-sharded attention fallback.
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49152,
        rope_theta=10000.0,
    )
)
