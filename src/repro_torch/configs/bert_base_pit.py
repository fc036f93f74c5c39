"""BERT-base — the APINT paper's own evaluation model (Fig 8, 128 tokens).

12L d_model=768 12H d_ff=3072 vocab=30522, bidirectional (encoder), LayerNorm,
GELU. This is the model the privacy-plane benchmarks reproduce the paper's
latency/accuracy breakdowns on.
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="bert-base-pit",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=30522,
        causal=False,
        norm_type="layernorm",
        activation="gelu",
        gated_mlp=False,
        rope_theta=0.0,  # BERT uses learned positions; we use absolute-pos table
    )
)
