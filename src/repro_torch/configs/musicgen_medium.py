"""MusicGen-medium [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.
Modality frontend (EnCodec) is a stub: input_specs() provides precomputed
frame embeddings (task spec). LayerNorm + (non-gated) GELU MLP as the
original MusicGen transformer.
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        norm_type="layernorm",
        activation="gelu",
        gated_mlp=False,
        input_mode="embeddings",
        rope_theta=10000.0,
    )
)
