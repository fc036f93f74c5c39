"""InternVL2-26B [arXiv:2404.16821; hf] — InternViT + InternLM2 backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 (padded to 92672 for
16-way vocab sharding). The InternViT frontend is a stub: input_specs()
provides precomputed patch embeddings prepended to the token sequence.
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        input_mode="tokens+image",
        num_image_tokens=256,
        rope_theta=1000000.0,
    )
)
