"""OLMoE-1B-7B [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert vocab=50304, MoE 64 experts top-8.
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        num_experts=64,
        num_experts_per_token=8,
        moe_impl="a2a",
        # moe_combine stays "psum": the explicit psum_scatter variant was
        # REFUTED by the isolated A/B (§Perf #5) — XLA already converts
        # psum+slice to reduce-scatter, and the manual scatter's transpose
        # costs an extra all-gather in backward.
        qk_norm=True,  # OLMoE uses QK-norm
        rope_theta=10000.0,
    )
)
