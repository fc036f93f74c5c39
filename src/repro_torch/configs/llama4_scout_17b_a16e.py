"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1.
40 heads is not divisible by the 16-way model axis: attention activations are
sequence-sharded (see models/sharding.py fallbacks), weights shard on the
flattened head*head_dim dim which IS divisible (5120/16).
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        num_experts=16,
        num_experts_per_token=1,
        moe_impl="a2a",  # moe_combine="psum": see §Perf #5 (scatter refuted)
        rope_theta=500000.0,
    )
)
