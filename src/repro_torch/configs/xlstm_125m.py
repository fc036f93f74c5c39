"""xLSTM-125M [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks.

12L d_model=768 4H vocab=50304, d_ff=0 (xLSTM blocks carry their own
up/down projections). Every 6th block is sLSTM (ratio ~ xLSTM[5:1]),
rest mLSTM.
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab_size=50304,
        slstm_every=6,
        norm_type="layernorm",
        causal=True,
    )
)
