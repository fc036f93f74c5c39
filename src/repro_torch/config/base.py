"""Config dataclasses for the model plane and the privacy plane.

The config system is deliberately explicit (frozen dataclasses + a registry)
rather than string-keyed dicts: every architecture in ``repro_torch.configs``
is a plain Python file declaring one ``ModelConfig`` and registering it.

A field-for-field copy of the JAX package's ``config/base.py`` (the tests
hold every record and helper equal to the reference's), plus
``BertConfig`` / ``BERT_BASE``, the widths the private serving path reads.
``PrivacyConfig``'s defaults decide the share modulus, word width and
circuit styles, so netlists built from it match the reference gate for
gate.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture. ``family`` selects the block stack:

    * ``dense``  — pre-norm GQA attention + (G)MLP blocks
    * ``moe``    — attention + mixture-of-experts FFN
    * ``ssm``    — xLSTM (mLSTM/sLSTM) recurrent blocks, no attention
    * ``hybrid`` — Mamba2 blocks with a periodically applied *shared*
                   attention block (Zamba2)
    * ``audio``  — dense decoder over precomputed codec-frame embeddings
    * ``vlm``    — dense decoder over [patch-embeddings ; token-embeddings]
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 -> d_model // num_heads
    causal: bool = True
    qk_norm: bool = False
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "silu"  # silu | gelu (gated MLP unless gated_mlp=False)
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_impl: str = "dense"  # dense (einsum dispatch) | a2a (shard_map EP)
    moe_combine: str = "psum"  # psum | psum_scatter (into seq-parallel stash)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM / hybrid ---
    ssm_state: int = 0  # Mamba2 N
    ssm_chunk: int = 256  # SSD chunk length
    ssm_expand: int = 2  # Mamba2 expansion factor
    ssm_conv: int = 4  # short conv width
    attn_every: int = 0  # hybrid: shared attn applied every N ssm blocks
    shared_attn_lora_rank: int = 0  # zamba2 per-invocation LoRA rank
    slstm_every: int = 0  # xlstm: every Nth block is sLSTM (rest mLSTM)

    # --- frontends (audio / vlm): stubs provide precomputed embeddings ---
    input_mode: str = "tokens"  # tokens | embeddings | tokens+image
    num_image_tokens: int = 0

    # --- numerics / compilation ---
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"  # master parameter dtype
    remat: str = "block"  # none | block  (jax.checkpoint around each block)
    scan_layers: bool = True
    attn_chunk: int = 512  # kv-chunk for flash-style attention scan
    logit_dtype: str = "float32"

    # --- privacy plane: which nonlinear ops are garbled ---
    gc_softmax_bits: int = 37
    gc_layernorm_bits: int = 37
    gc_act_bits: int = 21
    gc_frac_bits: int = 12

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % self.num_kv_heads == 0 or self.num_kv_heads == 0, (
            f"{self.name}: num_heads={self.num_heads} not a multiple of "
            f"num_kv_heads={self.num_kv_heads}"
        )

    # vocab padded so the embedding table shards over the model axis
    @property
    def padded_vocab(self) -> int:
        return _ceil_to(self.vocab_size, 128)

    @property
    def uses_attention(self) -> bool:
        return self.family in ("dense", "moe", "audio", "vlm", "hybrid")

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode (500k) is supported."""
        return self.family in ("ssm", "hybrid")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v, h = self.d_model, self.d_ff, self.padded_vocab, self.num_heads
        hd, kv = self.head_dim, self.num_kv_heads
        emb = v * d
        head = 0 if self.tie_embeddings else v * d
        per_attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        if self.gated_mlp:
            per_mlp = 3 * d * f
        else:
            per_mlp = 2 * d * f
        n = emb + head
        if self.family in ("dense", "audio", "vlm"):
            n += self.num_layers * (per_attn + per_mlp + 2 * d)
        elif self.family == "moe":
            n += self.num_layers * (
                per_attn + self.num_experts * per_mlp + d * self.num_experts + 2 * d
            )
        elif self.family == "ssm":
            # xLSTM rough: mLSTM block ~ (2*expand+2)*d^2-ish; use init-time count instead
            n += self.num_layers * (4 * d * d + 2 * d)
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            per_mamba = d * (2 * d_in + 2 * self.ssm_state * 1) + d_in * d + d_in * 2
            n += self.num_layers * (per_mamba + 2 * d)
            n += per_attn + per_mlp  # one shared block
        return n


# ---------------------------------------------------------------------------
# Input shapes (assigned per task spec)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def assigned_shapes(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells this arch actually runs.

    ``long_500k`` needs sub-quadratic attention: only ssm/hybrid run it
    (skip documented in DESIGN.md §5). All assigned archs are decoder-style,
    so decode shapes always run.
    """
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        out.append(s)
    return tuple(out)


# ---------------------------------------------------------------------------
# Mesh / train / privacy configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    microbatches: int = 1  # gradient accumulation factor
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    seed: int = 0
    grad_compression_bits: int = 0  # 0 = off, 8 = int8 error-feedback ring
    # cast f32 master params to compute dtype *before* the FSDP all-gather
    # (halves gather bytes); "float32" reproduces the gather-then-cast
    # baseline for the perf iteration log.
    param_gather_dtype: str = "bfloat16"


@dataclass(frozen=True)
class PrivacyConfig:
    """Knobs for the APINT privacy plane."""

    protocol: str = "apint"  # apint | primer_baseline
    mult_style: str = "xfbq"  # xfbq | conventional
    xfbq_qerror_terms: bool = False  # include Q-error correction terms
    layernorm_offload: bool = True  # APINT Fig.4 LayerNorm reduction
    scheduler: str = "fine"  # df | fr | sr | coarse | fine
    speculation: bool = True
    num_cores: int = 16
    wire_memory_kb: int = 128
    he_poly_n: int = 2048
    he_num_primes: int = 3
    he_t_bits: int = 40  # prime plaintext modulus (shares + GC word algebra)
    frac_bits: int = 12


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny config of the same family for CPU smoke tests.

    Preserves every structural feature (family, GQA ratio, MoE top-k, qk-norm,
    hybrid pattern, vocab padding behaviour) while shrinking all dims.
    """
    h = min(cfg.num_heads, 4)
    ratio = cfg.num_heads // cfg.num_kv_heads if cfg.num_kv_heads else 1
    kv = max(1, h // min(ratio, h))
    changes = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        num_heads=h,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=min(cfg.vocab_size, 512),
        attn_chunk=64,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_chunk=32,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        num_experts_per_token=(
            min(cfg.num_experts_per_token, 2) if cfg.num_experts_per_token else 0
        ),
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        slstm_every=min(cfg.slstm_every, 2) if cfg.slstm_every else 0,
        num_image_tokens=8 if cfg.num_image_tokens else 0,
        shared_attn_lora_rank=4 if cfg.shared_attn_lora_rank else 0,
        dtype="float32",
        scan_layers=cfg.scan_layers,
        name=cfg.name + "-smoke",
    )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)


@dataclass(frozen=True)
class BertConfig:
    """Encoder widths of a BERT-style model served privately."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "gelu"


#: BERT-base — the APINT paper's own evaluation model (Fig 8, 128 tokens).
BERT_BASE = BertConfig(
    name="bert-base-pit", num_layers=12, d_model=768, num_heads=12,
    head_dim=64, d_ff=3072, vocab_size=30522, activation="gelu",
)
