"""The two configuration records the private serving path reads.

``PrivacyConfig`` is a field-for-field copy of the JAX package's record
(its defaults decide the share modulus, word width and circuit styles, so
netlists built from it match the reference gate for gate). ``BERT_BASE``
carries the widths of the paper's evaluation model.
"""

from __future__ import annotations

from dataclasses import dataclass


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
