from repro_torch.config.base import (
    BERT_BASE,
    BertConfig,
    ModelConfig,
    ShapeConfig,
    MeshConfig,
    TrainConfig,
    PrivacyConfig,
    SHAPES,
    assigned_shapes,
    reduced_config,
)
from repro_torch.config.registry import register_config, get_config, list_configs

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "MeshConfig",
    "TrainConfig",
    "PrivacyConfig",
    "SHAPES",
    "assigned_shapes",
    "reduced_config",
    "register_config",
    "get_config",
    "list_configs",
    "BertConfig",
    "BERT_BASE",
]
