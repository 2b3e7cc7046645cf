"""Model zoo: the DeiT-style EfficientTransformer (the models ported so far)."""
from efficient_attention_torch.models.registry import create_model, register_model
from efficient_attention_torch.models.efficient_vit import Block, EfficientTransformer

__all__ = [
    "create_model",
    "register_model",
    "EfficientTransformer",
    "Block",
]
