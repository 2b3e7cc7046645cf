"""Model zoo: the DeiT-style EfficientTransformer and PVTv2 (the models
ported so far); importing the package registers their archs."""
from efficient_attention_torch.models.registry import create_model, register_model
from efficient_attention_torch.models.efficient_vit import Block, EfficientTransformer
from efficient_attention_torch.models.pvt import PVTBlock, PyramidVisionTransformerV2

__all__ = [
    "create_model",
    "register_model",
    "EfficientTransformer",
    "Block",
    "PyramidVisionTransformerV2",
    "PVTBlock",
]
