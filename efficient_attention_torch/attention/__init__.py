"""The efficient-attention zoo, PyTorch edition (the modules ported so far)."""
from efficient_attention_torch.attention.base import MASK_VAL, MultiheadAttention
from efficient_attention_torch.attention.eva import EVA
from efficient_attention_torch.attention.local import LocalAttention

__all__ = ["MASK_VAL", "MultiheadAttention", "LocalAttention", "EVA"]
