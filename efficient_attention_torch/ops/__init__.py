"""Tensor operations shared by the attention modules."""
