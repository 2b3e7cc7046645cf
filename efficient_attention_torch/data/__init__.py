"""Data: the synthetic image dataset and a batch iterator."""
