"""Parallel attention paths of the PyTorch port (dense reference only)."""
