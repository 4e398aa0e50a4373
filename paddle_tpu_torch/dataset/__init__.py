"""Datasets of the PyTorch port (counterpart of ``paddle_tpu/dataset``):
deterministic synthetic generators, numpy only."""

from . import ctr  # noqa: F401

__all__ = ['ctr']
