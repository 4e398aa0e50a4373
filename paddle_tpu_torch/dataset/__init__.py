"""Datasets of the PyTorch port (counterpart of ``paddle_tpu/dataset``):
deterministic synthetic generators, numpy only."""

from . import conll05  # noqa: F401
from . import ctr  # noqa: F401
from . import movielens  # noqa: F401
from . import uci_housing  # noqa: F401

__all__ = ['conll05', 'ctr', 'movielens', 'uci_housing']
