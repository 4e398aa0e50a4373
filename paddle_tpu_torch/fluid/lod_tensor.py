"""LoDTensor helpers (counterpart of ``paddle_tpu/fluid/lod_tensor.py``)."""

import numpy as np

from . import core

__all__ = ['create_lod_tensor', 'create_random_int_lodtensor']


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """A LoDTensor from numpy / list data and per-level lengths."""
    if isinstance(data, core.LoDTensor):
        return create_lod_tensor(data.numpy(), recursive_seq_lens, place)
    if isinstance(data, list):
        # flatten through all LoD nesting levels down to per-sequence rows
        rows = data
        for _ in range(len(recursive_seq_lens) - 1):
            rows = [seq for group in rows for seq in group]
        arrs = [np.asarray(row).reshape(len(row), -1) if not np.isscalar(
            row) else np.asarray([[row]]) for row in rows]
        data = np.concatenate(arrs, axis=0)
    data = np.asarray(data)
    t = core.LoDTensor(data)
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    assert t.has_valid_recursive_sequence_lengths(), \
        'invalid recursive_seq_lens for data shape %s' % (data.shape, )
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    """A LoDTensor of int64 drawn uniformly from [low, high] (numpy's global
    generator, as the JAX package draws them)."""
    assert isinstance(base_shape, list), 'base_shape should be a list'
    total = sum(recursive_seq_lens[-1])
    # randint(low, high + 1) is what numpy's random_integers(low, high) draws
    data = np.random.randint(low, high + 1, [total] + base_shape).astype(
        'int64')
    t = core.LoDTensor(data)
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    return t
