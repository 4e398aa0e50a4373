"""UCI-housing-shaped regression dataset: the PyTorch port's own copy of
``paddle_tpu/dataset/uci_housing.py``
(reference: python/paddle/dataset/uci_housing.py) — synthetic linear data
with noise; 13 features, scalar target."""

import numpy as np

__all__ = ['train', 'test', 'feature_range', 'FEATURE_DIM']

FEATURE_DIM = 13


def _make(seed, n):
    rng = np.random.RandomState(seed)
    w = np.linspace(-2.0, 2.0, FEATURE_DIM).astype('float32')
    x = rng.uniform(-1, 1, size=(n, FEATURE_DIM)).astype('float32')
    y = (x @ w + 0.5 + 0.05 * rng.standard_normal(n)).astype('float32')
    return x, y


def _reader_creator(seed, n):
    def reader():
        x, y = _make(seed, n)
        for i in range(n):
            yield x[i], y[i:i + 1]

    return reader


def train(n=404):
    return _reader_creator(3, n)


def test(n=102):
    return _reader_creator(5, n)


def feature_range(maximums, minimums):
    pass
