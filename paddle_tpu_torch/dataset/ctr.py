"""CTR (click-through-rate) dataset, criteo-display-ads shaped: the port's
own copy of ``paddle_tpu/dataset/ctr.py``, numpy only.  From one seed it
draws the same numbers as the JAX package's copy.

Each sample is (dense[13] float, sparse ids[26] int64 in [0, sparse_dim),
label {0, 1}); in ``train`` and ``test`` the label is correlated with both
the dense and the sparse features, so that models can learn.
"""

import numpy as np

__all__ = ['train', 'test', 'zipf_batch', 'DENSE_DIM', 'SPARSE_SLOTS',
           'SPARSE_DIM']

DENSE_DIM = 13
SPARSE_SLOTS = 26
SPARSE_DIM = 10000


def zipf_batch(rng, rows, vocab=SPARSE_DIM, hot_frac=None):
    """One skewed CTR feed batch: zipfian ids (zipf 1.2: mass on a few hot
    rows, a long tail), dense features and random labels, drawn from the
    ``np.random.RandomState`` ``rng``.

    ``hot_frac`` sharpens the skew: with probability hot_frac a lookup
    folds into a hot set of vocab/16 ids, the rest spread over the cold
    range.  None, the default, keeps the plain zipf stream."""
    # the draw order (dense, ids[, hot mask], label) is part of the
    # contract: both packages' batches from one seed are equal
    dense = rng.standard_normal((rows, DENSE_DIM)).astype('float32')
    base = rng.zipf(1.2, size=(rows, SPARSE_SLOTS))
    if hot_frac is not None:
        if not 0.0 < float(hot_frac) < 1.0:
            raise ValueError('zipf_batch: hot_frac must be in (0, 1), '
                             'got %r' % (hot_frac, ))
        hot_n = max(int(vocab) // 16, 1)
        hot = rng.random_sample((rows, SPARSE_SLOTS)) < float(hot_frac)
        ids = np.where(hot, base % hot_n,
                       hot_n + base % max(int(vocab) - hot_n, 1))
    else:
        ids = base % vocab
    return {
        'dense': dense,
        'sparse_ids': ids.astype('int64'),
        'label': rng.randint(0, 2, (rows, 1)).astype('int64'),
    }


def _reader(seed, n):
    def reader():
        rng = np.random.RandomState(seed)
        # a fixed per-id weight makes sparse features informative
        id_w = np.sin(np.arange(SPARSE_DIM) * 0.37)
        w_dense = rng.standard_normal(DENSE_DIM)
        for _ in range(n):
            dense = rng.standard_normal(DENSE_DIM).astype('float32')
            ids = (rng.zipf(1.2, size=SPARSE_SLOTS) % SPARSE_DIM).astype(
                'int64')
            logit = dense @ w_dense * 0.5 + id_w[ids].sum() * 0.8
            label = np.int64(1 / (1 + np.exp(-logit)) > rng.rand())
            yield dense, ids, label

    return reader


def train(n=4096, seed=0):
    return _reader(seed, n)


def test(n=512, seed=1):
    return _reader(seed + 10007, n)
