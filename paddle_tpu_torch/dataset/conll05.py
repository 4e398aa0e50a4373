"""CoNLL-2005 SRL-shaped dataset: the PyTorch port's own copy of
``paddle_tpu/dataset/conll05.py`` (reference:
python/paddle/dataset/conll05.py).  Synthetic: each sample is the
reference's 9-column tuple of aligned sequences
(word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred, mark, label)."""

import numpy as np

__all__ = ['get_dict', 'get_embedding', 'test']

_WORD_DICT = 4000
_VERB_DICT = 200
_LABEL_DICT = 59  # 2 * 29 BIO tags + O, reference label dict size


def get_dict():
    word_dict = {('w%d' % i): i for i in range(_WORD_DICT)}
    verb_dict = {('v%d' % i): i for i in range(_VERB_DICT)}
    label_dict = {('l%d' % i): i for i in range(_LABEL_DICT)}
    return word_dict, verb_dict, label_dict


def get_embedding(word_dim=32):
    rng = np.random.RandomState(5)
    return rng.standard_normal((_WORD_DICT, word_dim)).astype(np.float32)


def _reader_creator(seed, n):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            length = int(rng.randint(5, 30))
            words = rng.randint(0, _WORD_DICT, size=length)
            pred_pos = int(rng.randint(0, length))
            pred = rng.randint(0, _VERB_DICT, size=length)
            mark = np.zeros(length, np.int64)
            mark[pred_pos] = 1

            def ctx(shift):
                idx = np.clip(
                    np.arange(length) + shift, 0, length - 1)
                return words[idx]

            # labels correlate with distance to the predicate so a CRF
            # tagger genuinely learns structure
            label = np.minimum(
                np.abs(np.arange(length) - pred_pos), _LABEL_DICT - 1)
            cols = (words, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2), pred,
                    mark, label)
            yield tuple(list(map(int, c)) for c in cols)

    return reader


def test(n=500):
    return _reader_creator(23, n)


def train(n=2000):
    return _reader_creator(19, n)
