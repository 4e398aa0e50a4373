"""MovieLens-shaped recommender dataset: the PyTorch port's own copy of
``paddle_tpu/dataset/movielens.py``
(reference: python/paddle/dataset/movielens.py).

Deterministic synthetic users/movies with the same reader record layout:
(user_id, gender_id, age_id, job_id, movie_id, category_ids, title_ids,
score)."""

import numpy as np

__all__ = [
    'train', 'test', 'max_user_id', 'max_movie_id', 'max_job_id',
    'age_table', 'movie_categories', 'CATEGORY_DICT_SIZE',
    'TITLE_DICT_SIZE'
]

_USERS = 100
_MOVIES = 80
_JOBS = 21
_AGES = 7
_CATEGORIES = 18
_TITLE_VOCAB = 150
_RATINGS = 1500

age_table = [1, 18, 25, 35, 45, 50, 56]
CATEGORY_DICT_SIZE = _CATEGORIES
TITLE_DICT_SIZE = _TITLE_VOCAB


def max_user_id():
    return _USERS


def max_movie_id():
    return _MOVIES


def max_job_id():
    return _JOBS


def movie_categories():
    return {('cat%d' % i): i for i in range(_CATEGORIES)}


def _movies(rng):
    movies = {}
    for mid in range(1, _MOVIES + 1):
        ncat = rng.randint(1, 4)
        cats = rng.choice(_CATEGORIES, size=ncat, replace=False).tolist()
        ntitle = rng.randint(1, 5)
        title = rng.randint(0, _TITLE_VOCAB, size=ntitle).tolist()
        movies[mid] = (cats, title)
    return movies


def _reader_creator(seed, n):
    def reader():
        rng = np.random.RandomState(seed)
        movies = _movies(np.random.RandomState(99))
        for _ in range(n):
            uid = int(rng.randint(1, _USERS + 1))
            gender = int(rng.randint(0, 2))
            age = int(rng.randint(0, _AGES))
            job = int(rng.randint(0, _JOBS))
            mid = int(rng.randint(1, _MOVIES + 1))
            cats, title = movies[mid]
            # score correlated with ids so the model has signal to learn
            score = float(((uid * 7 + mid * 3) % 5) + 1)
            yield (uid, gender, age, job, mid, cats, title, score)

    return reader


def train():
    return _reader_creator(21, _RATINGS)


def test():
    return _reader_creator(23, _RATINGS // 5)
