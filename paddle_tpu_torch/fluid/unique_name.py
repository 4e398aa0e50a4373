"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""

import contextlib

__all__ = ['generate', 'switch', 'guard']


class UniqueNameGenerator(object):
    def __init__(self, prefix=None):
        self.ids = {}
        self.prefix = prefix or ''

    def __call__(self, key):
        if key not in self.ids:
            self.ids[key] = 0
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + '_'.join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    yield
    switch(old)
