"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside ``paddle_tpu`` (the JAX reference, which it never
imports).  It mirrors the reference's module paths: ``fluid/`` for the
program model and executor, ``ops/`` for the op lowerings, ``ops/kernels/``
for the hand-written Hopper kernels (the counterparts of
``ops/pallas/``), ``csrc/`` for their CUDA sources, ``models/`` for the
model builders, ``reader/`` and ``dataset/`` for the data a model is fed
(``batch`` groups a reader's samples into minibatches).
"""

from . import fluid  # noqa: F401
from . import reader  # noqa: F401
from . import dataset  # noqa: F401


def batch(reader_creator, batch_size, drop_last=False):
    """Group a sample reader into a batched reader
    (reference: python/paddle/batch.py)."""

    def batch_reader():
        r = reader_creator()
        b = []
        for instance in r:
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


__all__ = ['fluid', 'reader', 'dataset', 'batch']
