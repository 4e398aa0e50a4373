"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside ``paddle_tpu`` (the JAX reference, which it never
imports).  It mirrors the reference's module paths: ``fluid/`` for the
program model and executor, ``ops/`` for the op lowerings, ``ops/kernels/``
for the hand-written Hopper kernels (the counterparts of
``ops/pallas/``), ``csrc/`` for their CUDA sources, ``models/`` for the
model builders.
"""

from . import fluid  # noqa: F401
