"""Automatic mixed precision (counterpart of ``paddle_tpu/fluid/amp.py``).

bf16 operands for matmuls and convolutions, accumulated in f32 on the
tensor cores, with f32 master weights: parameters, gradients of f32
parameters, optimizer state, normalization statistics, softmax and loss
reductions stay f32.  A run-time mode that the lowerings read, not a
program rewrite:

    with fluid.amp_guard():
        exe.run(train_program, ...)

or globally: ``fluid.enable_amp(True)``.  The executor keys its compiled
blocks (and their CUDA graphs) on the mode.
"""

import contextlib

from ..ops import registry as _registry

__all__ = ['amp_guard', 'enable_amp', 'amp_enabled']


def enable_amp(enabled=True):
    _registry.set_amp(enabled)


def amp_enabled():
    return _registry.amp_enabled()


@contextlib.contextmanager
def amp_guard(enable=True):
    prev = _registry.amp_enabled()
    _registry.set_amp(enable)
    try:
        yield
    finally:
        _registry.set_amp(prev)
