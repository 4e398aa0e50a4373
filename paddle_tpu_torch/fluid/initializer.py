"""Parameter initializers (counterpart of ``paddle_tpu/fluid/initializer.py``).

Each initializer appends an init op (fill_constant / uniform_random /
gaussian_random) to the startup program block holding the parameter.
"""

import numpy as np

__all__ = ['Constant', 'Uniform', 'Normal', 'Xavier', 'ConstantInitializer',
           'UniformInitializer', 'NormalInitializer', 'XavierInitializer']


class Initializer(object):
    def __call__(self, param, block):
        raise NotImplementedError()

    @staticmethod
    def _compute_fans(var):
        shape = var.shape
        if not shape:
            return 1, 1
        if len(shape) == 2:
            return shape[0], shape[1]
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_in = shape[1] * receptive if len(shape) > 1 else shape[0]
        fan_out = shape[0] * receptive
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = value

    def __call__(self, var, block):
        return block.append_op(
            type='fill_constant',
            outputs={'Out': [var.name]},
            attrs={
                'shape': list(var.shape),
                'dtype': var.dtype,
                'value': float(self._value)
            })


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low = low
        self._high = high
        self._seed = seed

    def __call__(self, var, block):
        return block.append_op(
            type='uniform_random',
            outputs={'Out': [var.name]},
            attrs={
                'shape': list(var.shape),
                'dtype': var.dtype,
                'min': self._low,
                'max': self._high,
                'seed': self._seed
            })


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean = loc
        self._std_dev = scale
        self._seed = seed

    def __call__(self, var, block):
        return block.append_op(
            type='gaussian_random',
            outputs={'Out': [var.name]},
            attrs={
                'shape': list(var.shape),
                'dtype': var.dtype,
                'mean': self._mean,
                'std': self._std_dev,
                'seed': self._seed
            })


class XavierInitializer(Initializer):
    """Glorot init."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform = uniform
        self._fan_in = fan_in
        self._fan_out = fan_out
        self._seed = seed

    def __call__(self, var, block):
        f_in, f_out = self._compute_fans(var)
        fan_in = f_in if self._fan_in is None else self._fan_in
        fan_out = f_out if self._fan_out is None else self._fan_out
        if self._uniform:
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = np.sqrt(2.0 / (fan_in + fan_out))
        return NormalInitializer(0.0, std, self._seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
