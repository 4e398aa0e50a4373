"""Weight-decay regularizers (counterpart of
``paddle_tpu/fluid/regularizer.py``): L2 decay (``scale`` + ``sum``) and
L1 decay (``sign`` + ``scale`` + ``sum``)."""

from . import framework

__all__ = ['append_regularization_ops', 'L1Decay', 'L2Decay',
           'L1DecayRegularizer', 'L2DecayRegularizer']


class WeightDecayRegularizer(object):
    def append_regularization_ops(self, param, grad, block):
        raise NotImplementedError()


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(
            dtype=param.dtype, shape=param.shape, lod_level=0)
        block.append_op(
            type='scale',
            inputs={'X': [param]},
            outputs={'Out': [decay]},
            attrs={'scale': self._regularization_coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(
            type='sign', inputs={'X': [param]}, outputs={'Out': [sign]})
        block.append_op(
            type='scale',
            inputs={'X': [sign]},
            outputs={'Out': [decay]},
            attrs={'scale': self._regularization_coeff})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """grad += coeff * penalty'(param) appended as graph ops
    (reference regularizer.py:24)."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        regularization_term = None
        if param.regularizer is not None:
            regularization_term = param.regularizer(param, grad, grad.block)
        elif regularization is not None:
            regularization_term = regularization(param, grad, grad.block)
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        new_grad = grad.block.create_var(
            dtype=grad.dtype, shape=grad.shape, lod_level=grad.lod_level)
        grad.block.append_op(
            type='sum',
            inputs={'X': [grad, regularization_term]},
            outputs={'Out': [new_grad]})
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
