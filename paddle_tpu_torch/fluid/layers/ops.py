"""Op wrapper layers (counterpart of ``paddle_tpu/fluid/layers/ops.py``:
the unary activation layers of ``__activations__``, ``scale``, the
``elementwise_*`` layers, the ``logical_*`` layers, ``cumsum`` and the
random layers ``uniform_random``, ``gaussian_random`` and their
``*_batch_size_like`` forms)."""

from ..layer_helper import LayerHelper

__activations__ = [
    'sigmoid', 'logsigmoid', 'exp', 'tanh', 'tanh_shrink', 'softshrink',
    'sqrt', 'abs', 'ceil', 'floor', 'cos', 'sin', 'round', 'reciprocal',
    'log', 'square', 'softplus', 'softsign', 'brelu', 'leaky_relu',
    'soft_relu', 'elu', 'relu6', 'pow', 'stanh', 'hard_sigmoid', 'swish',
    'relu', 'thresholded_relu', 'hard_shrink',
]

__all__ = __activations__ + [
    'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'elementwise_max', 'elementwise_min',
    'elementwise_pow', 'scale', 'logical_and', 'logical_or', 'logical_xor',
    'logical_not', 'cumsum', 'uniform_random', 'gaussian_random',
    'uniform_random_batch_size_like', 'gaussian_random_batch_size_like',
]


def _unary_layer(op_type):
    def func(x, name=None, **kwargs):
        helper = LayerHelper(op_type, **locals())
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        out.shape = x.shape
        helper.append_op(
            type=op_type,
            inputs={'X': [x]},
            outputs={'Out': [out]},
            attrs=kwargs)
        return out

    func.__name__ = op_type
    return func


for _act in __activations__:
    globals()[_act] = _unary_layer(_act)


def _elementwise_layer(op_type):
    def func(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, **locals())
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        out.shape = x.shape
        helper.append_op(
            type=op_type,
            inputs={'X': [x],
                    'Y': [y]},
            outputs={'Out': [out]},
            attrs={'axis': axis})
        return helper.append_activation(out)

    func.__name__ = op_type
    return func


for _ew in ('add', 'sub', 'mul', 'div', 'max', 'min', 'pow'):
    globals()['elementwise_' + _ew] = _elementwise_layer('elementwise_' + _ew)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper('scale', **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(
        type='scale',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={
            'scale': float(scale),
            'bias': float(bias),
            'bias_after_scale': bias_after_scale
        })
    return helper.append_activation(out)


def _logical_layer(op_type, binary=True):
    def func(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, **locals())
        if out is None:
            out = helper.create_variable_for_type_inference(dtype='bool')
        inputs = {'X': [x]}
        if binary:
            inputs['Y'] = [y]
        helper.append_op(type=op_type, inputs=inputs,
                         outputs={'Out': [out]})
        return out

    func.__name__ = op_type
    return func


logical_and = _logical_layer('logical_and')
logical_or = _logical_layer('logical_or')
logical_xor = _logical_layer('logical_xor')
logical_not = _logical_layer('logical_not', binary=False)


def cumsum(x, axis=None, exclusive=None, reverse=None):
    helper = LayerHelper('cumsum', **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    attrs = {}
    if axis is not None:
        attrs['axis'] = axis
    if exclusive is not None:
        attrs['exclusive'] = exclusive
    if reverse is not None:
        attrs['reverse'] = reverse
    helper.append_op(
        type='cumsum', inputs={'X': [x]}, outputs={'Out': [out]}, attrs=attrs)
    return out


def uniform_random(shape, dtype='float32', min=-1.0, max=1.0, seed=0):
    helper = LayerHelper('uniform_random', **locals())
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = tuple(shape)
    helper.append_op(
        type='uniform_random',
        outputs={'Out': [out]},
        attrs={
            'shape': list(shape),
            'dtype': out.dtype,
            'min': min,
            'max': max,
            'seed': seed
        })
    out.stop_gradient = True
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype='float32'):
    helper = LayerHelper('gaussian_random', **locals())
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = tuple(shape)
    helper.append_op(
        type='gaussian_random',
        outputs={'Out': [out]},
        attrs={
            'shape': list(shape),
            'dtype': out.dtype,
            'mean': mean,
            'std': std,
            'seed': seed
        })
    out.stop_gradient = True
    return out


def uniform_random_batch_size_like(input,
                                   shape,
                                   dtype='float32',
                                   input_dim_idx=0,
                                   output_dim_idx=0,
                                   min=-1.0,
                                   max=1.0,
                                   seed=0):
    helper = LayerHelper('uniform_random_batch_size_like', **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='uniform_random_batch_size_like',
        inputs={'Input': [input]},
        outputs={'Out': [out]},
        attrs={
            'shape': list(shape),
            'input_dim_idx': input_dim_idx,
            'output_dim_idx': output_dim_idx,
            'min': min,
            'max': max,
            'seed': seed,
            'dtype': out.dtype
        })
    out.stop_gradient = True
    return out


def gaussian_random_batch_size_like(input,
                                    shape,
                                    input_dim_idx=0,
                                    output_dim_idx=0,
                                    mean=0.0,
                                    std=1.0,
                                    seed=0,
                                    dtype='float32'):
    helper = LayerHelper('gaussian_random_batch_size_like', **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='gaussian_random_batch_size_like',
        inputs={'Input': [input]},
        outputs={'Out': [out]},
        attrs={
            'shape': list(shape),
            'input_dim_idx': input_dim_idx,
            'output_dim_idx': output_dim_idx,
            'mean': mean,
            'std': std,
            'seed': seed,
            'dtype': out.dtype
        })
    out.stop_gradient = True
    return out
