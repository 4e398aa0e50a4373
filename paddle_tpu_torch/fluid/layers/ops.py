"""Op wrapper layers (counterpart of ``paddle_tpu/fluid/layers/ops.py``:
the unary activation layers of ``__activations__``, ``scale``, the
``elementwise_*`` layers and the ``logical_*`` layers)."""

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
    'logical_not',
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
