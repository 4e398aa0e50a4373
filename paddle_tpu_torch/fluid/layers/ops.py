"""Op wrapper layers (counterpart of ``paddle_tpu/fluid/layers/ops.py``:
``scale``, the ``elementwise_*`` builders, and the unary ``square`` and
``sqrt`` that gradient clipping builds with)."""

from ..layer_helper import LayerHelper

__all__ = [
    'square', 'sqrt', 'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'elementwise_max', 'elementwise_min',
    'elementwise_pow', 'scale',
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


square = _unary_layer('square')
sqrt = _unary_layer('sqrt')


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
