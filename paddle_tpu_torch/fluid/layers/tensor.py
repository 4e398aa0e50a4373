"""Tensor layers (counterpart of ``paddle_tpu/fluid/layers/tensor.py``; its
``load`` layer waits for the ``load`` host op)."""

import numpy as np

from .. import core
from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ['assign', 'fill_constant', 'fill_constant_batch_size_like',
           'create_global_var', 'sums', 'cast', 'concat', 'create_array',
           'zeros', 'ones', 'create_tensor', 'create_parameter', 'sum',
           'argmin', 'argmax', 'argsort', 'reverse']


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper('create_tensor', **locals())
    return helper.create_variable(
        name=helper.name, dtype=dtype, persistable=persistable)


def create_parameter(shape,
                     dtype,
                     name=None,
                     attr=None,
                     is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr
    helper = LayerHelper('create_parameter', **locals())
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape,
                      value,
                      dtype,
                      persistable=False,
                      force_cpu=False,
                      name=None):
    helper = LayerHelper('global_var', **locals())
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=name)
    helper.set_variable_initializer(
        var, initializer=Constant(value=float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper('cast', **locals())
    out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = x.shape
    helper.append_op(
        type='cast',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'in_dtype': x.dtype,
               'out_dtype': out.dtype})
    return out


def concat(input, axis=0, name=None):
    """``layers.nn.concat``; ``fluid.layers.concat`` resolves here, as in
    the JAX package (``layers/__init__`` star-imports ``tensor`` after
    ``nn``)."""
    from . import nn
    return nn.concat(input, axis, name)


def sums(input, out=None):
    helper = LayerHelper('sum', **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=helper.input_dtype())
        out.shape = input[0].shape
    helper.append_op(
        type='sum',
        inputs={'X': input},
        outputs={'Out': [out]})
    return out


def sum(x):
    """The elementwise sum of a list of tensors (a ``sum`` op)."""
    if isinstance(x, Variable):
        x = [x]
    return sums(list(x))


def assign(input, output=None):
    helper = LayerHelper('assign', **locals())
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype)
            output.shape = input.shape
        helper.append_op(
            type='assign', inputs={'X': [input]},
            outputs={'Out': [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=core.convert_np_dtype_to_dtype_(input.dtype))
            output.shape = input.shape
        helper.append_op(
            type='assign_value',
            outputs={'Out': [output]},
            attrs={
                'shape': list(input.shape),
                'dtype': output.dtype,
                'values': input
            })
    else:
        raise ValueError('assign expects Variable or numpy.ndarray')
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper('fill_constant', **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = tuple(shape)
    helper.append_op(
        type='fill_constant',
        inputs={},
        outputs={'Out': [out]},
        attrs={
            'shape': list(shape),
            'dtype': out.dtype,
            'value': float(value),
            'force_cpu': force_cpu
        })
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input,
                                  shape,
                                  dtype,
                                  value,
                                  input_dim_idx=0,
                                  output_dim_idx=0):
    """A constant of ``shape`` whose dim ``output_dim_idx`` is taken at run
    time from ``input``'s dim ``input_dim_idx`` (the batch)."""
    helper = LayerHelper('fill_constant_batch_size_like', **locals())
    out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = tuple(shape)
    helper.append_op(
        type='fill_constant_batch_size_like',
        inputs={'Input': [input]},
        outputs={'Out': [out]},
        attrs={
            'shape': list(shape),
            'dtype': out.dtype,
            'value': float(value),
            'input_dim_idx': input_dim_idx,
            'output_dim_idx': output_dim_idx
        })
    out.stop_gradient = True
    return out


def create_array(dtype):
    """An empty tensor array (a LOD_TENSOR_ARRAY var) for array_write and
    array_read."""
    helper = LayerHelper('create_array')
    return helper.create_variable(
        name='{0}.out'.format(helper.name),
        type=core.VarDesc.VarType.LOD_TENSOR_ARRAY,
        dtype=dtype)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(value=1.0, shape=shape, dtype=dtype)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(value=0.0, shape=shape, dtype=dtype)


def argmin(x, axis=0):
    helper = LayerHelper('argmin', **locals())
    out = helper.create_variable_for_type_inference('int64')
    helper.append_op(
        type='argmin',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'axis': axis})
    return out


def argmax(x, axis=0):
    helper = LayerHelper('argmax', **locals())
    out = helper.create_variable_for_type_inference('int64')
    helper.append_op(
        type='argmax',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'axis': axis})
    return out


def argsort(input, axis=-1, name=None):
    """(the values sorted along ``axis``, their indices)."""
    helper = LayerHelper('argsort', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference('int64')
    helper.append_op(
        type='argsort',
        inputs={'X': [input]},
        outputs={'Out': [out],
                 'Indices': [ids]},
        attrs={'axis': axis})
    return out, ids


def reverse(x, axis):
    helper = LayerHelper('reverse', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type='reverse',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'axis': axis if isinstance(axis, (list, tuple)) else [axis]})
    return out
