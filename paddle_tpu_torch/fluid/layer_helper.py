"""LayerHelper: shared plumbing for layer functions (counterpart of
``paddle_tpu/fluid/layer_helper.py``; parameter names come out identical)."""

import copy

from . import core
from . import unique_name
from .framework import Variable, Parameter, default_main_program, \
    default_startup_program
from .param_attr import ParamAttr
from .initializer import Constant, Xavier

__all__ = ['LayerHelper']


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get('name')
        if name is None:
            self.kwargs['name'] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs['name']

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def multiple_input(self, input_param_name='input'):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            return [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get('param_attr'))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get('bias_attr'))

    def multiple_param_attr(self, length):
        param_attr = self.param_attr
        if param_attr is False:
            # param_attr=False: parameter exists but is frozen
            param_attr = ParamAttr(trainable=False)
        if isinstance(param_attr, ParamAttr):
            param_attr = [param_attr]
        if len(param_attr) != 1 and len(param_attr) != length:
            raise ValueError('parameter number mismatch')
        elif len(param_attr) == 1 and length != 1:
            param_attr = param_attr + [
                copy.deepcopy(param_attr[0]) for _ in range(length - 1)
            ]
        return param_attr

    def iter_inputs_and_params(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        param_attrs = self.multiple_param_attr(len(inputs))
        for ipt, param_attr in zip(inputs, param_attrs):
            yield ipt, param_attr

    def input_dtype(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for ipt in inputs:
            if dtype is None:
                dtype = ipt.dtype
            elif dtype != ipt.dtype:
                raise ValueError('Data Type mismatch: %d to %d' %
                                 (dtype, ipt.dtype))
        return dtype

    def create_parameter(self,
                         attr,
                         shape,
                         dtype,
                         is_bias=False,
                         default_initializer=None):
        """Create a Parameter in the main program and its init op in the
        startup program."""
        if attr is False:
            attr = ParamAttr(trainable=False)
        attr = copy.deepcopy(attr) if attr is not None else ParamAttr()
        # explicit shared name: reuse the existing parameter
        if attr.name is not None and \
                self.main_program.global_block().has_var(attr.name):
            existing = self.main_program.global_block().var(attr.name)
            if isinstance(existing, Parameter):
                if tuple(existing.shape) != tuple(shape):
                    raise ValueError(
                        'shared parameter %r shape mismatch: %s vs %s' %
                        (attr.name, existing.shape, shape))
                if core.convert_np_dtype_to_dtype_(existing.dtype) != \
                        core.convert_np_dtype_to_dtype_(dtype):
                    raise ValueError(
                        'shared parameter %r dtype mismatch: %s vs %s' %
                        (attr.name, existing.dtype, dtype))
                return existing
        if default_initializer is None:
            if is_bias:
                attr._set_default_bias_initializer()
            else:
                attr._set_default_param_initializer()
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate('.'.join(
                [self.name, 'w' if not is_bias else 'b']))

        startup_block = self.startup_program.global_block()
        startup_param = startup_block.create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs())
        if attr.initializer is not None:
            attr.initializer(startup_param, startup_block)
        elif is_bias:
            Constant(0.0)(startup_param, startup_block)
        else:
            Xavier()(startup_param, startup_block)
        return self.main_program.global_block().create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs())

    def get_parameter(self, name):
        param = self.main_program.global_block().var(name)
        if not isinstance(param, Parameter):
            raise ValueError('no Parameter named %s' % name)
        return param

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate('.'.join([self.name, 'tmp'])),
            dtype=dtype,
            persistable=False,
            stop_gradient=stop_gradient)

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def create_or_get_global_variable(self, name, *args, **kwargs):
        block = self.main_program.global_block()
        if not block.has_var(name):
            return self.create_global_variable(name=name, *args, **kwargs)
        return block.var(name)

    def set_variable_initializer(self, var, initializer):
        startup_block = self.startup_program.global_block()
        sv = startup_block.create_var(
            name=var.name,
            shape=var.shape,
            dtype=var.dtype,
            persistable=True)
        initializer(sv, startup_block)
        return var

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(
            attr=bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        tmp.shape = input_var.shape
        self.append_op(
            type='elementwise_add',
            inputs={'X': [input_var],
                    'Y': [b]},
            outputs={'Out': [tmp]},
            attrs={'axis': dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get('act')
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {'type': act}
        else:
            act = copy.deepcopy(act)
        act_type = act.pop('type')
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        tmp.shape = input_var.shape
        self.append_op(
            type=act_type,
            inputs={'X': [input_var]},
            outputs={'Out': [tmp]},
            attrs=act)
        return tmp
