"""Operator overloads on ``Variable`` (counterpart of
``paddle_tpu/fluid/layers/math_op_patch.py``): ``+ - * / **``, the
comparisons and negation append the ops the JAX package appends (a Python
scalar operand becomes a ``scale`` op, or a ``fill_constant`` where scale
cannot express it), so a program built with them is the same under both
packages.  ``layers/__init__`` applies the patch at import."""

from .. import core
from .. import unique_name
from ..framework import Variable

__all__ = ['monkey_patch_variable']

_CMP_OPS = ('less_than', 'less_equal', 'greater_than', 'greater_equal',
            'equal', 'not_equal')

# the scale attrs of ``var <op> scalar``
_SCALAR_ATTRS = {
    'add': lambda v: {'scale': 1.0, 'bias': float(v)},
    'radd': lambda v: {'scale': 1.0, 'bias': float(v)},
    'sub': lambda v: {'scale': 1.0, 'bias': -float(v)},
    'rsub': lambda v: {'scale': -1.0, 'bias': float(v)},
    'mul': lambda v: {'scale': float(v), 'bias': 0.0},
    'div': lambda v: {'scale': 1.0 / float(v), 'bias': 0.0},
}


def monkey_patch_variable():
    def current_block(var):
        return var.block.program.current_block()

    def create_new_tmp_var(block, dtype):
        return block.create_var(name=unique_name.generate('tmp'),
                                dtype=dtype, persistable=False)

    def create_scalar_op(var, value, op):
        block = current_block(var)
        out = create_new_tmp_var(block, var.dtype)
        out.shape = var.shape
        block.append_op(type='scale', inputs={'X': [var]},
                        outputs={'Out': [out]},
                        attrs=_SCALAR_ATTRS[op](value))
        return out

    def binary(op_type, reverse=False):
        def impl(self, other):
            if isinstance(other, (int, float)):
                simple = {
                    'elementwise_add': 'radd' if reverse else 'add',
                    'elementwise_sub': 'rsub' if reverse else 'sub',
                    'elementwise_mul': 'mul',
                }
                if op_type in simple:
                    return create_scalar_op(self, other, simple[op_type])
                if op_type == 'elementwise_div' and not reverse:
                    return create_scalar_op(self, other, 'div')
                # otherwise the scalar becomes a [1] tensor
                block = current_block(self)
                const = create_new_tmp_var(block, self.dtype)
                const.shape = (1, )
                block.append_op(
                    type='fill_constant', outputs={'Out': [const]},
                    attrs={'shape': [1], 'dtype': const.dtype,
                           'value': float(other)})
                other = const
            block = current_block(self)
            lhs, rhs = (other, self) if reverse else (self, other)
            out = create_new_tmp_var(
                block, lhs.dtype if op_type not in _CMP_OPS else
                core.VarDesc.VarType.BOOL)
            out.shape = lhs.shape
            block.append_op(
                type=op_type, inputs={'X': [lhs], 'Y': [rhs]},
                outputs={'Out': [out]},
                attrs={'axis': -1} if op_type.startswith('elementwise')
                else {})
            return out

        return impl

    def neg(self):
        return create_scalar_op(self, 0.0, 'rsub')

    Variable.__add__ = binary('elementwise_add')
    Variable.__radd__ = binary('elementwise_add', reverse=True)
    Variable.__sub__ = binary('elementwise_sub')
    Variable.__rsub__ = binary('elementwise_sub', reverse=True)
    Variable.__mul__ = binary('elementwise_mul')
    Variable.__rmul__ = binary('elementwise_mul', reverse=True)
    Variable.__div__ = binary('elementwise_div')
    Variable.__truediv__ = binary('elementwise_div')
    Variable.__rdiv__ = binary('elementwise_div', reverse=True)
    Variable.__rtruediv__ = binary('elementwise_div', reverse=True)
    Variable.__pow__ = binary('elementwise_pow')
    Variable.__lt__ = binary('less_than')
    Variable.__le__ = binary('less_equal')
    Variable.__gt__ = binary('greater_than')
    Variable.__ge__ = binary('greater_equal')
    Variable.__neg__ = neg


monkey_patch_variable()
