"""InferenceTranspiler (counterpart of
``paddle_tpu/fluid/transpiler/inference_transpiler.py``).

Folds each batch_norm into the conv2d (or depthwise_conv2d) before it, with
or without a bias add between them: the filter becomes w * gamma / sqrt(var
+ eps), a conv bias b becomes b * gamma / sqrt(var + eps), and the
batch_norm op an ``elementwise_add`` of beta - mean * gamma / sqrt(var +
eps), written into BN's Bias var.  The folded values are computed in f64
from the scope's tensors, on their device, and stored in each parameter's
dtype.
"""

import torch

from .. import core
from ..executor import global_scope

__all__ = ['InferenceTranspiler']


def _scope_tensor(scope, name):
    var = scope.find_var(name)
    value = None if var is None else var.value()
    return value.tensor() if isinstance(value, core.LoDTensor) else value


class InferenceTranspiler(object):
    def transpile(self, program, place=None, scope=None):
        if scope is None:
            scope = global_scope()
        self._fuse_batch_norm(program, scope)
        return program

    def _fuse_batch_norm(self, program, scope):
        """conv2d [+ elementwise_add of a bias] + batch_norm, folded."""
        block = program.global_block()
        i = 0
        while i < len(block.ops) - 1:
            conv_op = block.ops[i]
            if conv_op.type not in ('conv2d', 'depthwise_conv2d'):
                i += 1
                continue
            j = i + 1
            bias_add = None
            if block.ops[j].type == 'elementwise_add' and \
                    block.ops[j].input('X') == conv_op.output('Output') and \
                    j + 1 < len(block.ops):
                bias_add = block.ops[j]
                j += 1
            bn = block.ops[j]
            prev_out = (bias_add.output('Out') if bias_add is not None
                        else conv_op.output('Output'))
            if bn.type != 'batch_norm' or bn.input('X') != prev_out:
                i += 1
                continue
            stats = [_scope_tensor(scope, bn.input(s)[0])
                     for s in ('Scale', 'Bias', 'Mean', 'Variance')]
            w_name = conv_op.input('Filter')[0]
            w = _scope_tensor(scope, w_name)
            b_name = bias_add.input('Y')[0] if bias_add is not None else None
            b = _scope_tensor(scope, b_name) if b_name is not None else None
            if any(v is None for v in stats + [w]) or (
                    bias_add is not None and
                    (b is None or b.numel() != w.shape[0])):
                # no statistics in the scope, or a bias add that is a
                # residual connection rather than the conv's bias
                i += 1
                continue
            scale, bias, mean, var = (v.double() for v in stats)
            eps = bn.attrs.get('epsilon', 1e-5)
            factor = scale / torch.sqrt(var + eps)
            scope.var(w_name).set_value(
                (w.double() * factor[:, None, None, None]).to(w.dtype))
            if b is not None:
                scope.var(b_name).set_value(
                    (b.double() * factor.reshape(b.shape)).to(b.dtype))
            bias_name = bn.input('Bias')[0]
            scope.var(bias_name).set_value(
                (bias - mean * factor).to(stats[1].dtype))
            block.ops[j] = type(bn)(
                block, 'elementwise_add',
                inputs={'X': prev_out, 'Y': [bias_name]},
                outputs={'Out': bn.output('Y')},
                attrs={'axis': 1})
            program._bump_version()
            i += 1
