"""Neural-network layers (counterpart of ``paddle_tpu/fluid/layers/nn.py``,
the layers the Transformer and stacked-LSTM slices build with).

Each layer appends OpDescs to the current program block; shapes are inferred
eagerly so later layers can read ``input.shape``.
"""

from ..layer_helper import LayerHelper
from ..initializer import Constant

__all__ = [
    'fc', 'embedding', 'layer_norm', 'dropout', 'softmax',
    'softmax_with_cross_entropy', 'cross_entropy', 'mean', 'reshape',
    'unsqueeze', 'flash_attention', 'reduce_sum', 'clip', 'clip_by_norm',
]


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def fc(input,
       size,
       num_flatten_dims=1,
       param_attr=None,
       bias_attr=None,
       act=None,
       is_test=False,
       name=None):
    """Fully-connected layer: one mul per input, a sum op over several
    inputs, then elementwise_add + activation."""
    helper = LayerHelper('fc', **locals())
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, param_attr in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        param_shape = [_prod(input_shape[num_flatten_dims:])] + [size]
        w = helper.create_parameter(
            attr=param_attr, shape=param_shape, dtype=dtype, is_bias=False)
        tmp = helper.create_variable_for_type_inference(dtype)
        tmp.shape = tuple(input_shape[:num_flatten_dims]) + (size, )
        helper.append_op(
            type='mul',
            inputs={'X': [input_var],
                    'Y': [w]},
            outputs={'Out': [tmp]},
            attrs={
                'x_num_col_dims': num_flatten_dims,
                'y_num_col_dims': 1
            })
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        pre_bias.shape = mul_results[0].shape
        helper.append_op(
            type='sum',
            inputs={'X': mul_results},
            outputs={'Out': pre_bias})
    pre_activation = helper.append_bias_op(pre_bias,
                                           dim_start=num_flatten_dims)
    return helper.append_activation(pre_activation)


def embedding(input,
              size,
              is_sparse=False,
              is_distributed=False,
              padding_idx=None,
              param_attr=None,
              dtype='float32'):
    """Lookup-table layer: a dense gather from a [vocab, dim] parameter."""
    helper = LayerHelper('embedding', **locals())
    w = helper.create_parameter(
        attr=helper.param_attr, shape=size, dtype=dtype, is_bias=False)
    tmp = helper.create_variable_for_type_inference(dtype)
    in_shape = tuple(input.shape)
    if in_shape and in_shape[-1] == 1:
        tmp.shape = in_shape[:-1] + (size[1], )
    else:
        tmp.shape = in_shape + (size[1], )
    tmp.lod_level = input.lod_level
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        type='lookup_table',
        inputs={'Ids': [input],
                'W': [w]},
        outputs={'Out': [tmp]},
        attrs={
            'is_sparse': is_sparse,
            'is_distributed': is_distributed,
            'padding_idx': padding_idx
        })
    return tmp


def layer_norm(input,
               scale=True,
               shift=True,
               begin_norm_axis=1,
               epsilon=1e-05,
               param_attr=None,
               bias_attr=None,
               act=None,
               name=None):
    helper = LayerHelper('layer_norm', **locals())
    dtype = helper.input_dtype()
    param_shape = [_prod(input.shape[begin_norm_axis:])]
    inputs = {'X': [input]}
    if scale:
        inputs['Scale'] = [helper.create_parameter(
            attr=helper.param_attr,
            shape=param_shape,
            dtype=dtype,
            default_initializer=Constant(1.0))]
    if shift:
        inputs['Bias'] = [helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype,
            is_bias=True)]
    mean_out = helper.create_variable_for_type_inference(
        dtype=dtype, stop_gradient=True)
    variance_out = helper.create_variable_for_type_inference(
        dtype=dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(
        type='layer_norm',
        inputs=inputs,
        outputs={
            'Y': [out],
            'Mean': [mean_out],
            'Variance': [variance_out]
        },
        attrs={'epsilon': epsilon,
               'begin_norm_axis': begin_norm_axis})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    helper = LayerHelper('dropout', **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    mask = helper.create_variable_for_type_inference(
        dtype=x.dtype, stop_gradient=True)
    helper.append_op(
        type='dropout',
        inputs={'X': [x]},
        outputs={'Out': [out],
                 'Mask': [mask]},
        attrs={
            'dropout_prob': dropout_prob,
            'is_test': is_test,
            'seed': seed if seed is not None else 0,
        })
    return out


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper('softmax', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type='softmax',
        inputs={'X': [input]},
        outputs={'Out': [out]})
    return out


def softmax_with_cross_entropy(logits,
                               label,
                               soft_label=False,
                               ignore_index=-100):
    helper = LayerHelper('softmax_with_cross_entropy', **locals())
    softmax = helper.create_variable_for_type_inference(dtype=logits.dtype)
    softmax.shape = logits.shape
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    loss.shape = tuple(logits.shape[:-1]) + (1, )
    helper.append_op(
        type='softmax_with_cross_entropy',
        inputs={'Logits': [logits],
                'Label': [label]},
        outputs={'Softmax': [softmax],
                 'Loss': [loss]},
        attrs={'soft_label': soft_label,
               'ignore_index': ignore_index})
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """-log of ``input``'s probability of ``label`` per row (or the soft
    labels' cross entropy): [N..., 1]."""
    helper = LayerHelper('cross_entropy', **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    out.shape = tuple(input.shape[:-1]) + (1, )
    helper.append_op(
        type='cross_entropy',
        inputs={'X': [input],
                'Label': [label]},
        outputs={'Y': [out]},
        attrs={'soft_label': soft_label,
               'ignore_index': ignore_index})
    return out


def mean(x, name=None):
    helper = LayerHelper('mean', **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = (1, )
    helper.append_op(type='mean', inputs={'X': [x]}, outputs={'Out': [out]})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper('reshape', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    total = _prod(x.shape) if all(s >= 0 for s in x.shape) else None
    # resolve 0 (copy input dim) first so -1 inference sees them
    resolved = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    known = _prod([s for s in resolved if s > 0])
    out.shape = tuple(
        (total // max(known, 1)) if (s == -1 and total is not None) else s
        for s in resolved)
    inputs = {'X': [x]}
    if actual_shape is not None:
        inputs['Shape'] = [actual_shape]
    helper.append_op(
        type='reshape',
        inputs=inputs,
        outputs={'Out': [out]},
        attrs={'shape': list(shape)})
    return helper.append_activation(out)


def unsqueeze(input, axes, name=None):
    helper = LayerHelper('unsqueeze', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type='unsqueeze',
        inputs={'X': [input]},
        outputs={'Out': [out]},
        attrs={'axes': list(axes)})
    return out


def flash_attention(q, k, v, num_heads=None, causal=False, scale=None,
                    impl='auto', sp_axis='sp', name=None):
    """Fused scaled-dot-product attention, one op (ops/attention_ops.py).

    q, k, v: [batch, seq, heads, head_dim] Variables, or
             [batch, seq, heads*head_dim] with num_heads given.
    impl: 'auto' | 'pallas' (the flash kernel where the shapes allow it) |
          'dense'; 'ring' and 'ulysses' wait for the parallel slice.
    Returns a Variable with q's shape.
    """
    helper = LayerHelper('flash_attention', **locals())
    squeeze_back = False
    if len(q.shape) == 3:
        if not num_heads:
            raise ValueError('3-D q/k/v need num_heads to split the fused '
                             'head dim')
        squeeze_back = True
        q = reshape(q, [0, 0, num_heads, q.shape[-1] // num_heads])
        k = reshape(k, [0, 0, num_heads, k.shape[-1] // num_heads])
        v = reshape(v, [0, 0, num_heads, v.shape[-1] // num_heads])
    out = helper.create_variable_for_type_inference(q.dtype)
    # attention output carries V's head_dim (may differ from Q's)
    out.shape = tuple(q.shape[:-1]) + (v.shape[-1], )
    helper.append_op(
        type='flash_attention',
        inputs={'Q': [q], 'K': [k], 'V': [v]},
        outputs={'Out': [out]},
        attrs={
            'causal': bool(causal),
            'scale': float(scale) if scale else -1.0,
            'impl': impl,
            'sp_axis': sp_axis,
        })
    if squeeze_back:
        out = reshape(out, [0, 0, int(num_heads) * int(v.shape[-1])])
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper('reduce_sum', **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    shape = list(input.shape)
    if dim is None or not shape:
        out.shape = (1, )
    else:
        dims = sorted(d % len(shape) for d in dim)
        if keep_dim:
            for d in dims:
                shape[d] = 1
            out.shape = tuple(shape)
        else:
            out.shape = tuple(s for i, s in enumerate(shape)
                              if i not in dims) or (1, )
    helper.append_op(
        type='reduce_sum',
        inputs={'X': [input]},
        outputs={'Out': [out]},
        attrs={
            'dim': dim if dim is not None else [0],
            'keep_dim': keep_dim,
            'reduce_all': dim is None
        })
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper('clip', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type='clip',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'min': min,
               'max': max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper('clip_by_norm', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type='clip_by_norm',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'max_norm': max_norm})
    return out
