"""Neural-network layers (counterpart of ``paddle_tpu/fluid/layers/nn.py``,
the layers the Transformer, stacked-LSTM, dense CV and book-model slices
build with, and the common tensor, shape, reduce and loss layers).

Each layer appends OpDescs to the current program block; shapes are inferred
eagerly so later layers can read ``input.shape``.
"""

import builtins

from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import Constant, Normal
from ..param_attr import ParamAttr

__all__ = [
    'fc', 'embedding', 'layer_norm', 'dropout', 'softmax',
    'softmax_with_cross_entropy', 'cross_entropy', 'mean', 'reshape',
    'unsqueeze', 'flash_attention', 'reduce_sum', 'clip', 'clip_by_norm',
    'conv2d', 'pool2d', 'batch_norm', 'gather', 'topk', 'concat',
    'sigmoid_cross_entropy_with_logits', 'square_error_cost',
    'linear_chain_crf', 'crf_decoding', 'cos_sim',
    'autoincreased_step_counter', 'matmul', 'one_hot', 'expand', 'mul',
    'transpose', 'flatten', 'split', 'reduce_mean', 'reduce_max',
    'reduce_min', 'reduce_prod', 'l2_normalize', 'prelu', 'maxout', 'pad',
    'pad2d', 'stack', 'unstack', 'squeeze', 'scatter', 'slice', 'shape',
    'label_smooth', 'smooth_l1', 'log_loss', 'multiplex', 'random_crop',
    'crop', 'dice_loss', 'rank_loss',
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


def gather(input, index):
    """Rows of ``input`` at ``index``."""
    helper = LayerHelper('gather', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type='gather',
        inputs={'X': [input],
                'Index': [index]},
        outputs={'Out': [out]})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    """x @ y with optional transposes of the last two dims and a scale."""
    helper = LayerHelper('matmul', **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xs = list(x.shape)
    ys = list(y.shape)
    if transpose_x and len(xs) >= 2:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) >= 2:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) >= 2 and len(ys) >= 2:
        out.shape = tuple(xs[:-1]) + (ys[-1], )
    helper.append_op(
        type='matmul',
        inputs={'X': [x],
                'Y': [y]},
        outputs={'Out': [out]},
        attrs={
            'transpose_X': transpose_x,
            'transpose_Y': transpose_y,
            'alpha': float(alpha)
        })
    return out


def one_hot(input, depth):
    """float32 one-hot rows of ``depth`` columns (no gradient)."""
    helper = LayerHelper('one_hot', **locals())
    out = helper.create_variable_for_type_inference(dtype='float32')
    helper.append_op(
        type='one_hot',
        inputs={'X': [input]},
        outputs={'Out': [out]},
        attrs={'depth': depth})
    out.stop_gradient = True
    return out


def expand(x, expand_times, name=None):
    """x tiled ``expand_times[i]`` times along each dim i."""
    helper = LayerHelper('expand', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = tuple(
        s * t for s, t in zip(x.shape, expand_times))
    helper.append_op(
        type='expand',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'expand_times': list(expand_times)})
    return out


def topk(input, k, name=None):
    """The k largest values of the last dim and their indices."""
    helper = LayerHelper('top_k', **locals())
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(dtype='int64')
    values.shape = tuple(input.shape[:-1]) + (k, )
    indices.shape = values.shape
    helper.append_op(
        type='top_k',
        inputs={'X': [input]},
        outputs={'Out': [values],
                 'Indices': [indices]},
        attrs={'k': k})
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def flash_attention(q, k, v, num_heads=None, causal=False, scale=None,
                    impl='auto', sp_axis='sp', name=None):
    """Fused scaled-dot-product attention, one op (ops/attention_ops.py).

    q, k, v: [batch, seq, heads, head_dim] Variables, or
             [batch, seq, heads*head_dim] with num_heads given.
    impl: 'auto' | 'pallas' (the flash kernel where the shapes allow it) |
          'dense'; 'ring' and 'ulysses' (the 'sp' mesh axis) raise.
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


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, **locals())
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
        type=op_type,
        inputs={'X': [input]},
        outputs={'Out': [out]},
        attrs={
            'dim': dim if dim is not None else [0],
            'keep_dim': keep_dim,
            'reduce_all': dim is None
        })
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_sum', input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_mean', input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_max', input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_min', input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_prod', input, dim, keep_dim, name)


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


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _conv_out_size(i, k, p, s, d=1):
    return (i + 2 * p - (d * (k - 1) + 1)) // s + 1


def conv2d(input,
           num_filters,
           filter_size,
           stride=1,
           padding=0,
           dilation=1,
           groups=None,
           param_attr=None,
           bias_attr=None,
           use_cudnn=True,
           act=None,
           name=None):
    """2-D convolution over NCHW with an OIHW filter, Normal(0, sqrt(2 /
    (k^2 C))) by default.  groups == C == num_filters > 1 builds a
    ``depthwise_conv2d`` op.  ``use_cudnn`` is accepted and not read: the
    op carries ``use_cudnn: False`` as the JAX package's does, and the
    lowering is cuDNN's on the card all the same."""
    helper = LayerHelper('conv2d', **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    std = (2.0 / (filter_size[0]**2 * num_channels))**0.5
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=filter_shape,
        dtype=dtype,
        default_initializer=Normal(0.0, std, 0))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    n, c, h, w_ = input.shape
    pre_bias.shape = (n, num_filters,
                      _conv_out_size(h, filter_size[0], padding[0], stride[0],
                                     dilation[0]),
                      _conv_out_size(w_, filter_size[1], padding[1], stride[1],
                                     dilation[1]))
    op_type = 'depthwise_conv2d' if (groups == num_channels and
                                     num_channels == num_filters and
                                     groups > 1) else 'conv2d'
    helper.append_op(
        type=op_type,
        inputs={'Input': [input],
                'Filter': [w]},
        outputs={'Output': [pre_bias]},
        attrs={
            'strides': stride,
            'paddings': padding,
            'dilations': dilation,
            'groups': groups,
            'use_cudnn': False,
        })
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input,
           pool_size=-1,
           pool_type='max',
           pool_stride=1,
           pool_padding=0,
           global_pooling=False,
           use_cudnn=True,
           ceil_mode=False,
           name=None,
           exclusive=True):
    """2-D max or average pooling over NCHW."""
    helper = LayerHelper('pool2d', **locals())
    dtype = helper.input_dtype()
    pool_size = _pair(pool_size)
    pool_stride = _pair(pool_stride)
    pool_padding = _pair(pool_padding)
    out = helper.create_variable_for_type_inference(dtype)
    n, c, h, w = input.shape
    if global_pooling:
        out.shape = (n, c, 1, 1)
    else:
        out.shape = (n, c,
                     _conv_out_size(h, pool_size[0], pool_padding[0],
                                    pool_stride[0]),
                     _conv_out_size(w, pool_size[1], pool_padding[1],
                                    pool_stride[1]))
    helper.append_op(
        type='pool2d',
        inputs={'X': [input]},
        outputs={'Out': [out]},
        attrs={
            'pooling_type': pool_type,
            'ksize': pool_size,
            'global_pooling': global_pooling,
            'strides': pool_stride,
            'paddings': pool_padding,
            'ceil_mode': ceil_mode,
            'exclusive': exclusive,
        })
    return out


def batch_norm(input,
               act=None,
               is_test=False,
               momentum=0.9,
               epsilon=1e-05,
               param_attr=None,
               bias_attr=None,
               data_layout='NCHW',
               in_place=False,
               name=None,
               moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               fuse_with_relu=False,
               use_global_stats=None):
    """Batch normalization.  The moving mean and variance are non-trainable
    parameters that the op writes back (MeanOut, VarianceOut name the same
    vars).  ``use_global_stats``: None follows ``is_test`` (and
    clone(for_test)); an explicit True or False picks the moving or the
    batch statistics in both modes, and the attr is omitted for None."""
    helper = LayerHelper('batch_norm', **locals())
    dtype = helper.input_dtype()
    input_shape = input.shape
    if data_layout == 'NCHW':
        channel_num = input_shape[1]
    else:
        channel_num = input_shape[-1]
    param_shape = [channel_num]

    scale = helper.create_parameter(
        attr=helper.param_attr,
        shape=param_shape,
        dtype=dtype,
        default_initializer=Constant(1.0))
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True)

    mean = helper.create_parameter(
        attr=ParamAttr(
            name=moving_mean_name,
            initializer=Constant(0.0),
            trainable=False,
            do_model_average=do_model_average_for_mean_and_var),
        shape=param_shape,
        dtype=dtype)
    mean.stop_gradient = True
    variance = helper.create_parameter(
        attr=ParamAttr(
            name=moving_variance_name,
            initializer=Constant(1.0),
            trainable=False,
            do_model_average=do_model_average_for_mean_and_var),
        shape=param_shape,
        dtype=dtype)
    variance.stop_gradient = True

    saved_mean = helper.create_variable_for_type_inference(
        dtype=dtype, stop_gradient=True)
    saved_variance = helper.create_variable_for_type_inference(
        dtype=dtype, stop_gradient=True)
    batch_norm_out = input if in_place else \
        helper.create_variable_for_type_inference(dtype)
    batch_norm_out.shape = input.shape

    helper.append_op(
        type='batch_norm',
        inputs={
            'X': [input],
            'Scale': [scale],
            'Bias': [bias],
            'Mean': [mean],
            'Variance': [variance]
        },
        outputs={
            'Y': [batch_norm_out],
            'MeanOut': [mean],
            'VarianceOut': [variance],
            'SavedMean': [saved_mean],
            'SavedVariance': [saved_variance]
        },
        attrs={
            'momentum': momentum,
            'epsilon': epsilon,
            # is_test gates the running-statistics update only; which
            # statistics normalize is the lowering's reading of
            # use_global_stats and is_test
            'is_test': bool(is_test),
            'data_layout': data_layout,
            **({} if use_global_stats is None
               else {'use_global_stats': bool(use_global_stats)}),
        })
    return helper.append_activation(batch_norm_out)


def concat(input, axis=0, name=None):
    helper = LayerHelper('concat', **locals())
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    shapes = [list(i.shape) for i in input]
    if shapes and all(len(s) == len(shapes[0]) for s in shapes):
        out_shape = list(shapes[0])
        out_shape[axis] = sum(s[axis] for s in shapes)
        out.shape = tuple(out_shape)
    helper.append_op(
        type='concat',
        inputs={'X': input},
        outputs={'Out': [out]},
        attrs={'axis': axis})
    return out


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper('sigmoid_cross_entropy_with_logits', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type='sigmoid_cross_entropy_with_logits',
        inputs={'X': [x],
                'Label': [label]},
        outputs={'Out': [out]})
    return out


def square_error_cost(input, label):
    """(input - label)^2 (reference layers/nn.py square_error_cost)."""
    helper = LayerHelper('square_error_cost', **locals())
    minus_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    minus_out.shape = input.shape
    helper.append_op(
        type='elementwise_sub',
        inputs={'X': [input],
                'Y': [label]},
        outputs={'Out': [minus_out]})
    square_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    square_out.shape = input.shape
    helper.append_op(
        type='square',
        inputs={'X': [minus_out]},
        outputs={'Out': [square_out]})
    return square_out


def linear_chain_crf(input, label, param_attr=None):
    """Linear-chain CRF negative log-likelihood per sequence (reference
    layers/nn.py linear_chain_crf); creates the [size + 2, size] transition
    parameter (row 0 the start weights, row 1 the end weights)."""
    helper = LayerHelper('linear_chain_crf', **locals())
    size = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[size + 2, size], dtype='float32')
    alpha = helper.create_variable_for_type_inference('float32')
    emission_exps = helper.create_variable_for_type_inference('float32')
    transition_exps = helper.create_variable_for_type_inference('float32')
    log_likelihood = helper.create_variable_for_type_inference('float32')
    helper.append_op(
        type='linear_chain_crf',
        inputs={'Emission': [input],
                'Transition': [transition],
                'Label': [label]},
        outputs={
            'Alpha': [alpha],
            'EmissionExps': [emission_exps],
            'TransitionExps': [transition_exps],
            'LogLikelihood': [log_likelihood],
        })
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """Viterbi decode with the CRF transition parameter (reference
    layers/nn.py crf_decoding); with a label, the per-token correctness
    indicator instead.  In a program without the parameter (one built for
    decoding, its weights loaded later by name) the parameter is created
    zero-initialized, with a warning."""
    helper = LayerHelper('crf_decoding', **locals())
    try:
        transition = helper.get_parameter(param_attr.name)
    except ValueError:
        import warnings
        warnings.warn(
            "crf_decoding: transition parameter %r does not exist in this "
            "program; creating it zero-initialized (expecting "
            "load_persistables to fill it)" % param_attr.name)
        size = input.shape[-1]
        transition = helper.create_parameter(
            attr=helper.param_attr, shape=[size + 2, size],
            dtype='float32', default_initializer=Constant(0.0))
    viterbi_path = helper.create_variable_for_type_inference('int64')
    viterbi_path.lod_level = input.lod_level
    inputs = {'Emission': [input], 'Transition': [transition]}
    if label is not None:
        inputs['Label'] = [label]
    helper.append_op(
        type='crf_decoding',
        inputs=inputs,
        outputs={'ViterbiPath': [viterbi_path]})
    return viterbi_path


def cos_sim(X, Y):
    """Row-wise cosine similarity [B, 1] (reference layers/nn.py
    cos_sim)."""
    helper = LayerHelper('cos_sim', **locals())
    out = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype)
    ynorm = helper.create_variable_for_type_inference(X.dtype)
    out.shape = (X.shape[0], 1)
    helper.append_op(
        type='cos_sim',
        inputs={'X': [X],
                'Y': [Y]},
        outputs={'Out': [out],
                 'XNorm': [xnorm],
                 'YNorm': [ynorm]})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 [1] counter that one ``increment`` op, the first
    time the counter is asked for, advances by ``step`` at every run of
    the program; it reads ``begin`` at the first run.  The op writes the
    var it reads, so on the card each replay of the captured block
    advances the scope's counter."""
    helper = LayerHelper('global_step_counter')
    counter_name = counter_name or '@STEP_COUNTER@'
    counter = helper.create_or_get_global_variable(
        name=counter_name, dtype='int64', shape=[1], persistable=True)
    if counter.op is None:
        helper.set_variable_initializer(
            counter, initializer=Constant(value=begin - 1))
        counter.op = helper.append_op(
            type='increment',
            inputs={'X': [counter]},
            outputs={'Out': [counter]},
            attrs={'step': float(step)})
        counter.stop_gradient = True
    return counter


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper('mul', **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = tuple(x.shape[:x_num_col_dims]) + tuple(
        y.shape[y_num_col_dims:])
    helper.append_op(
        type='mul',
        inputs={'X': [x],
                'Y': [y]},
        outputs={'Out': [out]},
        attrs={
            'x_num_col_dims': x_num_col_dims,
            'y_num_col_dims': y_num_col_dims
        })
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper('transpose', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = tuple(x.shape[p] for p in perm) if x.shape else ()
    helper.append_op(
        type='transpose',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'axis': list(perm)})
    return out


def flatten(x, axis=1, name=None):
    """X as a matrix: the dims before ``axis`` times the rest, built as a
    ``reshape`` op."""
    helper = LayerHelper('flatten', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = (_prod(x.shape[:axis]), _prod(x.shape[axis:]))
    helper.append_op(
        type='reshape',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'shape': [int(s) for s in out.shape]})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper('split', **locals())
    input_shape = input.shape
    dim_ = dim if dim >= 0 else len(input_shape) + dim
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = [input_shape[dim_] // num] * num
    else:
        sections = list(num_or_sections)
    outs = []
    for sec in sections:
        o = helper.create_variable_for_type_inference(dtype=input.dtype)
        s = list(input_shape)
        s[dim_] = sec
        o.shape = tuple(s)
        outs.append(o)
    helper.append_op(
        type='split',
        inputs={'X': [input]},
        outputs={'Out': outs},
        attrs={
            'num': num_or_sections if isinstance(num_or_sections, int) else 0,
            'sections': sections,
            'axis': dim_
        })
    return outs


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """X over its 2-norm along ``axis``: a ``norm`` op."""
    helper = LayerHelper('l2_normalize', **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    norm = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type='norm',
        inputs={'X': [x]},
        outputs={'Out': [out],
                 'Norm': [norm]},
        attrs={'axis': 1 if axis is None else axis,
               'epsilon': epsilon})
    return out


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper('prelu', **locals())
    if mode not in ('all', 'channel', 'element'):
        raise ValueError("mode should be 'all', 'channel' or 'element'")
    alpha_shape = [1]
    if mode == 'channel':
        alpha_shape = [1, x.shape[1], 1, 1]
    elif mode == 'element':
        alpha_shape = list(x.shape)
    alpha = helper.create_parameter(
        attr=helper.param_attr,
        shape=alpha_shape,
        dtype='float32',
        is_bias=False,
        default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(
        type='prelu',
        inputs={'X': [x],
                'Alpha': [alpha]},
        outputs={'Out': [out]},
        attrs={'mode': mode})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper('maxout', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    n, c, h, w = x.shape
    out.shape = (n, c // groups, h, w)
    helper.append_op(
        type='maxout',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'groups': groups})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper('pad', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if getattr(x, 'shape', None):
        shape = list(x.shape)
        for i in range(min(len(shape), len(paddings) // 2)):
            if shape[i] is not None and int(shape[i]) >= 0:
                shape[i] = int(shape[i]) + paddings[2 * i] + \
                    paddings[2 * i + 1]
        out.shape = tuple(shape)
    helper.append_op(
        type='pad',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'paddings': list(paddings),
               'pad_value': float(pad_value)})
    return out


def pad2d(input,
          paddings=(0, 0, 0, 0),
          mode='constant',
          pad_value=0.0,
          data_format='NCHW',
          name=None):
    helper = LayerHelper('pad2d', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type='pad2d',
        inputs={'X': [input]},
        outputs={'Out': [out]},
        attrs={
            'paddings': list(paddings),
            'mode': mode,
            'pad_value': float(pad_value)
        })
    return out


def stack(x, axis=0):
    helper = LayerHelper('stack', **locals())
    if isinstance(x, Variable):
        x = [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(
        type='stack',
        inputs={'X': x},
        outputs={'Y': [out]},
        attrs={'axis': axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper('unstack', **locals())
    if num is None:
        num = x.shape[axis]
    outs = [
        helper.create_variable_for_type_inference(x.dtype) for _ in range(num)
    ]
    helper.append_op(
        type='unstack',
        inputs={'X': [x]},
        outputs={'Y': outs},
        attrs={'axis': axis,
               'num': num})
    return outs


def squeeze(input, axes, name=None):
    helper = LayerHelper('squeeze', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type='squeeze',
        inputs={'X': [input]},
        outputs={'Out': [out]},
        attrs={'axes': list(axes)})
    return out


def scatter(input, index, updates, name=None):
    helper = LayerHelper('scatter', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type='scatter',
        inputs={'X': [input],
                'Ids': [index],
                'Updates': [updates]},
        outputs={'Out': [out]})
    return out


def slice(input, axes, starts, ends):
    """Python slicing of ``input`` along ``axes``.  Its shape is inferred
    by the runtime's rules (negative indices count from the end, an end of
    2**31 - 1 or more is open); a dim of unknown size stays unknown."""
    helper = LayerHelper('slice', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    if getattr(input, 'shape', None):
        int_max = 2**31 - 1
        shape = list(input.shape)
        for ax, s, e in zip(axes, starts, ends):
            if not (0 <= ax < len(shape)):
                continue
            dim = shape[ax]
            if dim is None or int(dim) < 0:
                continue
            shape[ax] = len(range(int(dim))[builtins.slice(
                None if s <= -int_max else s,
                None if e >= int_max else e)])
        out.shape = tuple(shape)
    helper.append_op(
        type='slice',
        inputs={'Input': [input]},
        outputs={'Out': [out]},
        attrs={
            'axes': list(axes),
            'starts': list(starts),
            'ends': list(ends)
        })
    return out


def shape(input):
    helper = LayerHelper('shape', **locals())
    out = helper.create_variable_for_type_inference(dtype='int32')
    helper.append_op(
        type='shape', inputs={'Input': [input]}, outputs={'Out': [out]})
    return out


def label_smooth(label,
                 prior_dist=None,
                 epsilon=0.1,
                 dtype='float32',
                 name=None):
    helper = LayerHelper('label_smooth', **locals())
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {'X': [label]}
    if prior_dist is not None:
        inputs['PriorDist'] = [prior_dist]
    helper.append_op(
        type='label_smooth',
        inputs=inputs,
        outputs={'Out': [out]},
        attrs={'epsilon': float(epsilon)})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper('smooth_l1_loss', **locals())
    diff = helper.create_variable_for_type_inference(dtype=x.dtype)
    loss = helper.create_variable_for_type_inference(dtype=x.dtype)
    inputs = {'X': [x], 'Y': [y]}
    if inside_weight is not None:
        inputs['InsideWeight'] = [inside_weight]
    if outside_weight is not None:
        inputs['OutsideWeight'] = [outside_weight]
    helper.append_op(
        type='smooth_l1_loss',
        inputs=inputs,
        outputs={'Diff': [diff],
                 'Out': [loss]},
        attrs={'sigma': sigma if sigma is not None else 1.0})
    return loss


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper('log_loss', **locals())
    loss = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type='log_loss',
        inputs={'Predicted': [input],
                'Labels': [label]},
        outputs={'Loss': [loss]},
        attrs={'epsilon': epsilon})
    return loss


def multiplex(inputs, index):
    helper = LayerHelper('multiplex', **locals())
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(
        type='multiplex',
        inputs={'X': inputs,
                'Ids': [index]},
        outputs={'Out': [out]})
    return out


def random_crop(x, shape, seed=None):
    helper = LayerHelper('random_crop', **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type='random_crop',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'shape': list(shape)})
    return out


def crop(x, shape=None, offsets=None, name=None):
    """``x`` cropped to ``shape`` from ``offsets`` (0 by default); ``shape``
    is a list of dims or a Variable whose shape is the target."""
    helper = LayerHelper('crop', **locals())
    inputs = {'X': [x]}
    attrs = {}
    if shape is None:
        raise ValueError('crop: shape is required: a list of output dims or '
                         'a Variable whose shape is the target')
    if isinstance(shape, Variable):
        inputs['Y'] = [shape]
        out_shape = shape.shape
    else:
        attrs['shape'] = list(shape)
        out_shape = tuple(shape)
    if offsets is None:
        offsets = [0] * len(x.shape)
    attrs['offsets'] = list(offsets)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = tuple(out_shape)
    helper.append_op(
        type='crop', inputs=inputs, outputs={'Out': [out]}, attrs=attrs)
    return out


def dice_loss(input, label, epsilon=0.00001):
    """Dice loss for segmentation: one-hot labels, each sample's
    intersection and areas summed over every non-batch dim, 1 - 2 I / (A +
    epsilon), averaged over the batch."""
    label = one_hot(label, depth=input.shape[-1])
    reduce_dim = list(range(1, len(input.shape)))
    inse = reduce_sum(input * label, dim=reduce_dim)
    dice_denominator = reduce_sum(input, dim=reduce_dim) + reduce_sum(
        label, dim=reduce_dim)
    dice_score = 1 - inse * 2 / (dice_denominator + epsilon)
    return reduce_mean(dice_score)


def rank_loss(label, left, right, name=None):
    """RankNet's pairwise loss of ``left`` over ``right`` given ``label``."""
    helper = LayerHelper('rank_loss', **locals())
    for v, n in ((label, 'label'), (left, 'left'), (right, 'right')):
        if not isinstance(v, Variable):
            raise ValueError('rank_loss: %s must be a Variable' % n)
    out = helper.create_variable_for_type_inference('float32')
    out.shape = tuple(left.shape)
    helper.append_op(
        type='rank_loss',
        inputs={'Label': [label],
                'Left': [left],
                'Right': [right]},
        outputs={'Out': [out]})
    return out
