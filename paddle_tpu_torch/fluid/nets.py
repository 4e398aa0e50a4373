"""Composite networks (counterpart of ``paddle_tpu/fluid/nets.py``: the
image blocks ``simple_img_conv_pool`` and ``img_conv_group``,
``sequence_conv_pool``, ``glu`` and multi-head
``scaled_dot_product_attention`` in plain layers)."""

from . import layers

__all__ = ['simple_img_conv_pool', 'sequence_conv_pool', 'glu',
           'scaled_dot_product_attention', 'img_conv_group']


def simple_img_conv_pool(input,
                         num_filters,
                         filter_size,
                         pool_size,
                         pool_stride,
                         act,
                         param_attr=None,
                         pool_type='max',
                         use_cudnn=True):
    conv_out = layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        param_attr=param_attr,
        act=act,
        use_cudnn=use_cudnn)
    pool_out = layers.pool2d(
        input=conv_out,
        pool_size=pool_size,
        pool_type=pool_type,
        pool_stride=pool_stride,
        use_cudnn=use_cudnn)
    return pool_out


def img_conv_group(input,
                   conv_num_filter,
                   pool_size,
                   conv_padding=1,
                   conv_filter_size=3,
                   conv_act=None,
                   param_attr=None,
                   conv_with_batchnorm=False,
                   conv_batchnorm_drop_rate=0.0,
                   pool_stride=1,
                   pool_type='max',
                   use_cudnn=True):
    """Convolutions (each optionally batch-normed, then dropped out at its
    rate) and one pool; per-conv arguments may be scalars or lists."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def __extend_list__(obj):
        if not hasattr(obj, '__len__'):
            return [obj] * len(conv_num_filter)
        return list(obj)

    conv_padding = __extend_list__(conv_padding)
    conv_filter_size = __extend_list__(conv_filter_size)
    param_attr = __extend_list__(param_attr)
    conv_with_batchnorm = __extend_list__(conv_with_batchnorm)
    conv_batchnorm_drop_rate = __extend_list__(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(
            input=tmp,
            num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i],
            padding=conv_padding[i],
            param_attr=param_attr[i],
            act=local_conv_act,
            use_cudnn=use_cudnn)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    pool_out = layers.pool2d(
        input=tmp,
        pool_size=pool_size,
        pool_type=pool_type,
        pool_stride=pool_stride,
        use_cudnn=use_cudnn)
    return pool_out


def sequence_conv_pool(input,
                       num_filters,
                       filter_size,
                       param_attr=None,
                       act='sigmoid',
                       pool_type='max'):
    conv_out = layers.sequence_conv(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        param_attr=param_attr,
        act=act)
    pool_out = layers.sequence_pool(input=conv_out, pool_type=pool_type)
    return pool_out


def glu(input, dim=-1):
    """The gated linear unit: a * sigmoid(b), ``input`` split in two
    halves a and b along ``dim``."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    act_b = layers.sigmoid(x=b)
    out = layers.elementwise_mul(x=a, y=act_b)
    return out


def scaled_dot_product_attention(queries,
                                 keys,
                                 values,
                                 num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over 3-D (batch, seq, dim)
    inputs, in plain layers: the heads split by ``reshape`` and
    ``transpose``, the scores a batched ``matmul``, a ``softmax`` over the
    keys, the context a second ``matmul``, the heads joined again."""
    if not (len(queries.shape) == len(keys.shape) == len(values.shape) == 3):
        raise ValueError('inputs must be 3-D (batch, seq, dim)')
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError('queries and keys hidden dims must match')
    if keys.shape[-2] != values.shape[-2]:
        raise ValueError('keys and values seq lens must match')
    if queries.shape[-1] % num_heads != 0:
        raise ValueError('hidden size must divide num_heads')

    def __split_heads(x, num_heads):
        if num_heads == 1:
            return x
        hidden_size = x.shape[-1]
        reshaped = layers.reshape(
            x=x,
            shape=list(x.shape[:-1]) + [num_heads, hidden_size // num_heads])
        return layers.transpose(x=reshaped, perm=[0, 2, 1, 3])

    def __combine_heads(x):
        if len(x.shape) == 3:
            return x
        trans_x = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(
            x=trans_x,
            shape=[trans_x.shape[0], trans_x.shape[1],
                   trans_x.shape[2] * trans_x.shape[3]])

    q = __split_heads(queries, num_heads)
    k = __split_heads(keys, num_heads)
    v = __split_heads(values, num_heads)

    key_dim_per_head = keys.shape[-1] // num_heads
    scaled_q = layers.scale(x=q, scale=key_dim_per_head**-0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)

    weights = layers.reshape(x=product, shape=[-1, product.shape[-1]])
    weights = layers.softmax(weights)
    weights = layers.reshape(x=weights, shape=list(product.shape))
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx_multiheads = layers.matmul(weights, v)
    return __combine_heads(ctx_multiheads)
