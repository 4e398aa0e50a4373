"""ResNet for ImageNet and cifar (counterpart of
``paddle_tpu/models/resnet.py``, the same programs and parameter names):
conv2d + batch_norm bottleneck or basic blocks, NCHW, trained with
Momentum or SGD."""

from .. import fluid

__all__ = ['resnet_imagenet', 'resnet_cifar10', 'build']


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act='relu'):
    conv1 = fluid.layers.conv2d(
        input=input,
        filter_size=filter_size,
        num_filters=ch_out,
        stride=stride,
        padding=padding,
        act=None,
        bias_attr=False)
    return fluid.layers.batch_norm(input=conv1, act=act)


def shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None)
    return input


def basicblock(input, ch_out, stride):
    short = shortcut(input, ch_out, stride)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None)
    return fluid.layers.elementwise_add(x=short, y=conv2, act='relu')


def bottleneck(input, ch_out, stride):
    short = shortcut(input, ch_out * 4, stride)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None)
    return fluid.layers.elementwise_add(x=short, y=conv3, act='relu')


def layer_warp(block_func, input, ch_out, count, stride):
    res_out = block_func(input, ch_out, stride)
    for i in range(1, count):
        res_out = block_func(res_out, ch_out, 1)
    return res_out


def resnet_imagenet(input, class_dim, depth=50, logits_only=False):
    """ResNet-50/101/152 (reference resnet.py:47).  ``logits_only`` skips
    the softmax so the caller can use the fused
    softmax_with_cross_entropy loss (one kernel, better numerics than
    softmax + cross_entropy — reference softmax_with_cross_entropy_op.cc
    motivates the same fusion)."""
    cfg = {
        18: ([2, 2, 2, 1], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck)
    }
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3)
    pool1 = fluid.layers.pool2d(
        input=conv1, pool_type='max', pool_size=3, pool_stride=2,
        pool_padding=1)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2)
    pool2 = fluid.layers.pool2d(
        input=res4, pool_size=7, pool_type='avg', pool_stride=1,
        global_pooling=True)
    out = fluid.layers.fc(input=pool2, size=class_dim,
                          act=None if logits_only else 'softmax')
    return out


def resnet_cifar10(input, class_dim, depth=32):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(
        input=input, ch_out=16, filter_size=3, stride=1, padding=1)
    res1 = layer_warp(basicblock, conv1, 16, n, 1)
    res2 = layer_warp(basicblock, res1, 32, n, 2)
    res3 = layer_warp(basicblock, res2, 64, n, 2)
    pool = fluid.layers.pool2d(
        input=res3, pool_size=8, pool_type='avg', pool_stride=1,
        global_pooling=True)
    out = fluid.layers.fc(input=pool, size=class_dim, act='softmax')
    return out


def build(depth=50,
          class_dim=1000,
          image_shape=(3, 224, 224),
          lr=0.01,
          use_momentum=True,
          variant='imagenet',
          fused_ce=True):
    """Build the train/test programs (reference benchmark fluid_benchmark).

    ``fused_ce`` (imagenet variant) trains on the fused
    softmax_with_cross_entropy head — one kernel, log-sum-exp stable —
    and leaves a softmax prediction output for inference/accuracy."""
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(
            name='img', shape=list(image_shape), dtype='float32')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        if variant == 'imagenet' and fused_ce:
            logits = resnet_imagenet(img, class_dim, depth=depth,
                                     logits_only=True)
            prediction = fluid.layers.softmax(logits)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(
                    logits=logits, label=label))
        else:
            if variant == 'imagenet':
                prediction = resnet_imagenet(img, class_dim, depth=depth)
            else:
                prediction = resnet_cifar10(img, class_dim, depth=depth)
            loss = fluid.layers.mean(
                fluid.layers.cross_entropy(input=prediction, label=label))
        acc = fluid.layers.accuracy(input=prediction, label=label)
        test_program = main.clone(for_test=True)
        if use_momentum:
            opt = fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9)
        else:
            opt = fluid.optimizer.SGD(learning_rate=lr)
        opt.minimize(loss)
    return dict(
        main=main,
        startup=startup,
        test=test_program,
        feeds=['img', 'label'],
        prediction=prediction,
        loss=loss,
        acc=acc)
