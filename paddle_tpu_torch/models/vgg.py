"""VGG-16 with batch norm and dropout (counterpart of
``paddle_tpu/models/vgg.py``, the same programs and parameter names)."""

from .. import fluid

__all__ = ['vgg16_bn_drop', 'build']


def vgg16_bn_drop(input, class_dim):
    def conv_block(input, num_filter, groups, dropouts):
        return fluid.nets.img_conv_group(
            input=input,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * groups,
            conv_filter_size=3,
            conv_act='relu',
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type='max')

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = fluid.layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = fluid.layers.fc(input=drop, size=512, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act='relu')
    drop2 = fluid.layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = fluid.layers.fc(input=drop2, size=512, act=None)
    prediction = fluid.layers.fc(input=fc2, size=class_dim, act='softmax')
    return prediction


def build(class_dim=1000, image_shape=(3, 224, 224), lr=0.01):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(
            name='img', shape=list(image_shape), dtype='float32')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        prediction = vgg16_bn_drop(img, class_dim)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=prediction, label=label))
        acc = fluid.layers.accuracy(input=prediction, label=label)
        test_program = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return dict(
        main=main,
        startup=startup,
        test=test_program,
        feeds=['img', 'label'],
        prediction=prediction,
        loss=loss,
        acc=acc)
