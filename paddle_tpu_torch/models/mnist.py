"""MNIST models (counterpart of ``paddle_tpu/models/mnist.py``, the same
programs and parameter names): the MLP (784-200-200-10, tanh) and the
LeNet-style conv net, trained with Adam."""

from .. import fluid

__all__ = ['mlp', 'conv_net', 'build']


def mlp(img, label):
    hidden = fluid.layers.fc(input=img, size=200, act='tanh')
    hidden = fluid.layers.fc(input=hidden, size=200, act='tanh')
    prediction = fluid.layers.fc(input=hidden, size=10, act='softmax')
    loss = fluid.layers.cross_entropy(input=prediction, label=label)
    return prediction, fluid.layers.mean(loss)


def conv_net(img, label):
    """LeNet-style conv net (reference test_recognize_digits.py conv path)."""
    conv_pool_1 = fluid.nets.simple_img_conv_pool(
        input=img,
        filter_size=5,
        num_filters=20,
        pool_size=2,
        pool_stride=2,
        act='relu')
    conv_pool_2 = fluid.nets.simple_img_conv_pool(
        input=conv_pool_1,
        filter_size=5,
        num_filters=50,
        pool_size=2,
        pool_stride=2,
        act='relu')
    prediction = fluid.layers.fc(input=conv_pool_2, size=10, act='softmax')
    loss = fluid.layers.cross_entropy(input=prediction, label=label)
    return prediction, fluid.layers.mean(loss)


def build(nn_type='mlp', img_shape=(784, ), lr=0.01):
    """Build (main, startup, feeds, prediction, loss, acc)."""
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(
            name='img', shape=list(img_shape), dtype='float32')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        net = mlp if nn_type == 'mlp' else conv_net
        prediction, loss = net(img, label)
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
