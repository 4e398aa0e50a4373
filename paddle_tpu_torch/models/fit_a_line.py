"""Linear regression on uci_housing (counterpart of
``paddle_tpu/models/fit_a_line.py``, the same programs and parameter
names; reference: tests/book/test_fit_a_line.py)."""

import paddle_tpu_torch.fluid as fluid

__all__ = ['build']


def build(feature_dim=13, lr=0.01):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[feature_dim],
                              dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        y_predict = fluid.layers.fc(input=x, size=1, act=None)
        cost = fluid.layers.square_error_cost(input=y_predict, label=y)
        avg_cost = fluid.layers.mean(cost)
        test_program = main.clone(for_test=True)
        fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return dict(
        main=main,
        startup=startup,
        test=test_program,
        feeds=['x', 'y'],
        prediction=y_predict,
        loss=avg_cost)
