"""Stacked dynamic-LSTM sentiment model (counterpart of
``paddle_tpu/models/stacked_lstm.py``, the same programs and parameter
names)."""

from .. import fluid

__all__ = ['stacked_lstm_net', 'build']


def stacked_lstm_net(data, label, dict_dim, emb_dim=128, hid_dim=128,
                     stacked_num=3, class_dim=2):
    emb = fluid.layers.embedding(
        input=data, size=[dict_dim, emb_dim], is_sparse=False)

    fc1 = fluid.layers.fc(input=emb, size=hid_dim * 4)
    lstm1, cell1 = fluid.layers.dynamic_lstm(input=fc1, size=hid_dim * 4)

    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = fluid.layers.fc(input=inputs, size=hid_dim * 4)
        lstm, cell = fluid.layers.dynamic_lstm(
            input=fc, size=hid_dim * 4, is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]

    fc_last = fluid.layers.sequence_pool(input=inputs[0], pool_type='max')
    lstm_last = fluid.layers.sequence_pool(input=inputs[1], pool_type='max')

    prediction = fluid.layers.fc(
        input=[fc_last, lstm_last], size=class_dim, act='softmax')
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    return prediction, fluid.layers.mean(cost)


def build(dict_dim=5149, class_dim=2, emb_dim=128, hid_dim=128,
          stacked_num=3, lr=0.002):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        data = fluid.layers.data(
            name='words', shape=[1], dtype='int64', lod_level=1)
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        prediction, loss = stacked_lstm_net(
            data, label, dict_dim, emb_dim, hid_dim, stacked_num, class_dim)
        acc = fluid.layers.accuracy(input=prediction, label=label)
        test_program = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return dict(
        main=main,
        startup=startup,
        test=test_program,
        feeds=['words', 'label'],
        prediction=prediction,
        loss=loss,
        acc=acc)
