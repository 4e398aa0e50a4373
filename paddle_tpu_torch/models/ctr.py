"""CTR model: a wide-and-deep net over one sparse embedding, the port's copy
of ``paddle_tpu/models/ctr.py``.

The 26 sparse slots share one table, looked up with ``is_sparse=True`` by
default: its gradient is a ``SparseRows`` row subset, never a dense [V, D]
tensor, and Adam updates only the rows a batch touches.
``is_distributed`` is carried as the op's attr only: the row-sharded table
comes with the port's parallel executor.
"""

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.dataset import ctr as ctr_data

__all__ = ['build']


def build(sparse_dim=None, embed_size=16, hidden_sizes=(64, 32),
          lr=0.01, is_sparse=True, is_distributed=False, optimizer=None):
    sparse_dim = sparse_dim or ctr_data.SPARSE_DIM
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        dense = fluid.layers.data(
            name='dense', shape=[ctr_data.DENSE_DIM], dtype='float32')
        sparse_ids = fluid.layers.data(
            name='sparse_ids', shape=[ctr_data.SPARSE_SLOTS], dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')

        # one shared table for all 26 slots: ids [B, 26] -> [B, 26, E]
        embed = fluid.layers.embedding(
            input=sparse_ids,
            size=[sparse_dim, embed_size],
            is_sparse=is_sparse,
            is_distributed=is_distributed,
            param_attr=fluid.ParamAttr(name='ctr_embedding'),
            dtype='float32')
        embed_flat = fluid.layers.reshape(
            embed, shape=[-1, ctr_data.SPARSE_SLOTS * embed_size])

        deep = fluid.layers.concat([dense, embed_flat], axis=1)
        for h in hidden_sizes:
            deep = fluid.layers.fc(input=deep, size=h, act='relu')
        # wide part: linear on the dense features
        wide = fluid.layers.fc(input=dense, size=1, act=None)
        deep_out = fluid.layers.fc(input=deep, size=1, act=None)
        logit = fluid.layers.elementwise_add(deep_out, wide)
        predict = fluid.layers.sigmoid(logit)
        loss = fluid.layers.sigmoid_cross_entropy_with_logits(
            logit, fluid.layers.cast(label, 'float32'))
        avg_loss = fluid.layers.mean(loss)
        test_program = main.clone(for_test=True)
        opt = optimizer or fluid.optimizer.Adam(learning_rate=lr)
        opt.minimize(avg_loss)
    return dict(
        main=main,
        startup=startup,
        test=test_program,
        feeds=['dense', 'sparse_ids', 'label'],
        prediction=predict,
        loss=avg_loss)
