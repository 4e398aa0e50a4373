"""N-gram word2vec, the port's copy of ``paddle_tpu/models/word2vec.py``:
four context-word embeddings that share one table -> concat -> hidden ->
softmax over the vocabulary.  With ``is_sparse=True`` the table's four
lookups each give a SparseRows gradient, and the backward pass sums them
(concatenates them) with one ``sum`` op.
"""

import paddle_tpu_torch.fluid as fluid

__all__ = ['build']


def build(dict_size=200, embed_size=32, hidden_size=256, lr=0.001,
          is_sparse=False):
    feed_names = ['firstw', 'secondw', 'thirdw', 'forthw', 'nextw']
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        words = [
            fluid.layers.data(name=n, shape=[1], dtype='int64')
            for n in feed_names
        ]
        embeds = [
            fluid.layers.embedding(
                input=w,
                size=[dict_size, embed_size],
                dtype='float32',
                is_sparse=is_sparse,
                param_attr=fluid.ParamAttr(name='shared_w'))
            for w in words[:4]
        ]
        concat = fluid.layers.concat(input=embeds, axis=1)
        hidden = fluid.layers.fc(input=concat, size=hidden_size,
                                 act='sigmoid')
        predict = fluid.layers.fc(input=hidden, size=dict_size,
                                  act='softmax')
        cost = fluid.layers.cross_entropy(input=predict, label=words[4])
        avg_cost = fluid.layers.mean(cost)
        test_program = main.clone(for_test=True)
        fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return dict(
        main=main,
        startup=startup,
        test=test_program,
        feeds=feed_names,
        prediction=predict,
        loss=avg_cost)
