"""Semantic role labeling with a CRF output layer (counterpart of
``paddle_tpu/models/label_semantic_roles.py``, the same programs and
parameter names; reference: tests/book/test_label_semantic_roles.py).

8 input features (word, predicate, 4 context windows, mark) -> embeddings
-> stacked alternating-direction dynamic LSTMs -> per-token scores ->
linear-chain CRF loss + Viterbi decode.
"""

import paddle_tpu_torch.fluid as fluid

__all__ = ['build']


def db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, mark,
            word_dict_len, pred_dict_len, mark_dict_len, label_dict_len,
            word_dim=8, mark_dim=4, hidden_dim=32, depth=4):
    """(reference test_label_semantic_roles.py db_lstm)"""
    predicate_embedding = fluid.layers.embedding(
        input=predicate, size=[pred_dict_len, word_dim])
    mark_embedding = fluid.layers.embedding(
        input=mark, size=[mark_dict_len, mark_dim])

    word_input = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    emb_layers = [
        fluid.layers.embedding(size=[word_dict_len, word_dim], input=x)
        for x in word_input
    ]
    emb_layers.append(predicate_embedding)
    emb_layers.append(mark_embedding)

    hidden_0_layers = [
        fluid.layers.fc(input=emb, size=hidden_dim, act='tanh')
        for emb in emb_layers
    ]
    hidden_0 = fluid.layers.sums(input=hidden_0_layers)
    lstm_0, _ = fluid.layers.dynamic_lstm(
        input=hidden_0, size=hidden_dim,
        candidate_activation='relu',
        gate_activation='sigmoid',
        cell_activation='sigmoid')

    # stack L-lstm and R-lstm with direction alternating per layer
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = fluid.layers.sums(input=[
            fluid.layers.fc(input=input_tmp[0], size=hidden_dim,
                            act='tanh'),
            fluid.layers.fc(input=input_tmp[1], size=hidden_dim,
                            act='tanh')
        ])
        lstm, _ = fluid.layers.dynamic_lstm(
            input=mix_hidden, size=hidden_dim,
            candidate_activation='relu',
            gate_activation='sigmoid',
            cell_activation='sigmoid',
            is_reverse=((i % 2) == 1))
        input_tmp = [mix_hidden, lstm]

    feature_out = fluid.layers.sums(input=[
        fluid.layers.fc(input=input_tmp[0], size=label_dict_len,
                        act='tanh'),
        fluid.layers.fc(input=input_tmp[1], size=label_dict_len,
                        act='tanh')
    ])
    return feature_out


def build(word_dict_len=200,
          pred_dict_len=40,
          mark_dict_len=2,
          label_dict_len=17,
          word_dim=8,
          mark_dim=4,
          hidden_dim=32,
          depth=2,
          lr=0.01):
    feed_names = ['word_data', 'verb_data', 'ctx_n2_data', 'ctx_n1_data',
                  'ctx_0_data', 'ctx_p1_data', 'ctx_p2_data', 'mark_data',
                  'target']
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        ins = [
            fluid.layers.data(name=n, shape=[1], dtype='int64', lod_level=1)
            for n in feed_names
        ]
        word_ins, target = ins[:8], ins[8]
        feature_out = db_lstm(*word_ins,
                              word_dict_len=word_dict_len,
                              pred_dict_len=pred_dict_len,
                              mark_dict_len=mark_dict_len,
                              label_dict_len=label_dict_len,
                              word_dim=word_dim,
                              mark_dim=mark_dim,
                              hidden_dim=hidden_dim,
                              depth=depth)
        crf_cost = fluid.layers.linear_chain_crf(
            input=feature_out,
            label=target,
            param_attr=fluid.ParamAttr(name='crfw'))
        avg_cost = fluid.layers.mean(crf_cost)
        crf_decode = fluid.layers.crf_decoding(
            input=feature_out, param_attr=fluid.ParamAttr(name='crfw'))
        test_program = main.clone(for_test=True)
        fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return dict(
        main=main,
        startup=startup,
        test=test_program,
        feeds=feed_names,
        loss=avg_cost,
        crf_decode=crf_decode)
