"""Transformer encoder-decoder (counterpart of
``paddle_tpu/models/transformer.py``: ``build`` and ``position_encoding``).

Every attention runs through the fused ``flash_attention`` op, which on the
card is the hand-written Hopper kernel; layouts are static [B, T, D] with
sinusoid position encodings added as program constants; the vocab projection
and label cross-entropy use the fused softmax_with_cross_entropy head.
"""

import numpy as np

from .. import fluid

__all__ = ['build', 'position_encoding']


def position_encoding(max_len, d_model):
    """Sinusoid table [1, max_len, d_model]."""
    pos = np.arange(max_len)[:, None].astype('float64')
    div = np.power(10000.0,
                   -(np.arange(0, d_model, 2).astype('float64') / d_model))
    table = np.zeros((max_len, d_model))
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[:d_model // 2])
    return table[None].astype('float32')


def _attention(q_in, kv_in, d_model, n_head, causal, name):
    q = fluid.layers.fc(input=q_in, size=d_model, bias_attr=False,
                        num_flatten_dims=2)
    k = fluid.layers.fc(input=kv_in, size=d_model, bias_attr=False,
                        num_flatten_dims=2)
    v = fluid.layers.fc(input=kv_in, size=d_model, bias_attr=False,
                        num_flatten_dims=2)
    ctxv = fluid.layers.flash_attention(
        q, k, v, num_heads=n_head, causal=causal, name=name)
    return fluid.layers.fc(input=ctxv, size=d_model, bias_attr=False,
                           num_flatten_dims=2)


def _add_norm(x, sub, dropout):
    if dropout:
        sub = fluid.layers.dropout(sub, dropout_prob=dropout)
    return fluid.layers.layer_norm(
        fluid.layers.elementwise_add(x, sub), begin_norm_axis=2)


def _ffn(x, d_model, d_ff):
    h = fluid.layers.fc(input=x, size=d_ff, act='relu', num_flatten_dims=2)
    return fluid.layers.fc(input=h, size=d_model, num_flatten_dims=2)


def _embed(ids, vocab, d_model, max_len, name):
    emb = fluid.layers.embedding(
        input=ids, size=[vocab, d_model],
        param_attr=fluid.ParamAttr(name=name))
    scaled = fluid.layers.scale(emb, scale=float(d_model)**0.5)
    pos = fluid.layers.assign(position_encoding(max_len, d_model))
    return fluid.layers.elementwise_add(scaled, pos)


def build(src_vocab=1000,
          trg_vocab=1000,
          max_len=32,
          n_layer=2,
          n_head=4,
          d_model=64,
          d_ff=128,
          dropout=0.0,
          lr=0.001):
    """Training program: encoder-decoder over [B, max_len] int64 ids.
    Feeds: src_ids, trg_ids (decoder input), lbl_ids (next tokens).

    The same programs and parameter names as the JAX package's ``build``:
    ``test`` is the forward program's ``clone(for_test=True)``, and ``main``
    then gets the backward pass and Adam at ``lr``."""
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data(name='src_ids', shape=[max_len],
                                dtype='int64')
        trg = fluid.layers.data(name='trg_ids', shape=[max_len],
                                dtype='int64')
        lbl = fluid.layers.data(name='lbl_ids', shape=[max_len],
                                dtype='int64')

        enc = _embed(src, src_vocab, d_model, max_len, 'src_emb')
        for i in range(n_layer):
            attn = _attention(enc, enc, d_model, n_head, causal=False,
                              name='enc_self_%d' % i)
            enc = _add_norm(enc, attn, dropout)
            enc = _add_norm(enc, _ffn(enc, d_model, d_ff), dropout)

        dec = _embed(trg, trg_vocab, d_model, max_len, 'trg_emb')
        for i in range(n_layer):
            self_attn = _attention(dec, dec, d_model, n_head, causal=True,
                                   name='dec_self_%d' % i)
            dec = _add_norm(dec, self_attn, dropout)
            cross = _attention(dec, enc, d_model, n_head, causal=False,
                               name='dec_cross_%d' % i)
            dec = _add_norm(dec, cross, dropout)
            dec = _add_norm(dec, _ffn(dec, d_model, d_ff), dropout)

        logits = fluid.layers.fc(input=dec, size=trg_vocab,
                                 num_flatten_dims=2)
        lbl3 = fluid.layers.unsqueeze(lbl, axes=[2])
        cost = fluid.layers.softmax_with_cross_entropy(logits, lbl3)
        avg_cost = fluid.layers.mean(cost)
        prediction = fluid.layers.softmax(logits)
        test_program = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    return dict(
        main=main,
        startup=startup,
        test=test_program,
        feeds=['src_ids', 'trg_ids', 'lbl_ids'],
        prediction=prediction,
        loss=avg_cost)
