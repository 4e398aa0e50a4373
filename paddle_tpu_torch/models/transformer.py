"""Transformer encoder-decoder (counterpart of
``paddle_tpu/models/transformer.py``: ``build``, ``position_encoding`` and
``build_step_decode``, the KV-cache decoder of the generation serving
lane).

Every attention runs through the fused ``flash_attention`` op, which on the
card is the hand-written Hopper kernel; layouts are static [B, T, D] with
sinusoid position encodings added as program constants; the vocab projection
and label cross-entropy use the fused softmax_with_cross_entropy head.
"""

import numpy as np

from .. import fluid

__all__ = ['build', 'position_encoding', 'build_step_decode']


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


def build_step_decode(vocab=1000,
                      d_model=64,
                      d_k=64,
                      max_ctx=32,
                      start_id=0,
                      end_id=1,
                      max_len=16,
                      chunk=None):
    """Stepwise KV-cache greedy decode for the generation serving lane: a
    single-layer incremental-attention decoder LM over a dense prompt,
    whose decode state is a per-request KV cache (``[S, max_ctx, d_k]``
    slot slabs) and a position counter.

      prefill: (prompt ids [B, T, 1], lengths [B, 1]) -> the prompt's K/V
          prefix ([B, T, d_k] each; admission zero-pads T up to the
          ``max_ctx`` slab) and the write position (the prompt length);
      step: (token, k_cache, v_cache, pos) -> the token's q/k/v
          projections, k/v written into row ``pos`` (a one_hot blend),
          attention over rows <= pos (sequence_mask), logits and the
          advanced state;
      chunk (``chunk=C``): a [B, C] token block's K/V projections written
          into rows pos .. pos+clen-1 (a per-position one-hot matmul, rows
          past the block's real length ``clen`` masked out) and ``pos``
          advanced by ``clen``: chained over a prompt it writes the rows
          the prefill's zero-padded admission writes.

    Prefill, step and chunk share the embedding and the K/V projections
    (ParamAttr-pinned names).  Every step op is row-independent."""
    shared = {
        'emb': fluid.ParamAttr(name='gen_tf_emb'),
        'k': fluid.ParamAttr(name='gen_tf_wk'),
        'v': fluid.ParamAttr(name='gen_tf_wv'),
    }
    prefill, prefill_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prefill, prefill_startup):
        src = fluid.layers.data(name='gen_src', shape=[-1, 1],
                                dtype='int64')
        src_len = fluid.layers.data(name='gen_src_len', shape=[1],
                                    dtype='float32')
        embp = fluid.layers.embedding(src, size=[vocab, d_model],
                                      param_attr=shared['emb'])
        k0 = fluid.layers.fc(embp, d_k, bias_attr=False,
                             num_flatten_dims=2, param_attr=shared['k'])
        v0 = fluid.layers.fc(embp, d_k, bias_attr=False,
                             num_flatten_dims=2, param_attr=shared['v'])
        pos0 = fluid.layers.scale(src_len, scale=1.0)
    step, step_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(step, step_startup):
        token = fluid.layers.data(name='gen_token', shape=[1],
                                  dtype='int64')
        k_cache = fluid.layers.data(name='gen_k', shape=[max_ctx, d_k],
                                    dtype='float32')
        v_cache = fluid.layers.data(name='gen_v', shape=[max_ctx, d_k],
                                    dtype='float32')
        pos = fluid.layers.data(name='gen_pos', shape=[1],
                                dtype='float32')
        embt = fluid.layers.embedding(token, size=[vocab, d_model],
                                      param_attr=shared['emb'])
        q = fluid.layers.fc(embt, d_k, bias_attr=False)
        k_new = fluid.layers.fc(embt, d_k, bias_attr=False,
                                param_attr=shared['k'])
        v_new = fluid.layers.fc(embt, d_k, bias_attr=False,
                                param_attr=shared['v'])

        # this token's k/v written into the cache row ``pos``
        onehot = fluid.layers.one_hot(pos, max_ctx)  # [B, max_ctx]
        oh3 = fluid.layers.expand(
            fluid.layers.unsqueeze(onehot, axes=[2]), [1, 1, d_k])
        keep3 = fluid.layers.scale(oh3, scale=-1.0, bias=1.0)

        def scatter(cache, new):
            new3 = fluid.layers.expand(
                fluid.layers.unsqueeze(new, axes=[1]), [1, max_ctx, 1])
            return fluid.layers.elementwise_add(
                fluid.layers.elementwise_mul(cache, keep3),
                fluid.layers.elementwise_mul(new3, oh3))

        k2 = scatter(k_cache, k_new)
        v2 = scatter(v_cache, v_new)

        # dot-product attention over the written prefix (rows <= pos)
        q3 = fluid.layers.expand(
            fluid.layers.unsqueeze(q, axes=[1]), [1, max_ctx, 1])
        scores = fluid.layers.scale(
            fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(k2, q3), dim=2),
            scale=1.0 / float(d_k)**0.5)  # [B, max_ctx]
        pos1 = fluid.layers.scale(pos, scale=1.0, bias=1.0)
        seqmask = fluid.layers.sequence_mask(pos1, maxlen=max_ctx,
                                             dtype='float32')
        masked = fluid.layers.elementwise_add(
            fluid.layers.elementwise_mul(scores, seqmask),
            fluid.layers.scale(seqmask, scale=1e9, bias=-1e9))
        attn = fluid.layers.softmax(masked)
        attn3 = fluid.layers.expand(
            fluid.layers.unsqueeze(attn, axes=[2]), [1, 1, d_k])
        ctxv = fluid.layers.reduce_sum(
            fluid.layers.elementwise_mul(v2, attn3), dim=1)  # [B, d_k]
        h = fluid.layers.fc([ctxv, q], d_model, act='tanh')
        logits = fluid.layers.fc(h, vocab)
    chunk_prog = chunk_startup = None
    ck = cv = cpos = None
    if chunk is not None:
        from ..fluid.shape_policy import bucketed_len
        chunk = bucketed_len(int(chunk))
        chunk_prog, chunk_startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(chunk_prog, chunk_startup):
            ctok = fluid.layers.data(name='gen_ctok', shape=[chunk, 1],
                                     dtype='int64')
            clen = fluid.layers.data(name='gen_clen', shape=[1],
                                     dtype='float32')
            kc = fluid.layers.data(name='gen_k', shape=[max_ctx, d_k],
                                   dtype='float32')
            vc = fluid.layers.data(name='gen_v', shape=[max_ctx, d_k],
                                   dtype='float32')
            cp = fluid.layers.data(name='gen_pos', shape=[1],
                                   dtype='float32')
            embc = fluid.layers.embedding(ctok, size=[vocab, d_model],
                                          param_attr=shared['emb'])
            k_new = fluid.layers.fc(embc, d_k, bias_attr=False,
                                    num_flatten_dims=2,
                                    param_attr=shared['k'])
            v_new = fluid.layers.fc(embc, d_k, bias_attr=False,
                                    num_flatten_dims=2,
                                    param_attr=shared['v'])
            # block position of token j is pos + j, valid while j < clen
            steps = fluid.layers.assign(
                np.arange(chunk, dtype='float32')[None, :])  # [1, C]
            posj = fluid.layers.elementwise_add(
                fluid.layers.expand(cp, [1, chunk]), steps)  # [B, C]
            scat = fluid.layers.one_hot(posj, max_ctx)  # [B, C, max_ctx]
            maskc = fluid.layers.sequence_mask(clen, maxlen=chunk,
                                               dtype='float32')  # [B, C]
            scat = fluid.layers.elementwise_mul(
                scat, fluid.layers.expand(
                    fluid.layers.unsqueeze(maskc, axes=[2]),
                    [1, 1, max_ctx]))
            covered = fluid.layers.reduce_sum(scat, dim=1)  # [B, max_ctx]
            keep3 = fluid.layers.expand(
                fluid.layers.unsqueeze(
                    fluid.layers.scale(covered, scale=-1.0, bias=1.0),
                    axes=[2]),
                [1, 1, d_k])

            def chunk_scatter(cache, new):
                # rows pos..pos+clen-1 replaced by the block's projections
                # ([B, max_ctx, C] @ [B, C, d_k]: each covered row receives
                # one new value), the other rows keep the slab
                return fluid.layers.elementwise_add(
                    fluid.layers.elementwise_mul(cache, keep3),
                    fluid.layers.matmul(scat, new, transpose_x=True))

            ck = chunk_scatter(kc, k_new)
            cv = chunk_scatter(vc, v_new)
            cpos = fluid.layers.elementwise_add(cp, clen)
    out = dict(
        prefill=prefill,
        prefill_startup=prefill_startup,
        step=step,
        step_startup=step_startup,
        prefill_feeds=['gen_src', 'gen_src_len'],
        prefill_fetches=[k0, v0, pos0],
        token='gen_token',
        logits=logits,
        state=[('gen_k', k2), ('gen_v', v2), ('gen_pos', pos1)],
        prompt='gen_src',
        prompt_len='gen_src_len',
        max_ctx=max_ctx,
        start_id=start_id,
        end_id=end_id,
        max_len=max_len)
    if chunk is not None:
        out.update(
            chunk=chunk_prog,
            chunk_startup=chunk_startup,
            chunk_token='gen_ctok',
            chunk_len='gen_clen',
            chunk_state=[('gen_k', ck), ('gen_v', cv),
                         ('gen_pos', cpos)],
            chunk_width=chunk)
    return out
