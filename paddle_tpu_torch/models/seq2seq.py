"""Seq2seq NMT with attention (counterpart of
``paddle_tpu/models/seq2seq.py``: ``build`` and ``build_decode``, the same
programs and parameter names).

Encoder: embedding -> per-token fc -> dynamic LSTM.  Decoder: a DynamicRNN
over the target tokens with Bahdanau-style attention over the encoder
states, the attention being sequence ops (expand, softmax, pool) inside the
step block.  ``build_decode`` runs the decoder as a StaticRNN of
``max_length`` beam-search steps on the static [B*K] beam layout.
``build_step_decode`` is the stepwise greedy decode the generation serving
lane runs: a GRU prompt encoder whose hidden state is the decode state,
its prefill, step and (``chunk=C``) chunk programs.
"""

from .. import fluid

__all__ = ['build', 'build_decode', 'build_step_decode']


def encoder(src_word_id, src_dict_dim, embedding_dim, encoder_size):
    src_embedding = fluid.layers.embedding(
        input=src_word_id, size=[src_dict_dim, embedding_dim])
    fc1 = fluid.layers.fc(input=src_embedding, size=encoder_size * 4,
                          act='tanh')
    lstm_hidden, lstm_cell = fluid.layers.dynamic_lstm(
        input=fc1, size=encoder_size * 4)
    return lstm_hidden


def simple_attention(encoder_vec, encoder_proj, decoder_state,
                     decoder_size):
    decoder_state_proj = fluid.layers.fc(
        input=decoder_state, size=decoder_size, bias_attr=False)
    decoder_state_expand = fluid.layers.sequence_expand(
        x=decoder_state_proj, y=encoder_proj)
    concated = fluid.layers.elementwise_add(encoder_proj,
                                            decoder_state_expand)
    concated = fluid.layers.tanh(concated)
    attention_weights = fluid.layers.fc(
        input=concated, size=1, act=None, bias_attr=False)
    attention_weights = fluid.layers.sequence_softmax(
        input=attention_weights)
    scaled = fluid.layers.elementwise_mul(
        x=encoder_vec, y=attention_weights, axis=0)
    context = fluid.layers.sequence_pool(input=scaled, pool_type='sum')
    return context


def train_decoder(context_boot, encoder_vec, encoder_proj, trg_word_id,
                  trg_dict_dim, embedding_dim, decoder_size):
    trg_embedding = fluid.layers.embedding(
        input=trg_word_id, size=[trg_dict_dim, embedding_dim])

    rnn = fluid.layers.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(trg_embedding)
        vec = rnn.static_input(encoder_vec)
        proj = rnn.static_input(encoder_proj)
        hidden_mem = rnn.memory(init=context_boot)
        context = simple_attention(vec, proj, hidden_mem, decoder_size)
        decoder_inputs = fluid.layers.fc(
            input=[context, current_word],
            size=decoder_size * 3,
            bias_attr=False)
        h, _, _ = fluid.layers.gru_unit(
            input=decoder_inputs, hidden=hidden_mem, size=decoder_size * 3)
        rnn.update_memory(hidden_mem, h)
        # the loop zeroes outputs past each row's length, so a constant-1
        # output doubles as the [B, T, 1] padding mask
        valid = fluid.layers.fill_constant_batch_size_like(
            input=current_word, shape=[-1, 1], value=1.0, dtype='float32')
        rnn.output(h, valid)
    # the vocabulary projection is pointwise in time, so it runs once after
    # the loop as one [B*T, D] x [D, V] product
    hidden_seq, valid_mask = rnn()
    logits = fluid.layers.fc(input=hidden_seq, size=trg_dict_dim)
    return logits, valid_mask


def build(src_dict_dim=1000,
          trg_dict_dim=1000,
          embedding_dim=64,
          encoder_size=64,
          decoder_size=64,
          lr=0.001):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data(
            name='src_word_id', shape=[1], dtype='int64', lod_level=1)
        trg = fluid.layers.data(
            name='target_language_word', shape=[1], dtype='int64',
            lod_level=1)
        label = fluid.layers.data(
            name='target_language_next_word', shape=[1], dtype='int64',
            lod_level=1)

        encoder_out = encoder(src, src_dict_dim, embedding_dim,
                              encoder_size)
        encoder_proj = fluid.layers.fc(
            input=encoder_out, size=decoder_size, bias_attr=False)
        encoder_last = fluid.layers.sequence_last_step(input=encoder_out)
        decoder_boot = fluid.layers.fc(
            input=encoder_last, size=decoder_size, act='tanh')

        logits, valid_mask = train_decoder(decoder_boot, encoder_out,
                                           encoder_proj, trg, trg_dict_dim,
                                           embedding_dim, decoder_size)
        # the prediction is zero on the padded steps, as the loop's outputs
        prediction = fluid.layers.elementwise_mul(
            fluid.layers.softmax(logits), valid_mask)
        cost = fluid.layers.softmax_with_cross_entropy(logits, label)
        # per-sentence sum over its length, then the batch mean
        sent_cost = fluid.layers.sequence_pool(input=cost, pool_type='sum')
        avg_cost = fluid.layers.mean(sent_cost)
        test_program = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    return dict(
        main=main,
        startup=startup,
        test=test_program,
        feeds=['src_word_id', 'target_language_word',
               'target_language_next_word'],
        prediction=prediction,
        loss=avg_cost)


def build_decode(src_dict_dim=1000,
                 trg_dict_dim=1000,
                 embedding_dim=64,
                 encoder_size=64,
                 decoder_size=64,
                 beam_size=4,
                 max_length=16,
                 start_id=0,
                 end_id=1):
    """Beam-search inference program: a StaticRNN of ``max_length`` steps
    carrying (ids, scores, hidden) per beam row, ``beam_search`` selecting
    at each step and ``beam_search_decode`` backtracking the parent
    pointers at the end."""
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data(
            name='src_word_id', shape=[1], dtype='int64', lod_level=1)
        encoder_out = encoder(src, src_dict_dim, embedding_dim,
                              encoder_size)
        encoder_proj = fluid.layers.fc(
            input=encoder_out, size=decoder_size, bias_attr=False)
        encoder_last = fluid.layers.sequence_last_step(input=encoder_out)
        decoder_boot = fluid.layers.fc(
            input=encoder_last, size=decoder_size, act='tanh')

        # per-sentence state tiled to per-beam rows [B*K, ...]
        vec = fluid.layers.beam_expand(encoder_out, beam_size)
        proj = fluid.layers.beam_expand(encoder_proj, beam_size)
        boot = fluid.layers.beam_expand(decoder_boot, beam_size)
        init_ids = fluid.layers.fill_constant_batch_size_like(
            input=boot, shape=[-1, 1], value=float(start_id), dtype='int64')
        init_scores = fluid.layers.beam_init_scores(decoder_boot, beam_size)
        # a dummy step input: it sets the loop's max_length steps
        ticker = fluid.layers.fill_constant_batch_size_like(
            input=boot, shape=[max_length, -1, 1], value=0.0,
            dtype='float32', input_dim_idx=0, output_dim_idx=1)

        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            rnn.step_input(ticker)
            pre_ids = rnn.memory(init=init_ids)
            pre_scores = rnn.memory(init=init_scores)
            hidden_mem = rnn.memory(init=boot)
            context = simple_attention(vec, proj, hidden_mem, decoder_size)
            pre_word = fluid.layers.embedding(
                input=pre_ids, size=[trg_dict_dim, embedding_dim])
            decoder_inputs = fluid.layers.fc(
                input=[context, pre_word],
                size=decoder_size * 3,
                bias_attr=False)
            h, _, _ = fluid.layers.gru_unit(
                input=decoder_inputs, hidden=hidden_mem,
                size=decoder_size * 3)
            prob = fluid.layers.fc(
                input=h, size=trg_dict_dim, act='softmax')
            topk_scores, topk_indices = fluid.layers.topk(prob, beam_size)
            accu_scores = fluid.layers.elementwise_add(
                fluid.layers.log(topk_scores), pre_scores)
            sel_ids, sel_scores, parent_idx = fluid.layers.beam_search(
                pre_ids, pre_scores, topk_indices, accu_scores,
                beam_size, end_id)
            new_h = fluid.layers.gather(h, parent_idx)
            rnn.update_memory(pre_ids, sel_ids)
            rnn.update_memory(pre_scores, sel_scores)
            rnn.update_memory(hidden_mem, new_h)
            rnn.output(sel_ids, sel_scores, parent_idx)

        ids_arr, scores_arr, parents_arr = rnn()
        sent_ids, sent_scores = fluid.layers.beam_search_decode(
            ids_arr, scores_arr, parents_arr, beam_size, end_id)
    return dict(
        main=main,
        startup=startup,
        feeds=['src_word_id'],
        sentence_ids=sent_ids,
        sentence_scores=sent_scores)


def build_step_decode(src_dict_dim=1000,
                      trg_dict_dim=1000,
                      embedding_dim=64,
                      encoder_size=64,
                      decoder_size=64,
                      start_id=0,
                      end_id=1,
                      max_len=16,
                      chunk=None):
    """Stepwise greedy NMT decode for the generation serving lane.  The
    prompt encoder is a masked GRU recurrence (``dynamic_gru``) whose
    hidden state is the decode state, so a prompt prefills either in one
    pass (``prefill``) or as a chain of C-token blocks (``chunk``, built
    with ``chunk=C``) over the same shared weights.

      prefill: src LoD -> embedding -> fc -> dynamic_gru (h0 zeros, steps
          past each row's length frozen) -> sequence_last_step: one
          [B, decoder_size] state fetch;
      chunk: (gen_ctok [B, C, 1], gen_hidden) -> the same layers seeded
          with ``h_0=gen_hidden`` and masked by the block's per-row real
          length (the engine feeds the @SEQLEN companion) -> the advanced
          hidden;
      step: (token, hidden) -> (vocab logits, hidden'): embedding + fc +
          one gru_unit sharing the prefill GRU's weight.

    Every step op is row-independent, so the slot-batched decode is
    token-identical to per-request decode.  The prefill and chunk
    programs share one GRU bias; the step's ``gru_unit`` has none (the
    two agree while that bias stays zero).  ``encoder_size`` is kept for
    the call sites: the GRU encoder is ``decoder_size`` wide."""
    del encoder_size  # the GRU prompt encoder is decoder_size-wide
    shared = {
        'emb': fluid.ParamAttr(name='gen_nmt_src_emb'),
        'proj': fluid.ParamAttr(name='gen_nmt_src_proj'),
        'gru': fluid.ParamAttr(name='gen_nmt_gru_w'),
        'gru_b': fluid.ParamAttr(name='gen_nmt_gru_b'),
    }

    def _encode(tokens, h_0=None, flatten=1):
        emb = fluid.layers.embedding(
            input=tokens, size=[src_dict_dim, embedding_dim],
            param_attr=shared['emb'])
        proj = fluid.layers.fc(input=emb, size=decoder_size * 3,
                               bias_attr=False, num_flatten_dims=flatten,
                               param_attr=shared['proj'])
        hidden_seq = fluid.layers.dynamic_gru(
            proj, decoder_size, param_attr=shared['gru'],
            bias_attr=shared['gru_b'], h_0=h_0)
        return fluid.layers.sequence_last_step(input=hidden_seq)

    prefill, prefill_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prefill, prefill_startup):
        src = fluid.layers.data(
            name='src_word_id', shape=[1], dtype='int64', lod_level=1)
        boot = _encode(src)
    chunk_prog = chunk_startup = chunk_h = None
    if chunk is not None:
        from ..fluid.shape_policy import bucketed_len
        chunk = bucketed_len(int(chunk))
        chunk_prog, chunk_startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(chunk_prog, chunk_startup):
            ctok = fluid.layers.data(name='gen_ctok', shape=[chunk, 1],
                                     dtype='int64')
            hidden_in = fluid.layers.data(
                name='gen_hidden', shape=[decoder_size], dtype='float32')
            chunk_h = _encode(ctok, h_0=hidden_in, flatten=2)
    step, step_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(step, step_startup):
        token = fluid.layers.data(name='gen_token', shape=[1],
                                  dtype='int64')
        hidden = fluid.layers.data(name='gen_hidden',
                                   shape=[decoder_size], dtype='float32')
        pre_word = fluid.layers.embedding(
            input=token, size=[trg_dict_dim, embedding_dim])
        decoder_inputs = fluid.layers.fc(
            input=pre_word, size=decoder_size * 3, bias_attr=False)
        h, _, _ = fluid.layers.gru_unit(
            decoder_inputs, hidden, decoder_size * 3,
            param_attr=shared['gru'], bias_attr=False)
        logits = fluid.layers.fc(input=h, size=trg_dict_dim)
    out = dict(
        prefill=prefill,
        prefill_startup=prefill_startup,
        step=step,
        step_startup=step_startup,
        prefill_feeds=['src_word_id'],
        prefill_fetches=[boot],
        token='gen_token',
        logits=logits,
        state=[('gen_hidden', h)],
        prompt='src_word_id',
        start_id=start_id,
        end_id=end_id,
        max_len=max_len)
    if chunk is not None:
        out.update(
            chunk=chunk_prog,
            chunk_startup=chunk_startup,
            chunk_token='gen_ctok',
            chunk_state=[('gen_hidden', chunk_h)],
            chunk_width=chunk)
    return out
