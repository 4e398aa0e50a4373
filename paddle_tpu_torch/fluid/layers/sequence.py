"""Sequence layers (counterpart of ``paddle_tpu/fluid/layers/sequence.py``:
``dynamic_lstm``, ``dynamic_gru``, ``gru_unit``, ``sequence_conv``,
``sequence_mask``, ``sequence_pool`` and its first/last-step aliases,
``sequence_softmax``, ``sequence_expand``, and the beam-search layers
``beam_expand``, ``beam_init_scores``, ``beam_search`` and
``beam_search_decode``).

A LoD input runs as a padded [B, T, ...] tensor with its lengths carried
under ``<name>@SEQLEN`` (see ``ops/sequence_ops.py``).
"""

from ..layer_helper import LayerHelper

__all__ = ['dynamic_lstm', 'dynamic_gru', 'gru_unit', 'sequence_conv',
           'sequence_pool', 'sequence_mask', 'sequence_first_step',
           'sequence_last_step', 'sequence_softmax', 'sequence_expand',
           'beam_expand', 'beam_init_scores', 'beam_search',
           'beam_search_decode']


def dynamic_lstm(input,
                 size,
                 h_0=None,
                 c_0=None,
                 param_attr=None,
                 bias_attr=None,
                 use_peepholes=True,
                 is_reverse=False,
                 gate_activation='sigmoid',
                 cell_activation='tanh',
                 candidate_activation='tanh',
                 dtype='float32',
                 name=None):
    """LSTM over a whole variable-length batch: ``input`` is the
    pre-projected gate sequence [*, 4D], ``size`` is 4D.  Returns (hidden,
    cell)."""
    helper = LayerHelper('lstm', **locals())
    hidden_dim = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[hidden_dim, 4 * hidden_dim],
        dtype=dtype)
    bias_size = [1, 7 * hidden_dim if use_peepholes else 4 * hidden_dim]
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True)

    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    batch_gate = helper.create_variable_for_type_inference(dtype)
    batch_cell_pre_act = helper.create_variable_for_type_inference(dtype)
    hidden.shape = tuple(input.shape[:-1]) + (hidden_dim, )
    cell.shape = hidden.shape
    hidden.lod_level = input.lod_level
    cell.lod_level = input.lod_level
    inputs = {'Input': [input], 'Weight': [weight], 'Bias': [bias]}
    if h_0 is not None:
        inputs['H0'] = [h_0]
    if c_0 is not None:
        inputs['C0'] = [c_0]
    helper.append_op(
        type='lstm',
        inputs=inputs,
        outputs={
            'Hidden': [hidden],
            'Cell': [cell],
            'BatchGate': [batch_gate],
            'BatchCellPreAct': [batch_cell_pre_act]
        },
        attrs={
            'use_peepholes': use_peepholes,
            'is_reverse': is_reverse,
            'gate_activation': gate_activation,
            'cell_activation': cell_activation,
            'candidate_activation': candidate_activation
        })
    return hidden, cell


def dynamic_gru(input,
                size,
                param_attr=None,
                bias_attr=None,
                is_reverse=False,
                gate_activation='sigmoid',
                candidate_activation='tanh',
                h_0=None):
    """GRU over a whole variable-length batch: ``input`` is the
    pre-projected [*, 3D] sequence, ``size`` is D; returns the hidden
    sequence."""
    helper = LayerHelper('gru', **locals())
    dtype = helper.input_dtype()
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype,
        is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    hidden.shape = tuple(input.shape[:-1]) + (size, )
    hidden.lod_level = input.lod_level
    batch_gate = helper.create_variable_for_type_inference(dtype)
    batch_reset = helper.create_variable_for_type_inference(dtype)
    batch_hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {'Input': [input], 'Weight': [weight], 'Bias': [bias]}
    if h_0 is not None:
        inputs['H0'] = [h_0]
    helper.append_op(
        type='gru',
        inputs=inputs,
        outputs={
            'Hidden': [hidden],
            'BatchGate': [batch_gate],
            'BatchResetHiddenPrev': [batch_reset],
            'BatchHidden': [batch_hidden]
        },
        attrs={
            'is_reverse': is_reverse,
            'gate_activation': gate_activation,
            'activation': candidate_activation
        })
    return hidden


def gru_unit(input,
             hidden,
             size,
             param_attr=None,
             bias_attr=None,
             activation='tanh',
             gate_activation='sigmoid'):
    """One GRU step: ``input`` is the projected [B, 3D], ``size`` is 3D.
    Returns (hidden, reset_hidden_prev, gate)."""
    activation_dict = dict(identity=0, sigmoid=1, tanh=2, relu=3)
    helper = LayerHelper('gru_unit', **locals())
    dtype = helper.input_dtype()
    size = size // 3
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden_pre = helper.create_variable_for_type_inference(dtype)
    updated_hidden = helper.create_variable_for_type_inference(dtype)
    updated_hidden.shape = hidden.shape
    inputs = {'Input': [input], 'HiddenPrev': [hidden], 'Weight': [weight]}
    if helper.bias_attr:
        bias = helper.create_parameter(
            attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype,
            is_bias=True)
        inputs['Bias'] = [bias]
    helper.append_op(
        type='gru_unit',
        inputs=inputs,
        outputs={
            'Gate': [gate],
            'ResetHiddenPrev': [reset_hidden_pre],
            'Hidden': [updated_hidden],
        },
        attrs={
            'activation': activation_dict[activation],
            'gate_activation': activation_dict[gate_activation],
        })
    return updated_hidden, reset_hidden_pre, gate


def sequence_conv(input,
                  num_filters,
                  filter_size=3,
                  filter_stride=1,
                  padding=None,
                  bias_attr=None,
                  param_attr=None,
                  act=None):
    """Context-window convolution over time (reference nn.py
    sequence_conv)."""
    helper = LayerHelper('sequence_conv', **locals())
    dtype = helper.input_dtype()
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    pre_bias.shape = tuple(input.shape[:-1]) + (num_filters, )
    pre_bias.lod_level = input.lod_level
    helper.append_op(
        type='sequence_conv',
        inputs={
            'X': [input],
            'Filter': [filter_param],
        },
        outputs={'Out': [pre_bias]},
        attrs={
            'contextStride': filter_stride,
            'contextStart': -int(filter_size // 2),
            'contextLength': filter_size
        })
    pre_act = helper.append_bias_op(pre_bias,
                                    dim_start=len(pre_bias.shape) - 1)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type, agg_to_no_sequence=False):
    """Pool each sequence to one vector (pool_type: sum, average, sqrt, max,
    last, first).  ``agg_to_no_sequence`` matters for nested inputs only,
    which wait for a later slice of the port."""
    helper = LayerHelper('sequence_pool', **locals())
    dtype = helper.input_dtype()
    pool_out = helper.create_variable_for_type_inference(dtype)
    max_index = helper.create_variable_for_type_inference(dtype='int32')
    if len(input.shape) >= 2:
        pool_out.shape = (input.shape[0], input.shape[-1])
    helper.append_op(
        type='sequence_pool',
        inputs={'X': [input]},
        outputs={'Out': [pool_out],
                 'MaxIndex': [max_index]},
        attrs={'pooltype': pool_type.upper(),
               'agg_to_no_sequence': bool(agg_to_no_sequence)})
    if pool_type == 'max':
        max_index.stop_gradient = True
    return pool_out


def sequence_first_step(input):
    return sequence_pool(input=input, pool_type='first')


def sequence_last_step(input):
    return sequence_pool(input=input, pool_type='last')


def sequence_softmax(input, use_cudnn=False, name=None):
    """Softmax over each sequence's steps."""
    helper = LayerHelper('sequence_softmax', **locals())
    dtype = helper.input_dtype()
    softmax_out = helper.create_variable_for_type_inference(dtype)
    softmax_out.shape = input.shape
    softmax_out.lod_level = input.lod_level
    helper.append_op(
        type='sequence_softmax',
        inputs={'X': [input]},
        outputs={'Out': [softmax_out]})
    return softmax_out


def sequence_expand(x, y, ref_level=-1, name=None,
                    expand_from_sequence=False):
    """Broadcast each row of ``x`` across the steps of ``y``'s sequence.
    ``expand_from_sequence`` (a nested ref) is not ported yet."""
    helper = LayerHelper('sequence_expand', **locals())
    dtype = helper.input_dtype('x')
    tmp = helper.create_variable_for_type_inference(dtype)
    tmp.lod_level = y.lod_level
    helper.append_op(
        type='sequence_expand',
        inputs={'X': [x],
                'Y': [y]},
        outputs={'Out': [tmp]},
        attrs={'ref_level': ref_level,
               'expand_from_sequence': bool(expand_from_sequence)})
    return tmp


def beam_expand(x, beam_size):
    """Tile per-sentence rows to per-beam rows: [B, ...] -> [B*K, ...]."""
    helper = LayerHelper('beam_expand', **locals())
    out = helper.create_variable_for_type_inference(
        helper.input_dtype('x'))
    out.shape = tuple(x.shape)
    out.lod_level = x.lod_level
    helper.append_op(
        type='beam_expand',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'beam_size': beam_size})
    return out


def beam_init_scores(ref, beam_size):
    """Initial accumulated scores [B*K, 1]: 0 for beam 0, -1e9 others."""
    helper = LayerHelper('beam_init_scores', **locals())
    out = helper.create_variable_for_type_inference('float32')
    out.shape = (-1, 1)
    helper.append_op(
        type='beam_init_scores',
        inputs={'X': [ref]},
        outputs={'Out': [out]},
        attrs={'beam_size': beam_size})
    return out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, row_offsets=None, name=None):
    """One beam-search step on the static [B*K] beam layout: returns
    (selected_ids, selected_scores, parent_idx).  The nested-LoD pools
    (``level`` 1, ``row_offsets``) build here but are not run yet."""
    helper = LayerHelper('beam_search', **locals())
    selected_ids = helper.create_variable_for_type_inference('int64')
    selected_scores = helper.create_variable_for_type_inference('float32')
    parent_idx = helper.create_variable_for_type_inference('int32')
    attrs = {'beam_size': beam_size, 'end_id': end_id, 'level': level}
    if row_offsets is not None:
        attrs['row_offsets'] = [int(o) for o in row_offsets]
    helper.append_op(
        type='beam_search',
        inputs={
            'pre_ids': [pre_ids],
            'pre_scores': [pre_scores],
            'ids': [ids],
            'scores': [scores],
        },
        outputs={
            'selected_ids': [selected_ids],
            'selected_scores': [selected_scores],
            'parent_idx': [parent_idx],
        },
        attrs=attrs)
    return selected_ids, selected_scores, parent_idx


def beam_search_decode(ids, scores, parent_idx, beam_size, end_id,
                       name=None):
    """Backtrack stacked per-step beams into sentences: returns
    (sentence_ids [B, K, T], sentence_scores [B, K])."""
    helper = LayerHelper('beam_search_decode', **locals())
    sentence_ids = helper.create_variable_for_type_inference('int64')
    sentence_scores = helper.create_variable_for_type_inference('float32')
    helper.append_op(
        type='beam_search_decode',
        inputs={'Ids': [ids],
                'Scores': [scores],
                'ParentIdx': [parent_idx]},
        outputs={'SentenceIds': [sentence_ids],
                 'SentenceScores': [sentence_scores]},
        attrs={'beam_size': beam_size,
               'end_id': end_id})
    return sentence_ids, sentence_scores


def sequence_mask(x, maxlen=None, dtype='int64', name=None):
    """Lengths [B] -> 0/1 mask [B, maxlen] in ``dtype``."""
    helper = LayerHelper('sequence_mask', **locals())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='sequence_mask',
        inputs={'X': [x]},
        outputs={'Out': [out]},
        attrs={'maxlen': maxlen if maxlen is not None else -1,
               'out_dtype': dtype})
    return out
