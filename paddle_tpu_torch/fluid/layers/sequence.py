"""Sequence layers (counterpart of ``paddle_tpu/fluid/layers/sequence.py``:
``dynamic_lstm``, ``sequence_pool`` and its first/last-step aliases).

A LoD input runs as a padded [B, T, ...] tensor with its lengths carried
under ``<name>@SEQLEN`` (see ``ops/sequence_ops.py``).
"""

from ..layer_helper import LayerHelper

__all__ = ['dynamic_lstm', 'sequence_pool', 'sequence_first_step',
           'sequence_last_step']


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
