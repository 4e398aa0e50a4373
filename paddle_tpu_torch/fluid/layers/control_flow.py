"""Recurrent control-flow layers (counterpart of
``paddle_tpu/fluid/layers/control_flow.py``: ``StaticRNN`` and
``DynamicRNN``).

Each builds a sub-block holding one step of the recurrence and appends one
``recurrent`` op to the enclosing block; ``ops/control_flow_ops.py`` runs
that op as a loop over time.  The op and its attrs are the JAX package's,
so a model builds the same program under both packages.
"""

import contextlib

from ..layer_helper import LayerHelper

__all__ = ['StaticRNN', 'DynamicRNN']


def _external_reads(sub_block, exclude=()):
    """Vars a sub-block reads from enclosing blocks (weights, globals).
    They are the op's ``ClosureInputs``, so the executor reads them from
    the scope and the generic grad returns their gradients."""
    exclude = set(exclude)
    local_writes = set()
    names = []
    for op in sub_block.ops:
        for n in op.input_arg_names:
            if (n not in sub_block.vars and n not in local_writes and
                    n not in exclude and n not in names):
                names.append(n)
        for n in op.output_arg_names:
            local_writes.add(n)
    return names


class StaticRNN(object):
    """Uniform-length RNN over time-major [T, B, ...] sequences: every step
    runs on every row."""

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper('static_rnn', name=name)
        self.memories = {}  # in-block mem var name -> [init, update] names
        self.inputs = []  # (seq var name, in-block var name)
        self.outputs = []
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self.sub_block = None
        self.parent_idx = None

    @contextlib.contextmanager
    def step(self):
        main_program = self.helper.main_program
        self.parent_idx = main_program.current_block_idx
        self.sub_block = main_program.create_block()
        self.status = StaticRNN.IN_RNN_BLOCK
        try:
            yield
        finally:
            main_program.rollback()
            self.status = StaticRNN.AFTER_RNN_BLOCK
            self._complete_op()

    def _assert_in_rnn_block_(self, method):
        if self.status != StaticRNN.IN_RNN_BLOCK:
            raise ValueError('You must invoke {0} in rnn.step()'.format(
                method))

    def memory(self,
               init=None,
               shape=None,
               batch_ref=None,
               init_value=0.0,
               init_batch_dim_idx=0,
               ref_batch_dim_idx=1):
        self._assert_in_rnn_block_('memory')
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    'if init is None, memory at least need shape and '
                    'batch_ref')
            parent_block = self.helper.main_program.block(self.parent_idx)
            ref_name = batch_ref.name
            dim_idx = ref_batch_dim_idx
            # the init op lives in the parent block: an in-block step input
            # as batch_ref stands for its time-major sequence there
            for seq_name, step_name in self.inputs:
                if step_name == ref_name:
                    ref_name = seq_name
                    dim_idx = ref_batch_dim_idx + 1
                    break
            init = parent_block.create_var(
                name='{}.init.{}'.format(self.helper.name,
                                         len(self.memories)),
                dtype='float32',
                shape=[-1] + list(shape))
            parent_block.append_op(
                type='fill_constant_batch_size_like',
                inputs={'Input': [ref_name]},
                outputs={'Out': [init]},
                attrs={
                    'shape': [-1] + list(shape),
                    'value': float(init_value),
                    'input_dim_idx': dim_idx,
                    'dtype': init.dtype,
                })
        mem = self.sub_block.create_var(
            name='{}.mem.{}'.format(self.helper.name, len(self.memories)),
            dtype=init.dtype,
            shape=init.shape)
        self.memories[mem.name] = [init.name, None]
        return mem

    def step_input(self, x):
        self._assert_in_rnn_block_('step_input')
        ipt = self.sub_block.create_var(
            name=x.name + '@step', dtype=x.dtype, shape=tuple(x.shape[1:]))
        self.inputs.append((x.name, ipt.name))
        return ipt

    def step_output(self, o):
        self._assert_in_rnn_block_('step_output')
        self.outputs.append(o.name)

    def output(self, *outputs):
        for each in outputs:
            self.step_output(each)

    def update_memory(self, mem, var):
        self._assert_in_rnn_block_('update_memory')
        if mem.name not in self.memories:
            raise ValueError('unknown memory %s' % mem.name)
        self.memories[mem.name][1] = var.name

    def _complete_op(self):
        parent_block = self.helper.main_program.block(self.parent_idx)
        out_vars = []
        for name in self.outputs:
            step_var = self.sub_block._find_var_recursive(name)
            out_vars.append(parent_block.create_var(
                name=name + '@rnn_out',
                dtype=step_var.dtype if step_var is not None else 'float32'))
        self._out_vars = out_vars
        exclude = [i for _, i in self.inputs] + list(self.memories.keys())
        parent_block.append_op(
            type='recurrent',
            inputs={
                'SeqInputs': [n for n, _ in self.inputs],
                'MemInits': [v[0] for v in self.memories.values()],
                'ClosureInputs': _external_reads(self.sub_block, exclude),
            },
            outputs={'Out': out_vars},
            attrs={
                'sub_block': self.sub_block,
                'step_input_names': [i for _, i in self.inputs],
                'mem_names': list(self.memories.keys()),
                'mem_update_names': [v[1] for v in self.memories.values()],
                'output_names': list(self.outputs),
                'time_major': True,
                'masked': False,
            })

    def __call__(self, *args, **kwargs):
        if self.status != StaticRNN.AFTER_RNN_BLOCK:
            raise ValueError('RNN output can only be retrieved after the '
                             'step block')
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars


class DynamicRNN(object):
    """Variable-length RNN over a LoD batch: one masked loop over the padded
    [B, T, ...] form, each row's memories frozen past its length and its
    outputs zero there."""

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper('dynamic_rnn', name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self.memories = {}
        self.inputs = []
        self.static_inputs = []
        self.outputs = []
        self.sub_block = None
        self.parent_idx = None

    @contextlib.contextmanager
    def block(self):
        main_program = self.helper.main_program
        self.parent_idx = main_program.current_block_idx
        self.sub_block = main_program.create_block()
        self.status = DynamicRNN.IN_RNN
        try:
            yield
        finally:
            main_program.rollback()
            self.status = DynamicRNN.AFTER_RNN
            self._complete_op()

    def step_input(self, x, level=0):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError('step_input must be called in block()')
        # x's desc shape is the concatenated LoD form (total, ...), already
        # time-free: a step's batch slice has the same rank
        ipt = self.sub_block.create_var(
            name=x.name + '@step', dtype=x.dtype, shape=tuple(x.shape))
        self.inputs.append((x.name, ipt.name))
        return ipt

    def static_input(self, x):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError('static_input must be called in block()')
        # visible unchanged at every step
        self.static_inputs.append(x.name)
        return x

    def memory(self,
               init=None,
               shape=None,
               value=0.0,
               need_reorder=False,
               dtype='float32'):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError('memory must be called in block()')
        if init is None:
            if shape is None:
                raise ValueError('memory needs init or shape')
            parent_block = self.helper.main_program.block(self.parent_idx)
            first_seq = self.inputs[0][0] if self.inputs else None
            init = parent_block.create_var(
                name='{}.mem_init.{}'.format(self.helper.name,
                                             len(self.memories)),
                dtype=dtype,
                shape=[-1] + list(shape))
            parent_block.append_op(
                type='fill_constant_batch_size_like',
                inputs={'Input': [first_seq]},
                outputs={'Out': [init]},
                attrs={
                    'shape': [-1] + list(shape),
                    'value': float(value),
                    'dtype': init.dtype,
                })
        mem = self.sub_block.create_var(
            name='{}.mem.{}'.format(self.helper.name, len(self.memories)),
            dtype=init.dtype,
            shape=init.shape)
        self.memories[mem.name] = [init.name, None]
        return mem

    def update_memory(self, ex_mem, new_mem):
        if ex_mem.name not in self.memories:
            raise ValueError('unknown memory %s' % ex_mem.name)
        self.memories[ex_mem.name][1] = new_mem.name

    def output(self, *outputs):
        for o in outputs:
            self.outputs.append(o.name)

    def _complete_op(self):
        parent_block = self.helper.main_program.block(self.parent_idx)
        out_vars = []
        for name in self.outputs:
            step_var = self.sub_block._find_var_recursive(name)
            ov = parent_block.create_var(
                name=name + '@rnn_out',
                dtype=step_var.dtype if step_var is not None else 'float32',
                lod_level=1)
            if step_var is not None and step_var.shape:
                # a step's [B, ...] stacks to a sequence [N, ...]: keep the
                # feature dims so that a downstream fc sizes its weight
                ov.shape = (-1, ) + tuple(step_var.shape[1:])
            out_vars.append(ov)
        self._out_vars = out_vars
        exclude = [i for _, i in self.inputs] + list(self.memories.keys())
        parent_block.append_op(
            type='recurrent',
            inputs={
                'SeqInputs': [n for n, _ in self.inputs],
                'MemInits': [v[0] for v in self.memories.values()],
                'StaticInputs': list(self.static_inputs),
                'ClosureInputs': _external_reads(
                    self.sub_block, exclude + list(self.static_inputs)),
            },
            outputs={'Out': out_vars},
            attrs={
                'sub_block': self.sub_block,
                'step_input_names': [i for _, i in self.inputs],
                'mem_names': list(self.memories.keys()),
                'mem_update_names': [v[1] for v in self.memories.values()],
                'output_names': list(self.outputs),
                'time_major': False,
                'masked': True,
            })

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError(
                'Output of the dynamic RNN can only be visited outside the '
                'rnn block')
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars
