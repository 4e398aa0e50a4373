"""Control-flow layers (counterpart of
``paddle_tpu/fluid/layers/control_flow.py``).

``StaticRNN`` and ``DynamicRNN`` build a sub-block holding one step of the
recurrence and append one ``recurrent`` op to the enclosing block; ``While``
appends a ``while`` op over its sub-block, ``Switch`` a ``switch_case`` op
over its case blocks, ``IfElse`` an ``ifelse`` op over its two branches;
``ops/control_flow_ops.py`` runs them.  The tensor-array layers
(``array_write``, ``array_read``, ``array_length``), the compare layers,
``increment``, ``Print`` and the LoD routing layers append one op each.
The ops and their attrs are the JAX package's, so a model builds the same
program under both packages.
"""

import contextlib

from .. import core
from .. import unique_name
from ..layer_helper import LayerHelper

__all__ = [
    'While', 'StaticRNN', 'DynamicRNN', 'increment', 'array_write',
    'array_read', 'array_length', 'less_than', 'equal', 'Switch', 'IfElse',
    'zeros_like', 'Print', 'is_empty', 'lod_rank_table',
    'reorder_lod_tensor_by_rank', 'split_lod_tensor', 'merge_lod_tensor',
]


def _compare(op_type, x, y, cond):
    helper = LayerHelper(op_type, x=x, y=y, cond=cond)
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool')
        cond.stop_gradient = True
    helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [cond]})
    return cond


def less_than(x, y, cond=None, **ignored):
    return _compare('less_than', x, y, cond)


def equal(x, y, cond=None, **ignored):
    return _compare('equal', x, y, cond)


def increment(x, value=1.0, in_place=True):
    """x + value, written into x itself by default."""
    helper = LayerHelper('increment', **locals())
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='increment', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'step': float(value)})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper('zeros_like', **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='fill_zeros_like', inputs={'X': [x]},
                     outputs={'Out': [out]})
    return out


def array_write(x, i, array=None):
    """Write x into a tensor array at index i (a new array by default)."""
    helper = LayerHelper('array_write', **locals())
    if array is None:
        array = helper.create_variable(
            name='{0}.out'.format(helper.name),
            type=core.VarDesc.VarType.LOD_TENSOR_ARRAY,
            dtype=x.dtype)
    helper.append_op(
        type='write_to_array',
        inputs={'X': [x],
                'I': [i]},
        outputs={'Out': [array]},
        # ties the op to its grad, which reads the index the forward used
        attrs={'_array_op_id': unique_name.generate('awrite')})
    return array


def array_read(array, i):
    helper = LayerHelper('array_read', **locals())
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op(
        type='read_from_array',
        inputs={'X': [array],
                'I': [i]},
        outputs={'Out': [out]},
        attrs={'_array_op_id': unique_name.generate('aread')})
    return out


def array_length(array):
    helper = LayerHelper('array_length', **locals())
    tmp = helper.create_variable_for_type_inference(dtype='int64',
                                                    stop_gradient=True)
    helper.append_op(type='lod_array_length', inputs={'X': [array]},
                     outputs={'Out': [tmp]})
    return tmp


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


class BlockGuard(object):
    def __init__(self, main_program):
        self.main_program = main_program

    def __enter__(self):
        self.main_program.create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.main_program.rollback()
        return exc_type is None


class While(object):
    """while (cond) { block }.  The loop's state is every var of an
    enclosing block that the body writes; each is snapshotted before the
    loop (the op's ``Init`` inputs), so that the op's grad replays the loop
    from its initial values.

    Without ``max_trip_count`` the loop runs until the condition is false,
    read on the host at every trip: the block holding it is never
    captured, and the loop has no grad.  With it, the loop runs that many
    trips, the state kept once the condition is false: it can be captured
    and differentiated, and carried tensor arrays are preallocated to the
    bound."""

    def __init__(self, cond, is_test=False, name=None, max_trip_count=0):
        self.helper = LayerHelper('while', name=name)
        if cond.dtype != core.VarDesc.VarType.BOOL:
            raise TypeError('condition should be a bool variable')
        self.cond_var = cond
        self.max_trip_count = int(max_trip_count or 0)

    @contextlib.contextmanager
    def block(self):
        main_program = self.helper.main_program
        parent_idx = main_program.current_block_idx
        sub_block = main_program.create_block()
        try:
            yield
        finally:
            main_program.rollback()
        parent_block = main_program.block(parent_idx)
        mod_names = []
        for op in sub_block.ops:
            for n in op.output_arg_names:
                if n not in sub_block.vars and n not in mod_names:
                    mod_names.append(n)
        carry_names = [self.cond_var.name] + [
            n for n in mod_names if n != self.cond_var.name]
        init_names = []
        for n in carry_names:
            src = parent_block._find_var_recursive(n)
            kwargs = {'name': unique_name.generate(n + '@WHILE_INIT')}
            if src is not None:
                kwargs['dtype'] = src.dtype
                kwargs['type'] = src.type
            snap = parent_block.create_var(**kwargs)
            parent_block.append_op(
                type='assign', inputs={'X': [n]},
                outputs={'Out': [snap.name]}, attrs={})
            init_names.append(snap.name)
        parent_block.append_op(
            type='while',
            inputs={
                'Condition': [self.cond_var],
                # the carried vars come in through their snapshots
                'X': _external_reads(sub_block, carry_names),
                'Init': init_names,
            },
            outputs={'Out': mod_names},
            attrs={'sub_block': sub_block,
                   'carry_names': carry_names,
                   'max_trip_count': self.max_trip_count})


class Switch(object):
    """Cases over conditions (``case``) and a ``default``: every case block
    runs, and each var they write takes the first true case's value."""

    def __init__(self, name=None):
        self.helper = LayerHelper('switch', name=name)
        self.cases = []  # (cond name or None, sub_block)
        self.parent_idx = None

    @contextlib.contextmanager
    def case(self, condition):
        main_program = self.helper.main_program
        if self.parent_idx is None:
            self.parent_idx = main_program.current_block_idx
        sub_block = main_program.create_block()
        try:
            yield
        finally:
            main_program.rollback()
        self.cases.append((condition.name, sub_block))

    @contextlib.contextmanager
    def default(self):
        main_program = self.helper.main_program
        sub_block = main_program.create_block()
        try:
            yield
        finally:
            main_program.rollback()
        self.cases.append((None, sub_block))

    @contextlib.contextmanager
    def block(self):
        try:
            yield self
        finally:
            program = self.helper.main_program
            parent_block = program.block(
                self.parent_idx if self.parent_idx is not None else
                program.current_block_idx)
            written = []
            for _, sb in self.cases:
                for op in sb.ops:
                    for n in op.output_arg_names:
                        if n not in sb.vars and n not in written:
                            written.append(n)
            parent_block.append_op(
                type='switch_case',
                inputs={'Conditions':
                        [c for c, _ in self.cases if c is not None]},
                outputs={'Out': written},
                attrs={'case_conds': [c for c, _ in self.cases],
                       'case_blocks': [sb for _, sb in self.cases]})


class IfElse(object):
    """Two branches over a [B, 1] bool condition.  ``input(x)`` routes x's
    rows to the branch through ``split_lod_tensor`` (the true branch gets
    the rows where cond holds, compacted), and the op reassembles the
    outputs row by row.  A branch that never calls ``input`` runs on the
    whole batch and its outputs are selected by row (a one-element
    condition selects whole tensors)."""

    OUT_IF_ELSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper('ifelse', name=name)
        self.cond = cond
        self.blocks = {}  # True/False -> sub_block
        self.outputs = {True: [], False: []}
        self.parent_idx = None
        self._out_vars = None
        self._routed = {True: False, False: False}

    @contextlib.contextmanager
    def true_block(self):
        with self._block(True):
            yield

    @contextlib.contextmanager
    def false_block(self):
        with self._block(False):
            yield

    @contextlib.contextmanager
    def _block(self, branch):
        main_program = self.helper.main_program
        if self.parent_idx is None:
            self.parent_idx = main_program.current_block_idx
        sub_block = main_program.create_block()
        self._current_branch = branch
        try:
            yield
        finally:
            main_program.rollback()
            self.blocks[branch] = sub_block

    def input(self, x):
        branch = self._current_branch
        self._routed[branch] = True
        out_true, out_false = split_lod_tensor(x, self.cond)
        return out_true if branch else out_false

    def output(self, *outs):
        self.outputs[self._current_branch].extend([o.name for o in outs])

    def __call__(self):
        if len(self.outputs[True]) != len(self.outputs[False]):
            raise ValueError('true/false branches must output equally')
        parent_block = self.helper.main_program.block(self.parent_idx)
        out_vars = [parent_block.create_var(name=t_name + '@ifelse',
                                            dtype='float32')
                    for t_name in self.outputs[True]]
        # the branches' external reads (weights) are the op's inputs, so
        # the executor reads them from the scope and the grad reaches them
        ext = []
        for blk in (self.blocks.get(True), self.blocks.get(False)):
            if blk is not None:
                for n in _external_reads(blk, exclude=(self.cond.name, )):
                    if n not in ext:
                        ext.append(n)
        parent_block.append_op(
            type='ifelse',
            inputs={'Cond': [self.cond],
                    'X': ext},
            outputs={'Out': out_vars},
            attrs={
                'true_block': self.blocks.get(True),
                'false_block': self.blocks.get(False),
                'true_out': list(self.outputs[True]),
                'false_out': list(self.outputs[False]),
                'routed_true': self._routed[True],
                'routed_false': self._routed[False],
            })
        return out_vars


def split_lod_tensor(input, mask, level=0):
    """(out_true, out_false): input's rows where the [B, 1] bool mask holds
    and where it does not, each compacted to the front of a tensor of
    input's shape (merge_lod_tensor never reads the tail)."""
    helper = LayerHelper('split_lod_tensor', **locals())
    out_true = helper.create_variable_for_type_inference(dtype=input.dtype)
    out_false = helper.create_variable_for_type_inference(dtype=input.dtype)
    out_true.shape = input.shape
    out_false.shape = input.shape
    helper.append_op(
        type='split_lod_tensor',
        inputs={'X': [input],
                'Mask': [mask]},
        outputs={'OutTrue': [out_true],
                 'OutFalse': [out_false]},
        attrs={'level': level})
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    """The inverse of split_lod_tensor: row r is the next row of in_true
    where mask[r], else of in_false; ``x`` gives the rows' layout."""
    helper = LayerHelper('merge_lod_tensor', **locals())
    out = helper.create_variable_for_type_inference(dtype=in_true.dtype)
    out.shape = x.shape
    helper.append_op(
        type='merge_lod_tensor',
        inputs={'X': [x],
                'Mask': [mask],
                'InTrue': [in_true],
                'InFalse': [in_false]},
        outputs={'Out': [out]},
        attrs={'level': level})
    return out


def Print(input,
          first_n=-1,
          message=None,
          summarize=-1,
          print_tensor_name=True,
          print_tensor_type=True,
          print_tensor_shape=True,
          print_tensor_lod=True,
          print_phase='both'):
    """Print a tensor's value as the program runs (the ``print`` host op,
    so the block holding it runs eagerly); returns the value passed
    through."""
    helper = LayerHelper('print', **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    out.shape = input.shape
    helper.append_op(
        type='print',
        inputs={'In': [input]},
        outputs={'Out': [out]},
        attrs={
            'first_n': first_n,
            'message': message or '',
            'summarize': summarize,
            'print_tensor_name': print_tensor_name,
            'print_tensor_type': print_tensor_type,
            'print_tensor_shape': print_tensor_shape,
            'print_tensor_lod': print_tensor_lod,
            'print_phase': print_phase.upper(),
        })
    return out


def is_empty(x, cond=None, **ignored):
    """[1] bool: x has no elements."""
    helper = LayerHelper('is_empty', **locals())
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool')
        cond.shape = (1, )
    helper.append_op(type='is_empty', inputs={'X': [x]},
                     outputs={'Out': [cond]})
    return cond


def lod_rank_table(x, level=0):
    """The row permutation sorting x's sequences by length, longest first,
    ties in row order."""
    helper = LayerHelper('lod_rank_table', **locals())
    table = helper.create_variable_for_type_inference(dtype='int32')
    table.shape = (x.shape[0] if x.shape else -1, )
    helper.append_op(type='lod_rank_table', inputs={'X': [x]},
                     outputs={'Out': [table]}, attrs={'level': level})
    return table


def reorder_lod_tensor_by_rank(x, rank_table):
    """x's rows in a lod_rank_table's order."""
    helper = LayerHelper('reorder_lod_tensor_by_rank', **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type='reorder_lod_tensor_by_rank',
                     inputs={'X': [x], 'RankTable': [rank_table]},
                     outputs={'Out': [out]})
    return out
