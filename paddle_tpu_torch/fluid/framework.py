"""Graph program representation: Program / Block / Operator / Variable.

Counterpart of ``paddle_tpu/fluid/framework.py``: the same pure-Python descs
and the same API, so a model builds the same program under both packages.
Every mutation of a program bumps ``Program._version``, which keys the
executor's compile cache (``executor.py``): a block planned (and, on the
card, captured) before a mutation is never served after it.
"""

import collections
import contextlib
import copy

from . import core
from . import unique_name

__all__ = [
    'Program', 'Block', 'Operator', 'Variable', 'Parameter', 'program_guard',
    'default_main_program', 'default_startup_program', 'switch_main_program',
    'switch_startup_program', 'name_scope', 'grad_var_name',
]

GRAD_VAR_SUFFIX = '@GRAD'


def grad_var_name(name):
    return name + GRAD_VAR_SUFFIX


class Variable(object):
    """A typed symbolic value in a Block; runtime values live in a Scope."""

    def __init__(self,
                 block,
                 type=core.VarDesc.VarType.LOD_TENSOR,
                 name=None,
                 shape=None,
                 dtype=None,
                 lod_level=None,
                 capacity=None,
                 persistable=None,
                 error_clip=None,
                 stop_gradient=False,
                 is_data=False,
                 initializer=None,
                 **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate('_generated_var')
        self.name = name
        self.type = type
        self.shape = tuple(shape) if shape is not None else ()
        if dtype is None:
            dtype = core.VarDesc.VarType.FP32
        if not isinstance(dtype, int):
            dtype = core.convert_np_dtype_to_dtype_(dtype)
        self.dtype = dtype
        self.lod_level = lod_level if lod_level is not None else 0
        self.persistable = bool(persistable)
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.error_clip = error_clip
        self.capacity = capacity
        # op that produced this var (filled by Block.append_op)
        self.op = None

    @property
    def np_dtype(self):
        return core.convert_dtype_to_np(self.dtype)

    @property
    def torch_dtype(self):
        return core.convert_dtype_to_torch(self.dtype)

    def to_string(self, throw_on_error=False, with_details=False):
        return 'var %s : shape=%s dtype=%s persistable=%s' % (
            self.name, self.shape, self.torch_dtype, self.persistable)

    __repr__ = __str__ = lambda self: self.to_string()


class Parameter(Variable):
    """A persistable, trainable Variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or dtype is None:
            raise ValueError('Parameter needs shape and dtype')
        kwargs.setdefault('persistable', True)
        super(Parameter, self).__init__(
            block, shape=shape, dtype=dtype, **kwargs)
        self.trainable = kwargs.get('trainable', True)
        self.optimize_attr = kwargs.get('optimize_attr',
                                        {'learning_rate': 1.0})
        self.regularizer = kwargs.get('regularizer', None)
        self.gradient_clip_attr = kwargs.get('gradient_clip_attr', None)
        self.do_model_average = kwargs.get('do_model_average', None)


class Operator(object):
    """One operation: type + named input/output var lists + attrs."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        # slot name -> list of var names
        self.inputs = {}
        self.outputs = {}
        if inputs:
            for slot, arg in inputs.items():
                self.inputs[slot] = self._to_name_list(arg)
        if outputs:
            for slot, arg in outputs.items():
                self.outputs[slot] = self._to_name_list(arg)
        self.attrs = dict(attrs) if attrs else {}

    @staticmethod
    def _to_name_list(arg):
        if arg is None:
            return []
        if isinstance(arg, (list, tuple)):
            return [a.name if isinstance(a, Variable) else a for a in arg]
        return [arg.name if isinstance(arg, Variable) else arg]

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name):
        return self.attrs.get(name)

    def has_attr(self, name):
        return name in self.attrs

    def set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    _set_attr = set_attr

    def rename_input(self, old_name, new_name):
        for slot, names in self.inputs.items():
            self.inputs[slot] = [new_name if n == old_name else n
                                 for n in names]
        self.block.program._bump_version()

    def rename_output(self, old_name, new_name):
        for slot, names in self.outputs.items():
            self.outputs[slot] = [new_name if n == old_name else n
                                  for n in names]
        self.block.program._bump_version()

    def to_string(self, throw_on_error=False):
        return '{%s} = %s(%s) attrs=%s' % (self.outputs, self.type,
                                           self.inputs, {
                                               k: v
                                               for k, v in self.attrs.items()
                                               if not k.startswith('_')
                                           })

    __repr__ = __str__ = lambda self: self.to_string()


class Block(object):
    """An ordered op list plus a var symbol table."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()  # name -> Variable
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, *args, **kwargs):
        var = Variable(self, *args, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, *args, **kwargs):
        global_block = self.program.global_block()
        param = Parameter(global_block, *args, **kwargs)
        global_block.vars[param.name] = param
        self.program._bump_version()
        return param

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError('var %r not in block %d' % (name, self.idx))
        return v

    def has_var(self, name):
        return name in self.vars

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def var_recursive(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError('var %r not found (block %d)' % (name, self.idx))
        return v

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type=None, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        for names in op.outputs.values():
            for n in names:
                v = self._find_var_recursive(n)
                if v is not None and v.op is None:
                    v.op = op
        self.program._bump_version()
        return op

    def _prepend_op(self, type=None, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    prepend_op = _prepend_op

    def _insert_op(self, index, type=None, inputs=None, outputs=None,
                   attrs=None):
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def _remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def to_string(self, throw_on_error=False, with_details=False):
        lines = ['block %d (parent %d):' % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append('  ' + v.to_string())
        for op in self.ops:
            lines.append('  ' + op.to_string())
        return '\n'.join(lines)

    __repr__ = __str__ = lambda self: self.to_string()


class Program(object):
    """A list of Blocks; block 0 is the global block."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0

    def _bump_version(self):
        """Invalidate the executor's compile-cache entries of this
        program: the version is part of their key."""
        self._version += 1

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def create_block(self, parent_idx=None):
        """Append a sub-block whose parent is the current block (or
        ``parent_idx``) and make it current: the body of a control-flow
        op.  Its var lookups fall through to the parent blocks."""
        new_idx = len(self.blocks)
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.blocks.append(Block(self, new_idx, parent))
        self.current_block_idx = new_idx
        return self.current_block()

    def rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield v

    def all_parameters(self):
        return self.global_block().all_parameters()

    def clone(self, for_test=False):
        """Deep-copy the program, every block of it: a ``sub_block`` attr
        points at the copy's block, as one deepcopy memo covers both.
        With ``for_test=True``, ops behave in inference mode (is_test attr
        set on the ops that have one)."""
        p = copy.deepcopy(self)
        if for_test:
            for blk in p.blocks:
                for op in blk.ops:
                    if 'is_test' in _IS_TEST_OPS.get(op.type, ()):
                        op.attrs['is_test'] = True
        p._bump_version()
        return p

    def prune(self, targets):
        """A copy that keeps only the global block's ops needed to compute
        ``targets`` (and its feed/fetch ops)."""
        if not isinstance(targets, (list, tuple)):
            targets = [targets]
        needed = set(t.name if isinstance(t, Variable) else t
                     for t in targets)
        p = copy.deepcopy(self)
        blk = p.global_block()
        kept = []
        for op in reversed(blk.ops):
            if op.type == 'fetch' or set(op.output_arg_names) & needed:
                kept.append(op)
                needed.update(op.input_arg_names)
        blk.ops = list(reversed(kept))
        p._bump_version()
        return p

    def inference_optimize(self, prune_read_op=True):
        """``clone(for_test=True)``, its ``read`` ops dropped."""
        p = self.clone(for_test=True)
        if prune_read_op:
            blk = p.global_block()
            blk.ops = [op for op in blk.ops if op.type != 'read']
            p._bump_version()
        return p

    def serialize_to_string(self):
        """framework.proto ProgramDesc bytes (``proto_serde``), the
        reference's model contract."""
        from . import proto_serde
        return proto_serde.serialize_program(self)

    @staticmethod
    def parse_from_string(data):
        """A program from ProgramDesc bytes, or from the structural JSON of
        the JAX package's earlier artifacts (``program_serde``)."""
        if isinstance(data, str):
            data = data.encode('utf-8')
        if data[:1] == b'{':
            from . import program_serde
            return program_serde.deserialize_program(data)
        from . import proto_serde
        return proto_serde.deserialize_program(data)

    def to_string(self, throw_on_error=False, with_details=False):
        return '\n'.join(b.to_string() for b in self.blocks)

    __repr__ = __str__ = lambda self: self.to_string()


# ops whose clone(for_test) should set is_test
_IS_TEST_OPS = {
    'dropout': ('is_test', ),
    'batch_norm': ('is_test', ),
    'layer_norm': (),
}

# ----------------------------------------------------------------------------
# default programs + guards
# ----------------------------------------------------------------------------
_main_program_ = Program()
_startup_program_ = Program()


def default_startup_program():
    return _startup_program_


def default_main_program():
    return _main_program_


def switch_main_program(program):
    global _main_program_
    prev = _main_program_
    _main_program_ = program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev = _startup_program_
    _startup_program_ = program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_start = None
    if startup_program is not None:
        prev_start = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_start is not None:
            switch_startup_program(prev_start)


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """A scope of names for the ops built inside it, as the JAX package
    keeps it: the prefix is pushed for the block's duration and names
    nothing."""
    _name_scope_stack.append(prefix or '')
    try:
        yield
    finally:
        _name_scope_stack.pop()


def get_var(name, program=None):
    """The Variable ``name`` of ``program``'s global block (the default
    main program's); ValueError if it has none."""
    program = program if program is not None else default_main_program()
    v = program.global_block().vars.get(name)
    if v is None:
        raise ValueError('var %r not found in program' % name)
    return v
