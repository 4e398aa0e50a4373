"""Float16Transpiler (counterpart of
``paddle_tpu/fluid/transpiler/float16_transpiler.py``).

Rewrites an f32 inference program to run in half precision, bfloat16 by
default or float16: every f32 persistable in the scope is cast to the half
dtype under the name ``<name>.fp16``, each f32 feed target gets a cast to
half after its feed, each f32 fetch target's producer writes a half var
that a cast turns back into the f32 target, and op inputs are renamed.
Callers feed and fetch f32 as before.  Batch norm's inputs keep f32 (the
reference's one exclusion): run ``InferenceTranspiler`` first to fold it.
Dtypes are read as torch dtypes (``Variable.torch_dtype``): numpy has no
bfloat16 here.
"""

import torch

from .. import core
from ..executor import global_scope

__all__ = ['Float16Transpiler']

_HALF_SUFFIX = '.fp16'
_HALF = {'bfloat16': torch.bfloat16, 'bf16': torch.bfloat16,
         'float16': torch.float16, 'fp16': torch.float16}


class Float16Transpiler(object):
    def transpile(self, program, place=None, scope=None, dtype='bfloat16',
                  feeded_var_names=None, fetch_var_names=None):
        """Rewrite ``program`` in place and convert the scope's params.

        feeded_var_names / fetch_var_names: needed for a program from
        ``load_inference_model``, which strips the embedded feed and fetch
        ops and returns their names; a program that still has them needs
        neither."""
        if scope is None:
            scope = global_scope()
        if dtype not in _HALF:
            raise ValueError('half dtype must be bfloat16 or float16, '
                             'got %r' % (dtype, ))
        self._half = _HALF[dtype]
        self.scope = scope
        self.block = program.global_block()
        self.input_map = {}

        def _name(v):  # load_inference_model returns fetch Variables
            return v.name if hasattr(v, 'name') else str(v)

        feeds = [_name(v) for v in (feeded_var_names or [])]
        fetches = [_name(v) for v in (fetch_var_names or [])]
        for op in self.block.ops:
            if op.type == 'feed':
                feeds.append(op.output('Out')[0])
            elif op.type == 'fetch':
                fetches.append(op.input('X')[0])

        self._convert_params()
        self._cast_feeds(feeds)
        self._cast_fetches(fetches)
        self._adjust_input()
        self._remove_unused_vars()
        program._bump_version()
        return program

    def _no_conversion_names(self):
        """batch_norm's inputs stay f32."""
        names = set()
        for op in self.block.ops:
            if op.type == 'batch_norm':
                names.update(op.input_arg_names)
        return names

    def _scope_tensor(self, name):
        var = self.scope.find_var(name)
        value = None if var is None else var.value()
        return value.tensor() if isinstance(value, core.LoDTensor) else value

    def _convert_params(self):
        no_convert = self._no_conversion_names()
        for name in list(self.block.vars):
            var = self.block.vars[name]
            if not var.persistable or name in no_convert:
                continue
            value = self._scope_tensor(name)
            if value is None or value.dtype != torch.float32:
                continue
            half_name = name + _HALF_SUFFIX
            self.block.create_var(name=half_name, shape=var.shape,
                                  dtype=self._half, persistable=True)
            self.scope.var(half_name).set_value(value.to(self._half))
            self.input_map[name] = half_name
            del self.block.vars[name]

    def _half_var(self, var):
        return self.block.create_var(name=var.name + _HALF_SUFFIX,
                                     shape=var.shape, dtype=self._half,
                                     persistable=False)

    def _cast_feeds(self, feeds):
        for name in dict.fromkeys(feeds):
            var = self.block.vars.get(name)
            if var is None or var.torch_dtype != torch.float32:
                continue  # integer id feeds stay as they are
            half_var = self._half_var(var)
            # right after the feed op when embedded, else at the start
            pos = 0
            for i, op in enumerate(self.block.ops):
                if op.type == 'feed' and op.output('Out')[0] == name:
                    pos = i + 1
                    break
            self.block._insert_op(
                pos, type='cast', inputs={'X': [name]},
                outputs={'Out': [half_var.name]},
                attrs={'in_dtype': var.dtype, 'out_dtype': half_var.dtype})
            self.input_map[name] = half_var.name

    def _cast_fetches(self, fetches):
        for name in dict.fromkeys(fetches):
            var = self.block.vars.get(name)
            if var is None or var.torch_dtype != torch.float32:
                continue
            half_var = self._half_var(var)
            producer = None
            for i, op in enumerate(self.block.ops):
                if name in op.output_arg_names and op.type != 'cast':
                    producer = i
            if producer is None:
                continue
            self.block.ops[producer].rename_output(name, half_var.name)
            # right after the producer, so that later readers (an embedded
            # fetch op among them) read the f32 var written
            self.block._insert_op(
                producer + 1, type='cast', inputs={'X': [half_var.name]},
                outputs={'Out': [name]},
                attrs={'in_dtype': half_var.dtype, 'out_dtype': var.dtype})

    def _adjust_input(self):
        for op in self.block.ops:
            if op.type == 'cast':
                continue  # the inserted casts keep their f32 inputs
            for arg in list(op.input_arg_names):
                if arg in self.input_map:
                    op.rename_input(arg, self.input_map[arg])

    def _remove_unused_vars(self):
        used = set()
        for op in self.block.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
        for name in list(self.block.vars):
            if name not in used and not self.block.vars[name].persistable:
                del self.block.vars[name]
