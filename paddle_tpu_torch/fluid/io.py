"""Model save/load and the parameter hand-over (counterpart of
``paddle_tpu/fluid/io.py``).

Scope tensors are written from, and read into, the executor's place:
each var as a version-0 LoDTensor stream (``proto_serde``), one file per
var or back to back in one combined file.  ``__model__`` holds
ProgramDesc protobuf bytes with embedded feed/fetch ops, byte for byte
what the JAX package writes, so a model saved by either package loads in
the other.  The JAX package's earlier artifacts (a JSON wrapper around a
structural-JSON program, npy and npz parameter files) load too.

``params_from_numpy`` and ``persistables_from_numpy`` hand numpy arrays
(for example the JAX package's scope) over to the port's scope.
"""

import json
import os

import numpy as np
import torch

from . import core
from . import proto_serde
from .framework import Program, Parameter, Variable, Operator, \
    default_main_program
from .executor import global_scope

__all__ = [
    'save_vars', 'save_params', 'save_persistables', 'load_vars',
    'load_params', 'load_persistables', 'save_inference_model',
    'load_inference_model', 'get_inference_program', 'params_from_numpy',
    'persistables_from_numpy',
]

_NON_TENSOR_KINDS = frozenset([
    core.VarDesc.VarType.FEED_MINIBATCH, core.VarDesc.VarType.FETCH_LIST,
    core.VarDesc.VarType.READER, core.VarDesc.VarType.RAW,
    core.VarDesc.VarType.STEP_SCOPES, core.VarDesc.VarType.CHANNEL,
])


def is_persistable(var):
    # readers and the feed/fetch holders are persistable but hold no tensor
    return var.persistable and getattr(var, 'type',
                                       None) not in _NON_TENSOR_KINDS


def is_parameter(var):
    return isinstance(var, Parameter)


def _scope_value(scope, name):
    var = scope.find_var(name)
    value = None if var is None else var.value()
    if isinstance(value, core.LoDTensor):
        value = value.tensor()
    if value is None:
        raise RuntimeError('variable %r has no value in scope' % name)
    return value


def _save_one(path, value):
    with open(path, 'wb') as f:
        f.write(proto_serde.serialize_lod_tensor(value))


def _load_one(path):
    with open(path, 'rb') as f:
        if f.read(6) == b'\x93NUMPY':  # an npy artifact
            f.seek(0)
            return torch.from_numpy(np.lib.format.read_array(f))
        f.seek(0)
        return proto_serde.read_lod_tensor(f)[0]


def check_tensor_matches_var(value, var, source):
    """A combined file's streams carry no names: each stream's dtype and
    dims must agree with the var it is read into."""
    got = core.convert_np_dtype_to_dtype_(value.dtype)
    if got != var.dtype:
        raise RuntimeError(
            '%s: dtype %s from file does not match var %r dtype %s' %
            (source, value.dtype, var.name,
             core.convert_dtype_to_torch(var.dtype)))
    want = tuple(var.shape or ())
    shape = tuple(value.shape)
    concrete_ok = len(shape) == len(want) and all(
        w in (-1, None) or int(w) == int(g) for w, g in zip(want, shape))
    if want and not concrete_ok:
        raise RuntimeError(
            '%s: shape %s from file does not match var %r shape %s' %
            (source, shape, var.name, want))


def _vars_of(main_program, vars, predicate):
    if vars is not None:
        return list(vars)
    if main_program is None:
        main_program = default_main_program()
    return list(filter(predicate, main_program.list_vars()))


def save_vars(executor,
              dirname,
              main_program=None,
              vars=None,
              predicate=None,
              filename=None):
    """Save the vars of ``main_program`` that ``predicate`` picks (or
    ``vars``) from the scope: a file each, or all in ``filename``."""
    vars = _vars_of(main_program, vars, predicate)
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    if filename is None:
        for var in vars:
            _save_one(os.path.join(dirname, var.name),
                      _scope_value(scope, var.name))
    else:
        # one stream after another, in var order
        with open(os.path.join(dirname, filename), 'wb') as f:
            for var in vars:
                f.write(proto_serde.serialize_lod_tensor(
                    _scope_value(scope, var.name)))


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program=main_program,
              predicate=is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program=main_program,
              predicate=is_persistable, filename=filename)


def load_vars(executor,
              dirname,
              main_program=None,
              vars=None,
              predicate=None,
              filename=None):
    """Load vars into the scope, as tensors on the executor's place."""
    vars = _vars_of(main_program, vars, predicate)
    scope = global_scope()
    device = executor.place.device
    put = lambda var, t: scope.var(var.name).set_value(t.to(device))
    if filename is None:
        for var in vars:
            put(var, _load_one(os.path.join(dirname, var.name)))
        return
    path = os.path.join(dirname, filename)
    with open(path, 'rb') as f:
        magic = f.read(2)
    if magic == b'PK':  # an npz artifact
        with np.load(path, allow_pickle=False) as blob:
            for var in vars:
                put(var, torch.from_numpy(blob[var.name]))
        return
    with open(path, 'rb') as f:
        for var in vars:
            value, _lod = proto_serde.read_lod_tensor(f)
            check_tensor_matches_var(value, var, path)
            put(var, value)


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program=main_program,
              predicate=is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program=main_program,
              predicate=is_persistable, filename=filename)


def get_inference_program(target_vars, main_program=None):
    if main_program is None:
        main_program = default_main_program()
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    return main_program.prune(targets=target_vars).inference_optimize()


def save_inference_model(dirname,
                         feeded_var_names,
                         target_vars,
                         executor,
                         main_program=None,
                         model_filename=None,
                         params_filename=None):
    """Prune ``main_program`` to ``target_vars``, save its persistables
    and write it, with feed and fetch ops, as ``__model__``.  Returns the
    fetch names."""
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    if main_program is None:
        main_program = default_main_program()
    os.makedirs(dirname, exist_ok=True)
    inference_program = main_program.prune(
        targets=target_vars).inference_optimize()
    fetch_var_names = [v.name for v in target_vars]
    # from the pruned program: a combined file is read back in the order
    # the loader walks that program's vars
    save_persistables(executor, dirname, inference_program, params_filename)
    _prepend_feed_ops(inference_program, list(feeded_var_names))
    _append_fetch_ops(inference_program, fetch_var_names)
    with open(os.path.join(dirname, model_filename or '__model__'),
              'wb') as f:
        f.write(inference_program.serialize_to_string())
    return fetch_var_names


def _prepend_feed_ops(program, feed_target_names, feed_holder='feed'):
    blk = program.global_block()
    blk.create_var(name=feed_holder,
                   type=core.VarDesc.VarType.FEED_MINIBATCH,
                   persistable=True)
    for i, name in enumerate(feed_target_names):
        blk.ops.insert(i, Operator(blk, 'feed', inputs={'X': [feed_holder]},
                                   outputs={'Out': [name]}, attrs={'col': i}))
    program._bump_version()


def _append_fetch_ops(program, fetch_target_names, fetch_holder='fetch'):
    blk = program.global_block()
    blk.create_var(name=fetch_holder,
                   type=core.VarDesc.VarType.FETCH_LIST,
                   persistable=True)
    for i, name in enumerate(fetch_target_names):
        blk.ops.append(Operator(blk, 'fetch', inputs={'X': [name]},
                                outputs={'Out': [fetch_holder]},
                                attrs={'col': i}))
    program._bump_version()


def _strip_feed_fetch_ops(program):
    """(feed names, fetch names) from the embedded feed/fetch ops, which
    are removed: the executor feeds and fetches by name."""
    blk = program.global_block()
    feeds, fetches, kept = {}, {}, []
    for op in blk.ops:
        if op.type == 'feed':
            feeds[op.attrs.get('col', len(feeds))] = op.output('Out')[0]
        elif op.type == 'fetch':
            fetches[op.attrs.get('col', len(fetches))] = op.input('X')[0]
        else:
            kept.append(op)
    blk.ops[:] = kept
    for holder in ('feed', 'fetch'):
        blk.vars.pop(holder, None)
    program._bump_version()
    return ([feeds[i] for i in sorted(feeds)],
            [fetches[i] for i in sorted(fetches)])


def load_inference_model(dirname,
                         executor,
                         model_filename=None,
                         params_filename=None):
    """(program, feed target names, fetch target Variables), the
    persistables loaded into the scope on the executor's place."""
    with open(os.path.join(dirname, model_filename or '__model__'),
              'rb') as f:
        data = f.read()
    if data[:1] == b'{':  # the JAX package's earlier JSON wrapper
        meta = json.loads(data.decode('utf-8'))
        program = Program.parse_from_string(meta['program'])
        feed_names = meta['feed_var_names']
        fetch_names = meta['fetch_var_names']
    else:
        program = Program.parse_from_string(data)
        feed_names, fetch_names = _strip_feed_fetch_ops(program)
    load_persistables(executor, dirname, program, params_filename)
    fetch_targets = [program.global_block().var(n) for n in fetch_names]
    return program, feed_names, fetch_targets


# ---- numpy hand-over ----
def params_from_numpy(program, arrays, scope=None, place=None):
    """Write ``program``'s parameters, given as ``{name: np.ndarray}`` (for
    example read from the JAX package's scope), into ``scope`` (the global
    scope by default) as tensors on ``place`` (``CUDAPlace(0)`` by default,
    as for ``Executor``).

    Raises ValueError, before writing anything, when a parameter of the
    program has no array, when an array names no parameter of the program,
    or when an array's shape or dtype differs from its parameter's."""
    _vars_from_numpy(program.all_parameters(), arrays, scope, place)


def persistables_from_numpy(program, arrays, scope=None, place=None):
    """``params_from_numpy`` over every persistable var of ``program``: the
    parameters and, in a training program, the optimizer's accumulators and
    learning rate."""
    _vars_from_numpy([v for v in program.list_vars() if v.persistable],
                     arrays, scope, place)


def _vars_from_numpy(variables, arrays, scope, place):
    scope = scope if scope is not None else global_scope()
    place = place if place is not None else core.CUDAPlace(0)
    declared = {v.name: v for v in variables}
    missing = sorted(set(declared) - set(arrays))
    unknown = sorted(set(arrays) - set(declared))
    if missing or unknown:
        raise ValueError('from_numpy: vars without an array: %s; arrays '
                         'naming no var: %s' % (missing, unknown))
    staged = {}
    for name, var in declared.items():
        arr = np.asarray(arrays[name])
        if tuple(arr.shape) != tuple(var.shape):
            raise ValueError('from_numpy: %r has shape %s, the program '
                             'declares %s' %
                             (name, tuple(arr.shape), tuple(var.shape)))
        if arr.dtype != var.np_dtype:
            raise ValueError('from_numpy: %r has dtype %s, the program '
                             'declares %s' % (name, arr.dtype, var.np_dtype))
        staged[name] = arr
    for name, arr in staged.items():
        # a copy: the scope never aliases the caller's array
        scope.var(name).set_value(torch.tensor(arr, device=place.device))
