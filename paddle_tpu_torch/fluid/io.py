"""Parameter and optimizer-state hand-over into the PyTorch port's scope."""

import numpy as np
import torch

from . import core
from .executor import global_scope

__all__ = ['params_from_numpy', 'persistables_from_numpy']


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
