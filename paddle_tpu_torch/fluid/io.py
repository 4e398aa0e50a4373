"""Parameter hand-over into the PyTorch port's scope."""

import numpy as np
import torch

from . import core
from .executor import global_scope

__all__ = ['params_from_numpy']


def params_from_numpy(program, arrays, scope=None, place=None):
    """Write ``program``'s parameters, given as ``{name: np.ndarray}`` (for
    example read from the JAX package's scope), into ``scope`` (the global
    scope by default) as tensors on ``place`` (``CUDAPlace(0)`` by default,
    as for ``Executor``).

    Raises ValueError, before writing anything, when a parameter of the
    program has no array, when an array names no parameter of the program,
    or when an array's shape or dtype differs from its parameter's."""
    scope = scope if scope is not None else global_scope()
    place = place if place is not None else core.CUDAPlace(0)
    params = {p.name: p for p in program.all_parameters()}
    missing = sorted(set(params) - set(arrays))
    unknown = sorted(set(arrays) - set(params))
    if missing or unknown:
        raise ValueError('params_from_numpy: parameters without an array: '
                         '%s; arrays naming no parameter: %s' %
                         (missing, unknown))
    staged = {}
    for name, param in params.items():
        arr = np.asarray(arrays[name])
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError('params_from_numpy: %r has shape %s, the '
                             'program declares %s' %
                             (name, tuple(arr.shape), tuple(param.shape)))
        if arr.dtype != param.np_dtype:
            raise ValueError('params_from_numpy: %r has dtype %s, the '
                             'program declares %s' %
                             (name, arr.dtype, param.np_dtype))
        staged[name] = arr
    for name, arr in staged.items():
        # a copy: the scope never aliases the caller's array
        scope.var(name).set_value(torch.tensor(arr, device=place.device))
