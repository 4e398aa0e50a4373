"""Executor: runs a program block op by op on a torch device.

Counterpart of ``paddle_tpu/fluid/executor.py``, single device.  The JAX
package compiles a whole block into one XLA executable; this executor
interprets the block eagerly, one lowering per op (the JAX package's
``_run_eager`` path), in four steps:

  1. prepare and validate the feeds against the data-layer declarations;
  2. walk the ops in program order to find the persistable vars read before
     they are written (state in, taken from the scope) and those written
     (state out, stored back into the scope);
  3. run every op's lowering through ``registry.run_op``;
  4. fetch to numpy.

Not ported yet: the compile cache, multi-step dispatch (``run_multi``,
``run_eval_multi``), decode and chunked-prefill paths, host ops, LoD feeds.
"""

import contextlib

import numpy as np
import torch

from . import core
from .framework import default_main_program, Variable
from .. import ops as _ops  # noqa: F401  (registers the lowerings)
from ..ops import registry

__all__ = ['Executor', 'global_scope', 'scope_guard']

_scope_stack = [core.global_scope()]


def global_scope():
    """The active scope: scope_guard swaps it."""
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


def _as_tensor(value):
    if isinstance(value, core.LoDTensor):
        return value.tensor()
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value))


def prepare_feed_arrays(feed):
    """Normalize a user feed dict to {name: torch tensor} (dense feeds)."""
    return {name: _as_tensor(value) for name, value in feed.items()}


def validate_feed(program, feed_arrays):
    """Fail fast with the var name and dims when a feed does not match its
    data-layer declaration."""
    block = program.block(0)
    for name, value in feed_arrays.items():
        var = block.vars.get(name)
        if var is None or not getattr(var, 'shape', None):
            continue
        shape = tuple(var.shape)
        got = tuple(value.shape)
        if len(got) != len(shape):
            raise ValueError(
                'feed %r: expected rank %d (declared shape %s), got shape %s'
                % (name, len(shape), shape, got))
        # declared dims must match (-1 dims are wildcards)
        for want, have in zip(shape, got):
            if want is not None and want > 0 and want != have:
                raise ValueError(
                    'feed %r: dim mismatch, declared shape %s but got shape '
                    '%s' % (name, shape, got))


def _feed_value(tensor, var_desc, device):
    if var_desc is not None and tensor.is_floating_point():
        want = var_desc.torch_dtype
        if want.is_floating_point and tensor.dtype != want:
            # feeding python floats / f64 arrays: trust the declared dtype
            tensor = tensor.to(want)
    return tensor.to(device)


def _state_plan(block, ops, feed_names, fetch_names):
    """(state_in, state_out): persistable vars read before any op writes
    them, and persistable vars some op writes, in program order."""
    defined = set(feed_names)
    state_in = []
    state_out = []

    def persistable(name):
        v = block._find_var_recursive(name)
        return v is not None and v.persistable

    for op in ops:
        for name in op.input_arg_names:
            if name not in defined and persistable(name):
                state_in.append(name)
                defined.add(name)
        for name in op.output_arg_names:
            if persistable(name) and name not in state_out:
                state_out.append(name)
            defined.add(name)
    # fetching a persistable var that no op writes still needs its value
    for name in fetch_names:
        if name not in defined and persistable(name):
            state_in.append(name)
            defined.add(name)
    return state_in, state_out


def _state_value(scope, name, device):
    var = scope.find_var(name)
    value = None if var is None else var.value()
    if isinstance(value, core.LoDTensor):
        value = value.tensor()
    if value is None:
        raise RuntimeError('persistable var %r is not initialized in scope '
                           '— did you run the startup program?' % name)
    return value.to(device)


class Executor(object):
    """Program runner on one place.

    ``Executor()`` with no place runs on ``CUDAPlace(0)``, the card, and
    raises when no CUDA card is present: it never falls back to the CPU.
    This differs on purpose from the JAX package, whose default place is
    ``CPUPlace()`` and whose ``CUDAPlace`` is an alias of ``TPUPlace``.  Pass
    ``CPUPlace()`` to run on the CPU (the kernels' plain versions), as the
    tests do.

    Random ops draw from one ``torch.Generator`` on the place's device,
    seeded from the ``random_seed`` of the first program this executor
    runs.
    """

    def __init__(self, place=None):
        self.place = place if place is not None else core.CUDAPlace(0)
        if self.place.device.type == 'cuda':
            if not torch.cuda.is_available():
                raise RuntimeError(
                    'Executor(%r): no CUDA card is available (pass '
                    'CPUPlace() to run on the CPU)' % self.place)
            if self.place.device.index >= torch.cuda.device_count():
                raise RuntimeError('Executor(%r): only %d CUDA card(s)' %
                                   (self.place, torch.cuda.device_count()))
        self._generator = None
        self._closed = False

    def _rng(self, program):
        if self._generator is None:
            g = torch.Generator(device=self.place.device)
            g.manual_seed(int(program.random_seed or 0) & 0xffffffffffffffff)
            self._generator = g
        return self._generator

    def run(self,
            program=None,
            feed=None,
            fetch_list=None,
            feed_var_name='feed',
            fetch_var_name='fetch',
            scope=None,
            return_numpy=True,
            use_program_cache=False):
        if self._closed:
            raise RuntimeError('Attempted to use a closed Executor')
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_list = fetch_list if fetch_list is not None else []
        if isinstance(fetch_list, (Variable, str)):
            fetch_list = [fetch_list]
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list]
        feed_arrays = prepare_feed_arrays(dict(feed or {}))
        validate_feed(program, feed_arrays)

        block = program.global_block()
        ops = [op for op in block.ops if op.type not in ('feed', 'fetch')]
        state_in, state_out = _state_plan(block, ops, list(feed_arrays),
                                          fetch_names)
        device = self.place.device
        env = {n: _state_value(scope, n, device) for n in state_in}
        for name, value in feed_arrays.items():
            env[name] = _feed_value(value, block._find_var_recursive(name),
                                    device)
        ctx = registry.LoweringContext(block, env, self.place,
                                       generator=self._rng(program))
        with torch.no_grad():
            for op in ops:
                registry.run_op(ctx, op)
        for name in state_out:
            if name in env:
                scope.var(name).set_value(env[name])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise ValueError('fetch %s: not fed, not computed by the '
                             'program, and not persistable' % missing)
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [f.detach().cpu().numpy() for f in fetches]
        return [core.LoDTensor(f) for f in fetches]

    def close(self):
        self._closed = True
