"""Typed module-level flags with environment-variable bootstrap.

Counterpart of ``paddle_tpu/fluid/flags.py``: the same registry, the same
flag names and defaults, and the same ``FLAGS_<name>`` environment variables,
so launcher scripts keep working.  ``check_nan_inf``, ``benchmark`` and
``cost_accounting`` act in the executor as in the JAX package (each help
text says how); ``xla_compile_cache_dir`` names XLA's cache there and is
accepted here and inert, as its help text says.  ``fused_lstm`` keeps its
values and its validation, with the card's own policy (see its help text
and ``ops/sequence_ops.py:_fused_lstm_ok``).
"""

import os

__all__ = ['DEFINE_bool', 'DEFINE_int32', 'DEFINE_double', 'DEFINE_string',
           'get_flag', 'set_flag', 'on_set', 'try_from_env', 'FLAGS',
           'TRYFROMENV']

_TRUE = ('1', 'true', 'yes', 'on')
_FALSE = ('0', 'false', 'no', 'off', '')


class _Flag(object):
    __slots__ = ('name', 'type', 'value', 'default', 'help', 'on_set')

    def __init__(self, name, type_, default, help_, on_set=None):
        self.name = name
        self.type = type_
        self.value = default
        self.default = default
        self.help = help_
        self.on_set = on_set


_registry = {}


def _define(name, type_, default, help_, on_set=None):
    if name in _registry:
        raise ValueError('flag %r already defined' % name)
    _registry[name] = _Flag(name, type_, default, help_, on_set)


def DEFINE_bool(name, default, help_=''):
    _define(name, bool, default, help_)


def DEFINE_int32(name, default, help_=''):
    _define(name, int, default, help_)


def DEFINE_double(name, default, help_=''):
    _define(name, float, default, help_)


def DEFINE_string(name, default, help_=''):
    _define(name, str, default, help_)


def _coerce(flag, value):
    if flag.type is bool:
        if isinstance(value, str):
            v = value.strip().lower()
            if v in _TRUE:
                return True
            if v in _FALSE:
                return False
            raise ValueError('invalid bool for flag %r: %r'
                             % (flag.name, value))
        return bool(value)
    return flag.type(value)


def get_flag(name):
    return _registry[name].value


def set_flag(name, value):
    flag = _registry[name]
    new = _coerce(flag, value)
    # on_set doubles as validator: a raise must leave the old value
    if flag.on_set is not None:
        flag.on_set(new)
    flag.value = new


def on_set(name, fn):
    """Attach a side-effect callback invoked on every set (and once now if
    the flag already differs from its default)."""
    flag = _registry[name]
    flag.on_set = fn
    if flag.value != flag.default:
        fn(flag.value)


def try_from_env(names):
    """Read ``FLAGS_<name>`` env vars for each whitelisted name: absent vars
    keep defaults, present ones are parsed per the flag's type."""
    for name in names:
        env = os.environ.get('FLAGS_' + name)
        if env is not None:
            set_flag(name, env)


class _FlagsView(object):
    """Attribute-style access mirroring gflags' FLAGS object."""

    def __getattr__(self, name):
        try:
            return _registry[name].value
        except KeyError:
            raise AttributeError('no flag named %r' % name)

    def __setattr__(self, name, value):
        set_flag(name, value)


FLAGS = _FlagsView()

# ---------------------------------------------------------------------------
# The flag set: the JAX package's names and defaults.  Flags whose effect is
# XLA's are accepted and inert here, and say so.
# ---------------------------------------------------------------------------

DEFINE_bool('check_nan_inf', False,
            'Raise on a NaN in an op\'s outputs as it runs eagerly '
            '(FloatingPointError naming the op, as jax_debug_nans names '
            'the primitive), and on a NaN or Inf in the state vars and '
            'fetches after a run and in each op\'s outputs in a block that '
            'runs eagerly (RuntimeError naming the var).')
DEFINE_bool('cpu_deterministic', False,
            'Force deterministic execution (accepted for launcher parity).')
DEFINE_bool('cudnn_deterministic', False,
            'Accepted for launcher parity; an alias of cpu_deterministic.')
DEFINE_bool('benchmark', False,
            'Synchronize after each Executor.run and log its wall time in '
            'milliseconds (logger paddle_tpu_torch, level INFO).')
DEFINE_double('fraction_of_gpu_memory_to_use', 0.92,
              'Inert: device memory belongs to PyTorch\'s caching allocator.')
DEFINE_bool('use_pinned_memory', True,
            'Accepted for launcher parity (host staging pool of the JAX '
            'package).')
DEFINE_bool('init_allocated_mem', False,
            'Accepted for launcher parity (host staging pool of the JAX '
            'package).')
DEFINE_bool('free_idle_memory', False,
            'Accepted for launcher parity (host staging pool of the JAX '
            'package).')
DEFINE_int32('paddle_num_threads', 1,
             'Host-side worker threads for readers and host ops.')
DEFINE_int32('rpc_deadline', 180000,
             'Distributed control-plane timeout in ms.')
DEFINE_bool('eager_delete_scope', True,
            'Drop executor kid scopes eagerly (scope lifetimes are '
            'Python-managed here; kept for launcher parity).')
DEFINE_string('xla_compile_cache_dir', '',
              'Inert in the PyTorch port: in the JAX package it names the '
              'persistent XLA compilation cache.')
DEFINE_bool('cost_accounting', False,
            'Record each executed block\'s cost entry once per key '
            '(FLOPs counted from its ops\' shapes, bytes accessed, memory '
            'stats) for Executor.cost_report().')
DEFINE_string('fused_lstm', 'auto',
              "lstm-op recurrence impl: on a CUDA place 'auto' and 'always' "
              'run the hand-written LSTM kernels (ops/kernels/lstm.py) for '
              'an eligible op (no peepholes, sigmoid/tanh/tanh, a width and '
              "batch the kernels take) and 'never' runs the step-by-step "
              "scan path; on the CPU 'auto' and 'never' run the scan path "
              "and 'always' the kernels' plain version.  An ineligible op "
              'runs the scan path in every mode.')


def _validate_fused_lstm(value):
    if value not in ('auto', 'never', 'always'):
        raise ValueError(
            "FLAGS_fused_lstm must be 'auto', 'never' or 'always' "
            '(got %r)' % (value, ))


on_set('fused_lstm', _validate_fused_lstm)

# every flag defined above may come from the environment
TRYFROMENV = tuple(sorted(_registry))
