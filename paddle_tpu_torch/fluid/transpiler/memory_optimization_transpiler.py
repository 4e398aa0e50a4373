"""memory_optimize and release_memory (counterpart of
``paddle_tpu/fluid/transpiler/memory_optimization_transpiler.py``).

The pass marks which vars of a program may be freed once their last use
has passed: ``program._releasable``, the names the global block's ops read
or write that are neither persistable, nor skipped by the caller, nor
touched anywhere inside a sub-block (their reads and writes do not appear
in the global block's op lists).  ``program._memory_optimize_stats``
counts them.

The executor (``fluid/executor.py``, ``_CompiledBlock``) drops each name
from its environment after its last op.  A block that the JAX package
jits (here: one with no capture refusal) does so for every name the pass
would mark, with or without the pass, as XLA's buffer assignment gives the
JAX package that reuse; a block that must run eagerly frees only the names
in ``program._releasable``, as the JAX package's eager path does.  Results
are unchanged: dropping a name only drops a reference.
"""

from ..framework import default_main_program

__all__ = ['memory_optimize', 'release_memory']


def _liveness(program):
    block = program.global_block()
    last_use = {}
    first_def = {}
    for idx, op in enumerate(block.ops):
        for name in op.input_arg_names:
            last_use[name] = idx
        for name in op.output_arg_names:
            first_def.setdefault(name, idx)
            last_use[name] = idx
    return first_def, last_use


def _sub_block_names(block, acc):
    """Every var name read or written inside the sub-blocks of ``block``'s
    ops, at any depth, added to ``acc``."""
    for op in block.ops:
        sub = op.attrs.get('sub_block') if op.attrs else None
        if sub is not None:
            for sop in sub.ops:
                acc.update(sop.input_arg_names)
                acc.update(sop.output_arg_names)
            _sub_block_names(sub, acc)
    return acc


def _protected(program, skip_opt_set):
    """Names never released: persistables (scope state), explicit skips,
    and every name touched inside a sub-block."""
    keep = set(skip_opt_set or ())
    for var in program.list_vars():
        if getattr(var, 'persistable', False):
            keep.add(var.name)
    _sub_block_names(program.global_block(), keep)
    return keep


def memory_optimize(input_program=None,
                    skip_opt_set=None,
                    print_log=False,
                    level=0):
    """Mark the program's releasable vars; a changed set bumps the
    program's version, so a block cached before the pass is planned
    again."""
    program = input_program or default_main_program()
    first_def, last_use = _liveness(program)
    keep = _protected(program, skip_opt_set)

    releasable = frozenset(n for n in last_use if n not in keep)
    if getattr(program, '_releasable', None) != releasable:
        program._releasable = releasable
        program._bump_version()

    stats = {
        'num_vars': len(first_def),
        'releasable': len(releasable),
        'protected': len(keep),
    }
    program._memory_optimize_stats = stats
    if print_log:
        print('memory_optimize: %(num_vars)d vars, %(releasable)d '
              'releasable, %(protected)d protected' % stats)
    return program


def release_memory(input_program=None, skip_opt_set=None):
    """memory_optimize's release marking (the reference inserted delete_var
    ops at last use; the executor applies the marking)."""
    return memory_optimize(input_program, skip_opt_set=skip_opt_set)
