"""Graph-level autodiff: append grad ops to the program (counterpart of
``paddle_tpu/fluid/backward.py``; the same grad-op graph, op for op).

Mirrors the reference's ``append_backward``
(python/paddle/fluid/backward.py:469): walks ops in reverse, synthesizes one
``<type>_grad`` op per forward op (the analog of C++ GradOpDescMakers,
framework/grad_op_desc_maker.h:34), renames duplicated gradient outputs and
inserts ``sum`` accumulation ops (_addup_repetitive_outputs_,
backward.py:135), and prunes branches that do not reach the loss
(_remove_no_grad_branch_, backward.py:204 — done here by only visiting ops
whose outputs carry gradients).

Grad ops are lowered by the generic torch.func.vjp machinery in
``paddle_tpu_torch.ops.registry`` unless an explicit grad lowering exists.
"""

import collections

import numpy as np

from . import core
from . import framework
from ..ops import registry

__all__ = ['append_backward', 'calc_gradient']

GRAD = framework.GRAD_VAR_SUFFIX


def _is_float_var(block, name):
    v = block._find_var_recursive(name)
    if v is None:
        return True  # temps default to fp32
    try:
        return np.issubdtype(v.np_dtype, np.floating)
    except Exception:
        return False


def _creates_subblock(op):
    return op.type in ('while', 'conditional_block', 'recurrent')


# op types that never get grad ops, regardless of connectivity
_NO_GRAD_OP_TYPES = {'read', 'feed', 'fetch', 'while', 'print',
                     'listen_and_serv'}


def _make_grad_op_spec(block, op, grad_known, no_grad):
    """Plan one grad op: (inputs, outputs, attrs) or None."""
    if op.type in _NO_GRAD_OP_TYPES:
        # a bounded While is reversible by the generic vjp (the analog of
        # the reference's WhileGradOpDescMaker); unbounded While is opaque
        if not (op.type == 'while' and op.attrs.get('max_trip_count')):
            return None
    out_grad_names = [n + GRAD for n in op.output_arg_names]
    if not any(g in grad_known for g in out_grad_names):
        return None
    inputs = {}
    for slot, names in op.inputs.items():
        inputs[slot] = list(names)
    for slot, names in op.outputs.items():
        inputs[slot] = list(names)
        inputs[slot + GRAD] = [n + GRAD for n in names]
    outputs = {}
    any_grad = False
    for slot, names in op.inputs.items():
        gnames = []
        for n in names:
            if n in no_grad or not _is_float_var(block, n):
                gnames.append('')
            else:
                gnames.append(n + GRAD)
                any_grad = True
        outputs[slot + GRAD] = gnames
    if not any_grad:
        return None
    attrs = dict(op.attrs)
    attrs[registry.FWD_IN_SLOTS_ATTR] = list(op.inputs.keys())
    attrs[registry.FWD_OUT_SLOTS_ATTR] = list(op.outputs.keys())
    return (op.type + '_grad', inputs, outputs, attrs)


def _dedup_grad_outputs(specs):
    """Rename multiply-written grad outputs and plan sum ops after the last
    contribution (reference _addup_repetitive_outputs_).

    Writes are grouped into LIVE RANGES: maximal runs of consecutive
    writes with no intervening reader of that grad name.  Only writes in
    the same run are fork contributions to rename-and-sum; a reader in
    between (e.g. a bounded While consuming its Out@GRAD before the
    snapshot assign's backward re-populates the same name for the
    pre-loop state) seals the run, and the next write is a fresh value,
    not an accumulation."""
    runs = collections.defaultdict(list)  # name -> list of runs
    open_run = {}  # name -> the currently open run (list of (idx, slot, i))
    for idx, (_, inputs, outputs, _) in enumerate(specs):
        reads = {n for names in inputs.values() for n in names if n}
        for n in reads:
            open_run.pop(n, None)  # a read seals the open run
        for slot, names in outputs.items():
            for i, n in enumerate(names):
                if not n:
                    continue
                run = open_run.get(n)
                if run is None:
                    run = []
                    runs[n].append(run)
                    open_run[n] = run
                run.append((idx, slot, i))
    sum_after = {}  # spec index -> list of (out_name, part_names)
    serial = collections.Counter()
    for name, run_list in runs.items():
        for run in run_list:
            if len(run) <= 1:
                continue
            parts = []
            for idx, slot, i in run:
                new_name = '%s@RENAME@%d' % (name, serial[name])
                serial[name] += 1
                specs[idx][2][slot][i] = new_name
                parts.append(new_name)
            last_idx = run[-1][0]
            sum_after[last_idx] = sum_after.get(last_idx, []) + [
                (name, parts)
            ]
    return specs, sum_after


def _append_grad_ops(block, fwd_ops, grad_known, no_grad, callbacks=None):
    """Append grad ops for fwd_ops (in reverse) into block.  Returns the set
    of grad var names produced."""
    specs = []
    known = set(grad_known)
    spec_src = []
    for op in reversed(fwd_ops):
        spec = _make_grad_op_spec(block, op, known, no_grad)
        if spec is None:
            continue
        specs.append([spec[0], spec[1], spec[2], spec[3]])
        spec_src.append(op)
        for names in spec[2].values():
            for n in names:
                if n:
                    known.add(n.split('@RENAME@')[0])
    specs, sum_after = _dedup_grad_outputs(specs)
    produced = set()
    for idx, (gtype, inputs, outputs, attrs) in enumerate(specs):
        gop = block.append_op(
            type=gtype, inputs=inputs, outputs=outputs, attrs=attrs)
        for names in outputs.values():
            for n in names:
                if n:
                    base = n.split('@RENAME@')[0]
                    produced.add(base)
                    _ensure_grad_var(block, n)
        if callbacks:
            for cb in callbacks:
                cb(block=block, context={'op': gop})
        for out_name, parts in sum_after.get(idx, []):
            block.append_op(
                type='sum',
                inputs={'X': parts},
                outputs={'Out': [out_name]})
            _ensure_grad_var(block, out_name)
            produced.add(out_name)
    return produced


def _ensure_grad_var(block, grad_name):
    if block.has_var(grad_name):
        return
    base = grad_name.split('@RENAME@')[0]
    fwd_name = base[:-len(GRAD)] if base.endswith(GRAD) else base
    fwd = block._find_var_recursive(fwd_name)
    block.create_var(
        name=grad_name,
        shape=fwd.shape if fwd is not None else (),
        dtype=fwd.dtype if fwd is not None else core.VarDesc.VarType.FP32,
        persistable=False)


def _collect_no_grad(program, no_grad_set):
    no_grad = set()
    if no_grad_set:
        no_grad.update(
            v.name if isinstance(v, framework.Variable) else v
            for v in no_grad_set)
    for v in program.list_vars():
        if v.stop_gradient:
            no_grad.add(v.name)
    return no_grad


def append_backward(loss,
                    parameter_list=None,
                    no_grad_set=None,
                    callbacks=None):
    """Append backward ops computing d(loss)/d(param) for every trainable
    parameter; returns [(param, grad_var)] (reference backward.py:469)."""
    program = loss.block.program
    block = program.global_block()
    no_grad = _collect_no_grad(program, no_grad_set)

    loss_grad = loss.name + GRAD
    block.append_op(
        type='fill_constant',
        inputs={},
        outputs={'Out': [loss_grad]},
        attrs={
            'shape': list(loss.shape) or [1],
            'value': 1.0,
            'dtype': loss.dtype,
            'op_role': 'backward',
        })
    _ensure_grad_var(block, loss_grad)

    # every op before the loss-grad fill we just appended is a forward op
    fwd_ops = list(block.ops[:-1])
    _append_grad_ops(block, fwd_ops, {loss_grad}, no_grad, callbacks)

    if parameter_list is not None:
        params = [
            block.var_recursive(p) if not isinstance(p, framework.Variable)
            else p for p in parameter_list
        ]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    params_and_grads = []
    for p in params:
        gname = p.name + GRAD
        if block.has_var(gname):
            params_and_grads.append((p, block.var(gname)))
    return params_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of targets w.r.t. inputs (reference backward.py:685)."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    program = targets[0].block.program
    block = program.global_block()
    no_grad = _collect_no_grad(program, no_grad_set)

    n_fwd = len(block.ops)
    seed = set()
    for t, tg in zip(targets, target_gradients):
        gname = t.name + GRAD
        if tg is None:
            block.append_op(
                type='fill_constant',
                inputs={},
                outputs={'Out': [gname]},
                attrs={
                    'shape': list(t.shape) or [1],
                    'value': 1.0,
                    'dtype': t.dtype
                })
        else:
            block.append_op(
                type='assign',
                inputs={'X': [tg.name]},
                outputs={'Out': [gname]})
        _ensure_grad_var(block, gname)
        seed.add(gname)

    _append_grad_ops(block, block.ops[:n_fwd], seed, no_grad)

    grads = []
    for iv in inputs:
        gname = iv.name + GRAD
        grads.append(block.var(gname) if block.has_var(gname) else None)
    return grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
