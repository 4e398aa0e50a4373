"""Executor: plans a program block once, and on the card replays it as a
CUDA graph.

Counterpart of ``paddle_tpu/fluid/executor.py``, single device.  The JAX
package compiles each block once into one XLA executable; this executor
plans each block once and, on a CUDA place, captures it once as a CUDA
graph (``torch.cuda.graph``), the PyTorch counterpart of ``jax.jit``:

  1. prepare and validate the feeds against the data-layer declarations: a
     one-level LoD feed becomes a padded [B, T, ...] tensor, T from
     ``shape_policy.bucketed_len``, plus its int32 lengths under
     ``<name>@SEQLEN`` (the JAX package's lowering of LoD to static shapes);
  2. resolve the block in the compile cache, keyed as the JAX package keys
     it (program id and version, fetch names, feed signature, place, scope
     id, AMP mode), an LRU of 64 whose entries die with their program or
     scope; each miss counts in ``compile_count`` and builds a
     ``_CompiledBlock``: the op list and the persistable vars read before
     they are written (state in, taken from the scope) and those written
     (state out);
  3. run it.  On the CPU every op's lowering runs eagerly through
     ``registry.run_op``.  On the card the first call of a key runs eagerly
     too (it builds the hand-written kernels and sets up the libraries);
     the second captures the block as a CUDA graph and replays it; every
     later call copies the feeds into the graph's static feed buffers and
     replays.  The scope's tensors are the graph's state buffers: the graph
     ends by copying each new state value into its buffer, and a buffer
     that the scope no longer holds gets the scope's value copied in before
     the replay (or, at a new shape or dtype, the block is captured again).
     A block with a lowering the registry declares uncapturable runs
     eagerly, and its ``mode`` says why.  A host op (``chunk_eval``; the
     registry's host-op table) is such a lowering: the eager walk copies
     its inputs to the host, calls its numpy function, and puts its
     outputs back on the block's device;
  4. fetch to numpy (a copy: the next replay overwrites the graph's
     outputs; a bf16 fetch comes back as an ``ml_dtypes.bfloat16`` array,
     as the JAX package returns it); a sparse gradient (``SparseRows``) is
     fetched as a ``core.SelectedRows``, as the JAX package fetches it, and
     a tensor array as a ``core.LoDTensorArray``.  A fetch of a var whose
     only write is inside one ``conditional_block`` raises, as the
     reference's read of an uninitialized var does.

Each block frees every var after its last op (its release plan), except
the fetches, the state, the persistables and the vars its sub-blocks
touch: XLA's buffer assignment gives the JAX package's jitted blocks that
reuse.  A block that must run eagerly frees only the vars that
``memory_optimize`` marked (``program._releasable``), as the JAX package's
eager path does.  Inside a capture a freed tensor goes back to the graph's
own pool.

``run_multi`` runs K steps of a block and ``run_eval_multi`` K evaluation
lots, on the card as K replays with no host sync between them.
``memory_analysis`` gives a block's argument, output and temporary bytes
(the largest live total of its release plan), and under
``FLAGS_cost_accounting`` ``cost_report`` gives each block's FLOPs and
bytes (``trace.analyze_cost``).  ``FLAGS_check_nan_inf`` raises on a NaN
(an op's outputs, as it runs eagerly) or a NaN or Inf (the state and the
fetches after a run; each op's outputs in a block that runs eagerly);
``FLAGS_benchmark`` synchronizes and logs each run's milliseconds; while
``fluid.profiler`` is on, each ``run``, ``run_multi`` and
``run_eval_multi`` call records one slice.  ``purge_programs`` drops one
program's blocks (the serving engine's eviction), releasing their graphs
at the next resolve; ``close()`` releases every graph at once, and a
dropped executor frees its blocks with it (the cache's finalizers hold it
weakly).

Not ported yet: ``run_decode_multi`` and ``run_chunk_prefill`` (generation
serving),
``py_reader`` feeds, the host ops but ``chunk_eval`` and ``print``
(``save``, ``load``, ``save_combine``, ``load_combine``, the distributed and
detection ones), nested (two-level) LoD feeds, ``SelectedRows`` feeds and scope
values (the JAX package hands them only to host ops).
"""

import collections
import contextlib
import logging
import threading
import time
import weakref

import numpy as np
import torch

from . import core
from . import flags
from . import profiler as _profiler
from . import trace as _trace
from .framework import default_main_program, Variable
from .shape_policy import bucketed_len
from .. import ops as _ops  # noqa: F401  (registers the lowerings)
from ..ops import registry
from ..ops.sparse import SparseRows

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
    """Normalize a user feed dict to {name: torch tensor}: a LoD feed lowers
    to padded [B, T, ...] plus a ``<name>@SEQLEN`` int32 lengths entry, and a
    ``core.PaddedSequence`` (already lowered) feeds its data and lengths as
    the same pair."""
    feed_arrays = {}
    for name, value in feed.items():
        if isinstance(value, core.PaddedSequence):
            if value.rows is not None:
                raise NotImplementedError(
                    'feed %r: a nested PaddedSequence (rows=) needs the '
                    '@ROWS side-band, which comes with a later sequence '
                    'slice of the PyTorch port' % name)
            feed_arrays[name] = _as_tensor(value.data)
            feed_arrays[name + registry.SEQLEN_SUFFIX] = _as_tensor(
                value.lengths).to(torch.int32)
        elif isinstance(value, core.LoDTensor) and value.lod():
            if len(value.lod()) >= 2:
                raise NotImplementedError(
                    'feed %r: a nested (%d-level) LoD feed needs the '
                    '@ROWS side-band, which comes with a later sequence '
                    'slice of the PyTorch port' % (name, len(value.lod())))
            padded, lengths = _lod_to_padded(value)
            feed_arrays[name] = torch.from_numpy(padded)
            feed_arrays[name + registry.SEQLEN_SUFFIX] = torch.from_numpy(
                lengths)
        else:
            feed_arrays[name] = _as_tensor(value)
    return feed_arrays


def _lod_to_padded(lt):
    """Concatenated LoD tensor -> (padded [B, T, ...], int32 lengths [B]),
    numpy, with T = bucketed_len(longest row)."""
    data = lt.numpy()
    offsets = np.asarray(lt.lod()[-1], np.int64)
    lengths = (offsets[1:] - offsets[:-1]).astype(np.int32)
    b = len(lengths)
    t = bucketed_len(int(lengths.max()) if b else 0)
    out = np.zeros((b, t) + data.shape[1:], data.dtype)
    if b and len(data):
        # row i gets data[offsets[i]:offsets[i+1]]
        row = np.repeat(np.arange(b), lengths)
        pos = np.arange(len(data)) - np.repeat(offsets[:-1], lengths)
        out[row, pos] = data
    return out, lengths


def validate_feed(program, feed_arrays):
    """Fail fast with the var name and dims when a feed does not match its
    data-layer declaration."""
    block = program.block(0)
    for name, value in feed_arrays.items():
        if name.endswith(registry.SEQLEN_SUFFIX):
            continue  # lengths side-band of a LoD feed, not a data var
        var = block.vars.get(name)
        if var is None or not getattr(var, 'shape', None):
            continue
        shape = tuple(var.shape)
        got = tuple(value.shape)
        # a LoD feed arrives padded: one more (time) dim than declared
        lod = getattr(var, 'lod_level', 0) or 0
        ranks = (len(shape), ) if not lod else (len(shape) + 1, len(shape))
        if len(got) not in ranks:
            raise ValueError(
                'feed %r: expected rank %d (declared shape %s%s), got shape '
                '%s' % (name, ranks[0], shape,
                        ', lod_level=%d' % lod if lod else '', got))
        # declared dims must match aligned from the right (leading batch and
        # time dims are free; -1 dims are wildcards)
        for want, have in zip(reversed(shape), reversed(got)):
            if want is not None and want > 0 and want != have:
                raise ValueError(
                    'feed %r: dim mismatch, declared shape %s but got shape '
                    '%s' % (name, shape, got))


# ----------------------------------------------------------------------------
# feed-list helpers of run_multi and run_eval_multi (the JAX package's
# paddle_tpu/fluid/executor.py, on torch tensors)
# ----------------------------------------------------------------------------
def feed_signature(feed_arrays):
    """(name, shape, dtype) of every prepared feed, sorted by name: a LoD
    feed's padded T is in its shape, and T fixes the shapes that the
    ``recurrent`` loop and the LSTM lowering run at."""
    return tuple((n, tuple(v.shape), str(v.dtype))
                 for n, v in sorted(feed_arrays.items()))


def _stacked_signature(per_step):
    """feed_signature of the per-step feeds stacked on a leading K axis."""
    if per_step is None:
        return None
    return tuple((n, (len(per_step), ) + shape, dtype)
                 for n, shape, dtype in feed_signature(per_step[0]))


def check_feed_list_uniform(per_step, what='run_multi'):
    """Every prepared lot must share feed_list[0]'s names, shapes and
    dtypes: one block replays them all."""
    sig0 = feed_signature(per_step[0])
    for i, fa in enumerate(per_step[1:], 1):
        if feed_signature(fa) != sig0:
            raise ValueError(
                '%s: feed_list[%d] differs in names, shapes or dtypes from '
                'feed_list[0] — all batches must share one shape bucket '
                '(pad to it, or group batches by bucket)' % (what, i))


def check_feed_list_names(per_step, what):
    """Every lot must share feed_list[0]'s name set."""
    names0 = set(per_step[0])
    for i, fa in enumerate(per_step[1:], 1):
        if set(fa) != names0:
            raise ValueError(
                '%s: feed_list[%d] differs in names from feed_list[0]'
                % (what, i))


def normalize_trailing_feed_list(per_step):
    """Lots whose sequence feeds disagree on the padded time extent are
    padded with zeros on axis 1 up to ``bucketed_len(max extent)``.  Only
    feeds with a ``<name>@SEQLEN`` companion take part: their lowerings
    mask by the real lengths.  Mutates and returns ``per_step``."""
    names0 = per_step[0]
    for name in list(names0):
        if name.endswith(registry.SEQLEN_SUFFIX) or \
                (name + registry.SEQLEN_SUFFIX) not in names0:
            continue
        if any(fa[name].dim() < 2 for fa in per_step):
            continue
        extents = [int(fa[name].shape[1]) for fa in per_step]
        if len(set(extents)) == 1:
            continue
        t = bucketed_len(max(extents))
        for fa, e in zip(per_step, extents):
            if e != t:
                v = fa[name]
                out = torch.zeros((v.shape[0], t) + tuple(v.shape[2:]),
                                  dtype=v.dtype, device=v.device)
                out[:, :e] = v
                fa[name] = out
    return per_step


def prepare_feed_list(feed_list):
    """Normalize a run_multi feed_list: one prepared feed dict per step,
    uniform across steps.  Returns (steps, per_step)."""
    if not feed_list:
        raise ValueError('run_multi: feed_list is empty')
    per_step = [prepare_feed_arrays(dict(f)) for f in feed_list]
    check_feed_list_names(per_step, 'run_multi')
    normalize_trailing_feed_list(per_step)
    check_feed_list_uniform(per_step)
    return len(per_step), per_step


def stack_steps(vals):
    """Stack per-step feeds on a new leading K axis."""
    return torch.stack([_as_tensor(v) for v in vals])


def _lead(v):
    """Leading dim of a feed value (a torch tensor, a LoDTensor or anything
    numpy reads), None for a scalar."""
    if isinstance(v, torch.Tensor):
        shape = v.shape
    elif isinstance(v, core.LoDTensor):
        shape = v.shape()
    else:
        shape = np.shape(v)
    return int(shape[0]) if len(shape) >= 1 else None


def _pad_rows(fa, batch_names, target):
    """One lot with its batch feeds padded to ``target`` rows by repeating
    the last real row, and the ``registry.SAMPLE_MASK_NAME`` feed (1.0 a
    real row, 0.0 padding), so the mean lowerings count the real rows only.
    Returns (lot, real rows)."""
    rows = sorted({_lead(fa[n]) for n in batch_names
                   if _lead(fa[n]) is not None})
    if len(rows) != 1 or not rows[0]:
        raise ValueError('ragged lot is ambiguous or empty: batch feeds %s '
                         'have rows %s' % (sorted(batch_names), rows))
    b = rows[0]
    out = dict(fa)
    for n in batch_names:
        v = fa[n]
        if v.dim() >= 1 and b < target:
            out[n] = torch.cat(
                [v, v[-1:].expand((target - b, ) + tuple(v.shape[1:]))])
    mask = torch.zeros((target, ), dtype=torch.float32)
    mask[:b] = 1.0
    out[registry.SAMPLE_MASK_NAME] = mask
    return out, b


def normalize_ragged_feed_list(per_step):
    """When any lot is ragged (lots disagree in rows: a lot's rows are its
    largest leading dim), pad all of them to the largest with a sample mask
    so that one block runs them all.  The batch feeds are those whose rows
    vary across lots.  Returns (per_step, reals, target, batch_feed_names);
    ``reals`` is each lot's real row count, None when nothing was
    padded."""
    leads = [max([_lead(v) for v in fa.values() if _lead(v) is not None],
                 default=0) for fa in per_step]
    target = max(leads)
    if all(b == target for b in leads):
        return per_step, None, target, None
    batch_names = {
        n for n in per_step[0]
        if len({_lead(fa[n]) for fa in per_step}) > 1
    } or {n for n, v in per_step[0].items() if _lead(v) == leads[0]}
    batch_names = {n for n in batch_names if _lead(per_step[0][n]) is not None}
    padded = [_pad_rows(fa, batch_names, target) for fa in per_step]
    return ([p[0] for p in padded], [p[1] for p in padded], target,
            batch_names)


def fetch_batch_led(compiled, n):
    """Which of the ``n`` fetches carry the batch on dim 0 (recorded by the
    block's last run), all False before it ran."""
    return getattr(compiled, '_fetch_batch_led', None) or [False] * n


def convert_eval_fetches(stacked, reals, target, compiled, steps,
                         return_numpy):
    """The host half of run_eval_multi: each [K, ...] fetch, with the
    batch-led ones trimmed from the padded ``target`` rows back to each
    lot's real rows.  Equal real counts trim as one slice (still stacked);
    unequal ones come back as a list of K arrays."""
    led = fetch_batch_led(compiled, len(stacked))
    wrap = lambda a: a if return_numpy else core.LoDTensor(
        torch.from_numpy(np.ascontiguousarray(a)))
    out = []
    for arr, is_led in zip(stacked, led):
        a = np.asarray(arr)
        if reals is not None and is_led and a.ndim >= 2 \
                and a.shape[1] == target:
            if len(set(reals)) == 1:
                a = a[:, :reals[0]]
            else:
                out.append([wrap(a[i][:reals[i]]) for i in range(steps)])
                continue
        out.append(wrap(a))
    return out


def collect_cost_report(compiled_blocks):
    """The blocks' cost entries as ``cost_report()``'s list: one record per
    (kind, key), with its key's repr."""
    out = []
    for compiled in compiled_blocks:
        for key, entry in compiled.cost_entries().items():
            if entry is None:
                continue
            rec = dict(entry)
            rec['key'] = repr(key)
            out.append(rec)
    return out


# ----------------------------------------------------------------------------
# the compiled block
# ----------------------------------------------------------------------------
def to_numpy(tensor, name):
    """A fetched tensor as a numpy array; a bf16 one as an
    ``ml_dtypes.bfloat16`` array of the same bits, as the JAX package
    fetches it (numpy has no bfloat16 of its own)."""
    if tensor.dtype == torch.bfloat16:
        import ml_dtypes
        return tensor.detach().view(torch.int16).cpu().numpy().view(
            ml_dtypes.bfloat16)
    return tensor.detach().cpu().numpy()


def _floats(val):
    """The floating tensor a value holds (a sparse gradient's rows), or
    None."""
    if isinstance(val, SparseRows):
        val = val.values
    return val if isinstance(val, torch.Tensor) and \
        val.is_floating_point() else None


def _check_nan_inf(pairs, where):
    """FLAGS_check_nan_inf's scan after a run (and of each op's outputs in
    a block that runs eagerly): raises naming the first var that holds a
    NaN or an Inf, with the JAX package's message."""
    for name, val in pairs:
        val = _floats(val)
        if val is not None and not bool(torch.isfinite(val).all()):
            raise RuntimeError(
                'check_nan_inf: %s %r contains NaN/Inf' % (where, name))


def _run_host_op(ctx, op, scope):
    """One host op on the eager walk: its inputs and their ``@SEQLEN``
    side-bands copied to the host, its function called on them, and what
    it wrote put back on the block's device."""
    host_env = {}
    for n in op.input_arg_names:
        for k in (n, n + registry.SEQLEN_SUFFIX):
            if k in ctx.env:
                v = ctx.env[k]
                host_env[k] = to_numpy(v, k) if isinstance(
                    v, torch.Tensor) else v
    before = dict(host_env)
    hctx = registry.LoweringContext(ctx.block, host_env, core.CPUPlace())
    registry.get_host_op(op.type)(hctx, op, scope)
    for k, v in host_env.items():
        if before.get(k) is not v:
            ctx.env[k] = torch.as_tensor(np.asarray(v)).to(ctx.device)


def _check_op_nans(op, env):
    """FLAGS_check_nan_inf's check of one op's outputs as it runs: raises
    FloatingPointError naming the op on a NaN, as jax_debug_nans (which
    the flag turns on in the JAX package) names the primitive."""
    for name in op.output_arg_names:
        val = _floats(env.get(name))
        if val is not None and bool(torch.isnan(val).any()):
            raise FloatingPointError('invalid value (nan) encountered in %s'
                                     % op.type)


class MemoryStats(object):
    """``memory_analysis``'s result: the fields of the JAX package's
    ``CompiledMemoryStats`` that its callers read.  ``argument`` bytes are
    the state and the feeds a block reads, ``output`` bytes the state it
    writes and its fetches, ``temp`` bytes the largest total of the other
    vars live at once under the block's release plan."""

    generated_code_size_in_bytes = 0
    alias_size_in_bytes = 0

    def __init__(self, argument, output, temp):
        self.argument_size_in_bytes = int(argument)
        self.output_size_in_bytes = int(output)
        self.temp_size_in_bytes = int(temp)

    def __repr__(self):
        return ('MemoryStats(argument_size_in_bytes=%d, output_size_in_bytes'
                '=%d, temp_size_in_bytes=%d)' % (
                    self.argument_size_in_bytes, self.output_size_in_bytes,
                    self.temp_size_in_bytes))


def _nbytes(value):
    meta = registry.value_meta(value)
    return meta[1] if meta is not None else 0


def _feed_value(tensor, var_desc, device):
    if var_desc is not None and tensor.is_floating_point():
        want = var_desc.torch_dtype
        if want.is_floating_point and tensor.dtype != want:
            # feeding python floats / f64 arrays: trust the declared dtype
            tensor = tensor.to(want)
    return tensor.to(device)


# ops that run every branch and select: each keeps a written var's old
# value where its condition is false
_BLENDED = ('conditional_block', 'ifelse', 'switch_case')


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
        reads = list(op.input_arg_names)
        if op.type in _BLENDED:
            # blended control flow reads every written var's old value
            # (the cond-false blend): a persistable updated in a branch
            # arrives as state
            reads += op.output_arg_names
        for name in reads:
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


def _scope_tensor(scope, name):
    var = scope.find_var(name)
    value = None if var is None else var.value()
    if isinstance(value, core.LoDTensor):
        value = value.tensor()
    if value is None:
        raise RuntimeError('persistable var %r is not initialized in scope '
                           '— did you run the startup program?' % name)
    return value


def _state_value(scope, name, device):
    return _scope_tensor(scope, name).to(device)


class _GraphMemory(object):
    """What the graphs of one executor share: one memory pool, and the
    tensors made into state buffers (a scope tensor found here is taken as
    the next graph's buffer as it is, so a train program and its
    ``clone(for_test)`` over one scope read the same buffers).

    The graphs replay in any order, and a capture may take memory that an
    earlier graph freed inside its capture and still writes at its every
    replay.  So nothing that outlives a replay lives in the pool: every
    state buffer is allocated outside any capture, and a graph's fetches
    are copied out before another graph replays."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self._buffers = {}  # id -> weakref of a state buffer

    def renew(self):
        """A fresh pool for the captures to come.  The allocator retires a
        pool once the last graph using it is gone, and a capture into a
        retired pool fails; the graphs still alive keep the old one."""
        self.pool = torch.cuda.graph_pool_handle()

    def add(self, t):
        buffers, key = self._buffers, id(t)

        def forget(ref):
            if buffers.get(key) is ref:
                del buffers[key]

        buffers[key] = weakref.ref(t, forget)

    def owns(self, t, device):
        ref = self._buffers.get(id(t))
        return ref is not None and ref() is t and t.device == device and \
            t.is_contiguous()


class _CompiledBlock(object):
    """One planned block for a (program, feed signature, fetch list, place,
    scope) key, and on the card its CUDA graph.

    ``mode`` is 'graph' or 'eager', and ``why`` says why a block runs
    eagerly: the CPU place, or the first op whose lowering the registry
    declares uncapturable (``refusal``)."""

    def __init__(self, program, block_idx, feed_names, fetch_names, place,
                 memory=None):
        self.program = program
        self.block = program.block(block_idx)
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.place = place
        self.ops = [op for op in self.block.ops
                    if op.type not in ('feed', 'fetch')]
        self.state_in, self.state_out = _state_plan(
            self.block, self.ops, self.feed_names, self.fetch_names)
        out = set(self.state_out)
        self.state_rw = [n for n in self.state_in if n in out]
        self.state_ro = [n for n in self.state_in if n not in out]
        self.host_ops = sorted({op.type for op in self.ops
                                if registry.is_host_op_type(op.type)})
        self.refusal = None
        for op in self.ops:
            self.refusal = registry.capture_refusal(op)
            if self.refusal is not None:
                break
        if place.device.type != 'cuda':
            self.mode, self.why = 'eager', 'CPU place'
        elif self.refusal is not None:
            self.mode, self.why = 'eager', self.refusal
        else:
            self.mode, self.why = 'graph', None
        self._release = self._release_plan(program)
        self._memory = memory
        # one eager run's op records (registry.recording) and its argument
        # and output bytes: the cost entries and the memory stats
        self._records = None
        self._io_bytes = None
        self._cost_entries = {}
        self._batch_feed_names = None  # set by run_eval_multi's padding
        self.last_eval_cost = None
        self._fetch_batch_led = None
        # the (steps, stacked feed signature) pairs run_multi and
        # run_eval_multi have run: the JAX package compiles one executable
        # for each
        self.multi_steps_seen = set()
        self.eval_steps_seen = set()
        self.calls = 0
        self.captures = 0
        self.replays = 0
        self.last_ran = None  # 'eager', 'capture' or 'replay'
        self.captured_launches = {}
        self._graph = None

    def _release_plan(self, program):
        """{op index: names to drop after that op}, each name at the last op
        that reads or writes it.  A block without a capture refusal (one
        the JAX package jits) drops every name; one that must run eagerly
        only those ``memory_optimize`` marked.  Never a fetch, a state var,
        a persistable or a name that a sub-block touches."""
        from .transpiler.memory_optimization_transpiler import \
            _sub_block_names
        allowed = None
        if self.refusal is not None:
            allowed = getattr(program, '_releasable', None)
            if not allowed:
                return {}
        keep = set(self.fetch_names) | set(self.state_in) | \
            set(self.state_out)
        keep.update(v.name for v in program.list_vars() if v.persistable)
        _sub_block_names(self.block, keep)
        last = {}
        for i, op in enumerate(self.ops):
            for n in list(op.input_arg_names) + list(op.output_arg_names):
                last[n] = i
        plan = {}
        for n, i in last.items():
            if n not in keep and (allowed is None or n in allowed):
                plan.setdefault(i, []).append(n)
        return plan

    # ---- execution ----
    def _execute(self, env, generator, capturing=False, scope=None):
        """Every op over ``env``, each name dropped after its last use as
        the release plan says: (new state, fetches).  The first eager run
        of the block records its ops' shapes (``registry.recording``).  A
        host op gets ``scope``."""
        ctx = registry.LoweringContext(self.block, env, self.place,
                                       generator=generator)
        mask = env.get(registry.SAMPLE_MASK_NAME)
        if mask is not None:
            declared = self._batch_feed_names
            ctx.batch_led = {
                n for n in self.feed_names
                if (n in declared if declared is not None else
                    env[n].dim() >= 1 and env[n].shape[0] == mask.shape[0])}
        record = self._records is None and not capturing
        args = {n: _nbytes(v) for n, v in env.items()} if record else None
        check = flags.FLAGS.check_nan_inf and not capturing
        release = self._release
        with torch.no_grad(), (registry.recording() if record else
                               contextlib.nullcontext()) as records:
            for i, op in enumerate(self.ops):
                if registry.is_host_op_type(op.type):
                    # a host op skips run_op: its read of a conditionally
                    # uninitialized var raises here, and its write covers
                    # the var
                    registry.check_cond_uninit(ctx, op.input_arg_names,
                                               'host op %r' % op.type)
                    _run_host_op(ctx, op, scope)
                    ctx.cond_uninit.difference_update(op.output_arg_names)
                else:
                    registry.run_op(ctx, op)
                if check:
                    _check_op_nans(op, env)
                    if self.refusal is not None:
                        _check_nan_inf(
                            [(n, env[n]) for n in op.output_arg_names
                             if n in env], 'output of op %r' % op.type)
                for n in release.get(i, ()):
                    env.pop(n, None)
        self._fetch_batch_led = [n in ctx.batch_led for n in self.fetch_names]
        registry.check_cond_uninit(ctx, self.fetch_names, 'fetch')
        missing = [n for n in self.fetch_names if n not in env]
        if missing:
            raise ValueError('fetch %s: not fed, not computed by the '
                             'program, and not persistable' % missing)
        new_state = {n: env[n] for n in self.state_out if n in env}
        fetches = [env[n] for n in self.fetch_names]
        if record:
            outs = dict(new_state, **dict(zip(self.fetch_names, fetches)))
            self._records = records
            self._io_bytes = (sum(args.values()),
                              sum(_nbytes(v) for v in outs.values()), args)
        return new_state, fetches

    def _feeds_env(self, feeds, device):
        return {n: _feed_value(v, self.block._find_var_recursive(n), device)
                for n, v in feeds.items()}

    def _run_eager(self, scope, feeds, generator):
        device = self.place.device
        env = {n: _state_value(scope, n, device) for n in self.state_in}
        env.update(self._feeds_env(feeds, device))
        new_state, fetches = self._execute(env, generator, scope=scope)
        fetches = self._store(scope, new_state, fetches)
        self.last_ran = 'eager'
        return fetches

    def _store(self, scope, new_state, fetches):
        """Write an eager step's state into the scope.  A value whose scope
        tensor is a graph's state buffer of the same shape and dtype is
        copied into it, so that the graphs over the scope keep reading
        their buffers; a value or fetch that views such a buffer is cloned
        first, as the copies overwrite it."""
        mem = self._memory
        targets = {}
        if mem is not None:
            for n, v in new_state.items():
                var = scope.find_var(n)
                t = var.value() if var is not None else None
                if isinstance(t, core.LoDTensor):
                    t = t.tensor()
                if isinstance(t, torch.Tensor) and t is not v and \
                        mem.owns(t, self.place.device) and \
                        t.shape == v.shape and t.dtype == v.dtype:
                    targets[n] = t
        ptrs = {t.untyped_storage().data_ptr() for t in targets.values()}

        def own(v):
            return v.clone() if isinstance(v, torch.Tensor) and \
                v.untyped_storage().data_ptr() in ptrs else v

        if ptrs:
            fetches = [own(f) for f in fetches]
            new_state = {n: own(v) for n, v in new_state.items()}
        for name, value in new_state.items():
            if name in targets:
                targets[name].copy_(value)
            else:
                scope.var(name).set_value(value)
        return fetches

    def _capture(self, scope, feeds, generator):
        """Capture the block as a CUDA graph over the scope's state (made
        state buffers first where they are not yet), then replay it once."""
        device = self.place.device
        mem = self._memory
        if self._graph is not None:
            # a capture again (new state shapes): the old graph may have been
            # its pool's last user
            self._graph = None
            mem.renew()
        taken = set()

        def buffer(n):
            """The scope's tensor for ``n`` as a state buffer: a buffer of
            its own for each name, even where two names hold one tensor,
            allocated here, outside the capture's pool."""
            t = _state_value(scope, n, device)
            if not mem.owns(t, device) or id(t) in taken:
                t = t.clone(memory_format=torch.contiguous_format)
                mem.add(t)
                scope.var(n).set_value(t)
            taken.add(id(t))
            return t

        state = {n: buffer(n) for n in self.state_in}
        # state written before it is read: the eager call before every
        # capture left its value, and so its shape, in the scope
        outs = {n: buffer(n) for n in self.state_out if n not in state}
        feed_bufs = {n: v.clone(memory_format=torch.contiguous_format)
                     for n, v in self._feeds_env(feeds, device).items()}
        bufs = dict(state, **outs)
        rw = {bufs[n].untyped_storage().data_ptr() for n in bufs
              if n in self.state_rw or n in outs}
        graph = torch.cuda.CUDAGraph()
        # each replay draws afresh from the executor's generator
        graph.register_generator_state(generator)
        before = registry.counts()
        with torch.cuda.graph(graph, pool=mem.pool):
            env = dict(state)
            env.update(feed_bufs)
            new_state, fetches = self._execute(env, generator,
                                               capturing=True)

            def own(v, buf=None):
                # a value that views a buffer the copies below overwrite
                return v.clone() if isinstance(v, torch.Tensor) and \
                    v is not buf and v.untyped_storage().data_ptr() in rw \
                    else v

            fetches = [own(f) for f in fetches]
            new_state = {n: own(v, bufs[n]) for n, v in new_state.items()}
            for n, v in new_state.items():
                buf = bufs[n]
                if v.shape != buf.shape or v.dtype != buf.dtype:
                    raise RuntimeError(
                        'capture: the step turns state var %r from %s %s '
                        'into %s %s; a graph replays a fixed shape and dtype'
                        % (n, tuple(buf.shape), buf.dtype, tuple(v.shape),
                           v.dtype))
                if v is not buf:
                    buf.copy_(v)  # the counterpart of donating state_rw
        after = registry.counts()
        self.captured_launches = {k: after[k] - before.get(k, 0)
                                  for k in after
                                  if after[k] != before.get(k, 0)}
        self._graph = graph
        self._state_bufs = state
        self._feed_bufs = feed_bufs
        self._outs = {n: bufs[n] for n in self.state_out}
        self._fetch_outs = fetches
        self.captures += 1
        graph.replay()
        self._publish(scope)
        self.last_ran = 'capture'
        return fetches

    def _state_ready(self, scope):
        """Make every state buffer hold the scope's value: False when a
        value changed shape or dtype, and the block must be captured
        again."""
        for n, buf in self._state_bufs.items():
            t = _scope_tensor(scope, n)
            if t is buf:
                continue
            if tuple(t.shape) != tuple(buf.shape) or t.dtype != buf.dtype:
                return False
            # the scope's value was replaced (a hand-over, a re-run startup
            # program, an eager run): copy it in
            buf.copy_(t)
            scope.var(n).set_value(buf)
        return True

    def _publish(self, scope):
        for n, t in self._outs.items():
            var = scope.var(n)
            if var.value() is not t:
                var.set_value(t)

    def _replay(self):
        self._graph.replay()
        self.replays += 1

    def run(self, scope, feeds, generator, eager=False):
        """One step; returns the fetch tensors (on the card, the graph's
        own outputs after a capture or replay: copy before the next
        call).  ``eager`` runs the lowerings one by one whatever the mode:
        the path a block takes before its capture, to time beside it.
        Under FLAGS_check_nan_inf the state and the fetches of a block the
        JAX package would jit are scanned after the step."""
        fetches = self._run(scope, feeds, generator, eager)
        if flags.FLAGS.check_nan_inf and self.refusal is None:
            _check_nan_inf([(n, _scope_tensor(scope, n))
                            for n in self.state_out
                            if scope.find_var(n) is not None], 'state var')
            _check_nan_inf(zip(self.fetch_names, fetches), 'fetch')
        return fetches

    def _run(self, scope, feeds, generator, eager):
        self.calls += 1
        if eager or self.mode != 'graph':
            return self._run_eager(scope, feeds, generator)
        if self._graph is None:
            if self.calls == 1:
                # first call of the key: builds the kernels, sets up the
                # libraries, and leaves every state var in the scope
                return self._run_eager(scope, feeds, generator)
            return self._capture(scope, feeds, generator)
        if not self._state_ready(scope):
            return self._capture(scope, feeds, generator)
        for n, buf in self._feed_bufs.items():
            buf.copy_(feeds[n])
        self._replay()
        self._publish(scope)
        self.last_ran = 'replay'
        return self._fetch_outs

    # ---- memory and cost ----
    def analyze(self, scope, feeds):
        """Run the block once, eagerly, to record its ops' shapes, unless a
        run already did: on clones of the state it writes, with a
        generator of its own and nothing stored, so that the scope and
        the executor's random stream stay as they were."""
        if self._records is not None:
            return
        device = self.place.device
        rw = set(self.state_out)
        env = {n: _state_value(scope, n, device) for n in self.state_in}
        env = {n: v.clone() if n in rw else v for n, v in env.items()}
        env.update(self._feeds_env(feeds, device))
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
        self._execute(env, generator, scope=scope)

    def memory_stats(self):
        """MemoryStats of the recorded run: the argument and output bytes,
        and the largest total of the other vars live at once while the
        block's ops run under its release plan."""
        arg_bytes, out_bytes, args = self._io_bytes
        live = {}
        cur = peak = 0
        for i, (op, meta, _) in enumerate(self._records):
            for n in op.output_arg_names:
                if n in args or n not in meta:
                    continue
                cur += meta[n][1] - live.get(n, 0)
                live[n] = meta[n][1]
            peak = max(peak, cur)
            for n in self._release.get(i, ()):
                cur -= live.pop(n, 0)
        return MemoryStats(arg_bytes, out_bytes, peak)

    _COST_LOCK = threading.Lock()

    def capture_cost(self, kind, key, scope, feeds, steps=1):
        """Under FLAGS_cost_accounting, the block's cost entry for
        (``kind``, ``key``), made once (``trace.analyze_cost``)."""
        if not flags.FLAGS.cost_accounting:
            return None
        full_key = (kind, ) + tuple(key)
        with self._COST_LOCK:
            if full_key in self._cost_entries:
                return self._cost_entries[full_key]
        self.analyze(scope, feeds)
        entry = _trace.analyze_cost(self._records, kind=kind, steps=steps,
                                    fetch_names=self.fetch_names,
                                    memory=self.memory_stats())
        with self._COST_LOCK:
            return self._cost_entries.setdefault(full_key, entry)

    def cost_entries(self):
        """This block's cost-registry entries."""
        with self._COST_LOCK:
            return dict(self._cost_entries)

    def _check_multi(self, what, steps):
        if steps < 1:
            raise ValueError('%s: steps must be >= 1, got %r' % (what, steps))
        if self.host_ops:
            raise RuntimeError(
                '%s: the program contains host ops and cannot run as one '
                'on-device loop — use run() per step' % what)
        if self.refusal is not None:
            raise RuntimeError(
                '%s: the block cannot be captured (%s) and so cannot run as '
                'one replayed loop — use run() per step' %
                (what, self.refusal))

    def _steps(self, scope, feeds, per_step, generator, steps, each):
        """Drive ``steps`` steps; ``each(i, fetches)`` sees every step's
        fetches before the next step runs."""
        step_feeds = (lambda i: per_step[i]) if per_step is not None else \
            (lambda i: feeds)
        i = 0
        # eager steps, and on the card the steps up to a live graph
        while i < steps and (self.mode != 'graph' or self._graph is None
                             or i == 0):
            each(i, self.run(scope, step_feeds(i), generator))
            i += 1
        if i == steps:
            return
        # K replays back to back: the remaining lots go to the device in
        # one copy each, then into the feed buffers on the stream
        device = self.place.device
        if per_step is not None:
            stacked = {n: stack_steps([fa[n] for fa in per_step[i:]]).to(
                device) for n in self._feed_bufs}
        else:
            for n, buf in self._feed_bufs.items():
                buf.copy_(feeds[n])
        for j in range(i, steps):
            self.calls += 1
            if per_step is not None:
                for n, buf in self._feed_bufs.items():
                    buf.copy_(stacked[n][j - i])
            self._replay()
            self.last_ran = 'replay'
            each(j, self._fetch_outs)
        self._publish(scope)

    def run_multi(self, scope, feeds, generator, steps, per_step=None):
        """``steps`` training steps, each on ``feeds`` or on per_step[i];
        the scope ends as ``steps`` run() calls leave it.  Returns the last
        step's fetches."""
        self._check_multi('run_multi', steps)
        last = []

        def keep(i, fetches):
            last[:] = fetches

        self._steps(scope, feeds, per_step, generator, steps, keep)
        return last

    def run_eval_multi(self, scope, feeds, generator, steps, per_step=None,
                       host=True):
        """``steps`` evaluation steps; every step's fetches, stacked
        [K, ...], as numpy (``host=False``: the stacked tensors on the
        block's device, nothing synchronized).  On the card each step's
        fetches are copied on the device into a [K, ...] buffer, and the
        host copies once."""
        self._check_multi('run_eval_multi', steps)
        stacked = []

        def collect(i, fetches):
            if any(isinstance(f, SparseRows) for f in fetches):
                raise TypeError('run_eval_multi: a sparse gradient '
                                '(SelectedRows) cannot be stacked; fetch it '
                                'with run()')
            if not stacked:
                stacked.extend(
                    torch.empty((steps, ) + tuple(f.shape), dtype=f.dtype,
                                device=f.device) for f in fetches)
            for buf, f in zip(stacked, fetches):
                buf[i].copy_(f)

        self._steps(scope, feeds, per_step, generator, steps, collect)
        if not host:
            return stacked
        return [to_numpy(s, n) for s, n in zip(stacked, self.fetch_names)]

    def release(self):
        """Drop the graph and the buffers it holds."""
        self._graph = None
        self._state_bufs = self._feed_bufs = self._outs = None
        self._fetch_outs = None


class Executor(object):
    """Program runner on one place.

    ``Executor()`` with no place runs on ``CUDAPlace(0)``, the card, and
    raises when no CUDA card is present: it never falls back to the CPU.
    This differs on purpose from the JAX package, whose default place is
    ``CPUPlace()`` and whose ``CUDAPlace`` is an alias of ``TPUPlace``.  Pass
    ``CPUPlace()`` to run on the CPU (the kernels' plain versions), as the
    tests do.  On the card each block is captured as a CUDA graph at its
    second call.

    Random ops draw from one ``torch.Generator`` on the place's device,
    seeded from the ``random_seed`` of the first program this executor
    runs; every captured graph replays it afresh.
    """

    _CACHE_MAX = 64  # LRU bound; each entry pins its Program (stable ids)

    def __init__(self, place=None):
        self.place = place if place is not None else core.CUDAPlace(0)
        cuda = self.place.device.type == 'cuda'
        if cuda:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    'Executor(%r): no CUDA card is available (pass '
                    'CPUPlace() to run on the CPU)' % self.place)
            if self.place.device.index >= torch.cuda.device_count():
                raise RuntimeError('Executor(%r): only %d CUDA card(s)' %
                                   (self.place, torch.cuda.device_count()))
        self._memory = _GraphMemory() if cuda else None
        self._generator = None
        self._closed = False
        self._cache = collections.OrderedDict()
        # blocks purged while a capture may be running (their program or
        # scope died, or ``purge_programs``): released at the next resolve,
        # never inside a capture
        self._retired = []
        self._finalizers = {}
        # each cache miss is one plan (and on the card one capture to come)
        self.compile_count = 0
        self._cache_lock = threading.RLock()

    def _rng(self, program):
        if self._generator is None:
            g = torch.Generator(device=self.place.device)
            g.manual_seed(int(program.random_seed or 0) & 0xffffffffffffffff)
            self._generator = g
        return self._generator

    def _pin_cache_lifetime(self, obj):
        """Purge the cache entries keyed by id(obj) when obj dies, so that a
        recycled id never reaches a stale block.  The finalizer reaches the
        executor through a weak reference: a dropped executor's blocks (and
        their graphs) die with it, whatever programs and scopes live on."""
        oid = id(obj)
        fin = self._finalizers.get(oid)
        if fin is not None and fin.alive:
            return
        ref = weakref.ref(self)

        def _purge():
            exe = ref()
            if exe is None:
                return
            with exe._cache_lock:
                exe._finalizers.pop(oid, None)
                for k in [k for k in list(exe._cache)
                          if oid in (k[0], k[5])]:
                    exe._retired.append(exe._cache.pop(k))

        self._finalizers[oid] = weakref.finalize(obj, _purge)

    def purge_programs(self, programs):
        """Drop every cached block of ``programs`` (a list of Programs):
        their entries leave the cache at once (the next run of such a
        program plans and captures again, counting in ``compile_count``)
        and their graphs and state buffers are released at the next
        resolve, or by ``release_retired()``, never inside a capture.
        Returns the number of entries dropped.  Blocks of other programs
        stay: an executor shared between models keeps theirs."""
        pids = {id(p) for p in programs}
        with self._cache_lock:
            keys = [k for k in list(self._cache) if k[0] in pids]
            for k in keys:
                self._retired.append(self._cache.pop(k))
        return len(keys)

    def release_retired(self):
        """Release the graphs and state buffers of purged blocks now.  The
        caller makes sure that no capture on this executor's pool runs
        meanwhile (the serving engine calls it paused, under its dispatch
        gate)."""
        with self._cache_lock:
            retired, self._retired[:] = list(self._retired), []
        self._release(retired)
        return len(retired)

    def _release(self, blocks):
        """Release ``blocks``' graphs and buffers; when a graph went, the
        next capture takes a fresh pool (``_GraphMemory.renew``)."""
        graphs = any(c._graph is not None for c in blocks)
        for compiled in blocks:
            compiled.release()
        if graphs and self._memory is not None:
            self._memory.renew()

    def _resolve_and_compile(self, program, feed, fetch_list, scope):
        """Normalize the arguments, prepare and validate the feeds, and
        find (or plan) the cached block."""
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
        sig = feed_signature(feed_arrays)
        key = (id(program), program._version, tuple(fetch_names), sig,
               self.place, id(scope), registry.amp_enabled())
        self._pin_cache_lifetime(program)
        self._pin_cache_lifetime(scope)
        self.release_retired()
        with self._cache_lock:
            compiled = self._cache.get(key)
            if compiled is None:
                self.compile_count += 1
                compiled = _CompiledBlock(program, 0, [n for n, _, _ in sig],
                                          fetch_names, self.place,
                                          self._memory)
                self._cache[key] = compiled
                if len(self._cache) > self._CACHE_MAX:
                    self._release([self._cache.popitem(last=False)[1]])
            else:
                self._cache.move_to_end(key)
        return program, scope, feed_arrays, compiled

    def run(self,
            program=None,
            feed=None,
            fetch_list=None,
            feed_var_name='feed',
            fetch_var_name='fetch',
            scope=None,
            return_numpy=True,
            use_program_cache=False,
            eager=False):
        """Run the program's global block once.  ``use_program_cache`` is
        accepted and ignored, as in the JAX package: every block is
        cached.  ``eager`` runs the block's lowerings one by one even where
        it replays a graph: the path a block takes before its capture, to
        time and compare beside it (the port's own option)."""
        program, scope, feed_arrays, compiled = self._resolve_and_compile(
            program, feed, fetch_list, scope)
        rng = self._rng(program)
        go = lambda: compiled.run(scope, feed_arrays, rng, eager=eager)
        if _profiler.is_profiler_enabled() and not flags.FLAGS.benchmark:
            # one slice per run, covering the device's work
            with _profiler.record_block(
                    'executor_run/block0[%s]' %
                    (','.join(compiled.fetch_names) or 'nofetch')):
                fetches = go()
                self._sync()
        elif flags.FLAGS.benchmark:
            t0 = time.perf_counter()
            fetches = go()
            self._sync()
            logging.getLogger('paddle_tpu_torch').info(
                'FLAGS_benchmark: run %.3f ms, %d fetches',
                (time.perf_counter() - t0) * 1e3, len(fetches))
        else:
            fetches = go()
        compiled.capture_cost('run', (), scope, feed_arrays)
        return self._convert_fetches(fetches, return_numpy, compiled)

    def _sync(self):
        if self.place.device.type == 'cuda':
            torch.cuda.synchronize(self.place.device)

    def run_multi(self,
                  program=None,
                  feed=None,
                  fetch_list=None,
                  steps=1,
                  scope=None,
                  return_numpy=True,
                  feed_list=None,
                  reader=None,
                  embed_caches=None):
        """Run ``steps`` training steps and return the last step's fetches;
        the scope ends as ``steps`` run() calls would leave it.

        feed: one batch reused every step, OR feed_list: one batch per step,
        all of one shape bucket (``steps`` is then len(feed_list)).  On the
        card the steps are replays of the block's graph, back to back, each
        lot copied into the feed buffers on the stream."""
        if reader is not None:
            raise NotImplementedError(
                'run_multi(reader=...): py_reader is not ported to PyTorch '
                'yet (ROADMAP.md, Queue 1 item 3: layers/io)')
        if embed_caches:
            raise NotImplementedError(
                'run_multi(embed_caches=...): the distributed embedding tier '
                'is not ported to PyTorch yet (ROADMAP.md, Queue 1 item 9)')
        per_step = None
        if feed_list is not None:
            if feed is not None:
                raise ValueError('run_multi: pass feed OR feed_list')
            steps, per_step = prepare_feed_list(feed_list)
            feed = per_step[0]  # keys the compile signature
        program, scope, feed_arrays, compiled = self._resolve_and_compile(
            program, feed, fetch_list, scope)
        self._note_multi_compile(compiled.multi_steps_seen, steps, per_step)
        names = tuple(sorted(feed_arrays))
        cost_key = ((), names, int(steps)) if per_step is not None else \
            (names, (), int(steps))
        _trace.flight_recorder.record(
            'multi_dispatch', executor='Executor', steps=int(steps),
            fetch_names=list(compiled.fetch_names),
            trace_id=getattr(_trace.current(), 'trace_id', None))
        go = lambda: compiled.run_multi(scope, feed_arrays, self._rng(
            program), int(steps), per_step=per_step)
        if _profiler.is_profiler_enabled():
            with _profiler.record_block(
                    'executor_run_multi/block0[x%d]' % int(steps)):
                fetches = go()
                self._sync()
        else:
            fetches = go()
        compiled.capture_cost('multi', cost_key, scope, feed_arrays,
                              steps=steps)
        return self._convert_fetches(fetches, return_numpy, compiled)

    def _dispatch_eval_multi(self,
                             program=None,
                             feed=None,
                             fetch_list=None,
                             steps=None,
                             scope=None,
                             feed_list=None,
                             reader=None,
                             host=False):
        """The front half of run_eval_multi: resolve the block, pad ragged
        lots to one bucket, run the K steps, and return ``(stacked, reals,
        target, compiled, k)`` with ``stacked`` the [K, ...] fetch tensors
        on the block's device, nothing synchronized (``host=True``: numpy).
        The serving engine drives this, so that it delivers one dispatch
        while the card runs the next.  ``reals`` is each lot's real row
        count (None when nothing was padded), ``target`` the padded rows."""
        if reader is not None:
            raise NotImplementedError(
                'run_eval_multi(reader=...): py_reader is not ported to '
                'PyTorch yet (ROADMAP.md, Queue 1 item 3: layers/io)')
        reals, target, batch_feed_names, per_step = None, None, None, None
        if feed_list is not None:
            if feed is not None:
                raise ValueError('run_eval_multi: pass feed OR feed_list')
            if not feed_list:
                raise ValueError('run_eval_multi: feed_list is empty')
            per_step = [prepare_feed_arrays(dict(f)) for f in feed_list]
            check_feed_list_names(per_step, 'run_eval_multi')
            normalize_trailing_feed_list(per_step)
            per_step, reals, target, batch_feed_names = \
                normalize_ragged_feed_list(per_step)
            steps = len(per_step)
            check_feed_list_uniform(per_step, 'run_eval_multi')
            feed = per_step[0]
        elif steps is None:
            raise ValueError('run_eval_multi: pass steps= with feed=')
        steps = int(steps)
        program, scope, feed_arrays, compiled = self._resolve_and_compile(
            program, feed, fetch_list, scope)
        if batch_feed_names is not None and compiled._batch_feed_names is None:
            # fixed by the feed signature, which keys the block
            compiled._batch_feed_names = frozenset(batch_feed_names)
        self._note_multi_compile(compiled.eval_steps_seen, steps, per_step)
        names = tuple(sorted(feed_arrays))
        cost_key = ((), names, steps) if per_step is not None else \
            (names, (), steps)
        _trace.flight_recorder.record(
            'eval_dispatch', executor='Executor', steps=steps,
            fetch_names=list(compiled.fetch_names),
            trace_id=getattr(_trace.current(), 'trace_id', None))
        stacked = compiled.run_eval_multi(scope, feed_arrays,
                                          self._rng(program), steps,
                                          per_step=per_step, host=host)
        # under FLAGS_cost_accounting the serving engine reads this
        # dispatch's entry (its FLOPs over the dispatch's wall)
        compiled.last_eval_cost = compiled.capture_cost(
            'eval_multi', cost_key, scope, feed_arrays, steps=steps)
        return stacked, reals, target, compiled, steps

    def run_eval_multi(self,
                       program=None,
                       feed=None,
                       fetch_list=None,
                       steps=None,
                       scope=None,
                       return_numpy=True,
                       feed_list=None,
                       reader=None):
        """Run ``steps`` evaluation steps and return every step's fetches:
        one [K, ...] array per fetch, except a batch-led fetch over ragged
        lots of unequal real rows, which comes back as a list of K arrays
        trimmed to each lot's rows.

        feed: one batch evaluated ``steps`` times, OR feed_list: one lot per
        step.  Lots of other time extents are padded to one bucket, lots of
        other row counts to the largest with a sample mask, and trimmed on
        the way out."""

        def go():
            stacked, reals, target, compiled, k = self._dispatch_eval_multi(
                program, feed=feed, fetch_list=fetch_list, steps=steps,
                scope=scope, feed_list=feed_list, reader=reader, host=True)
            return convert_eval_fetches(stacked, reals, target, compiled,
                                        k, return_numpy)

        if _profiler.is_profiler_enabled():
            with _profiler.record_block('executor_run_eval_multi/block0'):
                return go()  # the fetches' copy to the host syncs
        return go()

    def memory_analysis(self, program=None, feed=None, fetch_list=None,
                        scope=None):
        """The block's memory plan for these feeds (they key the block, as
        a real run's do): a ``MemoryStats`` with ``temp_size_in_bytes``,
        the largest total of non-argument vars live at once under the
        block's release plan, ``argument_size_in_bytes`` and
        ``output_size_in_bytes``.  A block that has not run yet runs once,
        eagerly, on clones of its state (nothing is stored in the
        scope)."""
        program = program if program is not None else \
            default_main_program()
        if any(op.type == 'read' for op in program.block(0).ops):
            raise RuntimeError(
                'memory_analysis: the program is reader-fed; popping a '
                'py_reader batch here would silently drop a minibatch '
                'from training — pass representative arrays via feed= '
                'on a reader-free clone instead')
        program, scope, feed_arrays, compiled = self._resolve_and_compile(
            program, feed, fetch_list, scope)
        if compiled.host_ops:
            raise RuntimeError(
                'memory_analysis: the program contains host ops '
                '(%s) and runs on the eager path, which has no single '
                'compiled executable — remove them or analyse the '
                'compute-only portion' % compiled.host_ops)
        compiled.analyze(scope, feed_arrays)
        return compiled.memory_stats()

    def cost_report(self):
        """Every cached block's cost-registry entries, captured under
        FLAGS_cost_accounting: kind ('run', 'multi', 'eval_multi'),
        steps, FLOPs (total and per step), bytes accessed, and the memory
        stats' argument, output and temporary bytes."""
        with self._cache_lock:
            blocks = list(self._cache.values())
        return collect_cost_report(blocks)

    def _note_multi_compile(self, seen, steps, per_step):
        """Count a (steps, stacked feed signature) pair the block has not
        run yet in ``compile_count``: the JAX package compiles one
        executable for each, and the port keeps the counts equal."""
        key = (int(steps), _stacked_signature(per_step))
        if key not in seen:
            seen.add(key)
            self.compile_count += 1

    def _convert_fetches(self, fetches, return_numpy, compiled):
        """Fetch tensors -> numpy arrays (or LoDTensors), and a sparse
        gradient (``SparseRows``) -> a ``core.SelectedRows``.  What the
        caller gets is its own: a graph's outputs are overwritten by its
        next replay, and a state var fetched from an eager run may be
        updated in place by the next step (the sparse optimizers write the
        rows they touch into the table)."""
        graph_owned = compiled.last_ran in ('capture', 'replay')
        state = set(compiled.state_out)
        arrays = {n for n in compiled.fetch_names
                  if getattr(compiled.block._find_var_recursive(n), 'type',
                             None) == core.VarDesc.VarType.LOD_TENSOR_ARRAY}

        def own(t, name):
            return t.clone() if graph_owned or name in state else t

        def convert(f, name):
            if isinstance(f, list) or name in arrays:
                # a tensor array: its elements, each a LoDTensor on the host
                out = core.LoDTensorArray()
                for t in (f if isinstance(f, list) else f.unbind(0)):
                    out.append(core.LoDTensor(t.detach().cpu().clone()))
                return out
            if isinstance(f, SparseRows):
                sr = core.SelectedRows(rows=f.rows.cpu().tolist(),
                                       height=f.height)
                sr.get_tensor().set(f.values.detach().cpu().clone())
                return sr
            if return_numpy:
                a = to_numpy(f, name)
                return a.copy() if f.device.type == 'cpu' and \
                    name in state else a
            return core.LoDTensor(own(f, name))

        return [convert(f, n) for f, n in zip(fetches, compiled.fetch_names)]

    def cached_blocks(self):
        """The cached blocks, the least recently used first: each has its
        ``mode`` ('graph' or 'eager') and ``why``, its plan (``state_in``,
        ``state_out``), and its ``calls``, ``captures``,
        ``replays`` (those after the replay that ends each capture) and
        ``captured_launches`` (the registry counters a capture grew)."""
        with self._cache_lock:
            return list(self._cache.values())

    def close(self):
        """Drop the compile cache and every purged block, their graphs with
        them, and detach the cache's finalizers."""
        with self._cache_lock:
            self._release(list(self._cache.values()) + self._retired)
            self._cache.clear()
            del self._retired[:]
            finalizers, self._finalizers = self._finalizers, {}
        for fin in finalizers.values():
            fin.detach()
        self._closed = True
