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
     eagerly, and its ``mode`` says why;
  4. fetch to numpy (a copy: the next replay overwrites the graph's
     outputs; numpy has no bfloat16, so a bf16 fetch raises unless
     ``return_numpy=False`` asks for the tensor); a sparse gradient
     (``SparseRows``) is fetched as a ``core.SelectedRows``, as the JAX
     package fetches it.

``run_multi`` runs K steps of a block and ``run_eval_multi`` K evaluation
lots, on the card as K replays with no host sync between them.

Not ported yet: ``run_decode_multi`` and ``run_chunk_prefill`` (serving),
``memory_analysis`` and the cost report, ``FLAGS_benchmark`` and the
profiler's run slices, ``py_reader`` feeds, host ops, nested (two-level)
LoD feeds, ``SelectedRows`` feeds and scope values (the JAX package hands
them only to host ops).
"""

import collections
import contextlib
import threading
import weakref

import numpy as np
import torch

from . import core
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
    to padded [B, T, ...] plus a ``<name>@SEQLEN`` int32 lengths entry."""
    feed_arrays = {}
    for name, value in feed.items():
        if isinstance(value, core.LoDTensor) and value.lod():
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
    """Leading dim of a feed value, None for a scalar."""
    return int(v.shape[0]) if v.dim() >= 1 else None


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


# ----------------------------------------------------------------------------
# the compiled block
# ----------------------------------------------------------------------------
def to_numpy(tensor, name):
    """A fetched tensor as a numpy array.  numpy has no bfloat16: a bf16
    fetch raises rather than hand back its bits as another type."""
    if tensor.dtype == torch.bfloat16:
        raise TypeError(
            'fetch %r: a bfloat16 value has no numpy form; fetch it with '
            'return_numpy=False (a LoDTensor over the torch tensor), or '
            'cast it to float32 in the program (Float16Transpiler casts '
            'its fetch targets back)' % name)
    return tensor.detach().cpu().numpy()


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
        self._memory = memory
        self._batch_feed_names = None  # set by run_eval_multi's padding
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

    # ---- execution ----
    def _execute(self, env, generator):
        """Every op over ``env``: (new state, fetches)."""
        ctx = registry.LoweringContext(self.block, env, self.place,
                                       generator=generator)
        mask = env.get(registry.SAMPLE_MASK_NAME)
        if mask is not None:
            declared = self._batch_feed_names
            ctx.batch_led = {
                n for n in self.feed_names
                if (n in declared if declared is not None else
                    env[n].dim() >= 1 and env[n].shape[0] == mask.shape[0])}
        with torch.no_grad():
            for op in self.ops:
                registry.run_op(ctx, op)
        self._fetch_batch_led = [n in ctx.batch_led for n in self.fetch_names]
        missing = [n for n in self.fetch_names if n not in env]
        if missing:
            raise ValueError('fetch %s: not fed, not computed by the '
                             'program, and not persistable' % missing)
        new_state = {n: env[n] for n in self.state_out if n in env}
        return new_state, [env[n] for n in self.fetch_names]

    def _feeds_env(self, feeds, device):
        return {n: _feed_value(v, self.block._find_var_recursive(n), device)
                for n, v in feeds.items()}

    def _run_eager(self, scope, feeds, generator):
        device = self.place.device
        env = {n: _state_value(scope, n, device) for n in self.state_in}
        env.update(self._feeds_env(feeds, device))
        new_state, fetches = self._execute(env, generator)
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
        self._graph = None
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
            new_state, fetches = self._execute(env, generator)

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
        the path a block takes before its capture, to time beside it."""
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

    def _check_multi(self, what, steps):
        if steps < 1:
            raise ValueError('%s: steps must be >= 1, got %r' % (what, steps))
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

    def run_eval_multi(self, scope, feeds, generator, steps, per_step=None):
        """``steps`` evaluation steps; every step's fetches, stacked
        [K, ...], as numpy.  On the card each step's fetches are copied on
        the device into a [K, ...] buffer, and the host copies once."""
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
        # blocks purged while a capture may be running: dropped at the next
        # resolve, never inside a capture
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
        recycled id never reaches a stale block."""
        oid = id(obj)
        fin = self._finalizers.get(oid)
        if fin is not None and fin.alive:
            return
        cache_ref = weakref.ref(self._cache)
        lock, retired = self._cache_lock, self._retired
        finalizers = self._finalizers

        def _purge():
            cache = cache_ref()
            if cache is None:
                return
            with lock:
                finalizers.pop(oid, None)
                for k in [k for k in list(cache) if oid in (k[0], k[5])]:
                    retired.append(cache.pop(k))

        self._finalizers[oid] = weakref.finalize(obj, _purge)

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
        with self._cache_lock:
            del self._retired[:]
            compiled = self._cache.get(key)
            if compiled is None:
                self.compile_count += 1
                compiled = _CompiledBlock(program, 0, [n for n, _, _ in sig],
                                          fetch_names, self.place,
                                          self._memory)
                self._cache[key] = compiled
                if len(self._cache) > self._CACHE_MAX:
                    self._cache.popitem(last=False)[1].release()
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
        fetches = compiled.run(scope, feed_arrays, self._rng(program),
                               eager=eager)
        return self._convert_fetches(fetches, return_numpy, compiled)

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
        fetches = compiled.run_multi(scope, feed_arrays, self._rng(program),
                                     int(steps), per_step=per_step)
        return self._convert_fetches(fetches, return_numpy, compiled)

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
        stacked = compiled.run_eval_multi(scope, feed_arrays,
                                          self._rng(program), steps,
                                          per_step=per_step)
        return convert_eval_fetches(stacked, reals, target, compiled, steps,
                                    return_numpy)

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

        def own(t, name):
            return t.clone() if graph_owned or name in state else t

        def convert(f, name):
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
        """Drop the compile cache, its graphs with it."""
        with self._cache_lock:
            for compiled in self._cache.values():
                compiled.release()
            self._cache = collections.OrderedDict()
        self._closed = True
