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
lots, on the card as K replays with no host sync between them; with
``reader=`` each drains K distinct batches from the program's ``py_reader``
(``fluid.dataflow``), and ``_dispatch_multi_scanned`` runs K steps over a
block of feeds already stacked on the card (the ``FeedPipeline``'s
dispatch).  A program's ``read`` op is satisfied on the host before the
step: ``run`` pops one batch from its reader into the feeds, and raises
``core.EOFException`` when the reader is exhausted; the op is never part
of a block or a graph.  Every path of one executor runs its steps under
one lock, from the first feed copied in to the outputs copied into
tensors the caller owns: the graphs share one memory pool, so two threads
(two serving engines on one executor, a feed pipeline beside them) never
replay into each other's buffers.
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

A ``ParallelExecutor``'s executor plans ``_DPCompiledBlock``s: one data-
parallel rank's block, whose lowerings see the ranks (``registry.
DataParallel``) and whose parameter gradients are all-reduced after the
last op that writes one.

``run_decode_multi`` runs K greedy decode steps of a step program over a
slot batch (the generation serving lane's dispatch) and
``_dispatch_chunk_prefill`` one C-token prefill advance of a chunk
program.  On the card each captures one step as a CUDA graph whose input
buffers are the carry (the slot slabs, the token, the alive mask and the
step budget): the step program, the argmax, the stop masking and the
merges of the state fetches into the slabs, ending with copies into the
carry (the counterpart of donating it), so a dispatch of K steps is K
replays with no host sync.  Each owner of a carry (a serving engine's slot
cache) replays a graph over buffers of its own; host feeds go into the
buffers with no host sync (``_copy_in``).  One driver,
``_run_loop``, runs every path: a block's own step is the case with no
carry.

Not ported yet: the host ops but ``chunk_eval`` and ``print``
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

__all__ = ['Executor', 'global_scope', 'scope_guard', 'fetch_var']

_scope_stack = [core.global_scope()]

# A capture runs in CUDA's global capture mode: while one is under way no
# other thread may make a call that can allocate or synchronize (a new
# pinned or device block, a stream's wait).  Every capture holds this
# lock, and so do the threads that stage feeds for the card (the feed
# pipeline, double_buffer's prefetch) around their CUDA calls.
CAPTURE_LOCK = threading.RLock()


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


def fetch_var(name, scope=None, return_numpy=True):
    """The value of var ``name`` (a persistable one, typically) straight
    from ``scope`` (the active scope by default), without running a
    program: a numpy array, or with ``return_numpy=False`` a
    ``LoDTensor``."""
    if not isinstance(name, str):
        raise TypeError('fetch_var: name must be a str, not %r' % (name, ))
    if scope is None:
        scope = global_scope()
    var = scope.find_var(name)
    if var is None:
        raise ValueError(
            'Cannot find %s in scope. Perhaps you need to make the variable '
            'persistable by using var.persistable = True in your program.'
            % name)
    value = var.value()
    tensor = _as_tensor(value)
    if return_numpy:
        # a copy: the scope's own tensor stays the scope's
        return to_numpy(tensor, name).copy()
    if isinstance(value, core.LoDTensor):
        return value
    return core.LoDTensor(tensor.detach().cpu())


def _as_tensor(value):
    if isinstance(value, core.LoDTensor):
        return value.tensor()
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value))


# program -> (its version, the global block's read ops): every dispatch
# asks, and a model's block holds thousands of ops
_READ_OPS = weakref.WeakKeyDictionary()


def read_ops(program):
    """The ``read`` ops of ``program``'s global block, cached for its
    current version (every mutation of a program bumps it)."""
    hit = _READ_OPS.get(program)
    if hit is None or hit[0] != program._version:
        hit = (program._version, [op for op in program.global_block().ops
                                  if op.type == 'read'])
        _READ_OPS[program] = hit
    return hit[1]


def _pop_readers_into_feed(program, feed, place=None):
    """For each ``read`` op, pop one minibatch from its ``py_reader`` and put
    it in the feeds: the batch is taken on the host, ahead of the step.
    Binds the reader's prefetch target to ``place``, the executor that
    consumes it.  Raises ``core.EOFException`` when a reader is
    exhausted."""
    ops = read_ops(program)
    if not ops:
        return
    from .layers import io as layers_io
    for op in ops:
        reader_name = op.input('Reader')[0]
        feeder = layers_io.get_reader_feeder(reader_name)
        if feeder is None:
            raise RuntimeError('no py_reader registered for %r' %
                               reader_name)
        if place is not None:
            feeder._executor_place = place
        batch = feeder.pop()
        if batch is None:
            raise core.EOFException(
                'reader %r is exhausted — call reader.reset() and '
                'reader.start() for the next pass' % reader_name)
        for name, value in zip(op.output('Out'), batch):
            feed[name] = value


def _reject_reader_fed(program, what):
    """The plain-feed multi paths refuse a reader-fed program: resolving it
    would pop one minibatch and the K steps would train on it K times.
    Each names its own reader mode, which drains K distinct batches."""
    prog = program if program is not None else default_main_program()
    if read_ops(prog):
        composing = ('run_eval_multi(reader=..., steps=K)'
                     if 'eval' in what else
                     'run_multi(reader=..., steps=K)')
        raise RuntimeError(
            '%s does not compose with py_reader-fed programs through '
            'feed=/feed_list= — pass the reader (%s drains K fresh '
            'batches per dispatch), feed the batches explicitly, or '
            'use run() per step' % (what, composing))
    return prog


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


def _name_of(v):
    return v.name if isinstance(v, Variable) else str(v)


def _state_pairs(state):
    if isinstance(state, dict):
        state = list(state.items())
    return tuple((str(feed_n), _name_of(fetch)) for feed_n, fetch in state)


def normalize_decode_spec(decode):
    """Validate and normalize ``run_decode_multi``'s ``decode=`` dict, the
    autoregressive wiring of a STEP program:

      token:   the feed carrying the current token ([S, 1] int)
      logits:  the fetch (Variable or name) whose argmax is the next token
      state:   ordered (feed_name, fetch) pairs: each step the fetch's
               value becomes the feed's next value
      context: slot feeds that never update (encoder outputs)
      end_id:  the EOS token id, the per-slot stop condition beside the
               per-slot step budget
    """
    if not isinstance(decode, dict):
        raise ValueError('decode= must be a dict (token/logits/state/'
                         'end_id), got %r' % (type(decode), ))
    missing = [k for k in ('token', 'logits', 'state', 'end_id')
               if k not in decode]
    if missing:
        raise ValueError('decode= is missing %s' % missing)
    state = _state_pairs(decode['state'])
    if not state:
        raise ValueError('decode= needs at least one state pair — a '
                         'stateless step function has nothing to carry '
                         'between decode steps')
    return {
        'token': str(decode['token']),
        'logits': _name_of(decode['logits']),
        'state': state,
        'context': tuple(str(n) for n in decode.get('context', ())),
        'end_id': int(decode['end_id']),
    }


def canonical_decode_carry(carry):
    """The carry's leaves as torch tensors (numpy arrays are wrapped, not
    copied; tensors pass as they are)."""
    return {'slots': {n: _as_tensor(v) for n, v in carry['slots'].items()},
            'token': _as_tensor(carry['token']),
            'alive': _as_tensor(carry['alive']),
            'remaining': _as_tensor(carry['remaining'])}


def check_decode_carry(carry, spec, what):
    """Fail fast when a decode carry does not match its spec: the slot dict
    must cover exactly the state and context feeds (their @SEQLEN/@ROWS
    companions may ride along), and the token/alive/remaining leaves must
    be present."""
    if not isinstance(carry, dict):
        raise ValueError('%s: carry must be a dict, got %r'
                         % (what, type(carry)))
    missing = [k for k in ('slots', 'token', 'alive', 'remaining')
               if k not in carry]
    if missing:
        raise ValueError('%s: carry is missing %s' % (what, missing))
    want = set(n for n, _ in spec['state']) | set(spec['context'])
    have = set(carry['slots'])
    extra = {n for n in have - want
             if not n.endswith((registry.SEQLEN_SUFFIX, '@ROWS'))}
    if want - have or extra:
        raise ValueError(
            '%s: carry slots %s do not match the decode spec (missing '
            '%s, unexpected %s)' % (what, sorted(have),
                                    sorted(want - have), sorted(extra)))


def normalize_chunk_spec(chunk):
    """Validate and normalize the ``chunk=`` dict of a chunked-prefill
    dispatch, the wiring of a CHUNK program:

      token:    the feed carrying one [S, C, 1] token block per slot
      len:      an optional per-slot real-length feed ([S, 1] float); the
                engine also feeds the token feed's @SEQLEN companion
      state:    ordered (step_feed_name, chunk_fetch) pairs, the chunk's
                advanced value of every decode-state slab
      start_id: the BOS token written into finishing slots' carry
    """
    if not isinstance(chunk, dict):
        raise ValueError('chunk= must be a dict (token/len/state/'
                         'start_id), got %r' % (type(chunk), ))
    missing = [k for k in ('token', 'state', 'start_id') if k not in chunk]
    if missing:
        raise ValueError('chunk= is missing %s' % missing)
    state = _state_pairs(chunk['state'])
    if not state:
        raise ValueError('chunk= needs at least one state pair — a chunk '
                         'that advances no slab is a no-op')
    return {
        'token': str(chunk['token']),
        'len': (str(chunk['len']) if chunk.get('len') is not None
                else None),
        'state': state,
        'start_id': int(chunk['start_id']),
    }


def check_chunk_aux(aux, what, slots=None):
    """Fail fast when a chunk dispatch's per-slot aux leaves (the active
    and finish masks, the finishing slots' step budget) are missing, not
    1-D, or not ``slots`` long."""
    if not isinstance(aux, dict):
        raise ValueError('%s: aux must be a dict, got %r'
                         % (what, type(aux)))
    missing = [k for k in ('active', 'finish', 'budget') if k not in aux]
    if missing:
        raise ValueError('%s: aux is missing %s' % (what, missing))
    for k in ('active', 'finish', 'budget'):
        shape = tuple(np.shape(aux[k]))
        if len(shape) != 1 or \
                (slots is not None and int(shape[0]) != int(slots)):
            raise ValueError(
                '%s: aux[%r] must be a 1-D per-slot vector%s, got shape %s'
                % (what, k, ' of length %d' % slots
                   if slots is not None else '', shape))


class HostCopy(object):
    """Tensors on their way to the host.  On the card each is copied into
    pinned host memory behind the work queued so far, and an event marks
    the copies' end: ``result()`` waits for that event only, never for the
    work queued after it (the chained decode lane harvests one dispatch
    while the next computes).  On the CPU the tensors are already there."""

    def __init__(self, tensors):
        self._event = None
        if tensors and tensors[0].device.type == 'cuda':
            self._host = []
            # a new pinned block must not be allocated during a capture
            with CAPTURE_LOCK:
                for t in tensors:
                    h = torch.empty(tuple(t.shape), dtype=t.dtype,
                                    pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    self._host.append(h)
                self._event = torch.cuda.Event()
                self._event.record()
        else:
            self._host = list(tensors)

    def done(self):
        """Whether the copies have finished, without waiting for them."""
        return self._event is None or self._event.query()

    def tensors(self):
        """The tensors on the host, once their copies are done."""
        if self._event is not None:
            self._event.synchronize()
        return self._host

    def result(self):
        """The tensors as numpy arrays, once their copies are done."""
        return [h.detach().numpy() for h in self.tensors()]


def upload(value, device, dtype=None):
    """``value`` on ``device`` (as ``dtype``) with no host sync: a host
    tensor goes by ``cudaMemcpyAsync`` from its own memory, which the
    driver stages before the call returns, so the copy queues behind the
    work on the stream and the host waits for none of it.  A blocking copy
    synchronizes the stream; a pinned one costs the host more
    (``profile_upload.py``).  The reverse of ``HostCopy``."""
    t = _as_tensor(value)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.to(device, non_blocking=True)


def _copy_in(buf, value):
    """Copy ``value`` into the buffer ``buf`` as ``upload`` moves it, with
    no tensor on the card between."""
    buf.copy_(_as_tensor(value), non_blocking=True)


def _carry_leaves(carry):
    """[(path, tensor)] of a decode carry, in a fixed order; [] for
    None, the block's own step."""
    if carry is None:
        return []
    out = [(('slots', n), carry['slots'][n]) for n in sorted(carry['slots'])]
    return out + [((k, ), carry[k]) for k in ('token', 'alive', 'remaining')]


def _owned(outs):
    """The step's outputs copied on the stream into tensors of their own
    (a sparse gradient's rows and values, a tensor array's elements), so
    that the next replay, which overwrites the graph's outputs, leaves
    them as they are."""
    def own(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, SparseRows):
            return SparseRows(v.rows.clone(), v.values.clone(), v.height)
        if isinstance(v, list):
            return [own(x) for x in v]
        return v
    return [own(o) for o in outs]


def _map_carry(fn, carry):
    """A decode carry with ``fn`` applied to every leaf."""
    return {'slots': {n: fn(v) for n, v in carry['slots'].items()},
            'token': fn(carry['token']), 'alive': fn(carry['alive']),
            'remaining': fn(carry['remaining'])}


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
                 memory, lock):
        self.program = program
        self.block = program.block(block_idx)
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.place = place
        # a read op's batch arrives as feeds, popped on the host
        self.ops = [op for op in self.block.ops
                    if op.type not in ('feed', 'fetch', 'read')]
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
        # the index of the op after which a data-parallel rank sums the
        # gradients over the ranks (_DPCompiledBlock._reduce_grads)
        self._grads_at = None
        self._memory = memory
        # held by _run_loop: the executor's, shared by all its blocks
        self._lock = lock
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
        # the (steps, carry signature) pairs of the decode loop and the
        # (width, carry signature) pairs of the chunk advance: the JAX
        # package compiles one executable for each
        self._decode_steps_seen = set()
        self._chunk_widths_seen = set()
        self.last_decode_cost = None
        self.last_chunk_cost = None
        # the captured steps by loop key (_run_loop): the block's own, and
        # each owner's decode step and chunk advance
        self._loops = {}
        self._loop_calls = collections.Counter()
        self._owners = {}  # id of a carry's owner -> weakref of it
        self.calls = 0
        self.captures = 0
        self.replays = 0
        self.last_ran = None  # 'eager', 'capture' or 'replay'
        self.captured_launches = {}

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
        self._seed_provenance(ctx, env)
        grads_at = self._grads_at
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
                if i == grads_at:
                    self._reduce_grads(ctx)
                for n in release.get(i, ()):
                    env.pop(n, None)
        self._note_fetches(ctx)
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

    def _seed_provenance(self, ctx, env):
        """Seed the ragged-batch provenance when a sample mask rides
        along: the feeds the padding declared batch-led, or else those
        whose dim 0 is the mask's."""
        mask = env.get(registry.SAMPLE_MASK_NAME)
        if mask is not None:
            declared = self._batch_feed_names
            ctx.batch_led = {
                n for n in self.feed_names
                if (n in declared if declared is not None else
                    env[n].dim() >= 1 and env[n].shape[0] == mask.shape[0])}
            ctx.batch_tainted = set(ctx.batch_led)

    def _note_fetches(self, ctx):
        self._fetch_batch_led = [n in ctx.batch_led for n in self.fetch_names]

    def _feeds_env(self, feeds, device):
        return {n: _feed_value(v, self.block._find_var_recursive(n), device)
                for n, v in feeds.items()}

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

    def _state_buffer(self, scope, n, taken):
        """The scope's tensor for ``n`` as a state buffer: a buffer of its
        own for each name (``taken`` holds the ids given out), even where
        two names hold one tensor, allocated here, outside any capture's
        pool."""
        device = self.place.device
        mem = self._memory
        t = _state_value(scope, n, device)
        if not mem.owns(t, device) or id(t) in taken:
            t = t.clone(memory_format=torch.contiguous_format)
            mem.add(t)
            scope.var(n).set_value(t)
        taken.add(id(t))
        return t

    def _state_ready(self, scope, bufs):
        """Make every state buffer of a captured step hold the scope's
        value: False when a value changed shape or dtype, and the step must
        be captured again."""
        for n, buf in bufs.items():
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

    def _publish(self, scope, outs):
        """Point the scope at a captured step's state buffers."""
        for n, t in outs.items():
            var = scope.var(n)
            if var.value() is not t:
                var.set_value(t)

    def run(self, scope, feeds, generator, eager=False):
        """One step; returns the fetch tensors (on the card, the graph's
        own outputs after a capture or replay: copy before the next
        call).  ``eager`` runs the lowerings one by one whatever the mode:
        the path a block takes before its capture, to time beside it.
        Under FLAGS_check_nan_inf the state and the fetches of a block the
        JAX package would jit are scanned after the step."""
        got = []
        self._run_loop(self._BLOCK, scope, feeds, None, generator, None,
                       self._block_body(generator, scope), 1,
                       lambda i, fetches: got.append(fetches), eager=eager,
                       own_last=True)
        self._check_step(scope, got[0])
        return got[0]

    def _check_step(self, scope, fetches):
        if flags.FLAGS.check_nan_inf and self.refusal is None:
            _check_nan_inf([(n, _scope_tensor(scope, n))
                            for n in self.state_out
                            if scope.find_var(n) is not None], 'state var')
            _check_nan_inf(zip(self.fetch_names, fetches), 'fetch')
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
        """The one rule for every K-step path (run_multi, run_eval_multi,
        the decode loop, the chunk advance): K >= 1, no host op, and a
        block that can be captured."""
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

    def run_multi(self, scope, feeds, generator, steps, per_step=None,
                  stacked=None):
        """``steps`` training steps, each on ``feeds``, on per_step[i] or
        on the i-th row of ``stacked`` (feeds stacked [K, ...] on the
        block's device); the scope ends as ``steps`` run() calls leave it.
        Returns the last step's fetches, tensors of their own, with
        nothing synchronized."""
        self._check_multi('run_multi', steps)
        last = []

        def keep(i, fetches):
            last[:] = fetches

        self._run_loop(self._BLOCK, scope, feeds, per_step, generator, None,
                       self._block_body(generator, scope), steps, keep,
                       check=True, own_last=True, stacked=stacked)
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

        self._run_loop(self._BLOCK, scope, feeds, per_step, generator, None,
                       self._block_body(generator, scope), steps, collect,
                       check=True)
        if not host:
            return stacked
        return [to_numpy(s, n) for s, n in zip(stacked, self.fetch_names)]

    # ---- the step driver ----
    # the loop key of the block's own step: run, run_multi, run_eval_multi
    _BLOCK = ('block', )

    def _block_body(self, generator, scope):
        """The block's own step as ``_run_loop`` takes it: the ops over the
        env, no carry, the fetches as the step's outputs."""
        def make(capturing):
            def body(env, carry):
                new_state, fetches = self._execute(
                    env, generator, capturing=capturing, scope=scope)
                return new_state, None, fetches
            return body
        return make

    def _run_loop(self, key, scope, feeds, per_step, generator, carry,
                  make_body, steps, each, eager=False, check=False,
                  own_last=False, stacked=None):
        """The one driver of every path: ``steps`` applications of a step
        (``make_body(capturing)`` gives its function of (env, carry): new
        state, new carry, outputs), step i on per_step[i], on row i of
        ``stacked`` or on ``feeds``, each step's outputs handed to
        ``each(i, outs)`` before the next step runs; with ``own_last`` the
        last step's outputs are copied into tensors of their own first
        (``_owned``) where they are a graph's.  Returns the final carry
        (None for the block's own step, which threads none).

        The whole call holds the executor's lock (``_lock``): another
        thread's steps on this executor cannot come between a feed copied
        in and the outputs handed to ``each``, nor a capture.

        On the CPU, under ``eager`` and for a block that cannot be
        captured, every step runs eagerly on new tensors.  On the card the
        first call of a loop key runs eagerly (it builds the kernels and
        leaves every state var in the scope), the next captures the step
        as a CUDA graph (``_capture_loop``) and replays it, and every later
        step replays: the feeds and the carry are copied into the graph's
        buffers first (a carry leaf that is the buffer itself stays), so
        the carry returned is the buffers, which the key's next replay
        overwrites.  ``check`` scans the state and the outputs of every
        step before the replays under FLAGS_check_nan_inf."""
        with self._lock:
            return self._run_loop_locked(
                key, scope, feeds, per_step, generator, carry, make_body,
                steps, each, eager, check, own_last, stacked)

    def _run_loop_locked(self, key, scope, feeds, per_step, generator, carry,
                         make_body, steps, each, eager, check, own_last,
                         stacked):
        device = self.place.device
        live = self.mode == 'graph' and not eager
        loop = self._loops.get(key) if live else None
        if loop is not None and not self._state_ready(scope, loop['state']):
            # a state var changed shape or dtype: capture afresh (the old
            # graph may have been its pool's last user)
            del self._loops[key]
            self._memory.renew()
            loop = None
        if stacked is not None:
            feeds_at = lambda i: {n: v[i] for n, v in stacked.items()}
        elif per_step is not None:
            feeds_at = lambda i: per_step[i]
        else:
            feeds_at = lambda i: feeds
        last = steps - 1
        i = 0
        while i < steps and loop is None:
            self.calls += 1
            self._loop_calls[key] += 1
            if live and self._loop_calls[key] > 1:
                loop = self._capture_loop(key, scope, feeds_at(i), generator,
                                          carry, make_body)
                carry, outs = loop['carry'], loop['outs']
                if own_last and i == last:
                    outs = _owned(outs)
            else:
                if carry is not None:
                    carry = _map_carry(lambda t: _as_tensor(t).to(device),
                                       carry)
                env = {n: _state_value(scope, n, device)
                       for n in self.state_in}
                env.update(self._feeds_env(feeds_at(i), device))
                new_state, carry, outs = make_body(False)(env, carry)
                outs = self._store(scope, new_state, outs)
                self.last_ran = 'eager'
            if check:
                self._check_step(scope, outs)
            each(i, outs)
            i += 1
        if i == steps:
            return carry
        if stacked is not None:
            stacked = {n: stacked[n][i:] for n in loop['feeds']}
        elif per_step is not None:
            # the remaining lots go to the device in one copy each, then
            # into the feed buffers on the stream
            stacked = {n: upload(stack_steps([fa[n] for fa in per_step[i:]]),
                                 device) for n in loop['feeds']}
        else:
            for n, buf in loop['feeds'].items():
                _copy_in(buf, feeds[n])
        for (path, buf), (_, t) in zip(_carry_leaves(loop['carry']),
                                       _carry_leaves(carry)):
            if t is not buf:
                if tuple(t.shape) != tuple(buf.shape):
                    raise ValueError(
                        'carry leaf %s has shape %s, the captured loop %s' %
                        ('/'.join(path), tuple(t.shape), tuple(buf.shape)))
                _copy_in(buf, t)
        for j in range(i, steps):
            self.calls += 1
            if stacked is not None:
                for n, buf in loop['feeds'].items():
                    buf.copy_(stacked[n][j - i], non_blocking=True)
            loop['graph'].replay()
            self.replays += 1
            self.last_ran = 'replay'
            each(j, _owned(loop['outs']) if own_last and j == last
                 else loop['outs'])
        self._publish(scope, loop['outs_state'])
        return loop['carry']

    def _capture_loop(self, key, scope, feeds, generator, carry, make_body):
        """Capture one step as a CUDA graph and replay it once.  Its
        buffers, all allocated outside the capture: the state (the scope's
        tensors made state buffers), the feeds, and the carry (copies of
        the incoming carry, never the caller's own tensors, which the
        replays would overwrite).  The step computes into temporaries and
        ends by copying the new carry and the new state into the buffers:
        the counterpart of donating them."""
        device = self.place.device
        mem = self._memory
        taken = set()
        state = {n: self._state_buffer(scope, n, taken)
                 for n in self.state_in}
        outs_state = {n: self._state_buffer(scope, n, taken)
                      for n in self.state_out if n not in state}
        feed_bufs = {n: v.clone(memory_format=torch.contiguous_format)
                     for n, v in self._feeds_env(feeds, device).items()}
        bufs = None if carry is None else _map_carry(
            lambda t: _as_tensor(t).to(device).clone(
                memory_format=torch.contiguous_format), carry)
        leaves = _carry_leaves(bufs)
        state_bufs = dict(state, **outs_state)
        rw = {t.untyped_storage().data_ptr() for _, t in leaves}
        rw.update(state_bufs[n].untyped_storage().data_ptr()
                  for n in self.state_out)
        graph = torch.cuda.CUDAGraph()
        # each replay draws afresh from the executor's generator
        graph.register_generator_state(generator)
        before = registry.counts()
        with CAPTURE_LOCK, torch.cuda.graph(graph, pool=mem.pool):
            env = dict(state)
            env.update(feed_bufs)
            new_state, new_carry, outs = make_body(True)(env, bufs)

            def own(v, buf=None):
                # a value that views a buffer the copies below overwrite
                return v.clone() if isinstance(v, torch.Tensor) and \
                    v is not buf and v.untyped_storage().data_ptr() in rw \
                    else v

            outs = [own(o) for o in outs]
            new_state = {n: own(v, state_bufs[n])
                         for n, v in new_state.items()}
            new_leaves = [own(v, b) for (_, v), (_, b) in zip(
                _carry_leaves(new_carry), leaves)]
            for v, (_, buf) in zip(new_leaves, leaves):
                if v is not buf:
                    buf.copy_(v)
            for n, v in new_state.items():
                buf = state_bufs[n]
                if v.shape != buf.shape or v.dtype != buf.dtype:
                    raise RuntimeError(
                        'capture: the step turns state var %r from %s %s '
                        'into %s %s; a graph replays a fixed shape and '
                        'dtype' % (n, tuple(buf.shape), buf.dtype,
                                   tuple(v.shape), v.dtype))
                if v is not buf:
                    buf.copy_(v)
        after = registry.counts()
        self.captured_launches = {k: after[k] - before.get(k, 0)
                                  for k in after
                                  if after[k] != before.get(k, 0)}
        loop = {'graph': graph, 'state': state, 'feeds': feed_bufs,
                'carry': bufs, 'outs': outs,
                'outs_state': {n: state_bufs[n] for n in self.state_out}}
        self._loops[key] = loop
        self.captures += 1
        graph.replay()
        self._publish(scope, loop['outs_state'])
        self.last_ran = 'capture'
        return loop

    # ---- the decode loop and the chunk advance ----
    def note_decode_compile(self, steps, carry_sig):
        """True when this (steps, carry signature) pair of the decode loop
        has not run before (the JAX package compiles its decode scan
        afresh for it)."""
        return self._note_seen(self._decode_steps_seen, steps, carry_sig)

    def note_chunk_compile(self, width, carry_sig):
        """The same for the chunk advance (the chunk width is its static
        shape knob)."""
        return self._note_seen(self._chunk_widths_seen, width, carry_sig)

    @staticmethod
    def _note_seen(seen, n, carry_sig):
        key = (int(n), feed_signature(carry_sig))
        if key in seen:
            return False
        seen.add(key)
        return True

    def _merge(self, mask, upd, old):
        """``upd`` where the per-slot ``mask`` holds, else ``old``, in the
        slab's dtype."""
        keep = torch.reshape(mask, (-1, ) + (1, ) * max(upd.dim() - 1, 0))
        return torch.where(keep, upd.to(old.dtype), old)

    def _decode_body(self, spec, generator, capturing=False):
        """One greedy decode step as a function of (env, carry): the step
        program over the slot batch, the argmax, the stop masking (a slot
        that emitted end_id or spent its budget freezes) and the merges of
        the state fetches into the slabs.  Returns (new state, new carry,
        [emit, alive entering the step])."""
        token_name = spec['token']
        end_id = spec['end_id']
        updates = [(feed_n, self.fetch_names.index(fetch_n))
                   for feed_n, fetch_n in spec['state']]

        def body(env, carry):
            env = dict(env)
            env.update(carry['slots'])
            env[token_name] = carry['token']
            new_state, fetches = self._execute(env, generator,
                                               capturing=capturing)
            token, alive = carry['token'], carry['alive']
            remaining = carry['remaining']
            logits = fetches[0]
            nxt = torch.argmax(torch.reshape(logits, (logits.shape[0], -1)),
                               dim=-1).to(token.dtype)
            emit = torch.where(alive, nxt, torch.full_like(nxt, end_id))
            rem = remaining - alive.to(remaining.dtype)
            live = alive & (emit != end_id) & (rem > 0)
            slots = dict(carry['slots'])
            for feed_n, fi in updates:
                slots[feed_n] = self._merge(alive, fetches[fi],
                                            carry['slots'][feed_n])
            new_token = torch.where(alive[:, None], emit[:, None], token)
            return new_state, {'slots': slots, 'token': new_token,
                               'alive': live, 'remaining': rem}, \
                [emit, alive]

        return body

    def _chunk_body(self, spec, generator, capturing=False):
        """One C-token prefill advance as a function of (env, carry): the
        chunk program over the slot batch, its state fetches merged into
        the slabs of the ``active`` slots, and the slots whose prompt ends
        in this block (``finish``) flipped to decoding: token <- start_id,
        alive <- True, remaining <- their budget.  The aux leaves ride in
        ``env`` under their own keys.  Returns (new state, new carry,
        [alive])."""
        start_id = spec['start_id']
        updates = [(feed_n, self.fetch_names.index(fetch_n))
                   for feed_n, fetch_n in spec['state']]

        def body(env, carry):
            env = dict(env)
            active = env.pop('@AUX_ACTIVE')
            fin = env.pop('@AUX_FINISH')
            budget = env.pop('@AUX_BUDGET')
            env.update(carry['slots'])
            new_state, fetches = self._execute(env, generator,
                                               capturing=capturing)
            slots = dict(carry['slots'])
            for feed_n, fi in updates:
                slots[feed_n] = self._merge(active, fetches[fi],
                                            carry['slots'][feed_n])
            token = carry['token']
            token = torch.where(fin[:, None], torch.full_like(token,
                                                              start_id),
                                token)
            alive = carry['alive'] | fin
            remaining = carry['remaining']
            remaining = torch.where(fin, budget.to(remaining.dtype),
                                    remaining)
            return new_state, {'slots': slots, 'token': token,
                               'alive': alive, 'remaining': remaining}, \
                [alive]

        return body


    def _owner_key(self, owner):
        """The part of a decode or chunk loop key that names the carry's
        owner: each owner replays a captured step of its own over buffers
        of its own, so two owners of one block (two engines on one
        executor and step program) never decode from each other's slots.
        None for a caller that owns no carry.  The loops of an owner that
        died are dropped here, at the next dispatch, never inside a
        capture.  Called under ``_lock``, as ``_run_loop`` and
        ``_own_carry`` after it are."""
        dead = [oid for oid, ref in list(self._owners.items())
                if ref() is None]
        for oid in dead:
            self._owners.pop(oid, None)
            gone = [k for k in list(self._loops) if k[1:2] == (oid, )]
            for k in gone:
                self._loops.pop(k, None)
            for k in [k for k in list(self._loop_calls) if k[1:2] == (oid, )]:
                self._loop_calls.pop(k, None)
            if gone and self._memory is not None:
                self._memory.renew()
        if owner is None:
            return None
        self._owners.setdefault(id(owner), weakref.ref(owner))
        return id(owner)

    def _own_carry(self, owner, carry):
        """The carry a dispatch hands back: the loop's buffers to their
        owner; a copy to a caller that owns none, whose next call (with
        this carry or another) must not overwrite it.  Called under
        ``_lock``: another thread's replay of the same loop cannot come
        between the replay and the copy."""
        if owner is not None or self.last_ran == 'eager':
            return carry
        return _map_carry(torch.clone, carry)

    def run_decode_multi(self, scope, feeds, generator, steps, carry, spec,
                         owner=None):
        """``steps`` greedy decode steps over the whole slot batch: each
        step's token comes from the previous step's argmax, a slot whose
        token was end_id or whose budget ran out freezes (its slabs and
        token keep their values).  Returns (carry', tokens [K, S], alive_in
        [K, S]): tokens[i, s] counts for slot s exactly when alive_in[i, s].
        Nothing is synchronized; on the card the tokens are written on the
        device, row by row, and carry' is ``owner``'s captured step's
        buffers (``_owner_key``), or a copy of them."""
        self._check_multi('run_decode_multi', steps)
        device = self.place.device
        s = int(carry['token'].shape[0])
        toks = torch.empty((steps, s), dtype=carry['token'].dtype,
                           device=device)
        alive_in = torch.empty((steps, s), dtype=torch.bool, device=device)

        def each(i, outs):
            toks[i].copy_(outs[0])
            alive_in[i].copy_(outs[1])

        with self._lock:
            key = ('decode', self._owner_key(owner), tuple(sorted(feeds)),
                   spec['token'], spec['state'], spec['end_id'])
            carry = self._run_loop(
                key, scope, feeds, None, generator, carry,
                lambda capturing: self._decode_body(spec, generator,
                                                    capturing),
                steps, each)
            carry = self._own_carry(owner, carry)
        step_feeds = dict(feeds)
        step_feeds.update(carry['slots'])
        step_feeds[spec['token']] = carry['token']
        self.last_decode_cost = self.capture_cost(
            'decode_multi', (tuple(sorted(feeds)),
                             tuple(sorted(carry['slots'])), int(steps)),
            scope, step_feeds, steps=steps)
        return carry, toks, alive_in

    def run_chunk_prefill(self, scope, feeds, generator, carry, aux, spec,
                          owner=None):
        """One C-token prefill advance over the whole slot batch: each
        ``active`` slot's slabs advance by its block of prompt tokens, the
        others keep theirs, and the ``finish`` slots turn to decoding.
        Returns (carry', alive') with nothing synchronized: on the card
        the feeds and the aux vectors reach the graph's buffers behind the
        work already queued, with no host sync (``_copy_in``)."""
        self._check_multi('run_chunk_prefill', 1)
        feeds = dict(feeds)
        feeds['@AUX_ACTIVE'] = _as_tensor(aux['active']).to(torch.bool)
        feeds['@AUX_FINISH'] = _as_tensor(aux['finish']).to(torch.bool)
        feeds['@AUX_BUDGET'] = _as_tensor(aux['budget'])
        got = []
        with self._lock:
            key = ('chunk', self._owner_key(owner), tuple(sorted(feeds)),
                   spec['token'], spec['state'], spec['start_id'])
            carry = self._run_loop(
                key, scope, feeds, None, generator, carry,
                lambda capturing: self._chunk_body(spec, generator,
                                                   capturing),
                1, lambda i, outs: got.append(outs[0].clone()))
            carry = self._own_carry(owner, carry)
        step_feeds = {n: v for n, v in feeds.items()
                      if not n.startswith('@AUX_')}
        step_feeds.update(carry['slots'])
        self.last_chunk_cost = self.capture_cost(
            'chunk_prefill', (tuple(sorted(step_feeds)),
                              tuple(sorted(carry['slots']))),
            scope, step_feeds)
        return carry, got[0]

    def release(self):
        """Drop the graphs and the buffers they hold."""
        self._loops = {}


def replicated_feeds(block, names):
    """The feeds of ``names`` that data-parallel ranks each take whole: their
    var (or the var of their ``@SEQLEN`` side-band) is annotated with an
    all-None ``PartitionSpec`` (``parallel.shard(var)``).  Every other feed
    is split on dim 0."""
    from ..parallel.api import sharding_of
    out = []
    for n in names:
        v = block._find_var_recursive(n.split(registry.SEQLEN_SUFFIX)[0])
        spec = sharding_of(v) if v is not None else None
        if spec is not None and all(a is None for a in spec):
            out.append(n)
    return out


class _DPCompiledBlock(_CompiledBlock):
    """A ``_CompiledBlock`` run by one data-parallel rank (the counterpart
    of the JAX package's ``_SpmdCompiledBlock``): its feeds are this rank's
    split of the global batch's rows, its state a replica.

    The lowerings' context carries ``dp`` (``registry.DataParallel``) and
    the provenance of the split rows: every split feed seeds
    ``batch_tainted``, so that a reduction over the rows is global
    (``registry.declare_dp_aware``) or raises.  Right after the last op
    that writes a parameter's ``@GRAD`` one all-reduce sums every dense
    parameter gradient, a flat bucket for each dtype, before the clip, the
    regularizers and the optimizer read them: with global-count means each
    rank's gradient is a partial sum of the global one.

    On the card under NCCL the collectives are captured in the block's
    CUDA graph with the rest of the step.  Gloo's cannot be captured: under
    gloo the block is declared eager before any capture (``mode``,
    ``why``), and ``run_multi`` runs its steps eagerly."""

    def __init__(self, program, block_idx, feed_names, fetch_names, place,
                 memory, lock, dp):
        super(_DPCompiledBlock, self).__init__(
            program, block_idx, feed_names, fetch_names, place, memory, lock)
        self.dp = dp
        self._replicated = frozenset(replicated_feeds(self.block,
                                                      self.feed_names))
        grads = {p.name + registry.GRAD_SUFFIX
                 for p in program.all_parameters()}
        writes = [i for i, op in enumerate(self.ops)
                  if grads.intersection(op.output_arg_names)]
        self._grads = sorted(grads)
        if writes:
            self._grads_at = writes[-1]
        self._fetch_split = None
        if self.mode == 'graph' and dp.backend == 'gloo':
            self.mode, self.why = 'eager', (
                'its collectives run on gloo, which a CUDA graph cannot '
                'capture')

    def _seed_provenance(self, ctx, env):
        super(_DPCompiledBlock, self)._seed_provenance(ctx, env)
        ctx.dp = self.dp
        split = [n for n in self.feed_names
                 if n not in self._replicated and env[n].dim() >= 1]
        ctx.batch_tainted = set(split) - {registry.SAMPLE_MASK_NAME}
        ctx.dp_rows = tuple(sorted({int(env[n].shape[0]) for n in split}))

    def _reduce_grads(self, ctx):
        """The gradient all-reduce: every parameter's dense @GRAD summed
        over the ranks."""
        names = [n for n in self._grads if n in ctx.env]
        sparse = [n for n in names if isinstance(ctx.env[n], SparseRows)]
        if sparse:
            raise NotImplementedError(
                'sparse (SelectedRows) gradients %s under data parallelism '
                'are not ported to PyTorch yet (ROADMAP.md, Queue 1 item 7)'
                % sparse)
        for n, g in zip(names, self.dp.all_reduce([ctx.env[n]
                                                   for n in names])):
            ctx.env[n] = g

    def _note_fetches(self, ctx):
        super(_DPCompiledBlock, self)._note_fetches(ctx)
        # an activation's gradient is split as the activation is
        split = lambda n: n.split(registry.GRAD_SUFFIX)[0] \
            in ctx.batch_tainted
        self._fetch_split = [split(n) for n in self.fetch_names]

    def fetch_split(self):
        """Which fetches hold this rank's split of the rows (gathered over
        the ranks on the way out), by the last run's provenance."""
        return self._fetch_split or [False] * len(self.fetch_names)


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
        # every block's steps run under it (_CompiledBlock._run_loop)
        self._run_lock = threading.RLock()
        # a data-parallel rank's executor (ParallelExecutor's): its blocks
        # are _DPCompiledBlocks over this registry.DataParallel
        self._dp = None

    def _rng(self, program):
        if self._generator is None:
            g = torch.Generator(device=self.place.device)
            # each data-parallel rank draws a stream of its own (rank 0
            # the single-process one)
            rank = self._dp.rank if self._dp is not None else 0
            g.manual_seed((int(program.random_seed or 0) + rank *
                           0x9E3779B97F4A7C15) & 0xffffffffffffffff)
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
        graphs = any(c._loops for c in blocks)
        for compiled in blocks:
            compiled.release()
        if graphs and self._memory is not None:
            self._memory.renew()

    def _resolve_and_compile(self, program, feed, fetch_list, scope,
                             pop_readers=True):
        """Normalize the arguments, prepare and validate the feeds, and
        find (or plan) the cached block.  ``pop_readers`` pops one batch
        of each ``read`` op's reader into the feeds (``run``); the paths
        that drain readers themselves, or refuse them, pass False."""
        if self._closed:
            raise RuntimeError('Attempted to use a closed Executor')
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_list = fetch_list if fetch_list is not None else []
        if isinstance(fetch_list, (Variable, str)):
            fetch_list = [fetch_list]
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list]
        feed = dict(feed or {})
        from .layers import io as layers_io
        layers_io.note_executor_place(self.place)
        if pop_readers:
            _pop_readers_into_feed(program, feed, self.place)
        feed_arrays = prepare_feed_arrays(feed)
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
                args = (program, 0, [n for n, _, _ in sig], fetch_names,
                        self.place, self._memory, self._run_lock)
                compiled = _CompiledBlock(*args) if self._dp is None else \
                    _DPCompiledBlock(*args, dp=self._dp)
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
        all of one shape bucket (``steps`` is then len(feed_list)), OR
        reader: the program's py_reader, from which ``steps`` distinct
        batches drain (a stream ending mid-block trains on the shorter
        tail, a batch of another shape bucket goes back to the stream for
        the next call, an exhausted reader raises ``core.EOFException``).
        On the card the steps are replays of the block's graph, back to
        back, each lot copied into the feed buffers on the stream; the
        overlapped form is ``fluid.FeedPipeline``."""
        if reader is not None:
            from .dataflow import check_reader_args, drain_reader_feed_list
            check_reader_args('run_multi', feed, feed_list)
            program = program if program is not None else \
                default_main_program()
            feed_list = drain_reader_feed_list(program, reader, steps,
                                               self.place)
        else:
            program = _reject_reader_fed(program, 'run_multi')
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
            program, feed, fetch_list, scope, pop_readers=False)
        self._note_multi_compile(compiled.multi_steps_seen, steps,
                                 _stacked_signature(per_step))
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

    def _dispatch_multi_scanned(self, program, fetch_list, scope, sig_feed,
                                stacked, steps, ready=None):
        """The front half of a K-step training dispatch over feeds already
        stacked on the block's device (the ``FeedPipeline`` drives it):
        resolve the block keyed on ``sig_feed`` (the first prepared step's
        feeds), make the stream wait for ``ready`` (the event recorded
        after the stacked feeds' copy on another stream), run the K steps,
        and return (the last step's fetches, tensors of their own on the
        device; the block) with no host sync: the host stages block N+1
        and delivers N-1 while N computes."""
        program, scope, _, compiled = self._resolve_and_compile(
            program, sig_feed, fetch_list, scope, pop_readers=False)
        steps = int(steps)
        # the stacked feeds' signature is _stacked_signature's of the
        # steps they stack: one count for run_multi's feed_list and this
        self._note_multi_compile(compiled.multi_steps_seen, steps,
                                 feed_signature(stacked))
        if ready is not None:
            torch.cuda.current_stream(self.place.device).wait_event(ready)
        if self.place.device.type == 'cuda':
            # the caching allocator must not hand the staged block to
            # another stream's allocation while this stream still reads it
            stream = torch.cuda.current_stream(self.place.device)
            for v in stacked.values():
                v.record_stream(stream)
        _trace.flight_recorder.record(
            'multi_dispatch', executor='Executor', steps=steps,
            fetch_names=list(compiled.fetch_names),
            trace_id=getattr(_trace.current(), 'trace_id', None))
        fetches = compiled.run_multi(scope, {}, self._rng(program), steps,
                                     stacked=stacked)
        return fetches, compiled

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
        count (None when nothing was padded), ``target`` the padded rows.
        ``reader=`` drains up to ``steps`` distinct batches from the
        program's py_reader onto the feed_list path, as run_multi's
        does."""
        if reader is not None:
            from .dataflow import check_reader_args, drain_reader_feed_list
            check_reader_args('run_eval_multi', feed, feed_list, steps,
                              require_steps=True)
            program = program if program is not None else \
                default_main_program()
            feed_list = drain_reader_feed_list(program, reader, steps,
                                               self.place)
        else:
            program = _reject_reader_fed(program, 'run_eval_multi')
        reals, target, batch_feed_names, per_step = None, None, None, None
        if feed_list is not None:
            if feed is not None:
                raise ValueError('run_eval_multi: pass feed OR feed_list')
            if not feed_list:
                raise ValueError('run_eval_multi: feed_list is empty')
            per_step = [prepare_feed_arrays(dict(f)) for f in feed_list]
            check_feed_list_names(per_step, 'run_eval_multi')
            normalize_trailing_feed_list(per_step)
            from .parallel_executor import pad_ragged_batch, \
                normalize_ragged_feed_list
            per_step, reals, target, batch_feed_names = \
                normalize_ragged_feed_list(
                    per_step, lambda fa, **kw: pad_ragged_batch(fa, 1, **kw))
            steps = len(per_step)
            check_feed_list_uniform(per_step, 'run_eval_multi')
            feed = per_step[0]
        elif steps is None:
            raise ValueError('run_eval_multi: pass steps= with feed=')
        steps = int(steps)
        program, scope, feed_arrays, compiled = self._resolve_and_compile(
            program, feed, fetch_list, scope, pop_readers=False)
        if batch_feed_names is not None and compiled._batch_feed_names is None:
            # fixed by the feed signature, which keys the block
            compiled._batch_feed_names = frozenset(batch_feed_names)
        self._note_multi_compile(compiled.eval_steps_seen, steps,
                                 _stacked_signature(per_step))
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
        the way out.  OR reader: the program's py_reader, from which up to
        ``steps`` distinct batches drain, as run_multi's reader= drains
        them."""

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

    def run_decode_multi(self, program=None, feed=None, carry=None,
                         steps=None, decode=None, scope=None, owner=None):
        """Run ``steps`` autoregressive greedy-decode iterations of a STEP
        program over a whole slot batch (the serving engine's decode-lane
        primitive).  ``decode`` names the token feed, the logits fetch
        (argmax = next token), the (state feed, state fetch) pairs, the
        read-only ``context`` slot feeds and ``end_id``; per-slot stop
        conditions (EOS emitted, ``carry['remaining']`` spent) are masked
        inside each step, so finished slots freeze.

        carry: {'slots': {name: [S, ...]}, 'token': [S, 1] int, 'alive':
        [S] bool, 'remaining': [S] int32}, numpy arrays or tensors.
        feed: feeds held constant across iterations.  Returns (carry',
        tokens [K, S], alive_in [K, S]) as tensors on the place's device:
        tokens[i, s] counts for slot s exactly when alive_in[i, s].

        ``owner`` (the port's own option; any object a weak reference can
        point at) is the holder of the carry: on the card each owner
        replays a captured step of its own, and carry' is that step's
        buffers, which the owner's next dispatch updates in place (so it
        passes carry' back and the chain runs with no copy).  With no
        owner carry' is a copy, and any carries may alternate."""
        carry_out, toks, alive_in, _ = self._dispatch_decode_multi(
            program, feed=feed, carry=carry, steps=steps, decode=decode,
            scope=scope, owner=owner)
        return carry_out, toks, alive_in

    def _dispatch_decode_multi(self, program=None, feed=None, carry=None,
                               steps=None, decode=None, scope=None,
                               owner=None):
        """The front half of run_decode_multi, which the engine's chained
        decode lane drives: resolve the step program's block for the
        carry's shapes and queue the K steps against a carry whose leaves
        may be the previous dispatch's buffers, so that dispatch N+1
        follows N on the stream with no host round trip.  Returns (carry',
        tokens, alive_in, compiled) with nothing synchronized."""
        if carry is None or steps is None or decode is None:
            raise ValueError('run_decode_multi: carry=, steps= and '
                             'decode= are required')
        steps = int(steps)
        program = _reject_reader_fed(program, 'run_decode_multi')
        spec = normalize_decode_spec(decode)
        check_decode_carry(carry, spec, 'run_decode_multi')
        carry = canonical_decode_carry(carry)
        fetch_list = [spec['logits']] + [f for _, f in spec['state']]
        sig_feed = dict(feed or {})
        sig_feed[spec['token']] = carry['token']
        sig_feed.update(carry['slots'])
        program, scope, feed_arrays, compiled = self._resolve_and_compile(
            program, sig_feed, fetch_list, scope, pop_readers=False)
        const = {n: v for n, v in feed_arrays.items()
                 if n not in carry['slots'] and n != spec['token']}
        carry_sig = dict(carry['slots'])
        carry_sig[spec['token']] = carry['token']
        if compiled.note_decode_compile(steps, carry_sig):
            self.compile_count += 1
        _trace.flight_recorder.record(
            'decode_dispatch', executor='Executor', steps=steps,
            slots=int(carry['token'].shape[0]),
            trace_id=getattr(_trace.current(), 'trace_id', None))
        carry_out, toks, alive_in = compiled.run_decode_multi(
            scope, const, self._rng(program), steps, carry, spec,
            owner=owner)
        return carry_out, toks, alive_in, compiled

    def _dispatch_chunk_prefill(self, program=None, feed=None, carry=None,
                                aux=None, chunk=None, scope=None,
                                owner=None):
        """One C-token prefill advance of a CHUNK program over the slot
        batch (the engine's chunk lane), queued against a carry whose
        leaves may be the decode lane's buffers.  ``feed`` carries the
        [S, C, 1] token block, its @SEQLEN companion and the optional
        per-slot length feed; ``aux`` the active/finish/budget slot
        vectors; ``owner`` as run_decode_multi's.  Returns (carry', alive',
        compiled) with nothing synchronized."""
        if carry is None or aux is None or chunk is None:
            raise ValueError('run_chunk_prefill: carry=, aux= and chunk= '
                             'are required')
        program = _reject_reader_fed(program, 'run_chunk_prefill')
        spec = normalize_chunk_spec(chunk)
        carry = canonical_decode_carry(carry)
        check_chunk_aux(aux, 'run_chunk_prefill',
                        slots=int(carry['token'].shape[0]))
        fetch_list = [f for _, f in spec['state']]
        sig_feed = dict(feed or {})
        sig_feed.update(carry['slots'])
        program, scope, feed_arrays, compiled = self._resolve_and_compile(
            program, sig_feed, fetch_list, scope, pop_readers=False)
        block_feed = {n: v for n, v in feed_arrays.items()
                      if n not in carry['slots']}
        width = int(feed_arrays[spec['token']].shape[1])
        carry_sig = dict(carry['slots'])
        carry_sig[spec['token']] = feed_arrays[spec['token']]
        if compiled.note_chunk_compile(width, carry_sig):
            self.compile_count += 1
        _trace.flight_recorder.record(
            'chunk_dispatch', executor='Executor', width=width,
            slots=int(carry['token'].shape[0]),
            trace_id=getattr(_trace.current(), 'trace_id', None))
        carry_out, ok = compiled.run_chunk_prefill(
            scope, block_feed, self._rng(program), carry, aux, spec,
            owner=owner)
        return carry_out, ok, compiled

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
        if read_ops(program):
            raise RuntimeError(
                'memory_analysis: the program is reader-fed; popping a '
                'py_reader batch here would silently drop a minibatch '
                'from training — pass representative arrays via feed= '
                'on a reader-free clone instead')
        program, scope, feed_arrays, compiled = self._resolve_and_compile(
            program, feed, fetch_list, scope, pop_readers=False)
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

    def _note_multi_compile(self, seen, steps, stacked_sig):
        """Count a (steps, stacked feed signature) pair the block has not
        run yet in ``compile_count``: the JAX package compiles one
        executable for each, and the port keeps the counts equal."""
        key = (int(steps), stacked_sig)
        if key not in seen:
            seen.add(key)
            self.compile_count += 1

    def _convert_fetches(self, fetches, return_numpy, compiled):
        """Fetch tensors -> numpy arrays (or LoDTensors), and a sparse
        gradient (``SparseRows``) -> a ``core.SelectedRows``.  What the
        caller gets is its own: a graph's outputs come copied already
        (``_run_loop``'s ``own_last``), and a state var fetched from an
        eager run may be updated in place by the next step (the sparse
        optimizers write the rows they touch into the table)."""
        state = set(compiled.state_out)
        arrays = {n for n in compiled.fetch_names
                  if getattr(compiled.block._find_var_recursive(n), 'type',
                             None) == core.VarDesc.VarType.LOD_TENSOR_ARRAY}

        def own(t, name):
            return t.clone() if name in state else t

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
