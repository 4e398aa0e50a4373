"""Overlapped input pipeline: reader-fed multi-step dispatch with the next
block staged on the card while the current one computes (counterpart of
``paddle_tpu/fluid/dataflow.py``, single device).

``FeedPipeline``:

  1. a background staging thread drains K fresh minibatches per block from
     a ``py_reader`` (or any iterator of feed dicts), prepares them (a LoD
     feed padded, with its ``@SEQLEN`` lengths), stacks them into one
     [K, ...] block and, for an executor on the card, copies it there from
     pinned host memory on a stream of its own, recording an event after
     the copy;
  2. the dispatch loop hands each staged block to the executor's front
     half (``Executor._dispatch_multi_scanned``): the compute stream waits
     for the block's event, the K steps replay the block's captured graph,
     and the last step's fetches are copied on the stream into tensors of
     their own and from them into pinned host memory, an event marking
     the copies' end (``HostCopy``), all with no host sync;
  3. at most ``pipeline_depth`` dispatches are in flight (2: double
     buffering); delivering one (``_drain_one``) waits for its own
     copies' event only, never for the dispatch queued behind it, so
     that while dispatch N computes block N+1 is staged and dispatch
     N-1's fetches are delivered;
  4. feed-stall seconds, overlap ratio and queue depth come from
     ``metrics()``, which ``fluid.profiler``'s metrics-source registry
     snapshots into a profiled window's sidecar, beside ``pipeline/``
     spans.

The staging thread touches no scope, no compile cache and no captured
buffer; it holds ``executor.CAPTURE_LOCK`` around its CUDA calls, so
that none of them runs while a graph is being captured.

``run_multi(reader=..., steps=K)`` is the synchronous one-dispatch form:
it drains K distinct batches from the reader and trains on them as one
dispatch, leaving the scope as K sequential ``run()`` calls over the same
batch stream would.

Not ported yet: a ``ParallelExecutor`` (ROADMAP.md, Queue 1 item 7) and
``embed_caches=`` (item 9) raise ``NotImplementedError``.
"""

import collections
import contextlib
import queue as _queue
import threading
import time
import weakref

import torch

from . import core
from . import profiler as _profiler
from . import trace as _trace
from .executor import (CAPTURE_LOCK, Executor, HostCopy, prepare_feed_arrays,
                       feed_signature, stack_steps, global_scope, read_ops)
from .framework import default_main_program, Variable
from ..ops.sparse import SparseRows

__all__ = ['FeedPipeline', 'FeedPipelineError', 'drain_reader_feed_list',
           'check_reader_args', 'find_read_op']


class FeedPipelineError(RuntimeError):
    """A staging-thread failure (the source reader or the stager itself
    raised).  Raised at most once per pipeline: by the iteration when it
    reaches the end sentinel, or by ``close()`` for an error that raced
    the close and was never delivered; the original exception is its
    ``__cause__``."""


def check_reader_args(what, feed, feed_list, steps=None,
                      require_steps=False):
    """The reader-fed multi paths' argument rule: ``reader=`` excludes
    ``feed=`` and ``feed_list=``, and the eval path (``require_steps``)
    has no default step count."""
    if feed is not None or feed_list is not None:
        raise ValueError('%s: pass reader= OR feed/feed_list' % what)
    if require_steps and (steps is None or int(steps) < 1):
        raise ValueError('%s: reader= needs steps >= 1, got %r'
                         % (what, steps))


_PIPELINE_SEQ = [0]
_PIPELINE_SEQ_LOCK = threading.Lock()

# most recent dispatches kept in FeedPipeline.dispatch_log
_DISPATCH_LOG_CAP = 4096


def find_read_op(program, reader=None):
    """The program's ``read`` op (the one consuming ``reader`` if given).
    Reader-driven multi-step dispatch takes exactly one reader: a program
    reading several queues has no single batch stream."""
    ops = read_ops(program)
    if reader is not None:
        name = reader.name if isinstance(reader, Variable) else str(reader)
        ops = [op for op in ops if op.input('Reader')[0] == name]
        if not ops:
            raise RuntimeError(
                'run_multi(reader=...): the program has no read op '
                'consuming reader %r' % name)
    if not ops:
        raise RuntimeError(
            'run_multi(reader=...): the program is not reader-fed — '
            'pass feed= or feed_list= instead')
    if len(ops) > 1:
        raise RuntimeError(
            'run_multi(reader=...): the program reads from %d readers; '
            'reader-driven multi-step dispatch supports exactly one'
            % len(ops))
    return ops[0]


def _feeder_of(program, reader, place=None):
    """(feeder, output names) of the program's read op; binds the
    reader's prefetch target to the consuming executor's place, as
    ``run()``'s pop does."""
    from .layers import io as layers_io
    op = find_read_op(program, reader)
    reader_name = op.input('Reader')[0]
    feeder = layers_io.get_reader_feeder(reader_name)
    if feeder is None:
        raise RuntimeError('no py_reader registered for %r' % reader_name)
    if place is not None:
        feeder._executor_place = place
    return feeder, list(op.output('Out'))


def drain_reader_feed_list(program, reader, steps, place=None):
    """Pop up to ``steps`` fresh minibatches from the program's reader as
    a list of prepared feed dicts.  The drain stops at a shape-bucket
    boundary: the first batch of another signature goes back to the
    stream (``push_back``) for the next call.  A stream ending mid-block
    gives the shorter tail; an exhausted reader raises
    ``core.EOFException``, as ``run()`` does.  (The same contract as
    ``FeedPipeline._next_block``, whose leftover is held by the pipeline:
    a change to one is a change to both.)"""
    feeder, names = _feeder_of(program, reader, place)
    out, sig0 = [], None
    for _ in range(int(steps)):
        batch = feeder.pop()
        if batch is None:
            break
        prepared = prepare_feed_arrays(dict(zip(names, batch)))
        sig = feed_signature(prepared)
        if out and sig != sig0:
            feeder.push_back(batch)
            break
        sig0 = sig
        out.append(prepared)
    if not out:
        raise core.EOFException(
            'reader is exhausted — call reader.reset() and '
            'reader.start() for the next pass')
    return out


def _fetch_leaves(fetch, out):
    """Append the tensors of one fetch to ``out``: a tensor, a sparse
    gradient's rows and values, a tensor array's elements."""
    if isinstance(fetch, torch.Tensor):
        out.append(fetch)
    elif isinstance(fetch, SparseRows):
        out.extend((fetch.rows, fetch.values))
    elif isinstance(fetch, list):
        for f in fetch:
            _fetch_leaves(f, out)


def _with_leaves(fetch, leaves):
    """``fetch`` rebuilt on the tensors ``leaves`` yields, in
    ``_fetch_leaves``' order."""
    if isinstance(fetch, torch.Tensor):
        return next(leaves)
    if isinstance(fetch, SparseRows):
        return SparseRows(next(leaves), next(leaves), fetch.height)
    if isinstance(fetch, list):
        return [_with_leaves(f, leaves) for f in fetch]
    return fetch


class _Block(object):
    """One staged K-step block: its feeds stacked [K, ...] (on the card
    behind ``ready``, the event after their copy), the first step's
    prepared feeds (they key the executor's block), and the source
    ordinals of its batches."""

    __slots__ = ('steps', 'sig_feed', 'stacked', 'ready', 'indices')

    def __init__(self, steps, sig_feed, stacked, ready, indices):
        self.steps = steps
        self.sig_feed = sig_feed
        self.stacked = stacked
        self.ready = ready
        self.indices = indices


class FeedPipeline(object):
    """Reader-fed multi-step training with the next block staged while
    the current one computes: up to ``pipeline_depth`` dispatches stay in
    flight.

    executor: a ``fluid.Executor``.
    fetch_list: fetch targets (the last step of each dispatch delivers).
    reader: a py_reader Variable the program consumes through
        ``read_file``, OR source: any iterator of feed dicts (the
        Trainer's ``DataFeeder`` form).
    steps: minibatches per dispatch (K).
    pipeline_depth: staged blocks ahead and dispatches in flight.
    bucketed: route each drained batch to the open block of its shape
        bucket instead of closing a block at every bucket boundary: one
        captured graph per feed signature, full K-step blocks from a
        length-skewed reader.  Batches keep reader order within a bucket;
        dispatches go in bucket-completion order, recorded per dispatch in
        ``dispatch_log`` (source ordinals).
    max_open_buckets: at most this many buckets accumulate at once; beyond
        it the least recently fed one flushes early as a shorter block.
    watchdog_stall_s: a started pipeline registers a probe with
        ``trace.watchdog`` over how long the dispatch loop has been
        waiting on the staging queue; crossing the threshold dumps the
        flight recorder.  None registers no probe.
    on_delivered: called with a dispatch's source ordinals and converted
        fetches once they are delivered (the dispatch has synchronized).

    Iterate the pipeline to drive it: each item is one dispatch's
    converted last-step fetches."""

    def __init__(self, executor, fetch_list, program=None, reader=None,
                 source=None, steps=1, pipeline_depth=2, scope=None,
                 return_numpy=True, name=None, bucketed=False,
                 max_open_buckets=4, watchdog_stall_s=None,
                 embed_caches=None, on_delivered=None):
        if (reader is None) == (source is None):
            raise ValueError('FeedPipeline: pass reader= OR source=')
        if int(steps) < 1:
            raise ValueError('FeedPipeline: steps must be >= 1')
        if int(pipeline_depth) < 1:
            raise ValueError('FeedPipeline: pipeline_depth must be >= 1')
        if int(max_open_buckets) < 1:
            raise ValueError('FeedPipeline: max_open_buckets must be >= 1')
        if not isinstance(executor, Executor):
            raise NotImplementedError(
                'FeedPipeline over a ParallelExecutor: the data-parallel '
                'pipeline is not ported to PyTorch yet (ROADMAP.md, Queue 1 '
                'item 7)')
        if embed_caches:
            raise NotImplementedError(
                'FeedPipeline(embed_caches=...): the distributed embedding '
                'tier is not ported to PyTorch yet (ROADMAP.md, Queue 1 '
                'item 9)')
        self._exe = executor
        self._program = (program if program is not None
                         else default_main_program())
        self._scope = scope if scope is not None else global_scope()
        self._fetch_list = fetch_list
        self.steps = int(steps)
        self.pipeline_depth = int(pipeline_depth)
        self._return_numpy = return_numpy
        self._device = executor.place.device
        if reader is not None:
            feeder, names = _feeder_of(self._program, reader,
                                       executor.place)
            self._next_batch = self._reader_batches(feeder, names)
        else:
            self._next_batch = iter(source)
        self._staged = _queue.Queue(maxsize=self.pipeline_depth)
        self._inflight = collections.deque()
        self._pending = None  # a prepared batch held across a bucket split
        self.bucketed = bool(bucketed)
        self.max_open_buckets = int(max_open_buckets)
        # feed signature -> [per-step feeds, source ordinals], at most
        # max_open_buckets of them, the least recently fed first
        self._open = collections.OrderedDict()
        self._drained = 0  # source ordinal of the next drained batch
        # the realized training order (bucketed mode): one list of source
        # ordinals per dispatch, bounded for an open-ended source
        self.dispatch_log = collections.deque(maxlen=_DISPATCH_LOG_CAP)
        self._on_delivered = on_delivered
        self._stream = None  # the staging thread's copy stream (the card)
        self._error = None
        self._error_delivered = False
        self._closed = False
        self._thread = None
        self._started = False
        self.watchdog_stall_s = (float(watchdog_stall_s)
                                 if watchdog_stall_s is not None else None)
        self._watchdog_probe = None
        self._watchdog_age_fn = None
        self._waiting_since = None
        # the staging thread owns the stage_* keys and blocks_staged,
        # partial_blocks, eof and bucket_early_flushes; the dispatch loop
        # the rest
        self._m = {'blocks_staged': 0, 'stage_s': 0.0, 'stage_s_first': 0.0,
                   'dispatches': 0, 'steps_dispatched': 0,
                   'feed_stall_s': 0.0, 'partial_blocks': 0, 'eof': False,
                   'bucket_early_flushes': 0}
        with _PIPELINE_SEQ_LOCK:
            _PIPELINE_SEQ[0] += 1
            seq = _PIPELINE_SEQ[0]
        self.name = name or ('feed-pipeline-%d' % seq)
        # the profiler's sidecar source, bound weakly: a dropped pipeline
        # is not kept alive by the registry
        ref = weakref.ref(self)
        self._metrics_fn = lambda: (ref().metrics() if ref() else None)
        self._metrics_key = _profiler.register_metrics_source(
            self.name, self._metrics_fn)
        weakref.finalize(self, _profiler.unregister_metrics_source,
                         self._metrics_key, self._metrics_fn)

    # ---- sources -------------------------------------------------------

    @staticmethod
    def _reader_batches(feeder, names):
        while True:
            batch = feeder.pop()
            if batch is None:
                return
            yield dict(zip(names, batch))

    # ---- staging thread ------------------------------------------------

    def _put(self, item):
        while not self._closed:
            try:
                self._staged.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def _drain_prepared(self):
        """Pop and prepare one source batch: (prepared feeds, source
        ordinal), or None at the end of the source."""
        try:
            batch = next(self._next_batch)
        except StopIteration:
            return None
        prepared = prepare_feed_arrays(dict(batch))
        idx = self._drained
        self._drained += 1
        return prepared, idx

    def _next_block(self):
        """Up to K batches of one feed signature as a block.  A batch of
        another signature closes the block and opens the next one (held
        in ``_pending``): a shorter tail block is one more compile, never
        a failure.  (``drain_reader_feed_list``'s contract.)"""
        per_step, sig0, indices = [], None, []
        while len(per_step) < self.steps:
            if self._closed:
                # close() mid-drain: consume nothing more from the source
                return None
            if self._pending is not None:
                (prepared, idx), self._pending = self._pending, None
            else:
                drained = self._drain_prepared()
                if drained is None:
                    break
                prepared, idx = drained
            sig = feed_signature(prepared)
            if per_step and sig != sig0:
                self._pending = (prepared, idx)
                break
            sig0 = sig
            per_step.append(prepared)
            indices.append(idx)
        if not per_step:
            return None
        return self._finish_block(per_step, indices)

    def _next_block_bucketed(self):
        """Route each drained batch to its signature's open block; a block
        reaching K steps is staged.  Beyond ``max_open_buckets`` open
        buckets the least recently fed one flushes early; at the end of
        the source the partial ones flush in that order."""
        while True:
            if self._closed:
                return None
            drained = self._drain_prepared()
            if drained is None:
                break
            prepared, idx = drained
            sig = feed_signature(prepared)
            entry = self._open.setdefault(sig, [[], []])
            entry[0].append(prepared)
            entry[1].append(idx)
            self._open.move_to_end(sig)
            if len(entry[0]) >= self.steps:
                del self._open[sig]
                return self._finish_block(*entry)
            if len(self._open) > self.max_open_buckets:
                self._m['bucket_early_flushes'] += 1
                return self._finish_block(*self._open.popitem(last=False)[1])
        if self._open:
            return self._finish_block(*self._open.popitem(last=False)[1])
        return None

    def _finish_block(self, per_step, indices):
        """Stack the block's steps [K, ...]; on the card, copy them there
        from pinned memory on the staging stream and record ``ready``."""
        def stack():
            return {n: stack_steps([fa[n] for fa in per_step])
                    for n in per_step[0]}

        if self._device.type != 'cuda':
            return _Block(len(per_step), per_step[0], stack(), None, indices)
        with CAPTURE_LOCK, torch.cuda.stream(self._stream):
            stacked = {n: (v if v.is_cuda else v.pin_memory()).to(
                self._device, non_blocking=True)
                for n, v in stack().items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return _Block(len(per_step), per_step[0], stacked, ready, indices)

    def _stage_loop(self):
        first = True
        try:
            stream = contextlib.nullcontext()
            if self._device.type == 'cuda':
                torch.cuda.set_device(self._device)
                with CAPTURE_LOCK:
                    self._stream = torch.cuda.Stream(self._device)
                # a reader's device-staged batch waits on this stream
                stream = torch.cuda.stream(self._stream)
            while not self._closed:
                t0 = time.time()
                with stream:
                    block = (self._next_block_bucketed() if self.bucketed
                             else self._next_block())
                if block is None:
                    self._m['eof'] = True
                    break
                dt = time.time() - t0
                self._m['blocks_staged'] += 1
                self._m['stage_s'] += dt
                if first:
                    self._m['stage_s_first'] = dt
                    first = False
                if block.steps < self.steps:
                    self._m['partial_blocks'] += 1
                _profiler.record_event('pipeline/stage[x%d]' % block.steps,
                                       dt, start=t0)
                if not self._put(block):
                    return
        except BaseException as e:  # delivered once, typed
            self._error = e
        finally:
            self._put(None)

    # ---- dispatch loop -------------------------------------------------

    def _feed_stall_age(self):
        """Seconds the dispatch loop has been waiting on the staging queue
        right now (None when it is not waiting): the watchdog's probe."""
        since = self._waiting_since
        return (time.time() - since) if since is not None else None

    def start(self):
        if self._closed:
            raise RuntimeError('FeedPipeline is closed')
        if not self._started:
            self._started = True
            self._thread = threading.Thread(
                target=self._stage_loop, name=self.name, daemon=True)
            self._thread.start()
            if self.watchdog_stall_s is not None and \
                    self._watchdog_probe is None:
                ref = weakref.ref(self)

                def age(ref=ref):
                    pipe = ref()
                    return pipe._feed_stall_age() if pipe else None

                self._watchdog_probe = _trace.watchdog.register(
                    'pipeline/%s/feed_stall' % self.name, age,
                    self.watchdog_stall_s)
                self._watchdog_age_fn = age
                weakref.finalize(self, _trace.watchdog.unregister,
                                 self._watchdog_probe, age)
        return self

    def _dispatch(self, block):
        _trace.flight_recorder.record(
            'pipeline_dispatch', pipeline=self.name, steps=block.steps,
            indices=list(block.indices),
            trace_id=getattr(_trace.current(), 'trace_id', None))
        fetches, compiled = self._exe._dispatch_multi_scanned(
            self._program, self._fetch_list, self._scope, block.sig_feed,
            block.stacked, block.steps, ready=block.ready)
        # on their way to the host right behind this dispatch, before the
        # next one is queued: delivering them waits for this one only
        leaves = []
        for f in fetches:
            _fetch_leaves(f, leaves)
        copy = HostCopy(leaves)
        self._m['dispatches'] += 1
        self._m['steps_dispatched'] += block.steps
        if self.bucketed:
            self.dispatch_log.append(list(block.indices))
        self._inflight.append((fetches, copy, compiled, block, time.time()))

    def _drain_one(self):
        """Deliver the oldest dispatch: wait for its fetches' copies to
        the host (its own event), then convert them."""
        fetches, copy, compiled, block, t0 = self._inflight.popleft()
        leaves = iter(copy.tensors())
        host = [_with_leaves(f, leaves) for f in fetches]
        out = self._exe._convert_fetches(host, self._return_numpy, compiled)
        _profiler.record_event('pipeline/dispatch[x%d]' % block.steps,
                               time.time() - t0, start=t0)
        if self._on_delivered is not None:
            self._on_delivered(list(block.indices), out)
        return out

    def __iter__(self):
        self.start()
        try:
            while True:
                t0 = time.time()
                if self._m['dispatches'] > 0:
                    # the first wait overlaps nothing: it is no stall
                    self._waiting_since = t0
                try:
                    block = self._staged.get()
                finally:
                    self._waiting_since = None
                stall = time.time() - t0
                if block is None:
                    # the end sentinel's wait delays no dispatch
                    self._raise_stage_error()
                    break
                if self._m['dispatches'] > 0:
                    self._m['feed_stall_s'] += stall
                    if stall > 1e-4:
                        _profiler.record_event('pipeline/feed_stall',
                                               stall, start=t0)
                self._dispatch(block)
                while len(self._inflight) >= self.pipeline_depth:
                    yield self._drain_one()
            while self._inflight:
                yield self._drain_one()
        finally:
            # an abandoned iterator closes quietly: the end sentinel above
            # already raised a stage error into the consumer, and raising
            # from a generator's finally would mask the primary exception
            self._close_quiet()

    def run(self):
        """Drive the pipeline to the end of its source; returns each
        dispatch's converted last-step fetches."""
        return list(self)

    def metrics(self):
        m = dict(self._m)
        m['queue_depth'] = self._staged.qsize()
        m['inflight'] = len(self._inflight)
        m['pipeline_depth'] = self.pipeline_depth
        m['steps_per_dispatch'] = self.steps
        m['bucketed'] = self.bucketed
        m['open_buckets'] = len(self._open)
        # of the staging seconds after the first block, the share the
        # dispatch loop did not wait for (no feed stall: 1)
        denom = m['stage_s'] - m['stage_s_first']
        if denom > 0:
            m['overlap_ratio'] = max(0.0, min(
                1.0, (denom - m['feed_stall_s']) / denom))
        else:
            m['overlap_ratio'] = 1.0 if m['feed_stall_s'] < 1e-3 else 0.0
        return m

    def _drain_staged(self):
        try:
            while True:
                self._staged.get_nowait()
        except _queue.Empty:
            pass

    def _raise_stage_error(self):
        """Raise a staging-thread failure once, as FeedPipelineError: from
        the iteration at the end sentinel, or from ``close()`` when it
        raced the close; never twice."""
        if self._error is None or self._error_delivered:
            return
        self._error_delivered = True
        err = self._error
        raise FeedPipelineError(
            'FeedPipeline source failed: %r' % (err, )) from err

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._drain_staged()  # unblocks a stager waiting on a full queue
        if self._thread is not None:
            # _closed is set: the stager's put loop ends and its drain
            # stops consuming; an error it raises meanwhile is recorded
            self._thread.join(timeout=5)
            self._thread = None
        # drop a block the unblocked put() left after the first drain: a
        # staged block would hold device memory as long as the pipeline
        self._drain_staged()
        self._inflight.clear()
        if self._watchdog_probe is not None:
            _trace.watchdog.unregister(self._watchdog_probe,
                                       self._watchdog_age_fn)
            self._watchdog_probe = None
        _profiler.unregister_metrics_source(self._metrics_key,
                                            self._metrics_fn)
        # an error that raced the close and was never iterated into, once,
        # after everything above is released
        self._raise_stage_error()

    def _close_quiet(self):
        """close() with a racing stage error marked delivered and not
        raised: for paths where raising would mask a primary exception."""
        try:
            self.close()
        except FeedPipelineError:
            pass

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._close_quiet()
        else:
            self.close()
