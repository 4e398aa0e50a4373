"""The inference serving engine: the forward path.

Counterpart of ``paddle_tpu/serving/engine.py``.  The reference ships
inference as a per-request ABI (paddle_inference_api.h:
PaddlePredictor.Run, one graph execution per call); this engine puts a
request-facing surface in front of the executor's multi-step eval
dispatch:

  1. **dynamic micro-batching**: submitted requests coalesce in a
     MicroBatcher up to max_batch_size rows or a max_wait deadline;
  2. **shape bucketing**: each lot pads (masked, the last real row
     repeated: the ``@SAMPLE_MASK`` machinery) to a bounded
     ShapeBucketSet rung, so wandering request sizes map to a small fixed
     set of blocks, each captured once as a CUDA graph on the card;
     fetches trim back to the real row counts.  The TRAILING dims bucket
     too (TrailingDimBuckets): variable seq-len/resolution extents
     quantize onto the shared ``fluid.shape_policy`` ladder (LoD feeds
     lower to padded + ``@SEQLEN`` at submit, ``PaddedSequence`` data
     re-pads to its rung), so mixed-length requests coalesce; per-request
     fetches trim back to the real trailing extents;
  3. **multi-step eval dispatch**: up to steps_per_dispatch same-bucket
     lots go out as ONE ``Executor.run_eval_multi`` dispatch (on the card
     K graph replays with no host sync between them), and up to
     pipeline_depth dispatches stay in flight, so the host delivers one
     while the card runs the next;
  4. **metrics**: queue depth, batch fill ratio, p50/p99 latency,
     dispatch and compile counts, surfaced through ``fluid.profiler``'s
     sidecar (``serving/<engine>/...`` spans, the engine's snapshot under
     its name).

Synchronous use needs no thread: an engine that was never ``start()``ed
dispatches inline on the submitter's thread (``fluid.Inferencer`` runs
this mode).  ``start()`` spawns the worker loop for the queued mode; on
the card the worker selects the engine's device before it runs anything.

Device memory (the ModelRegistry's arbiter hooks): the engine's model is
the set of persistables its program reads.  ``device_footprint`` sums
those of them that lie on the engine's device; ``evict_to_host`` copies
the same ones to CPU tensors bit for bit (the scope then holds their host
form), drops the engine's blocks through ``Executor.purge_programs`` and
releases their graphs and state buffers, paused and under the dispatch
gate, so no capture runs meanwhile; the next dispatch stages the same
ones back onto the device and the executor captures afresh.  So the
account, the eviction and the reload cover one set, and a model's
account is the same before its first eviction and after every reload.
Scope tensors the program does not read (a transpiler's f32 originals, a
training scope's optimizer moments) are not the model's: they are
neither counted nor moved.  An engine made by ``from_saved_model``
starts with its weights in host form, as the JAX package's loaded numpy
arrays are, and stages them at its first dispatch.

Not ported yet, each raising ``NotImplementedError``: generation
(``generation=``, ``submit_generate``, ``generate``, and
``ServingConfig``'s ``decode_*`` and ``prefill_chunk`` knobs: they need
the executor's ``run_decode_multi`` and ``run_chunk_prefill``),
dp/mesh serving (``parallel=``, ``mesh=``) and the embedding caches
(``embed_caches=``).  ROADMAP.md, Queue 1 items 7-9.
"""

import contextlib
import threading
import time
import warnings
import weakref
from collections import deque

import numpy as np
import torch

from ..fluid import core
from ..fluid import profiler as _profiler
from ..fluid import trace as _trace
from ..fluid.executor import Executor, feed_signature, fetch_batch_led, \
    prepare_feed_arrays, to_numpy, _as_tensor, _lead
from ..fluid.parallel_executor import pad_ragged_batch
from ..ops import registry
from ..ops.registry import SEQLEN_SUFFIX, SAMPLE_MASK_NAME
from .batcher import InferenceRequest, MicroBatcher
from .buckets import ShapeBucketSet, TrailingDimBuckets
from .errors import DeadlineExceededError, EngineClosedError
from .metrics import EngineMetrics, RateWindow
from .profile import ServiceTimeProfile

__all__ = ['ServingConfig', 'InferenceEngine']

_ENGINE_SEQ = [0]
_ENGINE_SEQ_LOCK = threading.Lock()

_GENERATION_TODO = ('generation serving is not ported to PyTorch yet: it '
                    'needs the executor\'s run_decode_multi and '
                    'run_chunk_prefill (ROADMAP.md, Queue 1 item 8)')


class ServingConfig(object):
    """Engine knobs, as in the JAX package's ``ServingConfig``.

    max_batch_size: rows per lot before a full flush.
    max_wait_ms: oldest-request age forcing a deadline flush: the
        latency bound at low traffic.
    steps_per_dispatch: max same-bucket lots per run_eval_multi dispatch.
    pipeline_depth: dispatches kept in flight before the worker blocks
        on the oldest one's results (2 = double buffering).
    bucket_sizes: explicit ladder for the ShapeBucketSet (None = powers
        of two up to max_batch_size).
    max_buckets: bound on the active bucket set (LRU accounting).
    trailing_buckets: quantize variable TRAILING dims onto the shared
        seq-len ladder (``fluid.shape_policy``, the executor's LoD
        ladder), so mixed-length sequence requests share a signature and
        coalesce: single-level LoD feeds lower to padded [B, T, ...] +
        @SEQLEN at submit, and PaddedSequence data re-pads to its rung.
        False makes every LoD/PaddedSequence request its own lot.
    trailing_ladders: EXPLICIT per-feed trailing ladders for DENSE feeds
        (``{'img': [224, 256]}`` for axis 1, or ``{'img': {2: [224, 256],
        3: [224, 256]}}``): the engine zero-pads those axes up to the
        covering rung, which is output-preserving only for models that
        ignore trailing padding; opting in asserts that.
    max_trailing_buckets: bound on the active trailing set.
    watchdog_stall_s: queue-age stall threshold (seconds) of the trace
        watchdog probe a started engine registers; None registers none.
    decode_slots, decode_steps, decode_pipeline_depth, prefill_chunk: the
        generation lane's knobs; any value raises NotImplementedError
        (generation is not ported yet).
    scheduling: 'edf' (default): highest priority first, earliest
        deadline first within a class, past-deadline requests SHED with
        DeadlineExceededError; requests without priorities or deadlines
        keep FIFO order.  'fifo': strict arrival order, no shedding.
    priority_aging_ms: each full window a request has waited promotes its
        effective class by one (EDF only); None keeps strict priority.
    shed_by_class: shed by accumulated backlog in scheduling order, so
        the lowest class's deadlined work sheds first (EDF only).
    admit_queue_depth / admit_queue_age_ms: the ModelRegistry's
        admission watermarks (typed OverloadedError at routing time).
    adaptive_admission: scale those watermarks by the measured drain vs
        arrival rate (clamped to [0.5, 2]).
    """

    def __init__(self, max_batch_size=32, max_wait_ms=5.0,
                 steps_per_dispatch=4, pipeline_depth=2,
                 bucket_sizes=None, max_buckets=16,
                 trailing_buckets=True, trailing_ladders=None,
                 max_trailing_buckets=32, watchdog_stall_s=None,
                 decode_slots=None, decode_steps=None,
                 decode_pipeline_depth=None, prefill_chunk=None, scheduling='edf',
                 admit_queue_depth=None, admit_queue_age_ms=None,
                 adaptive_admission=False, priority_aging_ms=None,
                 shed_by_class=False):
        if int(steps_per_dispatch) < 1:
            raise ValueError('steps_per_dispatch must be >= 1')
        if int(pipeline_depth) < 1:
            raise ValueError('pipeline_depth must be >= 1')
        if int(max_buckets) < 1:
            raise ValueError('max_buckets must be >= 1')
        if int(max_trailing_buckets) < 1:
            # a 0 bound would make every bucket_for miss insert-then-
            # evict its own key
            raise ValueError('max_trailing_buckets must be >= 1')
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.pipeline_depth = int(pipeline_depth)
        self.bucket_sizes = bucket_sizes
        self.max_buckets = int(max_buckets)
        if trailing_ladders and not trailing_buckets:
            raise ValueError(
                'ServingConfig: trailing_ladders= requires trailing '
                'bucketing — drop trailing_buckets=False, or drop the '
                'ladders')
        self.trailing_buckets = bool(trailing_buckets)
        self.trailing_ladders = trailing_ladders
        self.max_trailing_buckets = int(max_trailing_buckets)
        self.watchdog_stall_s = (float(watchdog_stall_s)
                                 if watchdog_stall_s is not None else None)
        for knob, value in (('decode_slots', decode_slots),
                            ('decode_steps', decode_steps),
                            ('decode_pipeline_depth', decode_pipeline_depth),
                            ('prefill_chunk', prefill_chunk)):
            if value is not None:
                raise NotImplementedError('%s: %s' % (knob,
                                                      _GENERATION_TODO))
        self.adaptive_admission = bool(adaptive_admission)
        if scheduling not in ('edf', 'fifo'):
            raise ValueError(
                "ServingConfig: scheduling must be 'edf' or 'fifo', "
                'got %r' % (scheduling, ))
        self.scheduling = scheduling
        if priority_aging_ms is not None and float(priority_aging_ms) <= 0:
            raise ValueError('priority_aging_ms must be > 0 (or None '
                             'for strict priority)')
        if priority_aging_ms is not None and scheduling == 'fifo':
            raise ValueError(
                'ServingConfig: priority_aging_ms only applies to EDF '
                "scheduling — drop scheduling='fifo', or drop the aging "
                'window')
        self.priority_aging_s = (float(priority_aging_ms) / 1e3
                                 if priority_aging_ms is not None else None)
        if shed_by_class and scheduling == 'fifo':
            raise ValueError(
                'ServingConfig: shed_by_class only applies to EDF '
                "scheduling — drop scheduling='fifo', or drop "
                'shed_by_class')
        self.shed_by_class = bool(shed_by_class)
        if admit_queue_depth is not None and int(admit_queue_depth) < 1:
            raise ValueError('admit_queue_depth must be >= 1 (or None '
                             'to disable the depth watermark)')
        if admit_queue_age_ms is not None and \
                float(admit_queue_age_ms) <= 0:
            raise ValueError('admit_queue_age_ms must be > 0 (or None '
                             'to disable the age watermark)')
        self.admit_queue_depth = (int(admit_queue_depth)
                                  if admit_queue_depth is not None
                                  else None)
        self.admit_queue_age_s = (float(admit_queue_age_ms) / 1e3
                                  if admit_queue_age_ms is not None
                                  else None)
        if self.adaptive_admission and self.admit_queue_depth is None \
                and self.admit_queue_age_s is None:
            raise ValueError(
                'ServingConfig: adaptive_admission needs a watermark '
                'to adapt — set admit_queue_depth and/or '
                'admit_queue_age_ms, or drop adaptive_admission')


class _HostTensor(core.LoDTensor):
    """The host form of an engine's scope value: a CPU copy of a tensor
    that was (or will be) on the engine's device.  The executor reads it
    as it reads any LoDTensor; the engine stages it back onto its device
    before its next dispatch."""


def _shape(v):
    if isinstance(v, core.LoDTensor):
        return tuple(v.shape())
    if isinstance(v, torch.Tensor):
        return tuple(v.shape)
    return tuple(np.shape(v))


def _dtype_name(v):
    if isinstance(v, core.LoDTensor):
        v = v.tensor()
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace('torch.', '')
    dtype = getattr(v, 'dtype', None)
    return str(dtype if dtype is not None else np.asarray(v).dtype)


def _to_tensor(v):
    return v.tensor() if isinstance(v, core.LoDTensor) else _as_tensor(v)


class _Lot(object):
    """One padded, bucket-shaped batch of coalesced requests."""

    __slots__ = ('requests', 'feed', 'real', 'bucket', 'sig', 'kind')

    def __init__(self, requests, feed, real, bucket, sig, kind='forward'):
        self.requests = requests
        self.feed = feed
        self.real = real  # None for an unbatchable (nested LoD) lot
        self.bucket = bucket
        self.sig = sig
        self.kind = kind


class InferenceEngine(object):
    """Serve a loaded inference program (fluid.io.load_inference_model)
    through micro-batched, bucketed, multi-step eval dispatches.  The
    place defaults to the executor's, else ``CUDAPlace(0)``; pass
    ``CPUPlace()`` to serve on the CPU."""

    def __init__(self, program, feed_names=None, fetch_list=None,
                 place=None, scope=None, executor=None, parallel=False,
                 mesh=None, config=None, name=None, generation=None,
                 embed_caches=None):
        if fetch_list is None:
            raise ValueError('InferenceEngine: fetch_list is required '
                             '(the fetch targets returned by '
                             'load_inference_model)')
        if parallel or mesh is not None:
            raise NotImplementedError(
                'sharded serving (parallel=, mesh=) needs ParallelExecutor, '
                'which is not ported to PyTorch yet (ROADMAP.md, Queue 1 '
                'item 7)')
        if generation is not None:
            raise NotImplementedError('generation=: ' + _GENERATION_TODO)
        if embed_caches:
            raise NotImplementedError(
                'embed_caches=: the two-tier embedding cache is not ported '
                'to PyTorch yet (ROADMAP.md, Queue 1 item 9)')
        self._program = program
        self._feed_names = list(feed_names) if feed_names else None
        self._fetch_list = list(fetch_list)
        # static axis-1 widths of the fetch targets: a fetch of such a width
        # (a class/hidden axis) can NOT be a mirrored rung-padded seq axis,
        # so _bucket_trailing voids any rung coinciding with one
        self._fetch_static_ax1 = set()
        for v in self._fetch_list:
            shape = tuple(getattr(v, 'shape', None) or ())
            if len(shape) >= 2 and shape[1] is not None and \
                    int(shape[1]) > 0:
                self._fetch_static_ax1.add(int(shape[1]))
        self._scope = scope if scope is not None else core.Scope()
        self.config = config if config is not None else ServingConfig()
        # host ops cannot run inside a replayed loop: such programs serve
        # EAGERLY, one exe.run per request, no padding or coalescing
        self._eager = any(registry.is_host_op_type(op.type)
                          for op in program.global_block().ops)
        # the model: the persistables the program reads (account,
        # eviction and staging all cover this one set)
        self._model_vars = sorted(
            {n for blk in program.blocks for op in blk.ops
             for n in op.input_arg_names
             if getattr(blk._find_var_recursive(n), 'persistable', False)})
        if place is None:
            place = executor.place if executor is not None else \
                core.CUDAPlace(0)
        self.place = place
        self._exe = executor if executor is not None else Executor(place)
        self.buckets = ShapeBucketSet(self.config.max_batch_size,
                                      sizes=self.config.bucket_sizes,
                                      multiple=1,
                                      max_buckets=self.config.max_buckets)
        self.trailing = None
        if self.config.trailing_buckets and not self._eager:
            self.trailing = TrailingDimBuckets(
                ladders=self.config.trailing_ladders,
                max_buckets=self.config.max_trailing_buckets)
        # deadline-aware lot formation: the engine owns the shed side
        # effects and feeds the batcher its service estimate (3x the min
        # recent dispatch wall of the request's signature: min, not mean,
        # so one cold dispatch cannot poison it into shedding everything)
        ref0 = weakref.ref(self)
        self._service_walls = deque(maxlen=8)
        self._profile = ServiceTimeProfile()
        self._batcher = MicroBatcher(
            self.config.max_batch_size, self.config.max_wait_s,
            scheduling=self.config.scheduling,
            on_shed=lambda req: (ref0() and ref0()._shed_request(req)),
            service_estimate_for=lambda req: (
                ref0()._service_estimate(req) if ref0() else 0.0),
            priority_aging_s=self.config.priority_aging_s,
            shed_by_class=self.config.shed_by_class)
        self._arrivals = RateWindow()
        self._drains = RateWindow()
        self._metrics = EngineMetrics()
        self._inflight = deque()
        self._last_sync_t = 0.0  # previous drain's sync, clips FLOP windows
        self._carry = deque()  # flushed lots awaiting a matching block
        self._inline_lock = threading.Lock()
        # the pause gate: the worker holds it for one collect->dispatch->
        # drain cycle; paused() (the registry's eviction window) holds it
        # for the whole pause
        self._cycle_lock = threading.RLock()
        # cross-engine dispatch turnstile: None for a lone engine; the
        # ModelRegistry shares ONE lock across its engines, so a dispatch
        # (and any capture in it) never overlaps another engine's dispatch,
        # staging or eviction on the card
        self._gate = None
        self._thread = None
        self._closed = False
        self._warned_unsliced = False
        self._watchdog_probe = None
        self._watchdog_age_fn = None
        with _ENGINE_SEQ_LOCK:
            _ENGINE_SEQ[0] += 1
            seq = _ENGINE_SEQ[0]
        self.name = name or ('serving-engine-%d' % seq)
        # timeline spans are keyed by engine name (serving/<name>/...)
        self._spans = 'serving/%s/' % self.name
        ref = weakref.ref(self)
        self._metrics_fn = lambda: (ref().metrics() if ref() else None)
        self._metrics_key = _profiler.register_metrics_source(
            self.name, self._metrics_fn)
        # an inline-mode engine may never be stop()ped: drop its
        # registration at GC so the source table can't grow unbounded
        weakref.finalize(self, _profiler.unregister_metrics_source,
                         self._metrics_key, self._metrics_fn)

    @classmethod
    def from_saved_model(cls, dirname, place=None, model_filename=None,
                         params_filename=None, **kwargs):
        """Build an engine straight from a save_inference_model dir (its
        own scope and executor).  The weights load in host form and go to
        the device at the first dispatch."""
        from ..fluid import io as fluid_io
        from ..fluid.executor import scope_guard
        place = place if place is not None else core.CUDAPlace(0)
        exe = Executor(place)
        scope = core.Scope()
        with scope_guard(scope):
            program, feed_names, fetch_targets = \
                fluid_io.load_inference_model(
                    dirname, Executor(core.CPUPlace()),
                    model_filename=model_filename,
                    params_filename=params_filename)
        for n in scope.local_var_names():
            var = scope.find_var(n)
            if isinstance(var.value(), torch.Tensor):
                var.set_value(_HostTensor(var.value()))
        return cls(program, feed_names=feed_names,
                   fetch_list=fetch_targets, place=place, scope=scope,
                   executor=exe, **kwargs)

    # ---- lifecycle ----------------------------------------------------

    def start(self):
        """Spawn the worker thread (queued mode)."""
        if self._closed:
            raise RuntimeError('engine is closed')
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._serve_loop, name=self.name, daemon=True)
            self._thread.start()
            if self.config.watchdog_stall_s is not None and \
                    self._watchdog_probe is None:
                # weak closures: the global watchdog must not pin a
                # dropped engine (and its scope's device tensors) alive
                ref = weakref.ref(self)

                def age(ref=ref):
                    eng = ref()
                    return eng._batcher.oldest_age() if eng else None

                def ctx(ref=ref):
                    eng = ref()
                    return eng._stall_context() if eng else None

                self._watchdog_probe = _trace.watchdog.register(
                    'serving/%s/queue_age' % self.name, age,
                    self.config.watchdog_stall_s, context_fn=ctx)
                self._watchdog_age_fn = age
                weakref.finalize(self, _trace.watchdog.unregister,
                                 self._watchdog_probe, age)
        return self

    def _stall_context(self):
        """The stall dump's in-flight view: trace ids still queued plus
        those dispatched but not yet delivered."""
        inflight = []
        try:
            for _, lots, _, _, _, _ in list(self._inflight):
                for lot in lots:
                    inflight.extend(r.trace_id for r in lot.requests)
        except RuntimeError:
            pass  # a drain mutated the deque mid-snapshot
        return {'queued_trace_ids': self._batcher.pending_trace_ids(),
                'inflight_trace_ids': inflight}

    def stop(self):
        """Drain the queue and all in-flight dispatches, then join."""
        if self._closed:
            return
        self._closed = True
        self._batcher.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        else:
            self._drain_inline()
        if self._watchdog_probe is not None:
            _trace.watchdog.unregister(self._watchdog_probe,
                                       self._watchdog_age_fn)
            self._watchdog_probe = None
        _profiler.unregister_metrics_source(self._metrics_key,
                                            self._metrics_fn)

    close = stop

    @contextlib.contextmanager
    def paused(self):
        """Quiesce the engine: block inline submitters and the worker's
        dispatch cycles, deliver every in-flight dispatch, and hold the
        engine idle for the with-block (the arbiter's eviction window).
        submit() keeps queueing; queued requests wait out the pause."""
        with self._inline_lock:
            with self._cycle_lock:
                while self._inflight:
                    self._drain_one()
                yield self

    # ---- footprint / eviction (the ModelRegistry's arbiter hooks) ------

    def _on_device(self, v):
        return isinstance(v, torch.Tensor) and \
            v.device.type == self.place.device.type and \
            (v.device.index or 0) == (self.place.device.index or 0)

    def _model_values(self):
        """(scope var, value) of each of the model's persistables that the
        scope holds."""
        for name in self._model_vars:
            var = self._scope.find_var(name)
            if var is not None:
                yield var, var.value()

    def device_footprint(self):
        """Live device bytes of this engine's model: the bytes of the
        persistables its program reads that lie on the engine's device
        (the graphs' private pools are not in it).  Host forms count
        nothing."""
        return sum(v.numel() * v.element_size()
                   for _, v in self._model_values() if self._on_device(v))

    def hbm_footprint(self):
        """Per-device live bytes (the JAX engine's shard-aware count): one
        device, so ``device_footprint()``."""
        return self.device_footprint()

    def drop_executables(self, programs=None):
        """Drop every cached block of THIS engine's programs from its
        executor (``Executor.purge_programs``): a shared executor keeps
        other models' blocks.  Their graphs and state buffers are released
        at the executor's next resolve (or at once by ``evict_to_host``).
        Returns the number of blocks dropped."""
        if programs is None:
            programs = [self._program]
        return self._exe.purge_programs(programs)

    def evict_to_host(self):
        """Demote the model to host memory: paused and under the dispatch
        gate, each of the model's persistables on the device (those
        ``device_footprint`` counts) is copied to a CPU tensor (bitwise:
        dtype and values kept, so the round trip is exact), the
        engine's blocks are dropped and their graphs and state buffers
        released, and on the card the allocator's cache is emptied, so the
        memory goes back to the card.  Returns (bytes moved, blocks
        dropped).  Reload is transparent: the next dispatch stages the
        host forms back and the executor plans and captures afresh."""
        with self.paused():
            with self._gated():
                moved = 0
                for var, v in list(self._model_values()):
                    if self._on_device(v):
                        host = v.detach().to('cpu', copy=True)
                        var.set_value(_HostTensor(host))
                        moved += host.numel() * host.element_size()
                dropped = self.drop_executables()
                self._exe.release_retired()
                if self.place.device.type == 'cuda':
                    torch.cuda.empty_cache()
        return moved, dropped

    def _stage(self):
        """Put the host forms of the model's persistables back on the
        engine's device (the reload half of ``evict_to_host``, and a saved
        model's first staging), as the JAX executor caches its read-only
        state back on the device.  Runs under the dispatch gate."""
        device = self.place.device
        for var, v in self._model_values():
            if isinstance(v, _HostTensor):
                var.set_value(v.tensor().to(device))

    @contextlib.contextmanager
    def _gated(self):
        gate = self._gate
        if gate is None:
            yield
        else:
            with gate:
                yield

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---- request surface ----------------------------------------------

    def _service_estimate(self, req):
        """The shed horizon for ONE pending request: 3x the service floor
        of its own coalescing signature, else the profile's global floor,
        else the engine-wide min-wall window."""
        est = self._profile.estimate(req.sig)
        if est is None:
            est = self._profile.floor()
        if est is None:
            est = (min(self._service_walls)
                   if self._service_walls else 0.0)
        return 3.0 * est

    def rate_stats(self):
        """Measured arrival vs drain rates (requests/s over the recent
        window; None while idle or single-sample)."""
        return {'arrival_req_s': self._arrivals.rate(),
                'drain_req_s': self._drains.rate()}

    def queue_depth(self):
        """Current micro-batch queue depth."""
        return self._batcher.depth()

    def _shed_request(self, req, where='queue'):
        """Resolve one past-deadline request as SHED: typed
        DeadlineExceededError, a 'shed' trace stage, a flight-recorder
        record, and the metrics counter."""
        if req.done():
            return
        now = time.time()
        late_ms = (round((now - req.deadline_t) * 1e3, 3)
                   if req.deadline_t is not None else None)
        if req.trace is not None:
            req.trace.add_stage('shed', now - req.enqueue_t)
            self._metrics.note_stages(req.trace.finalize(end=now))
        self._metrics.note_shed()
        _trace.flight_recorder.record(
            'serving_shed', engine=self.name, where=where,
            trace_id=req.trace_id, deadline_ms=req.deadline_ms,
            late_by_ms=late_ms)
        req.set_error(DeadlineExceededError(
            req.trace_id, req.deadline_ms, late_ms, where=where))

    def submit(self, feed, return_numpy=True, priority=0,
               deadline_ms=None):
        """Enqueue one request; returns an InferenceRequest future.  When
        the engine is not start()ed, the dispatch runs inline on this
        thread and the future is already done.  ``priority`` and
        ``deadline_ms`` ride the EDF scheduler: a request whose deadline
        passes while it waits is SHED (DeadlineExceededError) instead of
        served late."""
        if self._closed:
            raise EngineClosedError('engine is closed')
        if not isinstance(feed, dict) or not feed:
            raise ValueError('feed must be a non-empty {name: data} dict')
        if self._feed_names is not None:
            missing = set(self._feed_names) - set(feed)
            extra = set(feed) - set(self._feed_names)
            if missing or extra:
                raise ValueError(
                    'feed names %s do not match the inference program '
                    '(missing %s, unexpected %s)' %
                    (sorted(feed), sorted(missing), sorted(extra)))
        # ONE trace id per request: adopt the ambient context a router
        # attached, else mint one here
        ctx = _trace.current() or _trace.TraceContext()
        t_prep = time.time()
        feed, rows, sig, trims = self._prepare_request(feed)
        ctx.add_stage('pad', time.time() - t_prep)
        req = InferenceRequest(feed, rows, sig, return_numpy=return_numpy,
                               trailing=trims, trace=ctx,
                               priority=priority, deadline_ms=deadline_ms)
        self._metrics.note_request(rows or 1)
        self._arrivals.note()
        ctx.mark('enqueue')
        self._batcher.submit(req)
        if self._thread is None:
            self._drain_inline()
        return req

    def infer(self, feed, return_numpy=True, timeout=None):
        """Synchronous convenience: submit + wait."""
        return self.submit(feed, return_numpy=return_numpy).result(timeout)

    def submit_generate(self, *args, **kwargs):
        raise NotImplementedError('submit_generate: ' + _GENERATION_TODO)

    def generate(self, *args, **kwargs):
        raise NotImplementedError('generate: ' + _GENERATION_TODO)

    def metrics(self):
        """Engine snapshot + bucket reports + the executor's own compile
        counter (the ground truth the bucket policy bounds)."""
        snap = self._metrics.snapshot(
            queue_depth=self._batcher.depth(),
            queue_age=self._batcher.age_stats())
        snap['buckets'] = self.buckets.report()
        snap['trailing_buckets'] = (self.trailing.report()
                                    if self.trailing is not None else None)
        snap['executor_compile_count'] = self._exe.compile_count
        snap['inflight'] = len(self._inflight)
        snap['decode'] = None
        snap['embed_cache'] = None
        snap['service_profile'] = self._profile.snapshot()
        rates = self.rate_stats()
        snap['arrival_req_s'] = (round(rates['arrival_req_s'], 3)
                                 if rates['arrival_req_s'] else None)
        snap['drain_req_s'] = (round(rates['drain_req_s'], 3)
                               if rates['drain_req_s'] else None)
        return snap

    # ---- request -> lot -----------------------------------------------

    def _prepare_request(self, feed):
        """(feed, rows, coalescing signature, trailing trim map) for a
        request.  With trailing bucketing on, single-level LoD feeds lower
        to padded [B, T, ...] + @SEQLEN here (the executor's own lowering,
        already rung-quantized) and PaddedSequence / dense ladder feeds
        zero-pad their trailing axes up to the covering rung, so
        mixed-length requests in one rung share a signature.  Unbatchable
        feeds (host-op programs, scalars, NESTED LoD, any sequence feed
        with trailing bucketing off) come back as (feed, None, unique,
        None): single-request lots with no padding."""
        if self._eager:
            return feed, None, object(), None
        seq_like = False
        for v in feed.values():
            if isinstance(v, core.PaddedSequence):
                if self.trailing is None or v.rows is not None:
                    return feed, None, object(), None
                seq_like = True
            elif isinstance(v, core.LoDTensor) and v.lod():
                if self.trailing is None or len(v.lod()) >= 2:
                    return feed, None, object(), None
                seq_like = True
        items = prepare_feed_arrays(feed) if seq_like else dict(feed)
        # validate BEFORE bucketing: a request rejected here must leave no
        # trace in the trailing accounting
        leads = {}
        for name, v in sorted(items.items()):
            lead = _lead(v)
            if lead is None:
                return feed, None, object(), None
            if lead == 0:
                raise ValueError(
                    'feed %r has 0 rows — an empty request has no '
                    'result to serve' % name)
            leads[name] = lead
        if len(set(leads.values())) > 1:
            raise ValueError(
                'feeds disagree on the leading (batch) dim: %s — every '
                'input of one request must carry the same number of '
                'rows' % ({n: d for n, d in sorted(leads.items())}, ))
        trims = self._bucket_trailing(items) \
            if self.trailing is not None else None
        sig = tuple((name, _shape(v)[1:], _dtype_name(v))
                    for name, v in sorted(items.items()))
        return (items, int(next(iter(leads.values()))), sig, trims)

    def _bucket_trailing(self, items):
        """Quantize ``items``' variable trailing dims onto the
        TrailingDimBuckets ladder IN PLACE (zero fill, the pad
        _lod_to_padded applies): axis 1 of every feed with a @SEQLEN
        companion rides the shared seq-len policy; feeds named in
        ``trailing_ladders`` pad their configured axes.  Returns the
        axis-1 trim map {padded extent: real extent} for delivery; a rung
        claimed by two different real extents, or coinciding with a
        static axis-1 extent of a non-bucketed feed or of a fetch target,
        is ambiguous and dropped (such fetches deliver at the rung)."""
        claims = {}  # rung -> set of real axis-1 extents claiming it
        static_ax1 = set(self._fetch_static_ax1)
        plan = []  # (name, axes, explicit, shape), validated upfront
        for name in list(items):
            if name.endswith(SEQLEN_SUFFIX) or name == SAMPLE_MASK_NAME:
                continue
            explicit = set(self.trailing.ladder_axes(name))
            axes = set(explicit)
            if (name + SEQLEN_SUFFIX) in items:
                axes.add(1)
            shape = _shape(items[name])
            for ax in sorted(explicit):
                if ax >= len(shape):
                    raise ValueError(
                        'trailing ladder for feed %r names axis '
                        '%d, but the request has only %d dims — '
                        'fix trailing_ladders' % (name, ax, len(shape)))
            for ax in sorted(axes):
                if 1 <= ax < len(shape) and int(shape[ax]) < 1:
                    raise ValueError(
                        'feed %r has zero width on bucketed trailing '
                        'axis %d — an empty extent has nothing to '
                        'serve' % (name, ax))
            if 1 not in axes and len(shape) >= 2:
                static_ax1.add(int(shape[1]))
            if axes:
                plan.append((name, axes, explicit, shape))
        for name, axes, explicit, shape in plan:
            v = items[name]
            rows = max(int(shape[0]), 1) if shape else 1
            pads, prod_real, prod_rung = [], 1, 1
            seq_lens_sum, bucketed = None, False
            for ax in sorted(axes):
                if ax >= len(shape) or ax < 1:
                    continue
                real = int(shape[ax])
                rung = self.trailing.bucket_for(name, ax, real)
                bucketed = True
                if ax == 1 and (name + SEQLEN_SUFFIX) in items:
                    # a seq feed's true occupancy is its lengths' sum: the
                    # rung pad a lowered LoD feed already carries counts as
                    # waste too
                    seq_lens_sum = max(int(_to_tensor(
                        items[name + SEQLEN_SUFFIX]).sum()), 0)
                    prod_rung *= rung
                else:
                    prod_real *= real
                    prod_rung *= rung
                if ax == 1:
                    claims.setdefault(rung, set()).add(real)
                if rung != real:
                    pads.append((ax, rung - real))
            if pads:
                t = _to_tensor(v)
                # F.pad lists (left, right) pairs from the LAST axis back
                width = [0] * (2 * t.dim())
                for ax, p in pads:
                    width[2 * (t.dim() - 1 - ax) + 1] = p
                items[name] = torch.nn.functional.pad(t, width)
            if bucketed:
                base = seq_lens_sum if seq_lens_sum is not None else rows
                self._metrics.note_trailing(base * prod_real,
                                            rows * prod_rung)
        trims = {rung: reals.pop() for rung, reals in claims.items()
                 if len(reals) == 1 and rung not in reals
                 and rung not in static_ax1}
        return trims or None

    def _make_lot(self, requests):
        now = time.time()
        for r in requests:
            if r.trace is not None:
                r.trace.mark('collect', now)
        if _profiler.is_profiler_enabled() or _trace.spans_enabled():
            for r in requests:
                _profiler.record_event(self._spans + 'queue_wait',
                                       now - r.enqueue_t,
                                       start=r.enqueue_t)
        head = requests[0]
        if head.rows is None:
            # unbatchable: its own lot, no padding
            self._metrics.note_lot(1, 1, deadline_flush=False)
            if head.trace is not None:
                head.trace.mark('lot')
            return _Lot(requests, dict(head.feed), None, None,
                        ('nobatch', id(head)), kind=head.kind)
        rows = sum(r.rows for r in requests)
        bucket = self.buckets.bucket_for(rows)
        names = set(head.feed)
        if len(requests) == 1:
            feed = dict(head.feed)
        else:
            feed = {n: torch.cat([_to_tensor(r.feed[n]) for r in requests])
                    for n in names}
        # the mask rides every lot, so a full lot and a padded lot run
        # the same block (mask all ones vs ragged)
        feed, real, target = pad_ragged_batch(feed, bucket, names)
        deadline_flush = rows < self.config.max_batch_size
        self._metrics.note_lot(real, target, deadline_flush)
        t_lot = time.time()
        for r in requests:
            if r.trace is not None:
                r.trace.mark('lot', t_lot)
        return _Lot(requests, feed, real, target,
                    (head.kind, target, feed_signature(feed)),
                    kind=head.kind)

    # ---- dispatch / deliver -------------------------------------------

    def _dispatch(self, lots):
        """ONE run_eval_multi dispatch over K same-bucket lots, tracked in
        the in-flight pipeline with no host sync.  Host-op (eager)
        programs run one exe.run per lot instead."""
        if self._eager:
            return self._dispatch_eager(lots)
        t0 = time.time()
        before = self._exe.compile_count
        trace_ids = [r.trace_id for lot in lots for r in lot.requests]
        # recorded BEFORE the dispatch: a dispatch that errors must show in
        # the dump
        _trace.flight_recorder.record(
            'serving_dispatch', engine=self.name, lots=len(lots),
            lot_kind=lots[0].kind,
            bucket=lots[0].bucket, sig=repr(lots[0].sig)[:128],
            rows=[lot.real for lot in lots], trace_ids=trace_ids)
        feed_list = [l.feed for l in lots]
        try:
            with self._gated():
                self._stage()
                stacked, reals, target, compiled, k = \
                    self._exe._dispatch_eval_multi(
                        self._program, feed_list=feed_list,
                        fetch_list=self._fetch_list, scope=self._scope)
        except Exception as exc:
            self._metrics.note_error()
            _trace.flight_recorder.dump(
                'worker_error:%s' % self.name, error=repr(exc),
                trace_ids=trace_ids)
            for lot in lots:
                for req in lot.requests:
                    req.set_error(exc)
            return
        self._metrics.note_dispatch(k, self._exe.compile_count - before)
        t_disp = time.time()
        for lot in lots:
            for req in lot.requests:
                if req.trace is not None:
                    req.trace.mark('dispatch', t_disp)
        cost = getattr(compiled, 'last_eval_cost', None)
        self._inflight.append((stacked, lots, compiled, t0, t_disp, cost))

    def _dispatch_eager(self, lots):
        """Per-lot exe.run for host-op programs, delivered synchronously."""
        for lot in lots:
            t0 = time.time()
            req = lot.requests[0]  # eager lots are single-request
            before = self._exe.compile_count
            if req.trace is not None:
                req.trace.mark('dispatch', t0)
            _trace.flight_recorder.record(
                'serving_dispatch', engine=self.name, lots=1, eager=True,
                trace_ids=[req.trace_id])
            try:
                with self._gated():
                    self._stage()
                    outs = self._exe.run(self._program, feed=lot.feed,
                                         fetch_list=self._fetch_list,
                                         scope=self._scope,
                                         return_numpy=req.return_numpy)
            except Exception as exc:
                self._metrics.note_error()
                _trace.flight_recorder.dump(
                    'worker_error:%s' % self.name, error=repr(exc),
                    trace_ids=[req.trace_id])
                req.set_error(exc)
                continue
            self._metrics.note_dispatch(
                1, self._exe.compile_count - before)
            if req.trace is not None:
                req.trace.mark('sync')
                self._metrics.note_stages(req.trace.finalize())
            req.set_result(outs)
            if req.latency_s is not None:
                self._metrics.note_latency(req.latency_s)
            if _profiler.is_profiler_enabled() or _trace.spans_enabled():
                _profiler.record_event(self._spans + 'dispatch[eager]',
                                       time.time() - t0, start=t0)

    def _drain_one(self):
        """Deliver the OLDEST in-flight dispatch: host copy (the sync
        point), trim each lot to its real rows, slice per request, resolve
        the futures."""
        stacked, lots, compiled, t0, t_disp, cost = \
            self._inflight.popleft()
        try:
            arrays = [to_numpy(a, n) if isinstance(a, torch.Tensor)
                      else np.asarray(a)
                      for a, n in zip(stacked, compiled.fetch_names)]
        except Exception as exc:
            self._metrics.note_error()
            _trace.flight_recorder.dump(
                'worker_error:%s' % self.name, error=repr(exc),
                trace_ids=[r.trace_id for lot in lots
                           for r in lot.requests])
            for lot in lots:
                for req in lot.requests:
                    req.set_error(exc)
            return
        t_sync = time.time()
        for lot in lots:
            for req in lot.requests:
                if req.trace is not None:
                    req.trace.mark('sync', t_sync)
        # achieved FLOP rate: the cost registry's FLOPs over the wall the
        # device could have spent on THIS dispatch, clipped to start no
        # earlier than the previous drain's sync (pipelined windows overlap)
        dev_start = max(t_disp, self._last_sync_t)
        if cost is not None and cost.get('flops') and t_sync > dev_start:
            self._metrics.note_device(cost['flops'], t_sync - dev_start)
        # the shed horizon's input: one dispatch's RAW issue->sync span
        # (including the wait behind earlier in-flight dispatches, which
        # is part of a new lot's delivery time)
        wall = max(t_sync - t0, 0.0)
        self._service_walls.append(wall)
        for key in {lot.requests[0].sig for lot in lots}:
            if cost is not None and cost.get('flops'):
                rate = self._metrics.device_rate()
                if rate:
                    self._profile.seed(key, cost['flops'] / rate)
            self._profile.observe(key, wall)
        self._last_sync_t = t_sync
        led = fetch_batch_led(compiled, len(arrays))
        if not all(led) and not self._warned_unsliced and \
                any(len(lot.requests) > 1 for lot in lots):
            # a batch-REDUCED fetch from a coalesced lot covers every
            # rider's rows: there is no per-request value to slice out
            self._warned_unsliced = True
            warnings.warn(
                'serving engine %s: fetches %s are not per-row '
                '(batch-led) — coalesced requests receive the value '
                'computed over the WHOLE micro-batch, not their own '
                'rows.  Fetch per-row outputs, or serve such programs '
                'with max_batch_size=1.' %
                (self.name,
                 [n for n, is_led in zip(
                     getattr(compiled, 'fetch_names',
                             range(len(led))), led) if not is_led]))
        for j, lot in enumerate(lots):
            offset = 0
            for req in lot.requests:
                res = []
                for a, is_led in zip(arrays, led):
                    step = a[j]
                    if lot.real is not None and is_led \
                            and np.ndim(step) >= 1 \
                            and np.shape(step)[0] == lot.bucket:
                        step = step[offset:offset + req.rows]
                        if req.trailing is not None \
                                and np.ndim(step) >= 2:
                            # a per-row fetch mirroring a rung-padded
                            # input axis trims back to the request's real
                            # extent (ambiguous extents were dropped at
                            # submit and deliver at the rung)
                            real = req.trailing.get(np.shape(step)[1])
                            if real is not None:
                                step = step[:, :real]
                    if not req.return_numpy:
                        step = core.LoDTensor(torch.from_numpy(
                            np.ascontiguousarray(step)))
                    res.append(step)
                offset += req.rows or 0
                if req.trace is not None:
                    # finalize BEFORE resolving: a caller woken by result()
                    # sees a complete breakdown
                    self._metrics.note_stages(req.trace.finalize())
                    _trace.record_span(
                        self._spans + 'request', req.trace.t0,
                        req.trace.e2e_s, trace_id=req.trace_id)
                req.set_result(res)
                self._drains.note()
                if req.latency_s is not None:
                    self._metrics.note_latency(req.latency_s)
        if _profiler.is_profiler_enabled() or _trace.spans_enabled():
            _profiler.record_event(
                self._spans + 'dispatch[x%d]' % len(lots),
                time.time() - t0, start=t0)

    # ---- worker -------------------------------------------------------

    def _safe_make_lot(self, requests):
        """_make_lot that fails the LOT, not the worker."""
        try:
            return self._make_lot(requests)
        except Exception as exc:
            self._metrics.note_error()
            for req in requests:
                req.set_error(exc)
            return None

    def _collect_block(self, first_lot):
        """Extend a block with already-flushable same-bucket lots, then TRIM
        to a power-of-two lot count (extras go back on the carry queue):
        each distinct K is one compiled (steps, signature) pair, so the
        ladder bounds them at log2(K)+1 per bucket."""
        lots = [first_lot]
        while len(lots) < self.config.steps_per_dispatch:
            if self._carry:
                lot = self._carry.popleft()
            else:
                more = self._batcher.next_lot(timeout=0)
                if not more:
                    break
                lot = self._safe_make_lot(more)
                if lot is None:
                    continue
            if lot.sig != lots[0].sig:
                self._carry.appendleft(lot)
                break
            lots.append(lot)
        k = 1
        while k * 2 <= len(lots):
            k *= 2
        self._carry.extend(lots[k:])
        return lots[:k]

    def _serve_loop(self):
        if self.place.device.type == 'cuda':
            # the worker's own thread: select the engine's card, so that
            # its tensors, streams and captures land there
            torch.cuda.set_device(self.place.device)
        poll = max(min(self.config.max_wait_s, 0.005), 0.001)
        while True:
            try:
                reqs = []
                if not self._carry:
                    # an idle engine blocks on the queue's condition var
                    # OUTSIDE the cycle lock, so a paused() window never
                    # waits for traffic
                    reqs = self._batcher.next_lot(
                        timeout=poll if self._inflight else None)
                    if reqs is None:
                        break  # closed and drained
                # one collect->dispatch->drain cycle is the pause unit
                with self._cycle_lock:
                    if self._carry and not reqs:
                        self._dispatch(
                            self._collect_block(self._carry.popleft()))
                    elif reqs:
                        lot = self._safe_make_lot(reqs)
                        if lot is not None:
                            self._dispatch(self._collect_block(lot))
                    elif self._inflight:
                        self._drain_one()  # idle: deliver early
                    # backpressure: at most pipeline_depth dispatches in
                    # flight
                    while len(self._inflight) >= self.config.pipeline_depth:
                        self._drain_one()
            except Exception as exc:
                # _dispatch/_drain_one error their own lots' futures;
                # whatever still escapes must not kill the serving thread
                self._metrics.note_error()
                _trace.flight_recorder.dump(
                    'worker_error:%s' % self.name, error=repr(exc))
        with self._cycle_lock:
            while self._carry:
                self._dispatch([self._carry.popleft()])
            while self._inflight:
                self._drain_one()

    def _drain_inline(self):
        """Synchronous mode: flush + dispatch + deliver on the calling
        thread.  Serialized by _inline_lock."""
        with self._inline_lock:
            while True:
                progressed = False
                if self._carry:
                    self._dispatch(
                        self._collect_block(self._carry.popleft()))
                    progressed = True
                else:
                    reqs = self._batcher.next_lot(timeout=0, force=True)
                    if reqs:
                        lot = self._safe_make_lot(reqs)
                        if lot is not None:
                            self._dispatch(self._collect_block(lot))
                        progressed = True
                while self._inflight:
                    self._drain_one()
                    progressed = True
                if not progressed and not self._carry:
                    break
