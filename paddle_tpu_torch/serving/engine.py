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
     its name);
  5. **generation** (``generation=GenerationSpec``, ``submit_generate``):
     prompts prefill through the lot machinery above (or, under
     ``prefill_chunk=C``, as C-token chunk dispatches into PREFILLING
     slots, at most one per worker cycle after the decode dispatch), then
     admit into a ``SlotStateCache`` slot at a step boundary and decode in
     ``Executor._dispatch_decode_multi`` dispatches of ``decode_steps``
     greedy steps over the whole slot batch (on the card, K replays of one
     captured step).  At ``decode_pipeline_depth`` >= 2 dispatch N+1 is
     queued against dispatch N's carry before N is harvested: each
     dispatch's tokens go to the host behind an event of their own
     (``HostCopy``), so a harvest waits for its dispatch only.
     Admission, shedding and eviction happen at chain-flush points.

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

Not ported yet, each raising ``NotImplementedError``: dp/mesh serving,
generation included (``parallel=``, ``mesh=``; ROADMAP.md, Queue 1 item
7) and the embedding caches (``embed_caches=``; item 9).
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
from ..fluid.executor import Executor, HostCopy, feed_signature, \
    fetch_batch_led, prepare_feed_arrays, to_numpy, _as_tensor, _lead
from ..fluid.shape_policy import bucketed_len
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
    decode_slots: slot count of the generation lane's decode cache (the
        continuous-batching degree); meaningful with ``generation=``.
    decode_steps: greedy decode steps per device dispatch (the K of the
        decode loop: K replays of the captured step on the card).
    decode_pipeline_depth: decode dispatches kept in flight.  At 2 (the
        default) dispatch N+1 is queued against N's carry before N's
        tokens are harvested, so the host's bookkeeping overlaps the
        card's work; 1 is the per-dispatch-sync lane.
    prefill_chunk: chunked prefill: every prompt is consumed in C-token
        blocks interleaved with decode dispatches (decode first, at most
        one chunk a worker cycle), so the longest decode stall a prompt
        imposes is one chunk's wall.  Quantized up to the seq-len rung
        ladder; must equal the model's ``build_step_decode(chunk=C)``
        width.  None keeps the monolithic prefill lane.
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
                 decode_slots=8, decode_steps=4, decode_pipeline_depth=2,
                 prefill_chunk=None, scheduling='edf',
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
        if int(decode_slots) < 1:
            raise ValueError('decode_slots must be >= 1')
        if int(decode_steps) < 1:
            raise ValueError('decode_steps must be >= 1')
        self.decode_slots = int(decode_slots)
        self.decode_steps = int(decode_steps)
        if int(decode_pipeline_depth) < 1:
            raise ValueError('decode_pipeline_depth must be >= 1 '
                             '(1 = the per-dispatch-sync lane)')
        self.decode_pipeline_depth = int(decode_pipeline_depth)
        if prefill_chunk is not None:
            if int(prefill_chunk) < 1:
                raise ValueError('prefill_chunk must be >= 1 (or None '
                                 'for monolithic prefill)')
            prefill_chunk = bucketed_len(int(prefill_chunk))
        self.prefill_chunk = prefill_chunk
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
                'sharded serving (parallel=, mesh=) on ParallelExecutor is '
                'not ported to PyTorch yet (ROADMAP.md, Queue 1 item 8)')
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
        # the model: the persistables its programs read (account, eviction
        # and staging all cover this one set)
        programs = [program]
        if generation is not None:
            programs += [generation.prefill_program,
                         generation.step_program]
            if generation.chunk_program is not None:
                programs.append(generation.chunk_program)
        self._model_vars = sorted(
            {n for prog in programs for blk in prog.blocks for op in blk.ops
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
        # the generation lane: prompts prefill through the lot machinery,
        # then decode in slot-batched dispatches
        self.generation = generation
        self._decode_cache = None
        self._gen_ready = deque()  # (request, prefill values) awaiting a slot
        # in-flight decode-lane dispatches not yet harvested, FIFO = device
        # order: ('decode', HostCopy of (tokens, alive_in), None, k,
        # t_disp, slot->request at dispatch, slot-map snapshot) or
        # ('chunk', HostCopy of alive', None, width, t_disp, None, snap)
        self._decode_inflight = deque()
        # dispatch -> harvest walls: the lane's service floor
        self._decode_walls = deque(maxlen=8)
        # chunked prefill: prompts awaiting a prefilling slot, chunk walls
        # (the decode-priority budget) and the stall gauge's state
        self._chunk_pending = deque()
        self._chunk_walls = deque(maxlen=8)
        self._prefill_since_harvest = False
        self._last_harvest_t = None
        self._last_harvest_alive = frozenset()
        self._chunking = False
        if generation is None and self.config.prefill_chunk is not None:
            raise ValueError(
                'ServingConfig(prefill_chunk=) only applies to '
                'generation= engines — there is no prefill to chunk')
        if generation is not None:
            if self._eager:
                raise NotImplementedError(
                    'generation serving cannot run host-op programs — '
                    'the decode loop is pure compute')
            from .decode import SlotStateCache
            self._decode_cache = SlotStateCache(generation,
                                                self.config.decode_slots)
            self._gen_decode_arg = generation.decode_arg()
            if self.config.prefill_chunk is not None:
                if not generation.supports_chunked_prefill:
                    raise ValueError(
                        'ServingConfig(prefill_chunk=%d): this generation '
                        'model has no chunk program — build it with '
                        'build_step_decode(chunk=%d) (and run its '
                        'chunk_startup), or drop prefill_chunk'
                        % (self.config.prefill_chunk,
                           self.config.prefill_chunk))
                if generation.chunk_width != self.config.prefill_chunk:
                    raise ValueError(
                        'ServingConfig(prefill_chunk=%d) does not match '
                        'the model\'s chunk width %d — the chunk block\'s '
                        'shape is fixed at build time'
                        % (self.config.prefill_chunk,
                           generation.chunk_width))
                self._gen_chunk_arg = generation.chunk_arg()
                self._chunking = True
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
        ctx = {'queued_trace_ids': self._batcher.pending_trace_ids(),
               'inflight_trace_ids': inflight}
        if self._decode_cache is not None:
            # the decode lane's view: who holds each slot, how many
            # prefilled requests still wait for one, and the in-flight
            # chain (dispatched, never harvested)
            ctx['decode_slot_map'] = self._decode_cache.snapshot()
            ctx['decode_pending'] = len(self._gen_ready) + \
                len(self._chunk_pending)
            now = time.time()
            try:
                ctx['decode_chain'] = [
                    {'kind': e[0], 'steps': e[3],
                     'age_s': round(now - e[4], 4)}
                    for e in list(self._decode_inflight)]
            except RuntimeError:
                ctx['decode_chain'] = None  # a harvest raced the snapshot
        return ctx

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
                if self._decode_cache is not None:
                    # the decode chain counts as in flight too: flush it
                    # to a consistent boundary before anything moves
                    self._decode_flush()
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
            if self.generation is not None:
                programs += self._generation_programs()
        return self._exe.purge_programs(programs)

    def _generation_programs(self):
        gen = self.generation
        programs = [gen.prefill_program, gen.step_program]
        if gen.chunk_program is not None:
            programs.append(gen.chunk_program)
        return programs

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

    def submit_generate(self, feed, max_len=None, return_numpy=True,
                        priority=0, deadline_ms=None):
        """Enqueue one GENERATION request: ``feed`` is the prompt (the
        generation spec's prefill feeds, one sequence), ``max_len`` the
        per-request step budget (capped by the spec's).  Returns a
        GenerationRequest future resolving to the generated token ids
        (greedy; EOS-terminated or cut at max_len), token-identical to a
        per-request decode of the same prefill and step programs.

        The prompt coalesces into PREFILL lots with other generation
        requests (or, under ``prefill_chunk``, waits for a prefilling
        slot); the prefilled state then admits into a free decode slot at
        the next step boundary.  ``priority`` / ``deadline_ms`` ride the
        prefill lot like a forward request's; the decode lane also checks
        the deadline at every step boundary, and an expired generation
        releases its slot and sheds."""
        from .decode import GenerationRequest
        if self.generation is None:
            raise RuntimeError(
                'submit_generate: this engine serves no generation '
                'model — construct it with generation=GenerationSpec(...)')
        if self._closed:
            raise EngineClosedError('engine is closed')
        spec = self.generation
        if not isinstance(feed, dict) or not feed:
            raise ValueError('feed must be a non-empty {name: data} dict')
        missing = set(spec.prefill_feeds) - set(feed)
        extra = set(feed) - set(spec.prefill_feeds)
        if missing or extra:
            raise ValueError(
                'submit_generate: feed names %s do not match the '
                'prefill program (missing %s, unexpected %s)'
                % (sorted(feed), sorted(missing), sorted(extra)))
        max_len = spec.max_len if max_len is None else int(max_len)
        if max_len < 1:
            raise ValueError('submit_generate: max_len must be >= 1')
        max_len = min(max_len, spec.max_len)
        # the typed over-length reject, measured on the raw feed before any
        # padding touches it
        prompt_ids = prompt_len = None
        if spec.prompt_feed is not None and spec.prompt_feed in feed \
                and (self._chunking or spec.max_ctx is not None):
            prompt_ids, prompt_len = spec.prompt_ids(feed)
        if self._chunking and prompt_len is not None and prompt_len < 1:
            # no chunk to dispatch: the future would hang, the slot leak
            raise ValueError(
                'submit_generate: the prompt is empty — chunked prefill '
                'needs at least one token to consume')
        if spec.max_ctx is not None and prompt_len is not None:
            if prompt_len > spec.max_ctx:
                raise ValueError(
                    'submit_generate: prompt length %d exceeds the decode '
                    'context max_ctx=%d — the KV slab has no row to hold '
                    'token %d' % (prompt_len, spec.max_ctx, spec.max_ctx))
            if prompt_len + max_len > spec.max_ctx:
                raise ValueError(
                    'submit_generate: prompt length %d + max_len %d '
                    'exceeds the decode context max_ctx=%d — generated '
                    'tokens would write off the KV slab; shorten the '
                    'prompt or lower max_len'
                    % (prompt_len, max_len, spec.max_ctx))
        if self._chunking and prompt_ids is None:
            raise ValueError(
                'submit_generate: chunked prefill needs the prompt feed '
                '%r in the request' % (spec.prompt_feed, ))
        ctx = _trace.current() or _trace.TraceContext()
        if self._chunking:
            # no prefill lot forms: only the one-sequence check, no padding
            rows = self._chunk_prompt_rows(feed[spec.prompt_feed])
            if rows != 1:
                raise ValueError(
                    'submit_generate: the prompt must be ONE sequence '
                    '(got %r rows) — submit one request per sequence so '
                    'each occupies one decode slot' % (rows, ))
            feed, sig = None, ('gen-chunk', )
        else:
            t_prep = time.time()
            feed, rows, sig, _trims = self._prepare_request(feed)
            ctx.add_stage('pad', time.time() - t_prep)
            if rows is None:
                raise ValueError(
                    'submit_generate: this prompt cannot ride the batched '
                    'prefill path — nested (2-level) LoD prompts are '
                    'unsupported, and LoD prompts need trailing bucketing '
                    '(drop ServingConfig(trailing_buckets=False))')
            if rows != 1:
                raise ValueError(
                    'submit_generate: the prompt must be ONE sequence '
                    '(got %r rows) — submit one request per sequence so '
                    'each occupies one decode slot' % (rows, ))
            # prefill lots never share a block with forward lots
            sig = ('gen', ) + tuple(sig)
        req = GenerationRequest(feed, 1, sig, max_len,
                                return_numpy=return_numpy, trace=ctx,
                                priority=priority, deadline_ms=deadline_ms)
        if self._chunking:
            req.prompt_tokens = prompt_ids
            req.prompt_len = prompt_len
        self._metrics.note_generate()
        self._arrivals.note()
        ctx.mark('enqueue')
        self._batcher.submit(req)
        if self._thread is None:
            self._drain_inline()
        return req

    @staticmethod
    def _chunk_prompt_rows(v):
        """How many sequences the prompt feed carries: an LoD prompt its
        top-level sequences (nested LoD rejected), a dense one its leading
        dim."""
        if isinstance(v, core.LoDTensor) and v.lod():
            if len(v.lod()) >= 2:
                raise ValueError(
                    'submit_generate: nested (2-level) LoD prompts are '
                    'unsupported under chunked prefill')
            return max(len(v.lod()[-1]) - 1, 0)
        shape = _shape(v)
        return int(shape[0]) if shape else 0

    def generate(self, feed, max_len=None, timeout=None):
        """Synchronous convenience: submit_generate + wait."""
        return self.submit_generate(feed, max_len=max_len).result(timeout)

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
        snap['decode'] = (self._metrics.decode_snapshot(
            active_slots=self._decode_cache.active_slots(),
            free_slots=self._decode_cache.free_slots(),
            pending=len(self._gen_ready) + len(self._chunk_pending),
            inflight_scans=len(self._decode_inflight))
            if self._decode_cache is not None else None)
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
        feed, real, target = pad_ragged_batch(
            feed, 1, target=bucket, force_mask=True, batch_names=names)
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
        program, fetch_list = self._program, self._fetch_list
        if lots[0].kind == 'generate':
            # a prefill lot runs the spec's PREFILL program, fetching the
            # initial decoder state
            program = self.generation.prefill_program
            fetch_list = self.generation.prefill_fetches
            self._metrics.note_prefill_lot()
            # the stall gauge's "prefill in flight" marker
            self._prefill_since_harvest = True
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
                        program, feed_list=feed_list,
                        fetch_list=fetch_list, scope=self._scope)
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
                    if not req.return_numpy and req.kind != 'generate':
                        step = core.LoDTensor(torch.from_numpy(
                            np.ascontiguousarray(step)))
                    res.append(step)
                offset += req.rows or 0
                if req.kind == 'generate':
                    # a PREFILL result: the per-request state waits for
                    # slot admission at the next step boundary; the future
                    # resolves when the decode lane finishes it
                    self._gen_ready.append((req, res))
                    continue
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

    # ---- decode lane ---------------------------------------------------

    def _admit_ready(self):
        """Admit prefilled generation requests into free decode slots
        (step-boundary admission).  Returns how many were admitted."""
        admitted = 0
        while self._gen_ready and self._decode_cache.free_slots():
            req, values = self._gen_ready.popleft()
            if req.done():
                continue  # errored upstream; nothing to decode
            if self.config.scheduling == 'edf' and \
                    req.deadline_t is not None and \
                    time.time() > req.deadline_t:
                # dead on arrival at the slot ('fifo' serves it late)
                self._shed_request(req, where='admit')
                continue
            try:
                self._decode_cache.admit(req, values)
            except Exception as exc:
                self._metrics.note_error()
                req.set_error(exc)
                continue
            if req.trace is not None:
                req.trace.mark('admit')
            admitted += 1
        return admitted

    def _decode_dispatch(self):
        """Queue ONE K-step decode dispatch against the cache's current
        carry (mid-chain, the previous dispatch's buffers, which it updates
        in place), and its tokens' copy to the host behind an event of
        their own.  Returns True when a dispatch went out."""
        cache = self._decode_cache
        k = self.config.decode_steps
        snap = cache.snapshot()
        # recorded before the dispatch: a failing one must leave the slot
        # map in the ring
        _trace.flight_recorder.record(
            'decode_lot', engine=self.name, steps=k,
            chain_depth=len(self._decode_inflight), slot_map=snap)
        try:
            with self._gated():
                self._stage()
                carry, toks, alive_in, _ = \
                    self._exe._dispatch_decode_multi(
                        self.generation.step_program,
                        carry=cache.carry(), steps=k,
                        decode=self._gen_decode_arg, scope=self._scope,
                        owner=cache)
                out = HostCopy([toks, alive_in])
        except Exception as exc:
            self._decode_fail(exc, snap)
            return False
        cache.set_carry(carry)
        # the slot -> request map AT DISPATCH: a slot released and
        # re-admitted later must not receive this dispatch's tokens
        reqs = [cache.request_at(s) for s in range(cache.slots)]
        self._decode_inflight.append(
            ('decode', out, None, k, time.time(), reqs, snap))
        return True

    # ---- chunked prefill ----------------------------------------------

    def _admit_chunk_pending(self):
        """Admit pending chunked-prefill prompts into free slots in the
        PREFILLING phase (chain-flush points, like _admit_ready)."""
        admitted = 0
        while self._chunk_pending and self._decode_cache.free_slots():
            req = self._chunk_pending.popleft()
            if req.done():
                continue
            if self.config.scheduling == 'edf' and \
                    req.deadline_t is not None and \
                    time.time() > req.deadline_t:
                self._shed_request(req, where='admit')
                continue
            self._decode_cache.admit_prefilling(req)
            admitted += 1
        return admitted

    def _chunk_estimate(self):
        """The expected wall of one chunk dispatch."""
        est = self._profile.estimate(('chunk', self.config.prefill_chunk))
        if est is None:
            est = min(self._chunk_walls) if self._chunk_walls else 0.0
        return est

    def _chunk_should_dispatch(self):
        """At most one prefill chunk rides each worker cycle, and only
        when it fits the decode lane's deadline headroom: under EDF, if an
        active decoding request's deadline lands before the next step
        boundary plus a chunk wall, the chunk waits a cycle."""
        if not self._chunking:
            return False
        cache = self._decode_cache
        if not any(cur < req.prompt_len
                   for _, req, cur in cache.prefilling_items()
                   if req is not None):
            return False
        if self.config.scheduling == 'edf':
            deadlines = [
                req.deadline_t for req in cache.active_requests()
                if not req.prefilling and req.deadline_t is not None
                and not req.done()]
            if deadlines:
                est_scan = (min(self._decode_walls)
                            if self._decode_walls else 0.0)
                if time.time() + est_scan + self._chunk_estimate() > \
                        min(deadlines):
                    return False
        return True

    def _chunk_dispatch(self):
        """Dispatch ONE C-token chunk advancing every prefilling slot,
        queued on the cache's current carry.  Slots whose prompt ends in
        this block turn to decoding on the device; their cursors and
        phases are mirrored on the host.  Returns True when a chunk went
        out."""
        cache = self._decode_cache
        spec = self.generation
        c = self.config.prefill_chunk
        s = cache.slots
        work = [(idx, req, cur) for idx, req, cur
                in cache.prefilling_items()
                if req is not None and cur < req.prompt_len]
        if not work:
            return False
        blk = np.zeros((s, c, 1), np.int64)
        lens = np.zeros((s, ), np.int32)
        active = np.zeros((s, ), bool)
        fin = np.zeros((s, ), bool)
        budget = np.zeros((s, ), np.int32)
        for idx, req, cur in work:
            n = min(c, req.prompt_len - cur)
            blk[idx, :n, 0] = req.prompt_tokens[cur:cur + n]
            lens[idx] = n
            active[idx] = True
            if cur + n >= req.prompt_len:
                fin[idx] = True
                budget[idx] = req.max_len
        feed = {spec.chunk_token: blk,
                spec.chunk_token + SEQLEN_SUFFIX: lens}
        if spec.chunk_len is not None:
            feed[spec.chunk_len] = lens.astype(np.float32)[:, None]
        aux = {'active': active, 'finish': fin, 'budget': budget}
        snap = cache.snapshot()
        _trace.flight_recorder.record(
            'chunk_lot', engine=self.name, width=int(c),
            prefilling=len(work), finishing=int(fin.sum()),
            chain_depth=len(self._decode_inflight), slot_map=snap)
        try:
            with self._gated():
                self._stage()
                carry, ok, _ = self._exe._dispatch_chunk_prefill(
                    spec.chunk_program, feed=feed, carry=cache.carry(),
                    aux=aux, chunk=self._gen_chunk_arg, scope=self._scope,
                    owner=cache)
                out = HostCopy([ok])
        except Exception as exc:
            self._decode_fail(exc, snap)
            return False
        cache.set_carry(carry)
        self._metrics.note_chunk_dispatch(
            sum(int(lens[idx]) for idx, _, _ in work))
        self._prefill_since_harvest = True
        t_disp = time.time()
        for idx, req, cur in work:
            cache.advance_prefill(idx, int(lens[idx]))
            if fin[idx]:
                cache.finish_prefill(idx)
                if req.trace is not None:
                    # decode begins at this dispatch
                    req.trace.mark('admit', t_disp)
        self._decode_inflight.append(
            ('chunk', out, None, int(c), t_disp, None, snap))
        return True

    def _decode_harvest_one(self):
        """Harvest the OLDEST in-flight decode-lane dispatch.  A 'chunk'
        entry waits for its small completion marker (its wall feeds the
        decode-priority budget); a 'decode' entry waits for its token
        block, replays the loop's stop rule on the host (EOS emitted or
        budget spent), delivers every request the dispatch finished and
        releases their slots.  Returns True unless the chain was
        poisoned."""
        kind, payload, _, k, t_disp, reqs, snap = \
            self._decode_inflight.popleft()
        # a harvest with nothing in flight behind it idles the card: the
        # host sync the chained lane minimizes
        blocking = not self._decode_inflight
        cache = self._decode_cache
        if kind == 'chunk':
            try:
                payload.result()  # the sync point
            except Exception as exc:
                self._decode_fail(exc, snap)
                return False
            wall = max(time.time() - t_disp, 0.0)
            self._chunk_walls.append(wall)
            self._profile.observe(('chunk', self.config.prefill_chunk),
                                  wall)
            self._metrics.note_decode_harvest(blocking=blocking)
            if cache.active_slots() == 0 and not self._decode_inflight:
                self._reset_stall_gauge()
            return True
        try:
            toks, alive_in = payload.result()  # the sync point
        except Exception as exc:
            self._decode_fail(exc, snap)
            return False
        self._metrics.note_decode_harvest(blocking=blocking)
        t_sync = time.time()
        self._decode_walls.append(max(t_sync - t_disp, 0.0))
        # the inter-token stall gauge: the gap between consecutive token
        # harvests while prefill work was in flight, in units of the
        # lane's min dispatch wall, counted only when some REQUEST (by
        # identity) decoded across the whole gap
        alive_reqs = frozenset(
            reqs[int(s)]
            for s in np.nonzero(alive_in.any(axis=0))[0]
            if reqs[int(s)] is not None)
        if self._last_harvest_t is not None and \
                self._prefill_since_harvest and \
                (alive_reqs & self._last_harvest_alive):
            gap = max(t_sync - self._last_harvest_t, 0.0)
            floor = min(self._decode_walls) if self._decode_walls \
                else 0.0
            self._metrics.note_decode_stall(gap / max(floor, 1e-9), gap)
        self._last_harvest_t = t_sync
        self._last_harvest_alive = alive_reqs
        self._prefill_since_harvest = False
        end_id = self.generation.end_id
        finished = 0
        for s, req in enumerate(reqs):
            if req is None or req.done():
                continue
            req.tokens.extend(int(t) for t in toks[alive_in[:, s], s])
            # the loop's own stop rule, replayed on the host
            budget = min(req.max_len, self.generation.max_len)
            done = req.tokens and (req.tokens[-1] == end_id or
                                   len(req.tokens) >= budget)
            if done and req.slot == s:
                if req.trace is not None:
                    req.trace.mark('decode_end', t_sync)
                cache.release(s)
                self._finish_generate(req)
                finished += 1
        self._metrics.note_decode_dispatch(
            k, int(alive_in.sum()), k * cache.slots, finished)
        if cache.active_slots() == 0 and not self._decode_inflight:
            # going idle: the next busy period must not count the gap
            self._reset_stall_gauge()
        if _profiler.is_profiler_enabled() or _trace.spans_enabled():
            _profiler.record_event(self._spans + 'decode[x%d]' % k,
                                   time.time() - t_sync, start=t_sync)
        return True

    def _reset_stall_gauge(self):
        """Clear the stall gauge's episode state when the decode lane goes
        idle (by harvest, shed or a poisoned-chain reset)."""
        self._last_harvest_t = None
        self._last_harvest_alive = frozenset()
        self._prefill_since_harvest = False

    def _decode_fail(self, exc, snap):
        """A decode dispatch or harvest failed: every dispatch behind it
        consumed the bad carry, so error every slotted request, drop the
        chain and reset the cache to fresh host leaves; the worker
        survives."""
        self._metrics.note_error()
        _trace.flight_recorder.dump(
            'decode_error:%s' % self.name, error=repr(exc),
            slot_map=snap, chain_depth=len(self._decode_inflight))
        cache = self._decode_cache
        self._decode_inflight.clear()
        for req in cache.active_requests():
            cache.release(req.slot)
            if not req.done():
                req.set_error(exc)
        cache.reset()
        self._reset_stall_gauge()

    def _decode_flush(self):
        """Chain-flush point: harvest every in-flight dispatch, so that
        the slot map and the carry agree before admission, shedding or
        eviction touch the slots.  Returns True unless the chain was
        poisoned."""
        flushed = bool(self._decode_inflight)
        while self._decode_inflight:
            if not self._decode_harvest_one():
                return False
        if flushed:
            self._metrics.note_decode_flush()
        return True

    def _decode_mirror_alive(self, req):
        """Whether ``req``'s slot can still be alive, from harvested
        tokens only: the loop's stop rule."""
        budget = min(req.max_len, self.generation.max_len)
        return len(req.tokens) < budget and (
            not req.tokens or req.tokens[-1] != self.generation.end_id)

    def _decode_should_dispatch(self):
        """Dispatch again only when some occupied, decoding slot can still
        be alive after the dispatches in flight (a request's remaining
        budget is known; EOS only ends it sooner)."""
        active = self._decode_cache.active_requests()
        if not active:
            return False
        for req in active:
            if req.prefilling or not self._decode_mirror_alive(req):
                continue
            budget = min(req.max_len, self.generation.max_len)
            inflight_steps = sum(
                e[3] for e in self._decode_inflight
                if e[0] == 'decode' and req in e[5])
            if budget - len(req.tokens) - inflight_steps > 0:
                return True
        return False

    def _decode_doomed(self):
        """Active generations whose deadline lands before the next step
        boundary (one measured dispatch wall away); EDF only.  One
        predicate for _decode_needs_flush and the shed loop."""
        if self.config.scheduling != 'edf':
            return []
        now = time.time()
        est = min(self._decode_walls) if self._decode_walls else 0.0
        return [req for req in self._decode_cache.active_requests()
                if req.deadline_t is not None and
                now + est > req.deadline_t]

    def _decode_needs_flush(self):
        """True when the next cycle must touch slots: a doomed generation
        to shed, or prefilled requests and a free slot to admit into."""
        cache = self._decode_cache
        if (self._gen_ready or self._chunk_pending) and \
                cache.free_slots():
            return True
        return bool(self._decode_doomed())

    def _decode_cycle(self):
        """One decode-lane turn: flush the chain when admission or
        shedding must touch slots, queue the next decode dispatch FIRST,
        then (decode priority) at most one prefill chunk, then harvest the
        oldest in-flight dispatch behind them, so the harvest's host sync
        never idles the card.  At decode_pipeline_depth 1 this is
        dispatch, harvest, repeat.  Returns True when the lane made
        progress."""
        cache = self._decode_cache
        if cache is None:
            return False
        progressed = False
        if self._decode_needs_flush():
            progressed = True
            if not self._decode_flush():
                return True
            for req in self._decode_doomed():
                slot = req.slot
                cache.release(slot)
                cache.deactivate(slot)
                if req.trace is not None:
                    req.trace.add_count('decode_steps', len(req.tokens))
                self._shed_request(req, where='decode')
            if cache.active_slots() == 0:
                self._reset_stall_gauge()
            self._admit_ready()
            if self._chunking:
                self._admit_chunk_pending()
        dispatched = False
        if self._decode_should_dispatch():
            dispatched = self._decode_dispatch()
            progressed = dispatched or progressed
        if self._chunk_should_dispatch():
            chunked = self._chunk_dispatch()
            dispatched = dispatched or chunked
            progressed = chunked or progressed
        if not dispatched:
            # nothing worth another dispatch: drain the chain so finished
            # requests deliver and their slots free
            while self._decode_inflight:
                progressed = True
                if not self._decode_harvest_one():
                    return True
        while len(self._decode_inflight) >= \
                self.config.decode_pipeline_depth:
            progressed = True
            if not self._decode_harvest_one():
                break
        return progressed

    def _finish_generate(self, req):
        """Deliver one finished generation request: token ids out, trace
        finalized (prefill/decode/detokenize and the decode_steps count)
        before the future resolves."""
        out = np.asarray(req.tokens, np.int64)
        if req.trace is not None:
            req.trace.add_count('decode_steps', len(req.tokens))
            self._metrics.note_stages(req.trace.finalize())
            _trace.record_span(
                self._spans + 'generate', req.trace.t0,
                req.trace.e2e_s, trace_id=req.trace_id)
        req.set_result(out)
        self._drains.note()
        if req.latency_s is not None:
            self._metrics.note_latency(req.latency_s)

    def _gen_busy(self):
        """True while the generation lane has work: requests awaiting
        slots, occupied slots, or dispatches awaiting harvest."""
        return self._decode_cache is not None and (
            bool(self._gen_ready) or bool(self._chunk_pending) or
            bool(self._decode_inflight) or
            self._decode_cache.any_active())

    def evict_decode_cache(self):
        """Demote the decode slot cache to host memory, paused and under
        the dispatch gate (bit for bit: in-flight generations resume
        exactly once the next dispatch stages it back), drop the
        prefill/step/chunk blocks and release their graphs, whose buffers
        held the slabs.  Returns the bytes moved (the registry's arbiter
        evicts an idle generation model's cache with it)."""
        if self._decode_cache is None:
            return 0
        with self.paused():
            with self._gated():
                moved = self._decode_cache.to_host()
                self.drop_executables(programs=self._generation_programs())
                self._exe.release_retired()
                if self.place.device.type == 'cuda':
                    torch.cuda.empty_cache()
        return moved

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

    def _route_chunked(self, reqs):
        """Under ``prefill_chunk`` a generation lot never forms: the
        requests (which still travel the batcher for wake-ups, EDF order
        and queue sheds) wait for a PREFILLING slot instead.  Returns the
        requests that still need a lot; None when all went to the chunk
        lane."""
        if not self._chunking or not reqs or reqs[0].kind != 'generate':
            return reqs
        now = time.time()
        for req in reqs:
            if req.trace is not None:
                req.trace.mark('collect', now)
            self._chunk_pending.append(req)
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
                    # (a busy decode lane keeps stepping between arrivals)
                    reqs = self._batcher.next_lot(
                        timeout=poll if (self._inflight or
                                         self._gen_busy()) else None)
                    if reqs is None:
                        break  # closed and drained
                # one collect->dispatch->drain->decode cycle is the pause
                # unit
                with self._cycle_lock:
                    if reqs:
                        reqs = self._route_chunked(reqs)
                    if self._carry and not reqs:
                        self._dispatch(
                            self._collect_block(self._carry.popleft()))
                    elif reqs:
                        lot = self._safe_make_lot(reqs)
                        if lot is not None:
                            self._dispatch(self._collect_block(lot))
                    elif self._inflight and not self._gen_busy():
                        self._drain_one()  # idle: deliver early
                    # backpressure: at most pipeline_depth dispatches in
                    # flight
                    while len(self._inflight) >= self.config.pipeline_depth:
                        self._drain_one()
                    if self._decode_cache is not None:
                        # deliver a finished forward or prefill dispatch
                        # even while the decode lane is busy, then one
                        # decode turn: neither lane starves the other
                        if self._inflight and self._gen_busy():
                            self._drain_one()
                        self._decode_cycle()
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
            # run the generation lane dry
            while self._gen_busy():
                if not self._decode_cycle():
                    break
            if self._decode_cache is not None:
                self._decode_flush()

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
                        reqs = self._route_chunked(reqs)
                        if reqs:
                            lot = self._safe_make_lot(reqs)
                            if lot is not None:
                                self._dispatch(self._collect_block(lot))
                        progressed = True
                while self._inflight:
                    self._drain_one()
                    progressed = True
                # inline mode has no worker to step the lane later
                if self._gen_busy():
                    progressed = self._decode_cycle() or progressed
                if not progressed and not self._carry:
                    break
