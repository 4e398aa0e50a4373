"""Request-level tracing, per-executable cost accounting, and the
flight recorder (counterpart of ``paddle_tpu/fluid/trace.py``; the
serving engine's, the registry's and the feed pipeline's probes come with
those modules).

  1. **span contexts**: a ``TraceContext`` carries one trace id across
     threads and layers and turns absolute stage marks into a per-request
     breakdown whose stages sum to the end-to-end latency; ``attach()`` /
     ``current()`` hand a context across an API boundary; ``record_span``
     inside a ``tracing()`` window fills a bounded span log, one lane per
     thread (``dump_spans`` writes it as the JSON that
     ``tools/trace_export.py`` turns into a Chrome trace).

  2. **cost registry**: ``analyze_cost`` counts an executed block's work
     from the shapes its ops ran at, as XLA's cost analysis counts the
     JAX package's executable (``op_flops``): 2 FLOPs per multiply-add
     of ``mul``, ``matmul`` and the convolutions, 1 per output element of
     an elementwise op, 1 per input element of a reduction, and the
     hand-written kernels' own formulas; a generic grad's forward replay
     is not counted (XLA computes it once).  Gated by
     ``FLAGS_cost_accounting``.

  3. **flight recorder**: a bounded ring of the last dispatch records
     that ``dump()``s on a worker error or when the ``watchdog`` trips a
     registered stall probe.
"""

import contextlib
import itertools
import json
import logging
import math
import os
import threading
import time
from collections import deque

__all__ = [
    'TraceContext', 'STAGES', 'new_trace_id', 'attach', 'current',
    'tracing', 'record_span', 'spans', 'clear_spans', 'dump_spans',
    'FlightRecorder', 'flight_recorder', 'Watchdog', 'watchdog',
    'analyze_cost', 'op_flops',
]

# canonical per-request stages, in pipeline order: arbitration (the
# registry's residency gate, pre-enqueue), queue (enqueue -> lot
# collection), pad (request prepare + lot padding), dispatch (lot ready
# -> device dispatch issued, incl. carry/gate waits), device (dispatch
# -> host sync), trim (sync -> per-request slice delivered).
# GENERATION requests replace the post-collection stages with
# prefill (lot -> slot admission: the prompt's pad/dispatch/device/trim
# as one stage), decode (admission -> last decode-scan sync) and
# detokenize (last sync -> delivery); their breakdown also carries a
# decode_steps count.
# SHED requests end in a 'shed' stage instead: the seconds
# the request sat before the deadline scheduler dropped it (its future
# raises DeadlineExceededError — served stages before the shed, e.g. a
# generation's prefill, still appear).
STAGES = ('arbitration', 'queue', 'pad', 'prefill', 'dispatch',
          'device', 'trim', 'decode', 'detokenize', 'shed')

_ids = itertools.count(1)
_id_lock = threading.Lock()


def new_trace_id():
    with _id_lock:
        return 'tr-%06d' % next(_ids)


class TraceContext(object):
    """One request's trace: an id, absolute stage-boundary marks, and
    pre-accumulated stage seconds (stages measured where they happen —
    the registry's arbitration window, the submit path's prepare —
    before the boundary marks take over).  Thread-crossing is the
    point: the submit thread marks 'enqueue', the worker marks
    'collect'/'lot'/'dispatch', the drain marks 'sync', and
    ``finalize()`` (at delivery) turns the marks into the breakdown."""

    __slots__ = ('trace_id', 't0', 'marks', 'stage_s', 'e2e_s', 'counts')

    def __init__(self, trace_id=None):
        self.trace_id = trace_id or new_trace_id()
        self.t0 = time.time()
        self.marks = {}
        self.stage_s = {}
        self.e2e_s = None
        self.counts = {}

    def add_stage(self, stage, seconds):
        """Accumulate seconds measured outside the mark chain (e.g.
        'arbitration' by the registry, the prepare half of 'pad')."""
        self.stage_s[stage] = self.stage_s.get(stage, 0.0) + float(seconds)

    def add_count(self, name, n):
        """Accumulate a per-request integer (e.g. ``decode_steps`` —
        how many decode-scan steps this generation request consumed);
        rides ``breakdown()`` next to the stage times."""
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def mark(self, name, t=None):
        self.marks[name] = time.time() if t is None else t

    def finalize(self, end=None):
        """Close the trace: derive the boundary-mark stages and the
        end-to-end wall clock.  Robust to missing marks (an errored
        request finalizes with whatever boundaries it reached).
        A GENERATION request (an 'admit' mark present)
        derives prefill/decode/detokenize instead of the per-lot
        pad/dispatch/device/trim splits: its prompt pass IS one stage,
        and everything after admission belongs to the decode scan."""
        end = time.time() if end is None else end
        m = self.marks

        def seg(a, b):
            return max(m[b] - m[a], 0.0) if a in m and b in m else 0.0

        self.add_stage('queue', seg('enqueue', 'collect'))
        if 'admit' in m:
            self.add_stage('prefill', seg('collect', 'admit'))
            if 'decode_end' in m:
                self.add_stage('decode', seg('admit', 'decode_end'))
                self.add_stage('detokenize',
                               max(end - m['decode_end'], 0.0))
            else:
                # errored before any scan drained: whatever remains is
                # decode-lane time
                self.add_stage('decode', max(end - m['admit'], 0.0))
        else:
            self.add_stage('pad', seg('collect', 'lot'))
            self.add_stage('dispatch', seg('lot', 'dispatch'))
            self.add_stage('device', seg('dispatch', 'sync'))
            if 'sync' in m:
                self.add_stage('trim', max(end - m['sync'], 0.0))
        self.e2e_s = end - self.t0
        return self.stage_s

    def breakdown(self):
        """The response-surface view: trace id, end-to-end ms, and the
        per-stage ms in canonical order (only stages that occurred),
        plus any per-request counts (generation requests carry
        ``decode_steps``)."""
        out = {
            'trace_id': self.trace_id,
            'e2e_ms': (round(self.e2e_s * 1e3, 3)
                       if self.e2e_s is not None else None),
            'stages_ms': {s: round(self.stage_s[s] * 1e3, 3)
                          for s in STAGES if s in self.stage_s},
        }
        if self.counts:
            out.update(self.counts)
        return out


# ---- ambient context (cross-layer handoff) ----------------------------

_ambient = threading.local()


@contextlib.contextmanager
def attach(ctx):
    """Make ``ctx`` the calling thread's ambient trace for the block —
    the registry router attaches before engine.submit() so the engine
    threads the SAME trace id instead of minting a new one."""
    prev = getattr(_ambient, 'ctx', None)
    _ambient.ctx = ctx
    try:
        yield ctx
    finally:
        _ambient.ctx = prev


def current():
    return getattr(_ambient, 'ctx', None)


# ---- span log (the Chrome exporter's source) --------------------------

_SPAN_CAP = 8192
_span_lock = threading.Lock()
_span_log = deque(maxlen=_SPAN_CAP)
_span_state = {'enabled': 0}


def spans_enabled():
    return _span_state['enabled'] > 0


@contextlib.contextmanager
def tracing():
    """Enable span capture for the block (nested windows stack); spans
    from a previous window are cleared on the OUTERMOST entry so each
    session exports its own record."""
    with _span_lock:
        if _span_state['enabled'] == 0:
            _span_log.clear()
        _span_state['enabled'] += 1
    try:
        yield
    finally:
        with _span_lock:
            _span_state['enabled'] -= 1


def record_span(name, start_s, dur_s, trace_id=None, lane=None):
    """One timed slice in the span log; ``lane`` defaults to the
    CURRENT thread's name — spans land in per-thread lanes, which is
    exactly how the Chrome exporter renders them."""
    if not spans_enabled():
        return
    span = {
        'name': name,
        'start_s': float(start_s),
        'dur_s': float(dur_s),
        'lane': lane or threading.current_thread().name,
    }
    if trace_id is not None:
        span['trace_id'] = trace_id
    with _span_lock:
        _span_log.append(span)


def spans():
    with _span_lock:
        return list(_span_log)


def clear_spans():
    with _span_lock:
        _span_log.clear()


def dump_spans(path):
    """Write the span log as the JSON file tools/trace_export.py
    consumes; returns the span count."""
    snapshot = spans()
    with open(path, 'w') as f:
        json.dump({'spans': snapshot}, f)
    return len(snapshot)


# ---- flight recorder --------------------------------------------------

class FlightRecorder(object):
    """Bounded ring of recent dispatch/lot records.  Layers ``record``
    one small dict per dispatch (trace ids, sig, shape, timings);
    ``dump`` snapshots the ring on a worker error or a watchdog-tripped
    stall — the records ARE what was in flight.  ``last_dump`` keeps
    the most recent dump in memory (tests and post-mortems read it);
    ``dump_path`` (or the PADDLE_TPU_FLIGHT_DUMP env var) additionally
    writes each dump as JSON."""

    def __init__(self, capacity=256):
        self._lock = threading.Lock()
        self._records = deque(maxlen=int(capacity))
        self.last_dump = None
        self.dump_count = 0
        self.dump_path = None

    def record(self, kind, **fields):
        rec = dict(fields)
        rec['kind'] = kind
        rec['ts'] = time.time()
        with self._lock:
            self._records.append(rec)
        return rec

    def records(self):
        with self._lock:
            return list(self._records)

    def clear(self):
        with self._lock:
            self._records.clear()

    def dump(self, reason, **extra):
        dump = {
            'reason': reason,
            'ts': time.time(),
            'extra': extra,
            'records': self.records(),
        }
        with self._lock:
            self.last_dump = dump
            self.dump_count += 1
        path = self.dump_path or os.environ.get('PADDLE_TPU_FLIGHT_DUMP')
        if path:
            try:
                with open(path, 'w') as f:
                    json.dump(dump, f, default=repr)
            except OSError:
                pass  # a read-only fs must not mask the original error
        logging.getLogger('paddle_tpu_torch').error(
            'flight recorder dump (%s): %d in-flight records',
            reason, len(dump['records']))
        return dump


flight_recorder = FlightRecorder()


# ---- watchdog ---------------------------------------------------------

class Watchdog(object):
    """Threshold probes over subsystem ages (oldest queued request,
    current feed stall).  A probe whose age crosses its threshold trips
    ONCE per stall episode (re-arming when the age drops back), dumping
    the flight recorder with the probe's name as the reason.  The
    polling thread starts with the first registration and exits with
    the last unregistration; ``check()`` runs one sweep synchronously
    (deterministic for tests)."""

    def __init__(self, interval_s=1.0):
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._probes = {}  # name -> [age_fn, threshold_s, tripped]
        self._thread = None
        self._stop = threading.Event()

    def register(self, name, age_fn, threshold_s, context_fn=None):
        """Returns the KEY the probe landed under — a name already held
        by a live probe is uniquified (``name#2``, ...) instead of
        silently clobbered (two same-named engines must BOTH keep their
        stall monitoring; the profiler's metrics sources learned this
        the hard way).  Callers unregister by the returned key.

        ``context_fn`` (optional, zero-arg) is called when the probe
        trips and its result lands in the dump — the subsystem's own
        "what was in flight" view (e.g. the serving engine's queued +
        undrained trace ids), which the generic ring may not hold for
        work that stalled BEFORE dispatching."""
        with self._lock:
            key, n = name, 1
            while key in self._probes:
                n += 1
                key = '%s#%d' % (name, n)
            self._probes[key] = [age_fn, float(threshold_s), False,
                                 context_fn]
            if self._thread is None:
                self._stop = threading.Event()
                self._thread = threading.Thread(
                    target=self._loop, name='trace-watchdog', daemon=True)
                self._thread.start()
        return key

    def unregister(self, name, age_fn=None):
        """Drop a probe by its registered key.  Pass ``age_fn`` to make
        the removal owner-checked: a stale GC finalizer whose key has
        since been re-registered by a NEW subsystem must not kill the
        survivor's monitoring."""
        with self._lock:
            if age_fn is not None and name in self._probes and \
                    self._probes[name][0] is not age_fn:
                return
            self._probes.pop(name, None)
            if not self._probes and self._thread is not None:
                self._stop.set()
                self._thread = None

    def check(self):
        """One sweep; returns the names that tripped this sweep."""
        with self._lock:
            probes = list(self._probes.items())
        tripped = []
        for name, state in probes:
            age_fn, threshold, was_tripped, context_fn = state
            try:
                age = age_fn()
            except Exception:
                continue  # a dying subsystem must not kill the watchdog
            if age is None:
                # nothing aging IS recovery (a drained queue, an idle
                # dispatch loop): re-arm, or a second stall episode
                # whose first observed age already exceeds the
                # threshold would never dump
                state[2] = False
                continue
            if age >= threshold and not was_tripped:
                state[2] = True
                tripped.append(name)
                extra = {}
                if context_fn is not None:
                    try:
                        extra = dict(context_fn() or {})
                    except Exception:
                        pass  # the stalled subsystem may be half-dead
                flight_recorder.dump('stall:%s' % name,
                                     age_s=round(float(age), 3),
                                     threshold_s=threshold, **extra)
            elif age < threshold:
                state[2] = False
        return tripped

    def _loop(self):
        stop = self._stop
        while not stop.wait(self.interval_s):
            self.check()


watchdog = Watchdog()


# ---- per-executable cost accounting -----------------------------------
#
# A block's work counted from the shapes its ops ran at.  ``records`` is
# what ``registry.recording()`` collected over one run of the block: one
# ``(op, meta, children)`` per op, ``meta`` mapping each of the op's
# argument names to ``(shape, nbytes)`` and ``children`` the records of
# the ops it ran inside (a ``recurrent`` op's step block, every step).

# ops that only move, view, index, sort or make data: no arithmetic
_NO_FLOPS = frozenset((
    'assign', 'assign_value', 'beam_expand', 'beam_init_scores',
    'beam_search', 'beam_search_decode', 'cast', 'concat', 'feed', 'fetch',
    'fill_constant', 'fill_constant_batch_size_like', 'gather',
    'gaussian_random', 'lookup_table', 'reshape', 'sequence_expand',
    'sequence_first_step', 'sequence_last_step', 'uniform_random',
    'unsqueeze', 'chunk_eval', 'reshape2', 'transpose', 'transpose2',
    'squeeze', 'squeeze2', 'unsqueeze2', 'flatten', 'flatten2', 'split',
    'shape', 'slice', 'stack', 'unstack', 'reverse', 'pad', 'pad2d',
    'multiplex', 'crop', 'scatter', 'argsort', 'random_crop',
    'truncated_gaussian_random', 'uniform_random_batch_size_like',
    'gaussian_random_batch_size_like'))
# reductions: one FLOP per input element
_REDUCTIONS = frozenset((
    'mean', 'reduce_sum', 'sequence_pool', 'top_k', 'accuracy',
    'reduce_mean', 'reduce_max', 'reduce_min', 'reduce_prod', 'argmax',
    'argmin', 'arg_max', 'arg_min', 'isfinite', 'squared_l2_norm', 'l1_norm',
    'auc', 'precision_recall', 'positive_negative_pair'))
# FLOPs per output element of the ops that make several elementwise passes
# (the optimizers' updates, the normalizations, the softmax family, the
# losses)
_PASSES = {
    'sgd': 2, 'momentum': 4, 'adam': 11, 'softmax': 4,
    'sequence_softmax': 4, 'layer_norm': 8, 'batch_norm': 8, 'dropout': 2,
    'softmax_with_cross_entropy': 5, 'cross_entropy': 2,
    'sigmoid_cross_entropy_with_logits': 4, 'sum': 1, 'label_smooth': 2,
    'norm': 4, 'squared_l2_distance': 3, 'huber_loss': 6,
    'smooth_l1_loss': 8, 'log_loss': 8, 'hinge_loss': 5, 'rank_loss': 5,
    'margin_rank_loss': 6, 'modified_huber_loss': 8, 'kldiv_loss': 5,
}
# FLOPs per element of each gradient a generic grad produces, beside the
# forward op's largest output
_GRAD_PASSES = {'softmax': 4, 'sequence_softmax': 4, 'layer_norm': 10,
                'batch_norm': 10, 'softmax_with_cross_entropy': 2}


def _numel(shape):
    return int(math.prod(shape)) if shape is not None else 0


def _product_flops(op, shape_of):
    """2 FLOPs per multiply-add of a ``mul``, ``matmul`` or convolution
    op (its grad's inputs carry the forward op's slots)."""
    kind = op.type[:-5] if op.type.endswith('_grad') else op.type
    if kind == 'mul':
        x, y = shape_of(op.input('X')[0]), shape_of(op.input('Y')[0])
        xn = op.attrs.get('x_num_col_dims', 1)
        yn = op.attrs.get('y_num_col_dims', 1)
        return 2.0 * _numel(x[:xn]) * _numel(x[xn:]) * _numel(y[yn:])
    if kind == 'sequence_conv':
        x = shape_of(op.input('X')[0])
        k, m = shape_of(op.input('Filter')[0])
        return 2.0 * _numel(x[:-1]) * k * m
    if kind == 'matmul':
        x = shape_of(op.input('X')[0])
        out = shape_of(op.input('Out')[0] if op.type.endswith('_grad')
                       else op.output('Out')[0])
        k = x[-2] if op.attrs.get('transpose_X', False) and len(x) > 1 \
            else x[-1]
        return 2.0 * _numel(out) * k
    # conv2d, depthwise_conv2d: every output element sums C_in/g * kh * kw
    # products
    out = shape_of(op.input('Output')[0] if op.type.endswith('_grad')
                   else op.output('Output')[0])
    return 2.0 * _numel(out) * _numel(shape_of(op.input('Filter')[0])[1:])


def _kernel_flops(op, shape_of):
    """The hand-written kernels' own formulas (``chip_smoke.py``'s
    bounds): flash attention 4 B H Lq Lk D forward and 14 B H Lq Lk D +
    2 B Lq H D for dQ (with delta) and dK/dV; the LSTM recurrence
    2 T B D 4D forward and twice that (walk and dW) backward."""
    grad = op.type.endswith('_grad')
    if op.type.startswith('flash_attention'):
        b, lq, h, d = shape_of(op.input('Q')[0])
        lk = shape_of(op.input('K')[0])[1]
        pairs = float(b) * h * lq * lk * d
        return 14.0 * pairs + 2.0 * b * lq * h * d if grad else 4.0 * pairs
    b, t, d4 = shape_of(op.input('Input')[0])
    flops = 2.0 * t * b * d4 * (d4 // 4)
    return 2.0 * flops if grad else flops


_PRODUCTS = frozenset(('mul', 'matmul', 'conv2d', 'depthwise_conv2d',
                       'sequence_conv'))
_BLOCK_OPS = frozenset(('recurrent', 'while', 'conditional_block', 'ifelse',
                        'switch_case'))


def op_flops(op, meta, children=()):
    """FLOPs of one executed op, from the shapes it ran at.  A grad counts
    the products (or passes) of each gradient it makes; the forward replay
    that the generic grad runs is not counted.  An op that runs a block
    (``recurrent``, ``while``, the branches of ``conditional_block``,
    ``ifelse`` and ``switch_case``) counts the ops the block ran, every
    step, trip and branch, and its grad twice that."""
    grad = op.type.endswith('_grad')
    kind = op.type[:-5] if grad else op.type
    shape_of = lambda n: meta[n][0]
    if kind in _BLOCK_OPS:
        inner = sum(op_flops(*c) for c in children
                    if not c[0].type.endswith('_grad'))
        return 2.0 * inner if grad else float(inner)
    if kind in ('flash_attention', 'lstm'):
        return _kernel_flops(op, shape_of)
    if kind in ('linear_chain_crf', 'crf_decoding'):
        # each step adds the [D, D] transition to every row's [D] scores
        # and reduces over the source tag: 2 B T D^2, the grad twice that
        b, t, d = shape_of(op.input('Emission')[0])
        return 2.0 * b * t * d * d * (2 if grad else 1)
    grads = [n for s in op.outputs for n in op.output(s)
             if grad and s.endswith('@GRAD') and n in meta]
    if kind in _PRODUCTS:
        return _product_flops(op, shape_of) * (len(grads) if grad else 1)
    if kind in _NO_FLOPS:
        return 0.0
    if kind in ('sgd', 'momentum', 'adam'):
        # an update's passes run over its gradient's rows: all of the
        # parameter's, or a sparse gradient's (the rows a batch touched)
        return float(_PASSES[kind] * _numel(shape_of(op.input('Grad')[0])))
    if grad:
        # the forward op's largest output (or its cotangent) per gradient
        widest = max([_numel(shape_of(n)) for s in op.inputs
                      for n in op.input(s) if n in meta] or [0])
        return float(_GRAD_PASSES.get(kind, 2) * widest * len(grads))
    if kind in _REDUCTIONS:
        return float(sum(_numel(shape_of(n)) for s in op.inputs
                         for n in op.input(s) if n in meta))
    if kind == 'kldiv_loss':
        # its passes run over X, whatever its reduction leaves of the loss
        return float(_PASSES[kind] * _numel(shape_of(op.input('X')[0])))
    if kind == 'gru_unit':
        h = shape_of(op.input('HiddenPrev')[0])
        return 2.0 * h[0] * h[1] * 3 * h[1] + 10.0 * _numel(h)
    widest = max([_numel(shape_of(n)) for s in op.outputs
                  for n in op.output(s) if n in meta] or [0])
    return float(_PASSES.get(kind, 1) * widest)


def analyze_cost(records, kind='run', steps=1, fetch_names=None,
                 memory=None):
    """The cost-registry entry of a block from one run's ``records``:
    ``flops`` for ``steps`` steps (``flops_per_step`` for one),
    ``bytes_accessed`` (each op's input and output bytes, summed, times
    ``steps``) and, from ``memory`` (the block's ``MemoryStats``), the
    argument, output and temporary bytes of one step."""
    steps = max(int(steps), 1)
    per_step = float(sum(op_flops(*r) for r in records))
    # each op's inputs read and outputs written (a name an op reads and
    # writes, twice; a step block's ops not again)
    nbytes = float(sum(meta[n][1] for op, meta, _ in records
                       for n in list(op.input_arg_names) +
                       list(op.output_arg_names) if n in meta))
    entry = {
        'kind': kind,
        'steps': steps,
        'fetch_names': list(fetch_names or []),
        'flops': per_step * steps,
        'flops_per_step': per_step,
        'bytes_accessed': nbytes * steps,
    }
    if memory is not None:
        entry.update({
            'argument_bytes': int(memory.argument_size_in_bytes),
            'output_bytes': int(memory.output_size_in_bytes),
            'temp_bytes': int(memory.temp_size_in_bytes),
            'generated_code_bytes': int(
                memory.generated_code_size_in_bytes),
        })
    return entry
