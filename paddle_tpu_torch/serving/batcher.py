"""Dynamic micro-batching queue: coalesce submitted requests into lots.

Copy of ``paddle_tpu/serving/batcher.py`` (pure threading, no device
code).  The reference serves inference through a per-request C-API call
(paddle_inference_api.h Run); batching amortizes each dispatch's host
cost (on the card: the feed copies and a graph replay) over many
requests.  The queue's contract:

  * a lot closes when its rows reach ``max_batch_size`` (full flush) OR
    the OLDEST waiting request has aged ``max_wait_s`` (deadline flush)
    — latency is bounded by max_wait even at low traffic;
  * only signature-compatible requests (same feed names, BUCKETED
    trailing dims and dtypes — the engine quantizes variable seq-len/
    resolution dims onto its TrailingDimBuckets ladder before the sig
    is taken, so mixed-length requests in one rung DO coalesce)
    coalesce; an incompatible request simply waits its turn as the
    head of a later lot;
  * a lone request larger than max_batch_size forms its own lot (the
    bucket ladder gives it an exact entry) rather than being rejected.

Scheduling: under ``scheduling='edf'`` (the default) lot
formation is deadline-aware the way Clockwork (OSDI '20) serves its
SLOs — the head of each lot is the highest-PRIORITY pending request,
earliest-deadline-first within a priority class (requests without a
deadline order after deadlined peers, by arrival); and requests whose
deadline has already passed — or can no longer be met within the
engine's current service estimate — are SHED with a typed
``DeadlineExceededError`` instead of being served late, so an
overloaded queue spends the chip on answers that can still arrive in
time.  Requests carrying neither priority nor deadline degrade to
exact FIFO order, so pre-SLO callers see no change.
``scheduling='fifo'`` restores strict arrival order with no shedding
(the baseline side of the ``slo`` perf gate: under overload it happily
serves already-dead requests, starving live ones).

Requests double as futures: ``submit`` returns an InferenceRequest the
caller blocks on with ``.result()``; the engine's worker thread fills
it after the trimmed fetches come back.
"""

import threading
import time
from collections import deque

from .errors import DeadlineExceededError, EngineClosedError

__all__ = ['InferenceRequest', 'MicroBatcher']


class InferenceRequest(object):
    """One submitted feed dict + its future result.

    ``trailing`` maps a BUCKETED trailing extent back to this request's
    real extent ({padded_T: real_T}, axis 1) when the engine's
    trailing-dim ladder padded the request's seq/resolution dims up to
    a rung — the deliver path trims per-request fetches back to the
    real extents (engine._drain_one).

    ``trace`` is the request's TraceContext (fluid.trace): the engine
    threads ONE trace id from submit() through the micro-batch lot,
    dispatch, device sync and per-request trim, so a delivered request
    answers "where did my latency go" via ``breakdown()``.

    ``kind`` partitions the queue's lot space: 'forward'
    requests coalesce into eval lots, 'generate' ones
    (GenerationRequest) into PREFILL lots the engine routes to the
    decode lane — the two kinds never share a lot even if their feed
    signatures collide.

    ``priority`` / ``deadline_ms`` are the SLO lane: higher
    priority classes form lots first; within a class the scheduler is
    earliest-deadline-first, and a deadlined request that can no longer
    answer in time is shed with DeadlineExceededError instead of served
    late.  ``deadline_t`` is the ABSOLUTE wall-clock deadline (enqueue
    + deadline_ms); None means the request never expires."""

    kind = 'forward'

    def __init__(self, feed, rows, sig, return_numpy=True, trailing=None,
                 trace=None, priority=0, deadline_ms=None):
        self.feed = feed
        self.rows = rows  # None for unbatchable (LoD / scalar) feeds
        self.sig = sig
        self.trailing = trailing or None
        self.return_numpy = return_numpy
        self.trace = trace
        self.priority = int(priority)
        self.deadline_ms = (float(deadline_ms)
                            if deadline_ms is not None else None)
        self.enqueue_t = time.time()
        self.deadline_t = (self.enqueue_t + self.deadline_ms / 1e3
                           if self.deadline_ms is not None else None)
        self.latency_s = None
        self._event = threading.Event()
        self._result = None
        self._error = None

    @property
    def trace_id(self):
        return self.trace.trace_id if self.trace is not None else None

    def breakdown(self):
        """The per-request stage breakdown (trace id, end-to-end ms,
        stage ms in pipeline order) — populated at delivery; None for a
        request created without a trace context."""
        return self.trace.breakdown() if self.trace is not None else None

    def done(self):
        return self._event.is_set()

    def set_result(self, result):
        self.latency_s = time.time() - self.enqueue_t
        self._result = result
        self._event.set()

    def set_error(self, exc):
        self.latency_s = time.time() - self.enqueue_t
        self._error = exc
        self._event.set()

    def result(self, timeout=None):
        """Block until delivered; re-raises the dispatch's exception."""
        if not self._event.wait(timeout):
            raise TimeoutError('inference request not completed within '
                               '%r s' % (timeout, ))
        if self._error is not None:
            raise self._error
        return self._result


def _sched_key(req, now=None, aging_s=None, max_priority=None):
    """EDF-within-priority: higher priority first, then earliest
    absolute deadline (no deadline = never urgent), then arrival —
    so undeadlined equal-priority traffic keeps exact FIFO order.

    ``aging_s`` is the starvation escape hatch: strict priority starves a low class
    forever under saturating high-priority traffic, so each full aging
    window a request has waited promotes its EFFECTIVE class by one —
    a request aging ``k * aging_s`` competes as ``priority + k``.
    Promotion engages ONLY for requests below ``max_priority`` (the
    highest REAL class currently pending): starvation needs someone
    above you, and a class alone in the queue must keep pure EDF order
    — an aged undeadlined request must not cut ahead of a
    deadline-imminent peer of its own class.  Real priority is
    untouched; only lot-formation order changes."""
    pr = req.priority
    if aging_s and max_priority is not None and pr < max_priority:
        pr += int((now - req.enqueue_t) / aging_s)
    return (-pr,
            req.deadline_t if req.deadline_t is not None else float('inf'),
            req.enqueue_t)


class MicroBatcher(object):
    """``scheduling``: 'edf' (deadline-aware lot formation + shedding,
    the default — degrades to FIFO for requests without priorities or
    deadlines) or 'fifo' (strict arrival order, nothing shed).

    ``on_shed``: callback invoked (queue lock held) with each shed
    request; the owner errors the future, counts the shed, and marks
    the trace.  When None the batcher errors the future itself.

    ``service_estimate_fn``: optional () -> seconds — the engine's
    current estimate of one dispatch's service time.  A deadlined
    request is shed not just when its deadline HAS passed but when it
    cannot be met within the estimate (Clockwork's admission rule):
    serving a request that will miss anyway only delays live ones.

    ``service_estimate_for``: optional (request) -> seconds — the
    PER-SIGNATURE form of the horizon: the engine's
    ServiceTimeProfile answers with the estimate for each request's
    OWN executable signature (falling back to the global floor for an
    unseen one), so a mixed-shape queue sheds the slow-signature
    request a global minimum would have admitted toward certain
    deadline death — and keeps the cheap request the slow signature's
    wall would have doomed.  Takes precedence over
    ``service_estimate_fn`` when both are given.

    ``priority_aging_s``: optional seconds — the starvation escape
    hatch.  Strict priority-first lot formation
    starves a saturated-out low class FOREVER; with aging set, every
    full window a request has waited raises its EFFECTIVE class by one
    for scheduling only, so a starving request eventually outranks
    fresh high-priority arrivals.  Promotion engages only for requests
    BELOW the highest pending real class (cross-class starvation is
    the target; within one class pure EDF order holds).  None
    (default) keeps strict priority; EDF scheduling only."""

    def __init__(self, max_batch_size=32, max_wait_s=0.005,
                 scheduling='edf', on_shed=None,
                 service_estimate_fn=None, service_estimate_for=None,
                 priority_aging_s=None, shed_by_class=False):
        if int(max_batch_size) < 1:
            raise ValueError('max_batch_size must be >= 1')
        if scheduling not in ('edf', 'fifo'):
            raise ValueError("scheduling must be 'edf' or 'fifo', got %r"
                             % (scheduling, ))
        if priority_aging_s is not None and float(priority_aging_s) <= 0:
            raise ValueError('priority_aging_s must be > 0 (or None for '
                             'strict priority)')
        if priority_aging_s is not None and scheduling == 'fifo':
            # mirror ServingConfig's contradiction check: fifo never
            # sorts, so a silently-ignored aging window would read as
            # starvation relief that is not actually active
            raise ValueError("priority_aging_s only applies to 'edf' "
                             "scheduling — drop scheduling='fifo', or "
                             'drop the aging window')
        if shed_by_class and scheduling == 'fifo':
            # same contradiction shape: fifo never sheds at all
            raise ValueError("shed_by_class only applies to 'edf' "
                             "scheduling — drop scheduling='fifo', or "
                             'drop shed_by_class')
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = float(max_wait_s)
        self.scheduling = scheduling
        self.priority_aging_s = (float(priority_aging_s)
                                 if priority_aging_s is not None else None)
        self.shed_by_class = bool(shed_by_class)
        self._on_shed = on_shed
        self._service_estimate_fn = service_estimate_fn
        self._service_estimate_for = service_estimate_for
        self._pending = deque()
        self._cond = threading.Condition()
        self._closed = False

    def depth(self):
        with self._cond:
            return len(self._pending)

    def pending_rows(self):
        with self._cond:
            return sum(r.rows or 1 for r in self._pending)

    def oldest_age(self):
        """Age (seconds) of the oldest queued request; None when empty.
        The trace watchdog's queue-age stall probe reads this — a
        request aging far past max_wait means the worker is stuck."""
        with self._cond:
            if not self._pending:
                return None
            return time.time() - self._pending[0].enqueue_t

    def age_stats(self):
        """Queue-age stats: oldest/mean queued request age in
        seconds plus the depth — the registry's admission watermarks
        read these, and ``engine.metrics()`` surfaces them so a
        stalling queue is visible without waiting for the watchdog
        dump.  None when the queue is empty."""
        with self._cond:
            if not self._pending:
                return None
            now = time.time()
            ages = [now - r.enqueue_t for r in self._pending]
            return {'oldest_s': max(ages),
                    'mean_s': sum(ages) / len(ages),
                    'depth': len(ages)}

    def pending_trace_ids(self):
        """Trace ids of every queued request — the stall dump's view of
        work stuck BEFORE any dispatch record could enter the ring."""
        with self._cond:
            return [r.trace_id for r in self._pending]

    def submit(self, request):
        with self._cond:
            if self._closed:
                raise EngineClosedError('MicroBatcher is closed')
            self._pending.append(request)
            self._cond.notify_all()
        return request

    def close(self):
        """Stop accepting; wakes waiters so the worker can drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _shed_locked(self):
        """Drop every pending request whose deadline has passed — or
        cannot be met within the engine's current service estimate —
        before any of them can head a lot (EDF mode only).  The shed
        callback errors each future with DeadlineExceededError; a shed
        must never take the worker down, so callback faults fall back
        to erroring the future directly."""
        if not self._pending:
            return
        now = time.time()
        if self.shed_by_class and (self._service_estimate_for is not None
                                   or self._service_estimate_fn
                                   is not None):
            # load-shedding by CLASS: walk the
            # queue in scheduling order (highest class first, EDF
            # within a class) ACCUMULATING service estimates — a
            # deadlined request sheds when the backlog scheduled ahead
            # of it already pushes its finish past its deadline.  Low
            # classes sort last, so under overload their deadlined work
            # sheds FIRST; within one class the walk order IS the EDF
            # order, so nothing reorders.  (Per-request estimates
            # accumulate without modeling lot coalescing — a
            # deliberate upper bound: admission errs toward shedding
            # work the backlog has already doomed.)
            def est_of(r):
                try:
                    if self._service_estimate_for is not None:
                        return float(self._service_estimate_for(r) or 0.0)
                    return float(self._service_estimate_fn() or 0.0)
                except Exception:
                    return 0.0

            maxp = max(r.priority for r in self._pending)
            order = sorted(
                self._pending,
                key=lambda r: _sched_key(r, now, self.priority_aging_s,
                                         maxp))
            doomed, cum = [], 0.0
            for r in order:
                e = est_of(r)
                if r.deadline_t is not None and r.deadline_t < now + cum + e:
                    doomed.append(r)
                    continue  # shed work frees its service slot
                cum += e
        elif self._service_estimate_for is not None:
            # per-signature horizon: each pending request is
            # judged against the estimate for ITS OWN signature; an
            # estimator fault degrades that request to the bare
            # past-deadline check, never to a worker death
            doomed = []
            for r in self._pending:
                if r.deadline_t is None:
                    continue
                try:
                    est = float(self._service_estimate_for(r) or 0.0)
                except Exception:
                    est = 0.0
                if r.deadline_t < now + est:
                    doomed.append(r)
        else:
            est = 0.0
            if self._service_estimate_fn is not None:
                try:
                    est = float(self._service_estimate_fn() or 0.0)
                except Exception:
                    est = 0.0
            horizon = now + est
            doomed = [r for r in self._pending
                      if r.deadline_t is not None
                      and r.deadline_t < horizon]
        if not doomed:
            return
        # one rebuild, not len(doomed) deque.remove scans: a stall can
        # doom most of an overloaded queue at once, and this runs with
        # the queue lock held
        doomed_ids = {id(r) for r in doomed}
        self._pending = deque(r for r in self._pending
                              if id(r) not in doomed_ids)
        for req in doomed:
            try:
                if self._on_shed is not None:
                    self._on_shed(req)
            except Exception:
                pass  # the fallback below still resolves the future
            if not req.done():
                req.set_error(DeadlineExceededError(
                    req.trace_id, req.deadline_ms,
                    round((now - req.deadline_t) * 1e3, 3)))

    def _select_locked(self):
        """The head request plus every signature-compatible follower
        that fits under max_batch_size; incompatible requests stay
        queued untouched.  Head choice and follower order are the
        scheduling policy: arrival order under 'fifo', priority-then-
        earliest-deadline under 'edf' (which is arrival order again
        when nothing carries a priority or deadline)."""
        if self.scheduling == 'edf' and len(self._pending) > 1 and \
                any(r.priority != 0 or r.deadline_t is not None
                    for r in self._pending):
            # only pay the sort when something actually carries an SLO:
            # for plain traffic _sched_key is a constant prefix plus
            # enqueue_t, i.e. exactly arrival order.  Aging promotes
            # only BELOW the highest pending real class, so a class
            # alone in the queue keeps pure EDF/arrival order.
            now = time.time()
            maxp = max(r.priority for r in self._pending)
            order = sorted(
                self._pending,
                key=lambda r: _sched_key(r, now, self.priority_aging_s,
                                         maxp))
        else:
            order = list(self._pending)
        head = order[0]
        lot, rows = [head], head.rows or 1
        if head.rows is None:
            return lot, rows  # unbatchable: its own lot
        for req in order[1:]:
            # same signature AND same kind: a forward request must
            # never ride a prefill lot (different program + fetches)
            if req.sig != head.sig or req.rows is None or \
                    req.kind != head.kind:
                continue
            if rows + req.rows > self.max_batch_size:
                break
            lot.append(req)
            rows += req.rows
        return lot, rows

    def next_lot(self, timeout=None, force=False):
        """Coalesce the next lot.  Blocks up to ``timeout`` (None =
        forever) for something flushable; returns [] on timeout, None
        when closed AND drained.  ``force`` flushes whatever is pending
        immediately, deadline notwithstanding (the inline/synchronous
        path and the stop-drain use it)."""
        deadline_out = None if timeout is None else time.time() + timeout
        with self._cond:
            while True:
                if self.scheduling == 'edf':
                    self._shed_locked()
                if self._pending:
                    lot, rows = self._select_locked()
                    # the deadline flush triggers on the OLDEST pending
                    # request (under EDF the lot head may be a newer,
                    # more urgent arrival — the latency bound must
                    # still cover the request left waiting)
                    flush_at = min(r.enqueue_t for r in self._pending) \
                        + self.max_wait_s
                    now = time.time()
                    # an unbatchable head (rows None: LoD/scalar feeds)
                    # can never coalesce — waiting out the deadline
                    # would be pure added latency
                    if force or self._closed or lot[0].rows is None or \
                            rows >= self.max_batch_size or now >= flush_at:
                        for req in lot:
                            self._pending.remove(req)
                        return lot
                    wait = flush_at - now
                elif self._closed:
                    return None
                elif force:
                    return []
                else:
                    wait = None
                if deadline_out is not None:
                    remaining = deadline_out - time.time()
                    if remaining <= 0:
                        return []
                    wait = remaining if wait is None else min(wait,
                                                              remaining)
                self._cond.wait(wait)
