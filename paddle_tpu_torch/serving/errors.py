"""Typed serving errors: the SLO lane's reject/shed vocabulary.

Copy of ``paddle_tpu/serving/errors.py``.

Tail-latency serving needs callers to DISTINGUISH outcomes a bare
RuntimeError collapses: a request shed because its deadline passed
(retry is pointless — the answer is already worthless), a request
refused at the door because the model is overloaded (retry after the
hint — the queue will have drained), and a request racing an engine
shutdown (route to another replica).  Clockwork (OSDI '20) and ORCA
(OSDI '22) both make this distinction first-class; the reference Fluid
C-API had only per-call status codes.

All three subclass RuntimeError so pre-SLO callers that caught broad
RuntimeError keep working.
"""

__all__ = ['DeadlineExceededError', 'OverloadedError', 'EngineClosedError']


class DeadlineExceededError(RuntimeError):
    """The request was SHED: its deadline passed (or could not be met
    within the scheduler's service estimate) while it waited, so the
    engine dropped it instead of serving a dead answer late.  Carries
    the deadline and how late the request was at shed time, so load
    generators and callers can account goodput without string
    matching."""

    def __init__(self, trace_id=None, deadline_ms=None, late_by_ms=None,
                 where='queue'):
        self.trace_id = trace_id
        self.deadline_ms = deadline_ms
        self.late_by_ms = late_by_ms
        self.where = where  # 'queue' | 'decode' | 'admit'
        late = ('%+.1f ms past' % late_by_ms
                if late_by_ms is not None else 'past')
        super(DeadlineExceededError, self).__init__(
            'request %s shed at the %s: %s its %s ms deadline — the '
            'response could no longer arrive in time, so serving it '
            'would only have delayed live requests'
            % (trace_id or '<untraced>', where, late,
               deadline_ms if deadline_ms is not None else '?'))


class OverloadedError(RuntimeError):
    """Admission-control reject: the model's queue crossed its
    depth/age watermark, so the registry refused the request at ROUTING
    time instead of letting it queue toward certain deadline death.
    ``retry_after_s`` is the hint a client (or load balancer) should
    back off for — roughly one queue-drain window."""

    def __init__(self, model, queue_depth, queue_age_s, retry_after_s):
        self.model = model
        self.queue_depth = int(queue_depth)
        self.queue_age_s = float(queue_age_s)
        self.retry_after_s = float(retry_after_s)
        super(OverloadedError, self).__init__(
            'model %r is overloaded (queue depth %d, oldest queued '
            'request %.3fs old) — retry after ~%.3fs'
            % (model, self.queue_depth, self.queue_age_s,
               self.retry_after_s))


class EngineClosedError(RuntimeError):
    """The engine (or its micro-batch queue) stopped accepting work —
    a submit raced a stop()/unload().  Typed so a router retrying on a
    replacement replica does not have to pattern-match message text."""
