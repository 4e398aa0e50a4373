"""Engine observability: counters, gauges, and a latency reservoir.

Copy of ``paddle_tpu/serving/metrics.py`` (pure threading).

The snapshot is the serving analog of the Executor's ``compile_count``:
every number a capacity planner needs to see whether the engine is
batching well (fill ratio), keeping up (queue depth, p99), and staying
inside its compile budget (dispatches vs compiles).  ``fluid.profiler``
surfaces the same snapshot through its ``.events.json`` sidecar (the
engine registers itself as a metrics source), so ``tools/timeline.py``
renders serving spans next to the executor/device slices.
"""

import threading
import time
from collections import deque

__all__ = ['EngineMetrics', 'RateWindow']


def _percentile(sorted_vals, p):
    if not sorted_vals:
        return None
    idx = min(int(len(sorted_vals) * p), len(sorted_vals) - 1)
    return sorted_vals[idx]


class RateWindow(object):
    """Events-per-second over a sliding window of recent event
    timestamps — the adaptive admission watermarks compare
    an engine's request ARRIVAL rate against its delivery DRAIN rate.
    A timestamp window, not a decaying counter: an idle engine's rate
    goes to zero instead of freezing at its last busy value."""

    def __init__(self, maxlen=128, horizon_s=10.0):
        self._times = deque(maxlen=int(maxlen))
        self._horizon_s = float(horizon_s)
        self._lock = threading.Lock()

    def note(self, n=1):
        now = time.time()
        with self._lock:
            for _ in range(int(n)):
                self._times.append(now)

    def rate(self):
        """Events/s over the retained window clipped to the horizon;
        None before the second event (one timestamp spans no time).
        The inter-arrival estimator (n-1 events over the span from the
        first timestamp): n/span would overestimate by n/(n-1) —
        2x at n=2, exactly the small-count regime a falling-behind
        engine's drain window sits in, which would inflate the
        drain/arrival ratio and delay door-shedding."""
        now = time.time()
        with self._lock:
            times = [t for t in self._times
                     if now - t <= self._horizon_s]
            if len(times) < 2:
                return None
            span = max(now - times[0], 1e-6)
            return (len(times) - 1) / span


class EngineMetrics(object):
    """Thread-safe counters shared by the submit path and the worker.

    Latencies keep the last ``reservoir`` request round trips (enqueue
    to delivery), enough for stable p50/p99 without unbounded growth.
    """

    def __init__(self, reservoir=2048):
        self._lock = threading.Lock()
        self._latencies = deque(maxlen=reservoir)
        self.requests = 0
        self.rows = 0
        self.lots = 0
        self.padded_rows = 0
        self.bucket_rows = 0
        self.deadline_flushes = 0
        self.full_flushes = 0
        self.dispatches = 0
        self.steps_dispatched = 0
        self.compiles = 0
        self.errors = 0
        # SLO lane: requests shed past-deadline instead of
        # served late — the deadline scheduler's drop counter (typed
        # DeadlineExceededError on the future; NOT counted as errors)
        self.shed = 0
        # trailing-dim bucketing: padded vs real CELLS along
        # bucketed trailing axes (weighted by rows, summed over feeds)
        self.trailing_real_cells = 0
        self.trailing_padded_cells = 0
        # request tracing: per-stage seconds summed over
        # delivered traced requests — the aggregate view of the
        # per-request breakdowns (queue/pad/arbitration/dispatch/
        # device/trim)
        self.stage_s = {}
        self.traced_requests = 0
        # cost accounting: the cost registry's FLOPs executed
        # vs wall seconds of the drained dispatches that carried a cost
        # entry — achieved-MFU's numerator/denominator
        self.device_flops = 0.0
        self.device_seconds = 0.0
        # generation lane: continuous-batching decode.
        # decode_tokens counts REAL emitted tokens (alive slot-steps);
        # decode_slot_steps counts K*S scan capacity — their ratio is
        # the slot occupancy the admission policy achieved.
        self.decode_requests = 0
        self.decode_finished = 0
        self.decode_dispatches = 0
        self.decode_scan_steps = 0
        self.decode_tokens = 0
        self.decode_slot_steps = 0
        self.prefill_lots = 0
        # pipelined decode: host-sync accounting.  A HOST
        # SYNC is a harvest that blocked with NO other scan in flight
        # behind it — the device sat idle while the host round-tripped
        # (the per-scan-sync lane pays one per scan; the chained lane
        # pays one per chain FLUSH).  harvests counts every token-block
        # materialization; chain_flushes counts the admission/eviction/
        # shed boundaries that drained the whole chain.
        self.decode_host_syncs = 0
        self.decode_harvests = 0
        self.decode_chain_flushes = 0
        # chunked prefill: chunk dispatches + prompt tokens
        # they consumed, and the decode inter-token stall gauge — the
        # max wall gap between consecutive token-block harvests while
        # prefill work was in flight, raw seconds and in units of the
        # lane's min scan wall ("step boundaries missed to a prompt")
        self.prefill_chunks = 0
        self.prefill_chunk_tokens = 0
        self.max_decode_stall_cycles = 0.0
        self.max_decode_stall_s = 0.0

    def note_request(self, rows):
        with self._lock:
            self.requests += 1
            self.rows += int(rows)

    def note_lot(self, real_rows, bucket_rows, deadline_flush):
        with self._lock:
            self.lots += 1
            self.bucket_rows += int(bucket_rows)
            self.padded_rows += int(bucket_rows) - int(real_rows)
            if deadline_flush:
                self.deadline_flushes += 1
            else:
                self.full_flushes += 1

    def note_trailing(self, real_cells, padded_cells):
        """One request's trailing-dim padding tax: real vs padded cells
        (extent x rows, summed over that request's bucketed feed axes).
        The snapshot derives the padding-waste ratio from the totals."""
        with self._lock:
            self.trailing_real_cells += int(real_cells)
            self.trailing_padded_cells += int(padded_cells)

    def note_dispatch(self, steps, compiles):
        with self._lock:
            self.dispatches += 1
            self.steps_dispatched += int(steps)
            self.compiles += int(compiles)

    def note_latency(self, seconds):
        with self._lock:
            self._latencies.append(float(seconds))

    def note_error(self):
        with self._lock:
            self.errors += 1

    def note_shed(self):
        with self._lock:
            self.shed += 1

    def note_stages(self, stage_s):
        """One delivered request's finalized per-stage seconds."""
        with self._lock:
            self.traced_requests += 1
            for stage, s in stage_s.items():
                self.stage_s[stage] = self.stage_s.get(stage, 0.0) + \
                    float(s)

    def note_generate(self):
        with self._lock:
            self.decode_requests += 1

    def note_prefill_lot(self):
        with self._lock:
            self.prefill_lots += 1

    def note_decode_dispatch(self, scan_steps, alive_slot_steps,
                             slot_steps, finished):
        """One drained decode scan: K scan steps over S slots, of which
        ``alive_slot_steps`` emitted real tokens and ``finished``
        requests hit their stop condition inside the scan."""
        with self._lock:
            self.decode_dispatches += 1
            self.decode_scan_steps += int(scan_steps)
            self.decode_tokens += int(alive_slot_steps)
            self.decode_slot_steps += int(slot_steps)
            self.decode_finished += int(finished)

    def note_decode_harvest(self, blocking):
        """One harvested decode token block; ``blocking``
        marks a device-idling host sync (nothing else in flight behind
        the harvested scan)."""
        with self._lock:
            self.decode_harvests += 1
            if blocking:
                self.decode_host_syncs += 1

    def note_decode_flush(self):
        with self._lock:
            self.decode_chain_flushes += 1

    def note_chunk_dispatch(self, tokens):
        """One chunked-prefill dispatch consuming
        ``tokens`` real prompt tokens across the prefilling slots."""
        with self._lock:
            self.prefill_chunks += 1
            self.prefill_chunk_tokens += int(tokens)

    def note_decode_stall(self, cycles, seconds):
        """One observed decode inter-token stall under in-flight
        prefill work; the snapshot keeps the max."""
        with self._lock:
            self.max_decode_stall_cycles = max(
                self.max_decode_stall_cycles, float(cycles))
            self.max_decode_stall_s = max(self.max_decode_stall_s,
                                          float(seconds))

    def note_device(self, flops, seconds):
        """One drained dispatch's cost-analysis FLOPs + wall seconds
        (dispatch issue -> host sync) — accumulates achieved MFU."""
        with self._lock:
            self.device_flops += float(flops)
            self.device_seconds += float(seconds)

    def device_rate(self):
        """Achieved FLOPs/s so far (None before any cost-carrying
        drain) — the ServiceTimeProfile seeder's denominator: a signature's cost-analysis FLOPs over this rate is its
        expected wall."""
        with self._lock:
            if self.device_seconds > 0 and self.device_flops > 0:
                return self.device_flops / self.device_seconds
            return None

    def decode_snapshot(self, active_slots=None, free_slots=None,
                        pending=None, inflight_scans=None):
        """The generation lane's block of ``snapshot()`` (None when the
        engine serves no generation model): request/token tallies, the
        amortization ratios (tokens and scan steps per dispatch), the
        occupancy the continuous-batching admission achieved, and the
        pipelined lane's host-sync accounting."""
        with self._lock:
            if not self.decode_requests:
                return None
            return {
                'host_syncs': self.decode_host_syncs,
                'harvests': self.decode_harvests,
                'chain_flushes': self.decode_chain_flushes,
                'inflight_scans': inflight_scans,
                'host_syncs_per_token': (
                    round(self.decode_host_syncs / self.decode_tokens,
                          4)
                    if self.decode_tokens else None),
                'requests': self.decode_requests,
                'finished': self.decode_finished,
                'tokens': self.decode_tokens,
                'dispatches': self.decode_dispatches,
                'prefill_lots': self.prefill_lots,
                'prefill_chunks': self.prefill_chunks,
                'prefill_chunk_tokens': self.prefill_chunk_tokens,
                'max_decode_stall_cycles': (
                    round(self.max_decode_stall_cycles, 3)
                    if self.max_decode_stall_cycles else 0.0),
                'max_decode_stall_s': (
                    round(self.max_decode_stall_s, 6)
                    if self.max_decode_stall_s else 0.0),
                'steps_per_dispatch': (
                    round(self.decode_scan_steps /
                          self.decode_dispatches, 3)
                    if self.decode_dispatches else None),
                'tokens_per_dispatch': (
                    round(self.decode_tokens / self.decode_dispatches,
                          3)
                    if self.decode_dispatches else None),
                'slot_occupancy': (
                    round(self.decode_tokens / self.decode_slot_steps,
                          4)
                    if self.decode_slot_steps else None),
                'active_slots': active_slots,
                'free_slots': free_slots,
                'pending': pending,
            }

    def snapshot(self, queue_depth=0, queue_age=None):
        """One coherent dict: counters plus the derived rates the
        ROADMAP's serving lane cares about (batch fill ratio = real rows
        over padded-bucket rows across all lots; steps/dispatch is the
        measured pipelining depth).  ``queue_age`` is the batcher's
        age_stats() dict — the admission watermarks' inputs,
        surfaced so a stalling queue shows up in metrics() without
        waiting for the watchdog dump."""
        with self._lock:
            lat = sorted(self._latencies)
            return {
                'queue_depth': int(queue_depth),
                'queue_age_oldest_s': (
                    round(queue_age['oldest_s'], 4)
                    if queue_age else None),
                'queue_age_mean_s': (
                    round(queue_age['mean_s'], 4)
                    if queue_age else None),
                'shed': self.shed,
                'requests': self.requests,
                'rows': self.rows,
                'lots': self.lots,
                'dispatches': self.dispatches,
                'steps_dispatched': self.steps_dispatched,
                'steps_per_dispatch': (
                    round(self.steps_dispatched / self.dispatches, 3)
                    if self.dispatches else None),
                'compiles': self.compiles,
                'errors': self.errors,
                'padded_rows': self.padded_rows,
                'batch_fill_ratio': (
                    round((self.bucket_rows - self.padded_rows) /
                          self.bucket_rows, 4)
                    if self.bucket_rows else None),
                'deadline_flushes': self.deadline_flushes,
                'full_flushes': self.full_flushes,
                'trailing_real_cells': self.trailing_real_cells,
                'trailing_padded_cells': self.trailing_padded_cells,
                'trailing_padding_waste': (
                    round(1.0 - self.trailing_real_cells /
                          self.trailing_padded_cells, 4)
                    if self.trailing_padded_cells else None),
                'p50_latency_ms': (
                    round(_percentile(lat, 0.50) * 1e3, 3) if lat else None),
                'p99_latency_ms': (
                    round(_percentile(lat, 0.99) * 1e3, 3) if lat else None),
                'traced_requests': self.traced_requests,
                'stages_ms_mean': ({
                    stage: round(s / self.traced_requests * 1e3, 3)
                    for stage, s in sorted(self.stage_s.items())
                } if self.traced_requests else None),
                'device_flops_per_s': (
                    round(self.device_flops / self.device_seconds, 1)
                    if self.device_seconds > 0 and self.device_flops > 0
                    else None),
            }
