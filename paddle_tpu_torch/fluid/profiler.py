"""Profiler (counterpart of ``paddle_tpu/fluid/profiler.py``), on
``torch.profiler`` and ``torch.cuda.profiler``.

``profiler(state, sorted_key, profile_path)`` records host-side wall
times of named events (``record_event``, ``record_block``: the executor
records one slice per ``run``, ``run_multi`` and ``run_eval_multi`` call)
and, for state 'GPU' or 'All' when ``profile_path`` names a directory,
traces the device with ``torch.profiler`` and writes its Chrome trace
there.  On stop it prints a table of the events and writes it to
``profile_path``, with a JSON sidecar ``<profile_path>.events.json`` (the
host events, the trace directory, and the registered metrics sources'
snapshots).
"""

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict

from . import trace as _trace

__all__ = [
    'cuda_profiler', 'reset_profiler', 'profiler', 'start_profiler',
    'stop_profiler', 'record_event', 'record_block',
    'register_metrics_source', 'unregister_metrics_source',
    'is_profiler_enabled',
]

# the reference's /tmp/profile, under the process's temporary directory
_DEFAULT_PATH = os.path.join(tempfile.gettempdir(), 'profile')

_profiler_state = {
    'enabled': False,
    'events': defaultdict(list),  # name -> [durations]
    'timeline': [],  # (name, start_s, dur_s) — tools/timeline.py source
    'trace_dir': None,
    'device_trace': None,
    'start_time': None,
}
# record_event is called from background threads too (the serving
# engine's worker, the FeedPipeline's staging thread): the lock keeps
# appends atomic against a concurrent stop_profiler/reset_profiler
# swapping or iterating the event tables mid-profile
_record_lock = threading.Lock()

# subsystem metrics riding the sidecar: {source name: zero-arg snapshot
# fn}.  The serving engine registers here so a profiled serving window
# dumps queue depth / fill ratio / p50/p99 next to its timeline spans
# (tools/timeline.py renders the spans; the 'metrics' block carries the
# counters).  Sources returning None (e.g. a dead weakref) are skipped.
_metrics_sources = {}
# registrations come from user threads, engine GC finalizers, and the
# registry's loader concurrently: the uniquify scan + assign below is
# check-then-act and must be atomic or two same-named sources can both
# land on the bare key (the clobber the uniquify exists to prevent)
_sources_lock = threading.Lock()
# final snapshots of sources that unregistered MID-profile (the common
# `with profiler: with engine: ...` nesting stops the engine before
# stop_profiler collects) — without this the sidecar would lose them
_final_metrics = {}


def register_metrics_source(name, fn):
    """Register a snapshot source; returns the KEY it landed under.
    A name already held by a DIFFERENT live source is uniquified
    (``name#2``, ``name#3``, ...) instead of silently clobbered — two
    same-named engines stopped inside one profiler window must both
    keep their sidecar snapshot.  Callers unregister by the returned
    key."""
    with _sources_lock:
        key = name
        n = 1
        while (key in _metrics_sources
               and _metrics_sources[key] is not fn) \
                or (_profiler_state['enabled'] and key in _final_metrics):
            # _final_metrics holds snapshots of sources already STOPPED
            # in the ACTIVE profile window: a successor reusing their
            # name must not shadow them at collection time.  Outside a
            # window the leftover finals are dead (the next
            # start_profiler resets them) and must not push a fresh
            # source onto a #2 key forever.
            n += 1
            key = '%s#%d' % (name, n)
        _metrics_sources[key] = fn
        return key


def unregister_metrics_source(name, fn=None):
    """Drop a source.  Pass the registered fn to make the removal
    owner-checked: if another source has since taken the name (two
    engines registering as 'prod'), the survivor stays registered.
    Inside an active profile the source's last snapshot is kept for the
    session's sidecar."""
    with _sources_lock:
        if fn is not None and _metrics_sources.get(name) is not fn:
            return
        src = _metrics_sources.pop(name, None)
        take_final = src is not None and _profiler_state['enabled']
    if take_final:
        try:
            snap = src()
        except Exception:
            snap = None
        if snap is not None:
            # never clobber an earlier source's final snapshot: two
            # same-named engines stopped in one window keep BOTH rows
            # (the second lands as name#2)
            with _sources_lock:
                key = name
                n = 1
                while key in _final_metrics:
                    n += 1
                    key = '%s#%d' % (name, n)
                _final_metrics[key] = snap


def _collect_metrics():
    out = dict(_final_metrics)
    for name, fn in list(_metrics_sources.items()):
        try:
            snap = fn()
        except Exception:
            continue
        if snap is not None:
            out[name] = snap
    return out


def is_profiler_enabled():
    return _profiler_state['enabled']


def record_event(name, seconds, start=None):
    enabled = _profiler_state['enabled']
    if not enabled and not _trace.spans_enabled():
        return  # the hot path stays one dict lookup when both are off
    start_t = (time.time() - seconds) if start is None else start
    # mirror into the trace span log (no-op outside a trace.tracing()
    # window): every profiler event — executor runs, pipeline staging,
    # serving dispatches — lands in the Chrome-trace exporter's
    # per-thread lanes without a second instrumentation pass 
    _trace.record_span(name, start_t, seconds)
    if enabled:
        with _record_lock:
            _profiler_state['events'][name].append(seconds)
            _profiler_state['timeline'].append((name, start_t, seconds))


@contextlib.contextmanager
def record_block(name):
    if not _profiler_state['enabled']:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        record_event(name, time.time() - t0, start=t0)


def reset_profiler():
    with _record_lock:
        _profiler_state['events'] = defaultdict(list)
        _profiler_state['timeline'] = []
        _final_metrics.clear()


def _device_activities(state):
    """The torch.profiler activities of a device trace for ``state``."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if state in ('GPU', 'TPU', 'All') and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_profiler(state='All'):
    if _profiler_state['enabled']:
        return
    reset_profiler()  # each start opens a fresh session record
    _profiler_state['enabled'] = True
    _profiler_state['start_time'] = time.time()
    trace_dir = _profiler_state.get('trace_dir')
    if trace_dir and state in ('GPU', 'TPU', 'All'):
        import torch
        prof = torch.profiler.profile(activities=_device_activities(state))
        prof.__enter__()
        _profiler_state['device_trace'] = prof


def stop_profiler(sorted_key=None, profile_path=_DEFAULT_PATH):
    if not _profiler_state['enabled']:
        return
    _profiler_state['enabled'] = False
    prof = _profiler_state.get('device_trace')
    if prof is not None:
        _profiler_state['device_trace'] = None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            _profiler_state['trace_dir'],
            'device_trace_%d.json' % int(_profiler_state['start_time'])))
    with _record_lock:
        # snapshot against a record_event already past the enabled check
        # on another thread
        events = {n: list(d) for n, d in _profiler_state['events'].items()}
        _profiler_state['timeline'] = list(_profiler_state['timeline'])
    lines = ['%-40s %8s %12s %12s %12s' %
             ('Event', 'Calls', 'Total(s)', 'Min(s)', 'Max(s)')]
    rows = []
    for name, durs in events.items():
        rows.append((name, len(durs), sum(durs), min(durs), max(durs)))
    key_idx = {'calls': 1, 'total': 2, 'min': 3, 'max': 4}.get(
        sorted_key or 'total', 2)
    rows.sort(key=lambda r: r[key_idx], reverse=True)
    for r in rows:
        lines.append('%-40s %8d %12.6f %12.6f %12.6f' % r)
    report = '\n'.join(lines)
    if profile_path:
        try:
            with open(profile_path, 'w') as f:
                f.write(report)
        except OSError:
            pass
        # the machine-readable sidecar tools/timeline.py reads
        try:
            import json
            with open(profile_path + '.events.json', 'w') as f:
                json.dump({
                    'host_events': [
                        {'name': n, 'start_s': s, 'dur_s': d}
                        for n, s, d in _profiler_state['timeline']],
                    'trace_dir': _profiler_state.get('trace_dir'),
                    'metrics': _collect_metrics(),
                }, f)
        except OSError:
            pass
    print(report)


@contextlib.contextmanager
def profiler(state, sorted_key=None, profile_path=_DEFAULT_PATH):
    """Profile the enclosed region (reference profiler.py:136).

    state: 'CPU' (host timings only), 'GPU'/'TPU'/'All' (also a
    torch.profiler device trace, written as a Chrome trace into
    ``profile_path`` when it names a directory)."""
    if state not in ('CPU', 'GPU', 'TPU', 'All'):
        raise ValueError("state must be 'CPU', 'GPU', 'TPU' or 'All'")
    if profile_path and os.path.isdir(profile_path):
        _profiler_state['trace_dir'] = profile_path
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)
        _profiler_state['trace_dir'] = None


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """The enclosed region between cudaProfilerStart and cudaProfilerStop
    (``torch.cuda.profiler``), for an external profiler; without a CUDA
    card, as in the JAX package, a region that records nothing."""
    import torch
    if not torch.cuda.is_available():
        yield
        return
    with torch.cuda.profiler.profile():
        yield
