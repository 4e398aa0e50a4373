"""Per-executable-signature service-time profiles.

Copy of ``paddle_tpu/serving/profile.py`` (pure threading).  A global
shed horizon would be ONE number — 3x the minimum of the last
8 dispatch walls, whatever signature those dispatches served.  Under a
mixed-shape stream that is exactly wrong in both directions: a cheap
signature's wall drags the global minimum down, so a request of an
expensive signature is ADMITTED toward a deadline it can never meet
(and then served late, displacing live work); symmetrically, one
expensive signature can push a mean-based estimate up and shed cheap
requests that would have made it.  This profile keeps the estimate
PER SIGNATURE: the engine observes every drained dispatch's raw
issue->sync wall keyed by the lot's coalescing signature, and the
MicroBatcher's shed horizon asks for the estimate of each pending
request's OWN signature.

Statistic: the horizon estimate is the MINIMUM of a small recent-wall
window per signature — the same poisoning-proof statistic the global
horizon uses (a mean never recovers from a
compile-heavy cold dispatch because total shed stops drains; min
bounds the true service floor).  An EWMA of the walls rides along for
observability (``snapshot()``) and as the smoothed 'typical' wall —
it is deliberately NOT the shed statistic.

Seeding: a signature that has never been OBSERVED can still carry a
seed estimate derived from the cost registry (``trace.analyze_cost``
FLOPs over the engine's achieved FLOPs/s) — the engine seeds on the
first drain that carries a cost entry, so the min-window never
bottoms out at a compile-polluted first wall.  Observed walls always
participate alongside the seed; the seed is just one more candidate
floor.
"""

import threading
from collections import deque

__all__ = ['ServiceTimeProfile']


class ServiceTimeProfile(object):
    """EWMA + min-window wall-time profile keyed by executable
    signature.  Thread-safe: the submit path (shed horizon) reads while
    the worker observes.  Bounded: at most ``max_signatures`` entries,
    least-recently-observed evicted first."""

    def __init__(self, window=8, alpha=0.25, max_signatures=64):
        if int(window) < 1:
            raise ValueError('ServiceTimeProfile: window must be >= 1')
        if not (0.0 < float(alpha) <= 1.0):
            raise ValueError('ServiceTimeProfile: alpha must be in '
                             '(0, 1]')
        self._window = int(window)
        self._alpha = float(alpha)
        self._max = int(max_signatures)
        self._lock = threading.Lock()
        # key -> {'walls': deque, 'ewma': float|None, 'seed': float|None,
        #         'n': int}
        self._entries = {}

    def _entry_locked(self, key):
        e = self._entries.pop(key, None)
        if e is None:
            e = {'walls': deque(maxlen=self._window), 'ewma': None,
                 'seed': None, 'n': 0}
            while len(self._entries) >= self._max:
                # dict order is insertion order; pop/reinsert on touch
                # makes the first key the least recently observed
                self._entries.pop(next(iter(self._entries)))
        self._entries[key] = e
        return e

    def seed(self, key, seconds):
        """Install a cost-registry-derived estimate for ``key`` if it
        has none yet.  Seeds never overwrite an existing seed or any
        observation — they exist to pre-date the first (possibly
        compile-polluted) wall, not to fight the measurements."""
        seconds = float(seconds)
        if seconds <= 0.0:
            return False
        with self._lock:
            e = self._entry_locked(key)
            if e['seed'] is not None or e['n']:
                return False
            e['seed'] = seconds
            return True

    def observe(self, key, seconds):
        """One dispatch's raw issue->sync wall for ``key``."""
        seconds = max(float(seconds), 0.0)
        with self._lock:
            e = self._entry_locked(key)
            e['walls'].append(seconds)
            e['n'] += 1
            e['ewma'] = (seconds if e['ewma'] is None else
                         (1.0 - self._alpha) * e['ewma'] +
                         self._alpha * seconds)

    def estimate(self, key):
        """The service-floor estimate for ``key`` in seconds — the min
        of the recent-wall window (and the cost seed, if any), the
        statistic the shed horizon multiplies.  None when the signature
        was never seen."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            cands = list(e['walls'])
            if e['seed'] is not None:
                cands.append(e['seed'])
            return min(cands) if cands else None

    def floor(self):
        """The global fallback: the smallest per-signature estimate —
        what an UNSEEN signature gets (exactly the global-horizon
        behavior, so the profile only ever sharpens).  None when
        nothing was ever observed or seeded."""
        with self._lock:
            best = None
            for e in self._entries.values():
                cands = list(e['walls'])
                if e['seed'] is not None:
                    cands.append(e['seed'])
                if cands:
                    m = min(cands)
                    best = m if best is None else min(best, m)
            return best

    def signatures(self):
        with self._lock:
            return len(self._entries)

    def snapshot(self):
        """Observability: per-signature estimate/EWMA/count, keyed by a
        bounded repr of the signature plus a hash suffix — engine
        coalescing signatures are long tuples that can share a
        120-char prefix (e.g. differing only in a trailing rung), and
        a bare truncation would silently merge exactly the mixed-shape
        entries the profile exists to tell apart."""
        with self._lock:
            out = {}
            for key, e in self._entries.items():
                cands = list(e['walls'])
                if e['seed'] is not None:
                    cands.append(e['seed'])
                r = repr(key)
                if len(r) > 120:
                    r = '%s#%08x' % (r[:111], hash(key) & 0xffffffff)
                out[r] = {
                    'est_ms': (round(min(cands) * 1e3, 3)
                               if cands else None),
                    'ewma_ms': (round(e['ewma'] * 1e3, 3)
                                if e['ewma'] is not None else None),
                    'seeded': e['seed'] is not None,
                    'observed': e['n'],
                }
            return out
