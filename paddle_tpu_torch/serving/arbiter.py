"""Cross-model device-memory arbitration: budgeted admission + LRU weight
eviction for the multi-model registry.

Counterpart of ``paddle_tpu/serving/arbiter.py``.  The card's memory is
one pool shared by every loaded model's weights and its blocks' graphs;
the reference Fluid stack never arbitrated it (one predictor per
process, out-of-memory as the admission policy).  The ``HBMArbiter`` is
the ledger:

  * each model carries an ACCOUNT (bytes charged against the budget),
    SEEDED from ``fluid.contrib.memory_usage_calc.memory_usage`` (the
    program's var-sum upper bound at the top bucket size: weights plus
    one lot's activations) and CORRECTED to the live bytes once the model
    has served: the engine's ``device_footprint()``, the bytes of the
    CUDA tensors of the persistables its program reads (what an eviction
    moves and a reload stages back);
  * ``admit`` is the load-time gate: a model whose seed alone exceeds
    the budget raises ``HBMBudgetError`` (typed, so callers tell
    capacity from bugs) instead of running out of memory mid-request;
  * ``ensure`` is the dispatch-time gate: before a model serves, the
    least-recently-USED resident models are evicted (weights copied to
    host memory and their blocks' graphs released, through the
    registry's evict callback) until the target fits; the reload on the
    victim's next request is transparent;
  * every decision is counted (``evictions``, ``reloads``,
    ``admission_rejects``) and snapshotted for ``registry.metrics()``.

What ``torch.cuda.memory_allocated`` shows beside the accounts: every
tensor of the caching allocator on the card, so besides the models'
weights the graphs' private pools (a captured block's activations and
its static feed and fetch buffers), any transient feed or fetch, and the
scope tensors no model's program reads (a transpiler's f32 originals
left on the card).
The accounts hold the weights only (the seed covers one lot's
activations until the first correction); ``audit()`` reports the
difference as drift.

The arbiter is pure accounting + policy: it never touches device
memory itself.  The registry supplies the evict callback, which runs
under the victim engine's ``paused()`` window.
"""

import collections
import threading
import time

__all__ = ['HBMArbiter', 'HBMBudgetError', 'program_seed_bytes']

_UNIT_BYTES = {'B': 1, 'KB': 1024, 'MB': 1024**2, 'GB': 1024**3}


def program_seed_bytes(program, batch_size):
    """The admission seed: memory_usage's UPPER estimate for one
    forward pass at ``batch_size``, in bytes.  Deliberately the high
    bound — admission must be conservative; the live correction pulls
    the account down to the scope's live device bytes."""
    from ..fluid.contrib.memory_usage_calc import memory_usage
    _, high, unit = memory_usage(program, batch_size)
    return int(high * _UNIT_BYTES[unit])


class HBMBudgetError(RuntimeError):
    """Typed admission rejection: the model cannot fit the registry's
    HBM budget even with every other model evicted.  Carries the
    offending account so callers can size budgets programmatically."""

    def __init__(self, name, need_bytes, budget_bytes):
        self.model = name
        self.need_bytes = int(need_bytes)
        self.budget_bytes = int(budget_bytes)
        super(HBMBudgetError, self).__init__(
            'model %r needs ~%d bytes of HBM but the registry budget is '
            '%d bytes — raise hbm_budget_bytes or shrink the model/'
            'bucket ladder' % (name, need_bytes, budget_bytes))


class _Account(object):
    __slots__ = ('bytes', 'resident', 'source')

    def __init__(self, nbytes, resident, source):
        self.bytes = int(nbytes)
        self.resident = resident
        self.source = source  # 'seed' | 'live'


class HBMArbiter(object):
    """Budgeted accounts over the registry's models, LRU-ordered by
    last use.  ``budget_bytes=None`` disables enforcement (accounting
    and counters still run — the observability is free)."""

    def __init__(self, budget_bytes=None):
        self.budget_bytes = (int(budget_bytes)
                             if budget_bytes is not None else None)
        # insertion order IS the LRU order: touch() re-appends
        self._accounts = collections.OrderedDict()
        self._lock = threading.RLock()
        self.evictions = 0
        self.reloads = 0
        self.admission_rejects = 0
        self.last_audit = None

    def set_budget(self, budget_bytes):
        """Re-point the budget (tightening it does NOT evict eagerly —
        the next ensure() call enforces the new bound)."""
        with self._lock:
            self.budget_bytes = (int(budget_bytes)
                                 if budget_bytes is not None else None)

    def resident_bytes(self, exclude=None):
        with self._lock:
            return sum(a.bytes for n, a in self._accounts.items()
                       if a.resident and n != exclude)

    def admit(self, name, seed_bytes, ensure_cb=None):
        """Open an account at load time.  Raises HBMBudgetError when the
        seed alone can never fit; otherwise registers the account
        non-resident and lets ``ensure`` (via ensure_cb, usually
        registry-internal) make room."""
        seed_bytes = int(seed_bytes)
        with self._lock:
            if self.budget_bytes is not None and \
                    seed_bytes > self.budget_bytes:
                self.admission_rejects += 1
                raise HBMBudgetError(name, seed_bytes, self.budget_bytes)
            self._accounts[name] = _Account(seed_bytes, False, 'seed')
        if ensure_cb is not None:
            ensure_cb(name)

    def ensure(self, name, evict_cb):
        """Make ``name`` resident within budget: evict least-recently-
        used OTHER resident models (evict_cb(victim) must demote the
        victim's weights and return its live byte count) until the
        account fits.  Returns True when this call transitioned the
        model to resident (a reload when it had been evicted before).
        Counts as LRU use."""
        with self._lock:
            acct = self._accounts[name]
            self._accounts.move_to_end(name)
            was_resident = acct.resident
            if self.budget_bytes is not None:
                # evict in LRU order until the target fits
                while acct.bytes + self.resident_bytes(exclude=name) \
                        > self.budget_bytes:
                    victim = next(
                        (n for n, a in self._accounts.items()
                         if a.resident and n != name), None)
                    if victim is None:
                        self.admission_rejects += 1
                        raise HBMBudgetError(
                            name, acct.bytes, self.budget_bytes)
                    self.evict(victim, evict_cb)
            acct.resident = True
            if not was_resident and acct.source == 'live':
                # it served before and was evicted: this is a reload
                self.reloads += 1
            return not was_resident

    def evict(self, name, evict_cb):
        """Demote one model (the callback moves the buffers) and mark
        its account non-resident, corrected to the live bytes that
        actually moved."""
        with self._lock:
            acct = self._accounts[name]
            if not acct.resident:
                return 0
            moved = evict_cb(name)
            if moved:
                acct.bytes = int(moved)
                acct.source = 'live'
            acct.resident = False
            self.evictions += 1
            return moved

    def correct(self, name, live_bytes):
        """Live-stat correction: once a model has real device buffers,
        its account tracks them instead of the seed estimate (the
        'corrected by live buffer stats' half of the contract)."""
        live_bytes = int(live_bytes)
        if live_bytes <= 0:
            return
        with self._lock:
            acct = self._accounts.get(name)
            if acct is not None and acct.resident:
                acct.bytes = live_bytes
                acct.source = 'live'

    def touch(self, name):
        with self._lock:
            if name in self._accounts:
                self._accounts.move_to_end(name)

    def drop(self, name):
        with self._lock:
            self._accounts.pop(name, None)

    def is_resident(self, name):
        with self._lock:
            acct = self._accounts.get(name)
            return bool(acct is not None and acct.resident)

    def audit(self, live_bytes=None):
        """Cross-check the ledger against the runtime's own buffer
        stats: ``live_bytes`` defaults to ``torch.cuda.memory_allocated()``
        (every caching-allocator tensor on the current card, graph pools
        included; 0 without a card).  The drift, live minus
        accounted-resident, is the metric: a ledger matching reality
        sits near the graphs' and the transient feeds' bytes; a leak (an
        evicted model whose buffers never moved, an account stuck on a
        stale seed) walks away from it.  The result is kept as
        ``last_audit`` and rides ``snapshot()`` / ``registry.metrics()``."""
        if live_bytes is None:
            import torch
            live_bytes = (torch.cuda.memory_allocated()
                          if torch.cuda.is_available() else 0)
        with self._lock:
            accounted = self.resident_bytes()
            audit = {
                'live_bytes': int(live_bytes),
                'accounted_bytes': int(accounted),
                'drift_bytes': int(live_bytes) - int(accounted),
                'ts': time.time(),
            }
            self.last_audit = audit
        return dict(audit)

    def snapshot(self):
        with self._lock:
            return {
                'budget_bytes': self.budget_bytes,
                'resident_bytes': self.resident_bytes(),
                'evictions': self.evictions,
                'reloads': self.reloads,
                'admission_rejects': self.admission_rejects,
                'audit': (dict(self.last_audit)
                          if self.last_audit else None),
                'accounts': {
                    n: {'bytes': a.bytes, 'resident': a.resident,
                        'source': a.source}
                    for n, a in self._accounts.items()
                },
                'lru_order': list(self._accounts),
            }
