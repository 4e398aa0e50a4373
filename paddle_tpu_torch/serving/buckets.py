"""Shape bucketing: map variable request shapes onto a small fixed set
of compiled entries.

Copy of ``paddle_tpu/serving/buckets.py`` on the port's own
``fluid.shape_policy``.  Every distinct feed signature is one compiled
block (on the card one CUDA graph capture — Executor keys its cache on
the feed signature, executor.py:_resolve_and_compile), so a
serving workload whose request sizes wander over 1..max_batch must not
mint O(max_batch) executables.  The batch-dim answer mirrors the
seq-len ladder (fluid.shape_policy), but batch sizes are small and
latency-bound, so the default ladder is simply the powers of two up to
``max_batch_size`` (aligned up to ``multiple`` — the dp mesh extent
for sharded serving): padding waste < 50%, log2(max_batch) batch
shapes.  (The engine's lots-per-dispatch count is quantized to its own
power-of-two ladder — engine._collect_block — so the total executable
set is bounded at buckets x (log2(steps_per_dispatch)+1), not
buckets x K.)

``TrailingDimBuckets`` is the TRAILING-dim twin: per-feed
seq-len/resolution ladders seeded from the SAME
``fluid.shape_policy.bucketed_len`` policy the executor applies to LoD
max-lens, so requests with distinct trailing shapes (seq-len,
resolution) quantize to shared rungs and coalesce instead of minting
per-shape lots and per-shape executables.

Both sets are BOUNDED: at most ``max_buckets`` buckets stay active, LRU
evicted beyond that.  Eviction here is accounting — the Executor's own
LRU (64 entries) owns executable memory — but the report makes the
compile budget observable: the engine surfaces ``report()`` plus the
executor's ``compile_count`` through its metrics snapshot.

Lock discipline: ``bucket_for`` runs on
the engine's worker/submitter threads while ``report()`` serves
metrics()/the profiler sidecar from user threads.  The ladder
(``sizes`` / ``_ladders``) is immutable after __init__; EVERY mutable
member (the active-set OrderedDict, the eviction/oversize tallies) is
read and written only under ``_lock``, so a report snapshot can never
observe an LRU eviction mid-update (tests/test_trailing_buckets.py
hammers this invariant from concurrent threads).
"""

import collections
import threading

from ..fluid import shape_policy

__all__ = ['ShapeBucketSet', 'TrailingDimBuckets']


def _align_up(n, multiple):
    return -(-int(n) // multiple) * multiple if multiple > 1 else int(n)


class ShapeBucketSet(object):
    """The bounded ladder of padded batch sizes serving requests map to.

    sizes: explicit ladder (sorted, deduped, aligned to ``multiple``);
    None builds the default powers-of-two ladder up to max_batch_size.
    """

    def __init__(self, max_batch_size, sizes=None, multiple=1,
                 max_buckets=16):
        self.max_batch_size = int(max_batch_size)
        self.multiple = max(int(multiple), 1)
        if sizes is None:
            sizes, s = [], 1
            while True:
                aligned = _align_up(s, self.multiple)
                if aligned >= self.max_batch_size:
                    sizes.append(_align_up(self.max_batch_size,
                                           self.multiple))
                    break
                sizes.append(aligned)
                s *= 2
        else:
            sizes = [_align_up(s, self.multiple) for s in sizes]
            top = _align_up(self.max_batch_size, self.multiple)
            if max(sizes) < top:
                # the batcher coalesces up to max_batch_size rows no
                # matter the ladder — a short explicit ladder would send
                # every above-top lot to its own exact bucket, quietly
                # voiding the bounded-compile contract
                sizes.append(top)
        self.sizes = sorted(set(int(s) for s in sizes))
        if int(max_buckets) < 1:
            raise ValueError('max_buckets must be >= 1')
        self._max_buckets = int(max_buckets)
        self._active = collections.OrderedDict()  # bucket -> hit count
        # bucket_for runs on the engine's worker thread while report()
        # serves metrics()/the profiler sidecar from user threads — the
        # OrderedDict must not be iterated mid-mutation
        self._lock = threading.Lock()
        self.evictions = 0
        self.oversized = 0

    def bucket_for(self, rows):
        """Padded batch size for a lot of ``rows`` real rows: the
        smallest ladder entry that fits.  A lone request larger than the
        ladder top gets its own exact (multiple-aligned) bucket rather
        than being rejected — it still compiles once per distinct size,
        which the ``oversized`` counter makes visible."""
        rows = int(rows)
        if rows < 1:
            raise ValueError('bucket_for: rows must be >= 1, got %r'
                             % (rows, ))
        for s in self.sizes:
            if rows <= s:
                bucket = s
                break
        else:
            bucket = _align_up(rows, self.multiple)
        with self._lock:
            if bucket > self.sizes[-1]:
                self.oversized += 1
            if bucket in self._active:
                self._active[bucket] += 1
                self._active.move_to_end(bucket)
            else:
                self._active[bucket] = 1
                if len(self._active) > self._max_buckets:
                    self._active.popitem(last=False)
                    self.evictions += 1
        return bucket

    def report(self):
        """Observability snapshot: the ladder, the active (bounded) set
        with hit counts, and the eviction/oversize tallies.  Runs
        entirely under ``_lock`` (see the module docstring's lock
        audit): the OrderedDict copy, the eviction and the oversize
        counters all come from ONE consistent point in time."""
        with self._lock:
            return {
                'sizes': list(self.sizes),
                'active': list(self._active),
                'hits': dict(self._active),
                'evictions': self.evictions,
                'oversized': self.oversized,
                'max_buckets': self._max_buckets,
            }


class TrailingDimBuckets(object):
    """Bounded per-feed TRAILING-dim ladders (the seq-len/resolution
    twin of ShapeBucketSet).

    ``bucket_for(name, axis, extent)`` returns the padded extent a
    request's trailing dim quantizes to:

      * by default, the shared seq-len policy
        ``fluid.shape_policy.bucketed_len`` — the SAME ladder the
        executor applies to LoD max-lens, so the request path and the
        feed-lowering path stop being parallel inventions;
      * feeds named in ``ladders`` use their EXPLICIT rung list instead
        (a resolution ladder: ``{'img': [224, 256, 320]}`` applies to
        axis 1; ``{'img': {2: [224, 256], 3: [224, 256]}}`` names the
        axes).  An extent above the explicit top gets its own exact
        rung (counted ``oversized``) rather than being rejected.

    The active set is bounded at ``max_buckets`` (name, axis, rung)
    entries, LRU-evicted beyond that — accounting, like
    ShapeBucketSet's: the Executor's compile LRU owns executable
    memory; this report makes the per-dim compile budget observable.

    Lock discipline matches ShapeBucketSet (module docstring): the
    ladder table is immutable after __init__, every mutable member
    lives under ``_lock``.
    """

    def __init__(self, ladders=None, bucket=None, max_buckets=32):
        self.bucket = int(bucket) if bucket else shape_policy.SEQ_BUCKET
        lad = {}
        for name, spec in (ladders or {}).items():
            if isinstance(spec, dict):
                for axis, sizes in spec.items():
                    lad[(name, int(axis))] = sorted(
                        set(int(s) for s in sizes))
            else:
                lad[(name, 1)] = sorted(set(int(s) for s in spec))
        for key, sizes in lad.items():
            if key[1] < 1:
                # axis 0 is the BATCH dim (ShapeBucketSet's job); a
                # <1 axis would be silently skipped downstream
                raise ValueError(
                    'TrailingDimBuckets: ladder axis for %r must be '
                    '>= 1 (axis 0 is the batch dim — that ladder is '
                    'ShapeBucketSet/bucket_sizes)' % (key[0], ))
            if not sizes or min(sizes) < 1:
                raise ValueError(
                    'TrailingDimBuckets: ladder for %r must be a non-'
                    'empty list of positive extents, got %r'
                    % (key, sizes))
        self._ladders = lad
        if int(max_buckets) < 1:
            raise ValueError(
                'TrailingDimBuckets: max_buckets must be >= 1')
        self._max_buckets = int(max_buckets)
        self._active = collections.OrderedDict()  # (name,axis,rung)->hits
        self._lock = threading.Lock()
        self.evictions = 0
        self.oversized = 0

    def ladder_axes(self, name):
        """The axes an EXPLICIT ladder was configured for (dense feeds
        opt into trailing bucketing per feed; seq feeds with @SEQLEN
        lengths ride the default policy on axis 1)."""
        return sorted(axis for (n, axis) in self._ladders if n == name)

    def bucket_for(self, name, axis, extent):
        """Padded extent for feed ``name``'s trailing ``axis`` of real
        ``extent``: the explicit ladder's smallest covering rung, or
        the shared seq-len policy when no ladder names the feed."""
        extent = int(extent)
        if extent < 1:
            raise ValueError(
                'bucket_for: extent must be >= 1, got %r' % (extent, ))
        sizes = self._ladders.get((name, int(axis)))
        oversize = False
        if sizes is None:
            rung = shape_policy.bucketed_len(extent, self.bucket)
        else:
            for s in sizes:
                if extent <= s:
                    rung = s
                    break
            else:
                rung = extent  # above the explicit top: own exact rung
                oversize = True
        key = (name, int(axis), rung)
        with self._lock:
            if oversize:
                self.oversized += 1
            if key in self._active:
                self._active[key] += 1
                self._active.move_to_end(key)
            else:
                self._active[key] = 1
                if len(self._active) > self._max_buckets:
                    self._active.popitem(last=False)
                    self.evictions += 1
        return rung

    def report(self):
        """Observability snapshot (one consistent point in time, under
        ``_lock``): per-(feed, axis, rung) hit counts plus the
        eviction/oversize tallies.  Keys are rendered ``name[axis]:rung``
        so the snapshot is JSON-friendly in the profiler sidecar."""
        with self._lock:
            hits = {'%s[%d]:%d' % k: v for k, v in self._active.items()}
            return {
                'policy_bucket': self.bucket,
                'ladders': {'%s[%d]' % k: list(v)
                            for k, v in self._ladders.items()},
                'active': list(hits),
                'hits': hits,
                'evictions': self.evictions,
                'oversized': self.oversized,
                'max_buckets': self._max_buckets,
            }
