"""Multi-model serving: N named InferenceEngines over ONE shared device,
with cross-model device-memory arbitration.

Counterpart of ``paddle_tpu/serving/registry.py``, single device.  The
single-model engine (engine.py) batches one model's requests; a server
hosting several models also needs the FLEET view the reference stack never
had (one predictor per process): which models are loaded, what each pins
in device memory, and which one is evicted when the next arrives.
``ModelRegistry`` is that subsystem:

  * **lifecycle**: ``load(name, dirname)`` (a save_inference_model dir)
    or ``load(name, program=...)`` builds a per-model engine with its own
    scope and executor on the registry's place (``CUDAPlace(0)`` unless
    given ``CPUPlace()``); ``unload`` stops and forgets it; ``warm``
    pre-builds the bucket ladder; ``status()`` snapshots the fleet.  All
    thread-safe against in-flight requests.
  * **HBM arbiter** (arbiter.py): every model's footprint is accounted
    (seeded from ``fluid.contrib.memory_usage_calc``, corrected once it
    serves to the live device bytes of the persistables its program
    reads), admission is checked against ``hbm_budget_bytes``, and the
    budget is kept by LRU eviction to HOST memory: the victim engine is
    paused (its in-flight dispatches deliver), those same persistables
    are copied to the host bitwise and its blocks' graphs released; the
    next request to it stages them back and captures afresh (a reload).
  * **router**: ``submit(model, feed)`` ensures residency, bumps the
    LRU, tracks per-model request and row counts, and forwards to the
    model's engine queue; each engine's worker drains its own queue
    while one shared dispatch GATE serializes the engines' dispatches,
    stagings and evictions on the card (no capture ever overlaps another
    engine's work, and no model hogs the card between another's
    dispatches).
  * **generation**: ``load(..., generation=GenerationSpec)`` serves a
    model's decode lane; its slot cache is an account of its own,
    ``<model>:decode-cache`` (its exact slab bytes, a typed reject at
    load when it alone cannot fit), evicted on its own (the slabs to the
    host bit for bit, the prefill/step/chunk blocks purged and their
    graphs, which held the slabs, released) and staged back by the next
    decode dispatch; ``submit_generate``/``generate`` ensure the model
    and its cache resident; ``warm(decode_prefill=)`` warms prompt-length
    rungs and the decode step;
  * **observability**: per-model engine snapshots ride the profiler
    sidecar under the registry's metrics source; spans land in
    per-model ``serving/<model>`` timeline rows; ``metrics()`` carries
    the arbiter's eviction, reload and admission counters.

Not ported yet, each raising ``NotImplementedError``: dp/mesh serving
(``parallel=``, ``mesh=``; ROADMAP.md, Queue 1 item 8), row-sharded
tables and embedding caches (``embed_caches=``; item 9).

    reg = serving.ModelRegistry(hbm_budget_bytes=2 << 30)
    reg.load('ranker', '/models/ranker')
    with reg:                                  # starts every worker
        out, = reg.infer('ranker', {'x': batch})
    print(reg.status(), reg.metrics())
"""

import itertools
import threading
import time
import weakref

import numpy as np

from ..fluid import core
from ..fluid import profiler as _profiler
from ..fluid import trace as _trace
from .arbiter import HBMArbiter, HBMBudgetError, program_seed_bytes
from .engine import InferenceEngine, ServingConfig
from .errors import OverloadedError

__all__ = ['ModelRegistry']

# the arbiter account of a model's decode slot cache
DECODE_CACHE_SUFFIX = ':decode-cache'

class _ModelEntry(object):
    __slots__ = ('name', 'engine', 'dirname', 'loaded_t', 'requests',
                 'rows', 'first_req_t', 'last_req_t', 'overload_rejects')

    def __init__(self, name, engine, dirname):
        self.name = name
        self.engine = engine
        self.dirname = dirname
        self.loaded_t = time.time()
        self.requests = 0
        self.rows = 0
        self.first_req_t = None
        self.last_req_t = None
        self.overload_rejects = 0


class ModelRegistry(object):
    """Host N named models behind one router + HBM arbiter (module
    docstring has the design)."""

    def __init__(self, hbm_budget_bytes=None, place=None, parallel=False,
                 mesh=None, config=None, name=None):
        if parallel or mesh is not None:
            raise NotImplementedError(
                'sharded serving (parallel=, mesh=) on ParallelExecutor is '
                'not ported to PyTorch yet (ROADMAP.md, Queue 1 item 8)')
        self.place = place if place is not None else core.CUDAPlace(0)
        self.parallel = False
        self.mesh = None
        self.config = config  # default ServingConfig for loaded models
        self.name = name or 'model-registry'
        self.arbiter = HBMArbiter(hbm_budget_bytes)
        self._models = {}
        # ONE reentrant lock over the model table + arbiter decisions: a
        # submit ensuring residency (which may pause and evict another
        # model) never interleaves with a load/unload mutating the table
        self._lock = threading.RLock()
        # the dispatch turnstile shared by every hosted engine
        self._dispatch_gate = threading.Lock()
        self._started = False
        self._closed = False
        ref = weakref.ref(self)
        self._metrics_fn = lambda: (ref().metrics() if ref() else None)
        self._metrics_key = _profiler.register_metrics_source(
            self.name, self._metrics_fn)
        weakref.finalize(self, _profiler.unregister_metrics_source,
                         self._metrics_key, self._metrics_fn)

    # ---- lifecycle -----------------------------------------------------

    def load(self, name, dirname=None, program=None, feed_names=None,
             fetch_list=None, scope=None, executor=None, config=None,
             model_filename=None, params_filename=None, generation=None,
             embed_caches=None):
        """Load a model under ``name``: either a save_inference_model
        ``dirname`` (own scope + executor, the production form) or an
        explicit ``program`` (+ fetch_list, and a scope holding its
        params).  Admission-checked against the HBM budget BEFORE any
        device work: a model that can never fit raises HBMBudgetError
        with nothing loaded."""
        if not name or '/' in str(name) or ':' in str(name):
            raise ValueError(
                'model name must be a non-empty string without "/" or '
                '":" (it keys metrics sources, timeline rows, and the '
                'arbiter account namespace — the ":decode-cache" suffix '
                'routes eviction), got %r' % (name, ))
        if embed_caches:
            raise NotImplementedError(
                'load(embed_caches=): the two-tier embedding cache is not '
                'ported to PyTorch yet (ROADMAP.md, Queue 1 item 9)')
        with self._lock:
            if self._closed:
                raise RuntimeError('registry is closed')
            if name in self._models:
                raise ValueError(
                    'model %r is already loaded — unload() it first '
                    '(in-place replacement would strand its queued '
                    'requests)' % name)
            cfg = config or self.config or ServingConfig()
            if dirname is not None:
                if generation is not None:
                    # checked before an engine (and its profiler
                    # registration) exists
                    raise ValueError(
                        'load(%r): generation= requires program= (the '
                        'prefill/step programs reference live Variables, '
                        'which a saved-model dir cannot carry)' % name)
                engine = InferenceEngine.from_saved_model(
                    dirname, place=self.place,
                    model_filename=model_filename,
                    params_filename=params_filename,
                    config=cfg, name=name)
            elif program is not None:
                if fetch_list is None:
                    raise ValueError('load(program=...): fetch_list is '
                                     'required')
                engine = InferenceEngine(
                    program, feed_names=feed_names, fetch_list=fetch_list,
                    place=self.place, scope=scope, executor=executor,
                    config=cfg, name=name, generation=generation)
            else:
                raise ValueError('load(): pass dirname= or program=')
            cache_account = name + DECODE_CACHE_SUFFIX
            try:
                # admission gate: seed the account from the program's
                # var-sum estimate at the TOP bucket size (weights + the
                # largest lot's activations)
                seed = program_seed_bytes(engine._program,
                                          max(engine.buckets.sizes))
                self.arbiter.admit(name, seed)
                if engine._decode_cache is not None:
                    # the decode cache's bytes are exact (static slot
                    # shapes): one that alone cannot fit is a typed reject
                    # here, not an out-of-memory error mid-generation
                    self.arbiter.admit(
                        cache_account,
                        engine.generation.cache_nbytes(
                            engine._decode_cache.slots))
                self._models[name] = _ModelEntry(name, engine, dirname)
                # make room NOW (evicting LRU peers), so the first
                # request pays staging, not arbitration
                self.arbiter.ensure(name, self._evict_to_host)
                if engine._decode_cache is not None:
                    self.arbiter.ensure(cache_account, self._evict_to_host)
            except Exception:
                # ANY failure must not leak the constructed engine (its
                # profiler registration and scope)
                self.arbiter.drop(name)
                self.arbiter.drop(cache_account)
                self._models.pop(name, None)
                engine.stop()
                raise
            engine._gate = self._dispatch_gate
            if self._started:
                engine.start()
            return engine

    def unload(self, name):
        """Stop the model's engine (drains its queue + in-flight
        dispatches), drop its account, and forget it."""
        with self._lock:
            entry = self._models.pop(name, None)
            if entry is None:
                raise KeyError('model %r is not loaded' % name)
            self.arbiter.drop(name)
            self.arbiter.drop(name + DECODE_CACHE_SUFFIX)
        entry.engine.stop()

    def warm(self, name, bucket_ladder=None, trailing=None,
             decode_prefill=None):
        """Pre-build the model's blocks across its bucket ladder (or an
        explicit one) with zero-filled requests, so first real traffic
        finds its blocks planned.  Returns the number of warm requests
        served.

        ``trailing`` extends the warm set along the TRAILING dims
       : ``{feed_name: [extents]}`` warms one request per
        (batch rung x trailing extent) for that feed — an LoD-declared
        feed warms as a zero-filled LoD batch of that uniform length
        (so the prepared signature, padded data + @SEQLEN, matches
        real traffic whose lengths bucket to the same rung), a dense
        feed substitutes the extent into axis 1.  Several trailing
        feeds warm the FULL cross-product of their rungs — trailing
        extents correlate in real traffic (both sides of a translation
        pair bucket long together), so the correlated multi-feed
        signatures are exactly the ones that must not stay cold; the
        warm set is len(ladder) x prod(len(extents)), which the caller
        bounds through the extents passed.

        ``decode_prefill`` warms the generation lane: one zero-filled
        single-sequence prompt per extent runs through ``generate`` with
        ``max_len=1``, which plans the prefill block at each prompt-length
        rung and the decode step.  A decode-only call (no bucket_ladder or
        trailing) skips the forward surface.  The JAX package's warm
        catalog and ``prewarm()`` replay are not ported."""
        entry = self._entry(name)
        engine = entry.engine
        served = 0
        trailing = {str(f): [int(e) for e in v]
                    for f, v in (trailing or {}).items()}
        if decode_prefill is not None:
            served += self._warm_decode(name, engine,
                                        [int(e) for e in decode_prefill])
            if bucket_ladder is None and not trailing:
                return served
        ladder = list(bucket_ladder if bucket_ladder is not None
                      else engine.buckets.sizes)
        feed_names = engine._feed_names
        if not feed_names:
            raise ValueError(
                'warm(%r): the engine has no feed_names — load the '
                'model from a save_inference_model dir, or pass '
                'feed_names= at load()' % name)
        unknown = sorted(set(trailing) - set(feed_names))
        if unknown:
            # a typo'd key would silently warm NOTHING useful while
            # reporting served rungs
            raise ValueError(
                'warm(%r): trailing names %s are not feeds of this '
                'model (feeds: %s)' % (name, unknown, sorted(feed_names)))
        empty = sorted(f for f, extents in trailing.items()
                       if not list(extents))
        if empty:
            # an empty extent list would die later on trailing[f][0]
            # with a raw IndexError
            raise ValueError(
                'warm(%r): trailing extents for %s are empty — pass '
                'at least one extent per feed' % (name, empty))
        block = engine._program.global_block()

        def zero_feed(fname, rows, extent):
            var = block.vars[fname]
            shape = [int(d) for d in var.shape]
            shape[0] = int(rows)
            if getattr(var, 'lod_level', 0):
                if extent is None:
                    raise ValueError(
                        'warm(%r): feed %r is a sequence (lod_level=%d) '
                        '— pass trailing={%r: [extents]} to warm its '
                        'seq-len rungs' % (name, fname, var.lod_level,
                                           fname))
                if any(d < 0 for d in shape[1:]):
                    # the extent fills the TIME axis, not these: a seq
                    # feed with another dynamic dim would otherwise die
                    # inside np.zeros with a raw 'negative dimensions'
                    # error instead of this message
                    raise ValueError(
                        'warm(%r): feed %r has a non-batch dynamic dim '
                        '%s — warm it with real traffic instead'
                        % (name, fname, var.shape))
                from ..fluid.lod_tensor import create_lod_tensor
                t = int(extent)
                rows_data = [np.zeros((t, ) + tuple(shape[1:]),
                                      var.np_dtype).tolist()
                             for _ in range(int(rows))]
                return create_lod_tensor(rows_data, [[t] * int(rows)])
            if extent is not None:
                if len(shape) < 2:
                    # silently dropping the extent would warm duplicate
                    # all-zero signatures while reporting them as served
                    # rungs — the same 'warmed nothing while reporting
                    # rungs' failure the unknown-name check catches
                    raise ValueError(
                        'warm(%r): feed %r has no trailing axis '
                        '(shape %s) — drop it from trailing='
                        % (name, fname, var.shape))
                axes = set(engine.trailing.ladder_axes(fname)) \
                    if engine.trailing is not None else set()
                if axes and axes != {1}:
                    # flat extents substitute axis 1; a dict-form
                    # ladder on other axes would warm signatures real
                    # traffic never produces while reporting served
                    # rungs
                    raise ValueError(
                        'warm(%r): feed %r buckets on axes %s — flat '
                        'trailing extents warm axis 1 only; warm those '
                        'rungs with real traffic'
                        % (name, fname, sorted(axes)))
                if int(var.shape[1]) >= 0:
                    raise ValueError(
                        'warm(%r): feed %r has a STATIC axis-1 extent '
                        '%d — there are no axis-1 rungs to warm; drop '
                        'it from trailing='
                        % (name, fname, int(var.shape[1])))
                shape[1] = int(extent)
            if any(d < 0 for d in shape[1:]):
                raise ValueError(
                    'warm(%r): feed %r has a non-batch dynamic dim '
                    '%s — warm it with real traffic instead'
                    % (name, fname, var.shape))
            return np.zeros(shape, dtype=var.np_dtype)

        # the FULL cross-product of per-feed rungs: trailing extents
        # correlate in real traffic, so varying one feed while pinning
        # the others at their first extent would leave exactly the
        # dominant multi-feed signatures cold
        t_names = sorted(trailing)
        combos = list(itertools.product(
            *(list(dict.fromkeys(trailing[f])) for f in t_names)))
        for rows in ladder:
            for combo in combos or [()]:
                extents = dict(zip(t_names, combo))
                feed = {fname: zero_feed(fname, rows,
                                         extents.get(fname))
                        for fname in feed_names}
                self.infer(name, feed, timeout=600)
                served += 1
        return served

    def _warm_decode(self, name, engine, extents):
        spec = engine.generation
        if spec is None:
            raise ValueError(
                'warm(%r): decode_prefill= but the model serves no '
                'generation lane — load it with generation=' % name)
        if not extents:
            raise ValueError(
                'warm(%r): decode_prefill is empty — pass at least one '
                'prompt-length extent' % name)
        from ..fluid.lod_tensor import create_lod_tensor
        pblock = spec.prefill_program.global_block()
        served = 0
        for extent in dict.fromkeys(extents):
            feed = {}
            for fname in spec.prefill_feeds:
                var = pblock.vars[fname]
                if not getattr(var, 'lod_level', 0):
                    raise ValueError(
                        'warm(%r): prefill feed %r is not a sequence '
                        '(lod_level=0) — decode_prefill warms prompt-length '
                        'rungs; warm dense prompts with real traffic'
                        % (name, fname))
                shape = [int(d) for d in var.shape[1:]]
                if any(d < 0 for d in shape):
                    raise ValueError(
                        'warm(%r): prefill feed %r has a non-batch dynamic '
                        'dim %s — warm it with real traffic instead'
                        % (name, fname, var.shape))
                rows = np.zeros((extent, ) + tuple(shape),
                                var.np_dtype).tolist()
                feed[fname] = create_lod_tensor([rows], [[extent]])
            self.generate(name, feed, max_len=1, timeout=600)
            served += 1
        return served

    def _entry(self, name):
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise KeyError(
                    'model %r is not loaded (loaded: %s)'
                    % (name, sorted(self._models)))
            return entry

    def models(self):
        with self._lock:
            return sorted(self._models)

    # ---- arbiter plumbing ----------------------------------------------

    def _evict_to_host(self, victim):
        """The arbiter's evict callback: pause the victim engine (its
        in-flight dispatches deliver), copy its device tensors to the host
        bitwise and release its blocks' graphs.  Returns the live bytes
        moved (the arbiter's account correction).  A ``:decode-cache``
        victim demotes its model's decode slabs instead of the weights."""
        if victim.endswith(DECODE_CACHE_SUFFIX):
            owner = victim[:-len(DECODE_CACHE_SUFFIX)]
            return self._models[owner].engine.evict_decode_cache()
        moved, _ = self._models[victim].engine.evict_to_host()
        return moved

    def audit(self):
        """The arbiter's cross-check now: accounted-resident bytes beside
        what the runtime holds live (``torch.cuda.memory_allocated`` on a
        CUDA place; on the CPU the engines' scope tensors, which is what
        the accounts track), drift included.  Also kept on the arbiter
        and surfaced as the ``audit`` block of ``metrics()``."""
        live = None
        if self.place.device.type != 'cuda':
            with self._lock:
                engines = [e.engine for e in self._models.values()]
            live = sum(eng.device_footprint() for eng in engines)
        return self.arbiter.audit(live)

    def _ensure_resident(self, name, decode=False):
        """Dispatch-time gate: budget-arbitrate ``name`` resident (LRU
        peers evict as needed), its account corrected to its live bytes
        first.  ``decode=True`` (a routed generation request) also ensures
        the model's decode-cache account; its slabs are staged back by the
        next decode dispatch after an eviction."""
        with self._lock:
            entry = self._entry(name)
            self.arbiter.correct(name, entry.engine.device_footprint())
            self.arbiter.ensure(name, self._evict_to_host)
            if decode:
                cache = name + DECODE_CACHE_SUFFIX
                self.arbiter.correct(cache,
                                     entry.engine._decode_cache.nbytes())
                self.arbiter.ensure(cache, self._evict_to_host)
            return entry

    # ---- router --------------------------------------------------------

    def _check_admission(self, model):
        """Per-model overload admission: when the model's
        ServingConfig carries queue watermarks (admit_queue_depth /
        admit_queue_age_ms) and its engine's queue has crossed one,
        refuse the request at the DOOR with a typed OverloadedError —
        BEFORE paying arbitration (an eviction on behalf of a request
        that would only queue toward deadline death helps nobody).  The
        retry-after hint is one queue-drain window: the oldest queued
        age (how far behind the worker is) floored at the batching
        wait.  (The entry lookup is NOT returned: _ensure_resident must
        re-resolve it under the lock anyway, or it would race an
        unload between the two calls.)"""
        entry = self._entry(model)
        cfg = entry.engine.config
        depth_wm = cfg.admit_queue_depth
        age_wm = cfg.admit_queue_age_s
        if depth_wm is None and age_wm is None:
            return
        depth = entry.engine._batcher.depth()
        age = entry.engine._batcher.oldest_age() or 0.0
        if cfg.adaptive_admission and (
                (depth_wm is not None and depth >= 0.5 * depth_wm) or
                (age_wm is not None and age >= 0.5 * age_wm)):
            # adaptive watermarks: scale the static marks by
            # the measured drain/arrival ratio, clamped to [0.5, 2.0].
            # An engine whose drain keeps up (ratio >= 1) tolerates a
            # deeper queue — the static watermark was sized for a
            # falling-behind worst case, and rejecting an absorbable
            # burst wastes goodput; one falling behind (ratio < 1)
            # admits at a proportionally SHALLOWER depth, shedding at
            # the door while the queue can still drain what it holds.
            # Before both rates are measurable the static marks stand.
            # Gated on the queue being at least HALFWAY to a static
            # mark: below that no clamped scale can change the
            # verdict, so the hot submit path skips the two
            # lock-guarded rate() passes entirely.
            rates = entry.engine.rate_stats()
            arrival, drain = rates['arrival_req_s'], rates['drain_req_s']
            if arrival and drain:
                scale = min(max(drain / arrival, 0.5), 2.0)
                if depth_wm is not None:
                    depth_wm = max(depth_wm * scale, 1.0)
                if age_wm is not None:
                    age_wm = age_wm * scale
        if (depth_wm is not None and depth >= depth_wm) or \
                (age_wm is not None and age >= age_wm):
            with self._lock:
                entry.overload_rejects += 1
            raise OverloadedError(
                model, depth, age,
                retry_after_s=round(max(age, cfg.max_wait_s), 4))

    def submit(self, model, feed, return_numpy=True, priority=0,
               deadline_ms=None):
        """Route one request to ``model``: admission-check it against
        the model's overload watermarks (typed OverloadedError with a
        retry-after hint when the queue is past them), ensure the model
        is resident under the HBM budget (transparently reloading it /
        evicting LRU peers — the caller never sees the arbitration,
        only the latency), and enqueue on its engine.  ``priority`` /
        ``deadline_ms`` ride through to the engine's deadline scheduler
       .  Returns the engine's InferenceRequest future — its
        ``breakdown()`` carries the routed request's per-stage latency
        INCLUDING the arbitration window paid here (the trace context
        is attached before engine.submit, so the engine threads the
        registry's trace id instead of minting its own)."""
        self._check_admission(model)
        ctx = _trace.TraceContext()
        t0 = time.time()
        entry = self._ensure_resident(model)
        ctx.add_stage('arbitration', time.time() - t0)
        now = time.time()
        with self._lock:
            entry.requests += 1
            if entry.first_req_t is None:
                entry.first_req_t = now
            entry.last_req_t = now
        with _trace.attach(ctx):
            req = entry.engine.submit(feed, return_numpy=return_numpy,
                                      priority=priority,
                                      deadline_ms=deadline_ms)
        if req.rows:
            with self._lock:
                entry.rows += req.rows
        return req

    def infer(self, model, feed, return_numpy=True, timeout=None):
        """Synchronous convenience: submit + wait."""
        return self.submit(model, feed,
                           return_numpy=return_numpy).result(timeout)

    def submit_generate(self, model, feed, max_len=None, priority=0,
                        deadline_ms=None):
        """Route one GENERATION request: admission-check the overload
        watermarks, ensure the model AND its decode cache resident under
        the budget, then enqueue on its engine's decode lane.  Returns the
        engine's GenerationRequest future; its ``breakdown()`` carries the
        arbitration window beside the prefill/decode/detokenize stages."""
        self._check_admission(model)
        ctx = _trace.TraceContext()
        t0 = time.time()
        entry = self._ensure_resident(model, decode=True)
        ctx.add_stage('arbitration', time.time() - t0)
        now = time.time()
        with self._lock:
            entry.requests += 1
            if entry.first_req_t is None:
                entry.first_req_t = now
            entry.last_req_t = now
        with _trace.attach(ctx):
            req = entry.engine.submit_generate(feed, max_len=max_len,
                                               priority=priority,
                                               deadline_ms=deadline_ms)
        with self._lock:
            entry.rows += 1
        return req

    def generate(self, model, feed, max_len=None, timeout=None):
        """Synchronous convenience: submit_generate + wait."""
        return self.submit_generate(model, feed,
                                    max_len=max_len).result(timeout)

    # ---- start/stop ----------------------------------------------------

    def start(self):
        """Start every loaded model's worker (queued mode); models
        loaded later start automatically."""
        with self._lock:
            if self._closed:
                raise RuntimeError('registry is closed')
            self._started = True
            engines = [e.engine for e in self._models.values()]
        for eng in engines:
            eng.start()
        return self

    def stop(self):
        """Stop every engine (each drains its queue), then unregister
        the registry's metrics source."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            engines = [e.engine for e in self._models.values()]
        for eng in engines:
            eng.stop()
        _profiler.unregister_metrics_source(self._metrics_key,
                                            self._metrics_fn)

    close = stop

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---- observability -------------------------------------------------

    def status(self):
        """One fleet snapshot: per-model residency, HBM account (bytes +
        whether it is the seed estimate or live-corrected), live device
        footprint, queue depth, and request tallies — plus the arbiter's
        budget line."""
        with self._lock:
            arb = self.arbiter.snapshot()
            out = {'budget_bytes': arb['budget_bytes'],
                   'resident_bytes': arb['resident_bytes'],
                   'models': {}}
            for name, entry in self._models.items():
                acct = arb['accounts'].get(name, {})
                out['models'][name] = {
                    'resident': acct.get('resident', False),
                    'hbm_bytes': acct.get('bytes', 0),
                    'account_source': acct.get('source'),
                    'device_footprint': entry.engine.device_footprint(),
                    'queue_depth': entry.engine.queue_depth(),
                    'requests': entry.requests,
                    'rows': entry.rows,
                    'dirname': entry.dirname,
                    'parallel': False,
                }
            return out

    def queue_depths(self):
        """Cheap per-model queue depths — the fleet replica's
        per-response load report: no arbiter snapshot, no
        device-footprint walk, just each engine's batcher depth."""
        with self._lock:
            entries = dict(self._models)
        return {name: entry.engine.queue_depth()
                for name, entry in entries.items()}

    def metrics(self):
        """Router + arbiter + per-model engine snapshots (this is what
        the profiler sidecar carries under the registry's source)."""
        with self._lock:
            entries = dict(self._models)
        arb = self.arbiter.snapshot()
        per_model = {}
        for name, entry in entries.items():
            snap = entry.engine.metrics()
            window = ((entry.last_req_t - entry.first_req_t)
                      if entry.requests > 1 and entry.first_req_t else None)
            snap['router'] = {
                'requests': entry.requests,
                'rows': entry.rows,
                'req_per_s': (round((entry.requests - 1) / window, 3)
                              if window else None),
                'overload_rejects': entry.overload_rejects,
            }
            per_model[name] = snap
        return {
            'models': per_model,
            'evictions': arb['evictions'],
            'reloads': arb['reloads'],
            'admission_rejects': arb['admission_rejects'],
            'overload_rejects': sum(e.overload_rejects
                                    for e in entries.values()),
            'budget_bytes': arb['budget_bytes'],
            'resident_bytes': arb['resident_bytes'],
            'audit': arb['audit'],
            'lru_order': arb['lru_order'],
        }
