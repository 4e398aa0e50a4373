"""ParallelExecutor: data-parallel training on ``torch.distributed``
(counterpart of ``paddle_tpu/fluid/parallel_executor.py``).

The JAX package runs one GSPMD program over the global batch: feeds split
on dim 0 over the 'dp' mesh axis, parameters replicated, every op seeing
the global batch.  Here one process runs each rank, every process is fed
the same global batch (the JAX package's multi-process contract), and the
program keeps the arithmetic of one program over that batch:

  1. rows: the global feed is padded to a multiple of the 'dp' extent by
     repeating its last real row (``pad_ragged_batch``; the ``@SAMPLE_MASK``
     is always added), and rank r takes rows [r*b, (r+1)*b) of every feed;
  2. reductions over the batch axis are global: the dp-aware lowerings
     (``mean``, ``reduce_sum``/``reduce_mean`` over dim 0, training
     ``batch_norm``, ``accuracy``, ``auc``, ``precision_recall``,
     ``kldiv_loss``) all-reduce their sums and counts; any other op that
     takes the split rows to an output without them raises (on every rank
     alike, before any later collective);
  3. gradients: each dp-aware reduction has an explicit grad, and no
     collective runs inside the generic grad's replay;
  4. parameter gradients: one all-reduce sum of every dense ``@GRAD`` right
     after the last op writing one, before the clip, the regularizers and
     the optimizer (not an average: the means already divide by the global
     count).  ``BuildStrategy``'s ``reduce_strategy`` and
     ``gradient_scale_strategy`` are accepted and change nothing, as in the
     JAX package;
  5. fetches: replicated values as they are; a fetch of the split rows is
     gathered in rank order and trimmed of the padding rows;
  6. randomness: each rank's generator is seeded from the program's seed
     and the rank;
  7. equal start: ``bcast_params()`` broadcasts every persistable from rank
     0, and the constructor calls it;
  8. capture: on the card under NCCL the collectives are captured in the
     block's CUDA graph; gloo's cannot be, and a block over gloo is
     declared eager before any capture (``cached_blocks()`` says why).

Data parallelism alone is ported: a mesh axis other than 'dp', row-sharded
tables, sparse gradients, the decode and chunk lanes, the feed pipeline and
reader-fed ``run_multi`` over a ``ParallelExecutor`` raise
(ROADMAP.md, Queue 1 items 7 and 8).
"""

import torch

from . import core
from .executor import (Executor, global_scope, prepare_feed_arrays,
                       _pop_readers_into_feed, _reject_reader_fed,
                       check_feed_list_uniform, check_feed_list_names,
                       normalize_trailing_feed_list, convert_eval_fetches,
                       fetch_batch_led, to_numpy, _as_tensor, _lead,
                       _stacked_signature)
from .framework import default_main_program, Variable
from ..ops import registry

__all__ = ['ParallelExecutor', 'ExecutionStrategy', 'BuildStrategy']


def pad_ragged_batch(feed_arrays, multiple, target=None, force_mask=False,
                     skip=(), batch_names=None, sizes_only=False,
                     report=None):
    """Pad the lot's batch dim up to ``target`` (default: the next multiple
    of ``multiple``, the dp extent) by repeating the last real row, and add
    a ``registry.SAMPLE_MASK_NAME`` feed (1.0 a real row, 0.0 padding), so
    that the mean lowerings, and through them every gradient, weight by the
    real row count.

    The batch row count is the non-divisible leading dim among the split
    feeds (names in ``skip``, feeds with a layout of their own, never
    vote): a divisible non-batch feed cannot take over the inference, and
    two feeds disagreeing on non-divisible rows is an error.
    ``batch_names`` skips the inference: only those feeds are batch-led
    (run_multi's re-pad pass).

    Returns (feed_arrays, n_real, n_padded); the input dict comes back
    untouched when the lot already divides and no mask is forced.
    ``sizes_only`` runs the inference alone: (None, n_real, n_padded).
    ``report`` (a dict) receives ``batch_names``: the feeds taken as
    batch-led, before padding (after it every batch feed shares the padded
    rows with any aux feed that happens to have as many)."""
    dims = set()
    for n, v in feed_arrays.items():
        if n in skip or isinstance(v, core.SelectedRows):
            continue
        if batch_names is not None and n not in batch_names:
            continue
        d = _lead(v)
        if d is not None:
            dims.add(d)
    dims = sorted(dims)
    if batch_names is not None:
        if len(dims) != 1:
            raise ValueError(
                'ragged lot is ambiguous: batch feeds %s disagree on '
                'rows %s' % (sorted(batch_names), dims))
        b = dims[0]
        if target is not None:
            tgt = int(target)
        else:
            tgt = -(-b // multiple) * multiple if multiple > 1 else b
    elif target is not None:
        # a lot that already divides carries no inference signal of its
        # own: the caller must say which feeds are batch-led
        raise ValueError('pad_ragged_batch: target= requires batch_names=')
    elif multiple > 1:
        nondiv = [d for d in dims if d % multiple]
        if len(nondiv) > 1:
            raise ValueError(
                'ragged lot is ambiguous: feeds disagree on batch rows %s '
                '(each %% %d != 0) — pad them to one batch size first, or '
                'annotate non-batch feeds with paddle_tpu_torch.parallel.'
                'shard' % (nondiv, multiple))
        b = nondiv[0] if nondiv else (dims[-1] if dims else 0)
        tgt = -(-b // multiple) * multiple if nondiv else b
    else:
        b = dims[-1] if dims else 0
        tgt = b
    if report is not None:
        report['batch_names'] = {
            n for n, v in feed_arrays.items()
            if n not in skip and not isinstance(v, core.SelectedRows)
            and (batch_names is None or n in batch_names)
            and _lead(v) == b}
    if b == 0 or (tgt == b and not force_mask):
        return (None if sizes_only else feed_arrays), b, b
    if sizes_only:
        return None, b, tgt
    out = {}
    pad = tgt - b
    for n, v in feed_arrays.items():
        if isinstance(v, core.SelectedRows):
            out[n] = v
            continue
        # as tensors (a lod-free LoDTensor's own): one lot's signature,
        # padded or not
        a = _as_tensor(v)
        if n in skip or (batch_names is not None and n not in batch_names) \
                or _lead(a) != b or not pad:
            out[n] = a  # not batch-leading, or nothing to append
            continue
        # repeat the last real row: always a valid row (in-range indices,
        # finite activations); its loss and gradients are masked out
        out[n] = torch.cat([a, a[-1:].expand((pad, ) + tuple(a.shape[1:]))])
    mask = torch.zeros((tgt, ), dtype=torch.float32)
    mask[:b] = 1.0
    out[registry.SAMPLE_MASK_NAME] = mask
    return out, b, tgt


def normalize_ragged_feed_list(per_step, pad_fn):
    """The ragged-feed_list normalization behind run_multi and
    run_eval_multi: size-probe every lot, and when any is ragged (or lots
    disagree in rows) pad all of them to the common target with masked
    rows, so that one block runs them all.  The batch feeds are those whose
    rows vary across lots; identical lots fall back to the first probe's
    inference.

    pad_fn(feed_arrays, **kw) -> (feed_arrays, n_real, n_padded): the
    executor's padding policy (``pad_ragged_batch`` with multiple 1 for
    one process, ``ParallelExecutor._pad_ragged`` for the dp extent).

    Returns (per_step, reals, target, batch_feed_names); ``reals`` is each
    lot's real row count, or None when nothing was padded."""
    probed = [pad_fn(fa, sizes_only=True) for fa in per_step]
    target = max(p[2] for p in probed)
    if not any(p[2] != target or p[1] != target for p in probed):
        return per_step, None, target, None
    batch_names = {
        n for n in per_step[0]
        if len({_lead(fa[n]) for fa in per_step}) > 1
    } or {n for n, v in per_step[0].items()
          if _lead(v) == probed[0][1]}
    rpt = {}
    repadded = [pad_fn(fa, target=target, force_mask=True,
                       batch_names=batch_names, report=rpt)
                for fa in per_step]
    return ([p[0] for p in repadded], [p[1] for p in repadded], target,
            rpt.get('batch_names'))


class ExecutionStrategy(object):
    def __init__(self):
        self.num_threads = 0
        self.use_event = True
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 100


class BuildStrategy(object):
    class ReduceStrategy(object):
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy(object):
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ''


def _later(what, item='7'):
    raise NotImplementedError(
        'ParallelExecutor.%s is not ported to PyTorch yet (ROADMAP.md, '
        'Queue 1 item %s)' % (what, item))


class ParallelExecutor(object):
    """Data-parallel training and evaluation over the ranks of
    ``torch.distributed``'s default process group (one rank without one).

    Every rank calls it with the same global batch.  It runs on the card,
    ``cuda:(rank % device_count)``, unless ``use_cuda=False``, and raises
    without a card.  The process group's backend decides the collectives:
    NCCL captures them in the block's CUDA graph, gloo runs its blocks
    eagerly.  ``mesh``: a mesh of a 'dp' axis alone
    (``parallel.make_mesh``); ``share_vars_from``, ``num_trainers`` and
    ``trainer_id`` are accepted as the JAX package accepts them (the process
    group gives the ranks)."""

    def __init__(self,
                 use_cuda=True,
                 loss_name=None,
                 main_program=None,
                 share_vars_from=None,
                 exec_strategy=None,
                 build_strategy=None,
                 num_trainers=1,
                 trainer_id=0,
                 scope=None,
                 mesh=None,
                 **kwargs):
        import torch.distributed as dist
        from ..parallel.mesh import mesh_axes
        from ..parallel.multihost import rank_device
        self._main_program = main_program if main_program is not None \
            else default_main_program()
        self._scope = scope if scope is not None else global_scope()
        if dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
            rank, world = dist.get_rank(), dist.get_world_size()
            backend = dist.get_backend()
        else:
            group, rank, world, backend = None, 0, 1, None
        axes = mesh_axes(mesh) if mesh is not None else {'dp': world}
        if set(axes) != {'dp'}:
            raise NotImplementedError(
                'ParallelExecutor: mesh axes %s; the PyTorch port runs data '
                'parallelism only (ROADMAP.md, Queue 1 item 7)' % axes)
        if axes['dp'] != world:
            raise ValueError('ParallelExecutor: the mesh has %d dp ranks, '
                             'the process group %d' % (axes['dp'], world))
        self._check_annotations()
        self.exec_strategy = exec_strategy or ExecutionStrategy()
        self.build_strategy = build_strategy or BuildStrategy()
        device = rank_device(rank, use_cuda)
        place = core.CUDAPlace(device.index) if use_cuda else \
            core.CPUPlace()
        self._exe = Executor(place)
        self._dp = registry.DataParallel(group, rank, world, backend)
        self._exe._dp = self._dp
        self.dispatch_count = 0
        self.steps_dispatched = 0
        self.bcast_params()

    # ---- observability, as the JAX package's ----
    @property
    def device_count(self):
        return self._dp.world

    @property
    def compile_count(self):
        """Block plans and the (steps, stacked signature) pairs run_multi
        and run_eval_multi have run: the JAX package compiles one executable
        for each."""
        return self._exe.compile_count

    @property
    def dp(self):
        """The ranks' ``registry.DataParallel``: rank, world, backend, and
        the collectives' calls, bytes and eager seconds."""
        return self._dp

    def cached_blocks(self):
        return self._exe.cached_blocks()

    def cost_report(self):
        return self._exe.cost_report()

    def close(self):
        self._exe.close()

    # ---- the rows ----
    def _check_annotations(self):
        """The layouts the port runs: state replicated, a feed split on
        dim 0 over 'dp' (the default) or taken whole by every rank (an
        all-None spec).  Any other annotation raises: row-sharded state
        (``DistributeTranspiler``'s distributed tables) and the other mesh
        axes are not ported."""
        from ..parallel.api import sharding_of
        for v in self._main_program.list_vars():
            axes = list(sharding_of(v) or ())
            if not any(a is not None for a in axes):
                continue
            if v.persistable or axes[0] != 'dp' or any(axes[1:]):
                raise NotImplementedError(
                    'var %r is annotated %s: the PyTorch port runs data '
                    'parallelism only (replicated state, feeds split on dim '
                    '0); row-sharded tables and tensor, sequence, pipeline '
                    'and expert parallelism come with ROADMAP.md, Queue 1 '
                    'item 7' % (v.name, tuple(axes)))

    def _replicated(self, feed_arrays):
        from .executor import replicated_feeds
        return set(replicated_feeds(self._main_program.block(0),
                                    feed_arrays))

    def _pad_ragged(self, feed_arrays, **kw):
        return pad_ragged_batch(feed_arrays, self._dp.world,
                                skip=self._replicated(feed_arrays), **kw)

    def _masked(self, feed_arrays):
        """(lot padded to the dp extent with its sample mask, real rows,
        padded rows, batch feed names)."""
        rpt = {}
        fa, real, padded = self._pad_ragged(feed_arrays, force_mask=True,
                                            report=rpt)
        return fa, real, padded, rpt.get('batch_names')

    def _split(self, feed_arrays):
        """This rank's rows [r*b, (r+1)*b) of every split feed."""
        world, rank = self._dp.world, self._dp.rank
        keep = self._replicated(feed_arrays)
        out = {}
        for n, v in feed_arrays.items():
            v = _as_tensor(v)
            if n in keep or v.dim() == 0 or world == 1:
                out[n] = v
                continue
            rows = int(v.shape[0])
            if rows % world:
                raise ValueError(
                    'feed %r: %d rows do not split over %d data-parallel '
                    'ranks (annotate a feed that every rank takes whole with '
                    'paddle_tpu_torch.parallel.shard(var))' % (n, rows,
                                                               world))
            b = rows // world
            out[n] = v[rank * b:(rank + 1) * b]
        return out

    def _resolve(self, fetch_list, local, batch_names):
        program, scope, feed_arrays, compiled = \
            self._exe._resolve_and_compile(self._main_program, local,
                                           fetch_list, self._scope,
                                           pop_readers=False)
        if compiled.host_ops:
            raise NotImplementedError(
                'ParallelExecutor cannot run programs containing host ops '
                '%s — run them with fluid.Executor' % compiled.host_ops)
        if compiled._batch_feed_names is None and batch_names is not None:
            # fixed by the feed signature, which keys the block
            compiled._batch_feed_names = frozenset(batch_names)
        return feed_arrays, compiled

    def _gathered(self, fetches, compiled, dim=0):
        """Each fetch that holds this rank's split of the rows gathered
        over the ranks in rank order; the others as they are."""
        out = []
        for f, split in zip(fetches, compiled.fetch_split()):
            if split and isinstance(f, torch.Tensor):
                f = self._dp.gather_rows(f, dim)
            out.append(f)
        return out

    def _convert(self, fetches, compiled, return_numpy, real, padded):
        fetches = self._gathered(fetches, compiled)
        if real != padded:
            led = fetch_batch_led(compiled, len(fetches))
            fetches = [f[:real] if is_led and getattr(f, 'ndim', 0) >= 1
                       and f.shape[0] == padded else f
                       for f, is_led in zip(fetches, led)]
        return self._exe._convert_fetches(fetches, return_numpy, compiled)

    @staticmethod
    def _fetch_names(fetch_list):
        if isinstance(fetch_list, (Variable, str)):
            fetch_list = [fetch_list]
        return [f.name if isinstance(f, Variable) else str(f)
                for f in fetch_list]

    # ---- running ----
    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        """One step over the global batch ``feed``; returns the fetches of
        the global batch."""
        program = self._main_program
        feed = dict(feed if feed is not None else (feed_dict or {}))
        _pop_readers_into_feed(program, feed, self._exe.place)
        fa, real, padded, names = self._masked(prepare_feed_arrays(feed))
        local, compiled = self._resolve(self._fetch_names(fetch_list),
                                        self._split(fa), names)
        fetches = compiled.run(self._scope, local, self._exe._rng(program))
        self.dispatch_count += 1
        self.steps_dispatched += 1
        return self._convert(fetches, compiled, return_numpy, real, padded)

    def _feed_list(self, feed_list, what):
        """Each lot of ``feed_list`` prepared, padded to one target with its
        mask and split: (local lots, reals or None, target, batch names)."""
        if not feed_list:
            raise ValueError('%s: feed_list is empty' % what)
        per_step = [prepare_feed_arrays(dict(f)) for f in feed_list]
        check_feed_list_names(per_step, what)
        normalize_trailing_feed_list(per_step)
        per_step, reals, target, names = normalize_ragged_feed_list(
            per_step, self._pad_ragged)
        if reals is None:
            masked = [self._masked(fa) for fa in per_step]
            per_step, names = [m[0] for m in masked], masked[0][3]
        local = [self._split(fa) for fa in per_step]
        check_feed_list_uniform(local, what)
        return local, reals, target, names

    def run_multi(self, fetch_list, feed=None, steps=1, feed_list=None,
                  return_numpy=True, reader=None, embed_caches=None):
        """``steps`` steps over the global batch ``feed``, or one over each
        global lot of ``feed_list`` (ragged lots, a ragged last one
        included, padded to one target with masked rows); the scope ends
        as ``steps`` run() calls leave it.  Returns the last step's
        fetches.  On the card under NCCL the steps are replays of the
        block's CUDA graph, collectives included."""
        if reader is not None:
            _later('run_multi(reader=...)')
        if embed_caches:
            _later('run_multi(embed_caches=...)', item='9')
        program = _reject_reader_fed(self._main_program,
                                     'ParallelExecutor.run_multi')
        fetch_names = self._fetch_names(fetch_list)
        per_step = None
        if feed_list is not None:
            if feed is not None:
                raise ValueError('run_multi: pass feed OR feed_list')
            per_step, reals, padded, names = self._feed_list(feed_list,
                                                             'run_multi')
            steps = len(per_step)
            real = reals[-1] if reals is not None else padded
            local = per_step[0]
        else:
            fa, real, padded, names = self._masked(
                prepare_feed_arrays(dict(feed or {})))
            local = self._split(fa)
        local, compiled = self._resolve(fetch_names, local, names)
        steps = int(steps)
        self._exe._note_multi_compile(compiled.multi_steps_seen, steps,
                                      _stacked_signature(per_step))
        fetches = compiled.run_multi(self._scope, local,
                                     self._exe._rng(program), steps,
                                     per_step=per_step)
        self.dispatch_count += 1
        self.steps_dispatched += steps
        return self._convert(fetches, compiled, return_numpy, real, padded)

    def run_eval_multi(self, fetch_list, feed=None, steps=None,
                       feed_list=None, return_numpy=True, reader=None):
        """``steps`` evaluation steps over the global batch ``feed``, or one
        over each global lot of ``feed_list``; every step's fetches, as
        Executor.run_eval_multi returns them, of the global batch."""
        if reader is not None:
            _later('run_eval_multi(reader=...)')
        program = _reject_reader_fed(self._main_program,
                                     'ParallelExecutor.run_eval_multi')
        fetch_names = self._fetch_names(fetch_list)
        per_step, reals = None, None
        if feed_list is not None:
            if feed is not None:
                raise ValueError('run_eval_multi: pass feed OR feed_list')
            per_step, reals, target, names = self._feed_list(
                feed_list, 'run_eval_multi')
            steps = len(per_step)
            local = per_step[0]
        else:
            if steps is None or int(steps) < 1:
                raise ValueError('run_eval_multi: steps must be >= 1, got '
                                 '%r' % (steps, ))
            fa, real, target, names = self._masked(
                prepare_feed_arrays(dict(feed or {})))
            reals = [real] * int(steps) if real != target else None
            local = self._split(fa)
        steps = int(steps)
        local, compiled = self._resolve(fetch_names, local, names)
        self._exe._note_multi_compile(compiled.eval_steps_seen, steps,
                                      _stacked_signature(per_step))
        stacked = compiled.run_eval_multi(
            self._scope, local, self._exe._rng(program), steps,
            per_step=per_step, host=False)
        self.dispatch_count += 1
        self.steps_dispatched += steps
        stacked = [to_numpy(s, n) for s, n in zip(
            self._gathered(stacked, compiled, dim=1), compiled.fetch_names)]
        return convert_eval_fetches(stacked, reals, target, compiled, steps,
                                    return_numpy)

    def bcast_params(self):
        """Every persistable of the program that the scope holds, broadcast
        from rank 0 (the reference's BCastParamsToDevices), so that every
        rank starts from rank 0's state.  The values are first moved to this
        rank's device."""
        device = self._exe.place.device
        names = sorted({v.name for v in self._main_program.list_vars()
                        if v.persistable})
        tensors = []
        for n in names:
            var = self._scope.find_var(n)
            value = var.value() if var is not None else None
            if isinstance(value, core.LoDTensor):
                value = value.tensor()
            if not isinstance(value, torch.Tensor):
                continue
            if value.device != device:
                value = value.to(device)
                var.set_value(value)
            tensors.append(value)
        self._dp.broadcast_(tensors)

    # ---- not in this slice ----
    def run_decode_multi(self, *args, **kwargs):
        _later('run_decode_multi', item='8')

    def _dispatch_chunk_prefill(self, *args, **kwargs):
        _later('run_chunk_prefill', item='8')
