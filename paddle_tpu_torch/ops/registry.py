"""Op lowering registry: OpDesc -> PyTorch.

Counterpart of ``paddle_tpu/ops/registry.py``.  Every op type registers a
*lowering*: a function that reads its input tensors from the context's
environment and writes its outputs.  The JAX package traces a whole block
into one XLA computation; here the executor calls the lowerings one op at a
time, eagerly, on the place's device.

The ``@SEQLEN`` side-band (per-row valid lengths riding beside a padded
tensor) propagates from inputs to outputs exactly as in the JAX package.
Mixed precision (``set_amp``, the ``amp_*`` helpers) is host state that
the lowerings read as they run; the executor keys its compiled blocks on
it, so a block captured under one mode never replays under the other.

On a CUDA place the executor captures a block once as a CUDA graph and
replays it.  A lowering that a capture cannot hold (one that reads a device
value on the host, copies from host memory, or draws from a generator of its
own) is declared with ``declare_uncapturable``; a block that holds one runs
eagerly, as the JAX package runs a block with a host op eagerly.

Host ops (``register_host_op``) run outside the lowerings, on numpy, as in
the JAX package: ``fn(ctx, op, scope)`` reads its inputs from ``ctx.env``
as host arrays and writes host arrays.  A host op is declared
uncapturable, so a block that holds one runs op by op on every call; the
executor copies the op's inputs to the host before the call and puts its
outputs back on the block's device after it.

Gradients: ``backward.append_backward`` appends one ``<op>_grad`` OpDesc per
forward op.  Unless an op registers an explicit grad lowering (random ops
must: the generic one would redraw their randomness), ``<op>_grad`` runs
``torch.func.vjp`` of the forward lowering, where the JAX package runs
``jax.vjp``.  The executor runs eagerly, so the vjp recomputes the forward
op: nothing merges the recompute with the first forward the way XLA's CSE
does inside one jit.  ``torch.func.vjp`` is a function transform, so the
executor's outer ``torch.no_grad()`` does not reach inside it.  A lowering
replayed under it must be functional: no in-place op on an input or a
captured tensor, and no ``.item()`` or ``.numpy()`` of a differentiated
value.
"""

import collections
import contextlib
import threading
import time

import torch

__all__ = ['register_lowering', 'register_grad_lowering', 'get_lowering',
           'register_host_op', 'get_host_op', 'is_host_op_type',
           'LoweringContext', 'run_op', 'recording', 'value_meta',
           'fwd_structure', 'SEQLEN_SUFFIX',
           'GRAD_SUFFIX', 'SAMPLE_MASK_NAME', 'declare_uncapturable',
           'check_cond_uninit',
           'capture_refusal', 'register_counter', 'counts', 'set_amp',
           'amp_enabled', 'amp_cast_in', 'amp_cast_out', 'amp_upcast_f32',
           'amp_harmonize', 'amp_matmul', 'DataParallel', 'declare_dp_aware',
           'declare_row_wise',
           'store_grad', 'dp_scaled_grad']

_LOWERINGS = {}
_GRAD_LOWERINGS = {}
_UNCAPTURABLE = {}  # op type -> (reason, predicate over the op or None)
# host ops: fn(ctx, op, scope) over numpy values, run by the executor's
# eager walk in place of a lowering
_HOST_OPS = {}
_COUNTERS = []  # callables -> {name: count}
# under data parallelism (``DataParallel``), the ops that may read the rows
# the ranks split; any other op that reads them raises (``_dp_kept``).
# dp-aware lowerings reduce over the split rows as over the global batch:
# op type -> fn(ctx, op) giving the output slots that still hold split rows.
# Row-wise ones keep the rows on dim 0, each row computed from its own:
# op type -> when(ctx, op), whether this op (its attrs, which inputs are
# split, the shapes) does
_DP_AWARE = {}
_ROW_WISE = {}

SEQLEN_SUFFIX = '@SEQLEN'
# the ragged-batch sample mask the executor feeds beside padded lots
# (1.0 = real row, 0.0 = padding), as in the JAX package
SAMPLE_MASK_NAME = '@SAMPLE_MASK'
# ops that consume sequence structure and emit dense outputs — sequence
# lengths must NOT propagate through them
_SEQ_CONSUMERS = {
    'sequence_pool', 'sequence_last_step', 'sequence_first_step',
}


def register_lowering(op_type):
    def deco(fn):
        _LOWERINGS[op_type] = fn
        return fn

    return deco


def register_grad_lowering(op_type):
    """Register an explicit lowering for ``<op_type>_grad``."""

    def deco(fn):
        _GRAD_LOWERINGS[op_type] = fn
        return fn

    return deco


def register_host_op(op_type):
    """Register ``fn(ctx, op, scope)`` as ``op_type``'s host function; a
    block that holds the op is refused capture and runs eagerly."""

    def deco(fn):
        _HOST_OPS[op_type] = fn
        declare_uncapturable(op_type, 'runs on the host (a host op)')
        return fn

    return deco


def get_host_op(op_type):
    return _HOST_OPS.get(op_type)


def is_host_op_type(op_type):
    return op_type in _HOST_OPS


def declare_dp_aware(*op_types, rows=None):
    """Declare that the lowerings of ``op_types`` handle row-split inputs
    under data parallelism: a reduction over the rows all-reduces its sums
    and counts (``LoweringContext.global_sum``).  ``rows(ctx, op)`` gives
    the output slots that still hold the split rows (None: none do); every
    other output is global."""
    for t in op_types:
        _DP_AWARE[t] = rows or (lambda ctx, op: ())


def declare_row_wise(*op_types, when=None):
    """Declare that, under data parallelism, ``op_types`` compute each row
    of their outputs' dim 0 from the same row of their split inputs, so
    that the outputs hold the split rows too.  ``when(ctx, op)``, run
    after the op, says whether this op does (its axis attrs, which inputs
    are split, the shapes); by default, whether every output's dim 0 is
    the split inputs' (``same_rows``)."""
    for t in op_types:
        _ROW_WISE[t] = when or same_rows


def declare_uncapturable(op_type, reason, when=None):
    """Declare that ``op_type`` (and its generic grad, which replays it)
    cannot run inside a CUDA graph capture, for ``reason``; ``when(op)``,
    if given, limits the declaration to the ops it is true for."""
    _UNCAPTURABLE[op_type] = (reason, when)


def capture_refusal(op):
    """Why a capture cannot hold ``op``, or None.  The ops of the blocks
    its ``sub_block`` attr names are checked too."""
    fwd = op.type[:-5] if op.type.endswith('_grad') else op.type
    entry = _UNCAPTURABLE.get(op.type) or _UNCAPTURABLE.get(fwd)
    if entry is not None and (entry[1] is None or entry[1](op)):
        return 'op %r %s' % (op.type, entry[0])
    sub = op.attrs.get('sub_block')
    if sub is not None and hasattr(sub, 'ops'):
        for inner in sub.ops:
            why = capture_refusal(inner)
            if why is not None:
                return why
    return None


def register_counter(fn):
    """Register a host-side counter source, ``fn() -> {name: count}``, such
    as a kernel wrapper's launch counts.  A capture records how far each
    count grew while it ran (``captured_launches``): a replay calls no
    wrapper, so it counts nothing here."""
    _COUNTERS.append(fn)
    return fn


def counts():
    """Every registered counter's current value, by name."""
    out = {}
    for fn in _COUNTERS:
        out.update(fn())
    return out


def get_lowering(op_type):
    fn = _LOWERINGS.get(op_type)
    if fn is not None:
        return fn
    if op_type.endswith('_grad'):
        fwd = op_type[:-5]
        if fwd in _GRAD_LOWERINGS:
            return _GRAD_LOWERINGS[fwd]
        if fwd in _LOWERINGS:
            return _make_generic_grad(fwd)
    raise NotImplementedError(
        'no PyTorch lowering registered for op %r (not ported yet)' %
        op_type)


class LoweringContext(object):
    """Environment handed to every lowering.

    ``env`` maps var name -> torch tensor; ``block`` gives the var descs;
    ``place`` names the device new tensors are made on; ``generator`` is the
    ``torch.Generator`` random ops draw from.
    """

    def __init__(self, block, env, place, generator=None, is_test=False,
                 cond_uninit=None, conditional_scope=False):
        self.block = block
        self.env = env
        self.place = place
        self._generator = generator
        self.is_test = is_test
        # host-side values of scalar index chains, as in the JAX package:
        # fill_constant, increment and assign record a [1] var's known
        # value here (run_op drops the entry of a name any other op
        # writes), so that a tensor-array op takes a Python index and
        # never reads one off the device (a sync a capture cannot hold)
        self.concrete = {}
        # each tensor-array op's index as its forward ran, by the op's
        # ``_array_op_id``: the index var may be incremented in place by
        # the time the op's grad runs
        self.array_log = {}
        # names whose only assignment so far is inside one
        # conditional_block: when its cond is false the reference leaves
        # the var uninitialized and errors on a read; the blended lowering
        # zero-fills it, so an unguarded read of it is rejected
        # (``check_cond_uninit``).  The set is shared by nested contexts;
        # ``conditional_scope`` marks one whose ops run conditionally (a
        # branch or a loop body): there reads are not checked and writes
        # do not clear the flag
        self.cond_uninit = cond_uninit if cond_uninit is not None else set()
        self.conditional_scope = conditional_scope
        # ragged-batch provenance, as in the JAX package: env names derived
        # from batch-led feeds that still carry the batch on dim 0.  Seeded
        # by the executor when a @SAMPLE_MASK rides along, propagated by
        # run_op; the mean lowerings mask only these.
        self.batch_led = set()
        # ...and names of batch ancestry whatever their dim 0 now (a
        # reshape [B, T, ..] -> [B*T, ..] leaves batch_led but not this
        # set), so that a masked lowering can warn of a flattened batch.
        # Under data parallelism (``dp``) it holds the names whose dim 0 is
        # split over the ranks, every split feed seeding it, and ``dp_rows``
        # the local rows of those feeds
        self.batch_tainted = set()
        self.dp = None
        self.dp_rows = ()
        # a mean's cotangent scale under dp, by its output name: its
        # local denominator over the global one (``dp_scaled_grad``)
        self.dp_grad_scale = {}

    @property
    def device(self):
        return self.place.device

    @property
    def generator(self):
        if self._generator is None:
            raise RuntimeError('op requested randomness but no generator '
                               'was given to this context')
        return self._generator

    # ---- value access ----
    def get(self, op, slot, default=None):
        names = op.input(slot)
        if not names:
            return default
        return self.env[names[0]]

    def set(self, op, slot, value):
        names = op.output(slot)
        if names:
            self.env[names[0]] = value

    def lookup(self, name):
        return self.env[name]

    def has(self, name):
        return name in self.env

    def store(self, name, value):
        self.env[name] = value

    def var_desc(self, name):
        return self.block._find_var_recursive(name)

    def sub_context(self, env):
        """A context over ``env`` that shares this one's block, place,
        mode and uninitialized-read tracking, with a copy of its known host
        values, but has no generator: a replayed forward must draw
        nothing."""
        sub = LoweringContext(self.block, env, self.place,
                              is_test=self.is_test,
                              cond_uninit=self.cond_uninit,
                              conditional_scope=self.conditional_scope)
        sub.concrete = dict(self.concrete)
        # a grad's replayed forward reads the forward's names: their
        # ragged-batch provenance holds there too
        sub.batch_led = set(self.batch_led)
        sub.batch_tainted = set(self.batch_tainted)
        # no collective runs in a replay: a dp-aware lowering replayed
        # there reduces its local rows, which its grad scales
        return sub

    def dp_split(self, name):
        """Whether ``name``'s dim 0 is split over data-parallel ranks."""
        return self.dp is not None and name in self.batch_tainted

    def global_sum(self, *tensors):
        """The tensors summed over the data-parallel ranks in one
        collective (each as it is without dp)."""
        if self.dp is None:
            return tensors
        return tuple(self.dp.all_reduce(list(tensors), exact=True))


class DataParallel(object):
    """The data-parallel ranks a block runs over (``LoweringContext.dp``):
    one process a rank, each holding its split of every feed's rows and a
    replica of the state, on ``torch.distributed``'s ``group`` (None for
    one rank without a process group, where every collective is the
    identity).

    ``calls`` and ``bytes`` count the collectives issued, ``seconds`` the
    host wall time of those run eagerly (on the card the device is
    synchronized on either side, so that the work queued before a
    collective is not counted in it), ``captured`` those issued inside a
    CUDA graph capture (each then runs at every replay, counted
    nowhere)."""

    def __init__(self, group, rank, world, backend=None):
        self.group, self.rank, self.world = group, int(rank), int(world)
        self.backend = backend
        self.seconds, self.calls, self.bytes, self.captured = 0.0, 0, 0, 0

    def _note(self, t0, nbytes, tensors):
        if t0 is not None:
            if tensors[0].is_cuda:
                torch.cuda.synchronize(tensors[0].device)
            self.seconds += time.perf_counter() - t0
        else:
            self.captured += 1
        self.calls += 1
        self.bytes += nbytes

    @staticmethod
    def _timed(tensors):
        """The start of an eager collective over ``tensors`` (None inside
        a capture), the device's queued work done first."""
        if tensors[0].is_cuda:
            if torch.cuda.is_current_stream_capturing():
                return None
            torch.cuda.synchronize(tensors[0].device)
        return time.perf_counter()

    def all_reduce(self, tensors, exact=False):
        """The sums of ``tensors`` over the ranks, as new tensors: one
        collective for each dtype over a flat buffer of them all (with
        ``exact``, one over all of them in f64: counts and small sums)."""
        if self.group is None or not tensors:
            return list(tensors)
        import torch.distributed as dist
        t0 = self._timed(tensors)
        groups = collections.OrderedDict()
        for i, t in enumerate(tensors):
            key = torch.float64 if exact else t.dtype
            groups.setdefault(key, []).append(i)
        out = [None] * len(tensors)
        nbytes = 0
        for dtype, idx in groups.items():
            flat = torch.cat([torch.reshape(tensors[i], (-1, )).to(dtype)
                              for i in idx])
            dist.all_reduce(flat, group=self.group)
            nbytes += flat.numel() * flat.element_size()
            at = 0
            for i in idx:
                t = tensors[i]
                out[i] = torch.reshape(flat[at:at + t.numel()],
                                       t.shape).to(t.dtype)
                at += t.numel()
        self._note(t0, nbytes, tensors)
        return out

    def broadcast_(self, tensors, src=0):
        """Overwrite ``tensors`` in place with rank ``src``'s values: one
        collective for each dtype over a flat buffer."""
        if self.group is None or not tensors:
            return
        import torch.distributed as dist
        t0 = self._timed(tensors)
        groups = collections.OrderedDict()
        for t in tensors:
            groups.setdefault(t.dtype, []).append(t)
        nbytes = 0
        for ts in groups.values():
            flat = torch.cat([torch.reshape(t, (-1, )) for t in ts])
            dist.broadcast(flat, src, group=self.group)
            nbytes += flat.numel() * flat.element_size()
            at = 0
            for t in ts:
                t.copy_(torch.reshape(flat[at:at + t.numel()], t.shape))
                at += t.numel()
        self._note(t0, nbytes, tensors)

    def gather_rows(self, tensor, dim=0):
        """Every rank's ``tensor`` concatenated on ``dim`` in rank order."""
        if self.group is None:
            return tensor
        import torch.distributed as dist
        t0 = self._timed([tensor])
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.world)]
        dist.all_gather(parts, tensor, group=self.group)
        self._note(t0, tensor.numel() * tensor.element_size() * self.world,
                   [tensor])
        return torch.cat(parts, dim=dim)


_RECORDING = threading.local()


@contextlib.contextmanager
def recording():
    """Record every op that ``run_op`` runs in this thread inside the
    block: a list of ``(op, meta, children)``, ``meta`` mapping each of
    the op's argument names to ``(shape, nbytes)`` (``value_meta``) as the
    op left them, ``children`` the records of the ops it ran inside it (a
    ``recurrent`` op's step block at every step).  The executor's cost
    accounting and memory analysis read it."""
    records = []
    prev = getattr(_RECORDING, 'stack', None)
    _RECORDING.stack = [records]
    try:
        yield records
    finally:
        _RECORDING.stack = prev


def value_meta(value):
    """(shape, bytes) of an environment value: a tensor, or a sparse
    gradient (its values' shape; its values' and rows' bytes); None for
    anything else."""
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), value.numel() * value.element_size()
    if isinstance(value, list) and value and all(
            isinstance(v, torch.Tensor) for v in value):
        # a tensor array: its elements stacked
        return ((len(value), ) + tuple(value[0].shape),
                sum(v.numel() * v.element_size() for v in value))
    values, rows = getattr(value, 'values', None), getattr(value, 'rows',
                                                           None)
    if isinstance(values, torch.Tensor) and isinstance(rows, torch.Tensor):
        return tuple(values.shape), (values.numel() * values.element_size()
                                     + rows.numel() * rows.element_size())
    return None


# op types that keep ``ctx.concrete`` themselves; every other op's outputs
# drop their entries
_CONCRETE_PRESERVING = {'fill_constant', 'increment', 'assign'}


def check_cond_uninit(ctx, names, what):
    """Reject a read of a var whose only assignment is inside one
    conditional_block: when the cond is false the var is uninitialized, and
    the reference's conditional_block op errors on such a read.  One helper
    for every call site (op inputs, host-op inputs, fetches)."""
    if not ctx.cond_uninit:
        return
    for n in names:
        if n in ctx.cond_uninit:
            raise RuntimeError(
                '%s reads var %r, whose only assignment is inside a '
                'single conditional_block: when the cond is false the '
                'var is uninitialized (reference conditional_block_op.cc '
                'errors on such a read) — write it unconditionally or '
                'in both branches first' % (what, n))


def run_op(ctx, op):
    """Run one op's lowering, then propagate sequence-length metadata from
    its inputs to its outputs.  An unguarded read of a conditionally
    uninitialized var raises first, and an unguarded write covers it."""
    guarded = ctx.conditional_scope or op.type == 'conditional_block'
    if not guarded:
        check_cond_uninit(ctx, op.input_arg_names, 'op %r' % op.type)
    if op.type not in _CONCRETE_PRESERVING:
        for n in op.output_arg_names:
            ctx.concrete.pop(n, None)
    stack = getattr(_RECORDING, 'stack', None)
    if stack:
        children = []
        stack.append(children)
        try:
            get_lowering(op.type)(ctx, op)
        finally:
            stack.pop()
        meta = {}
        for n in list(op.input_arg_names) + list(op.output_arg_names):
            m = value_meta(ctx.env.get(n))
            if m is not None:
                meta[n] = m
        stack[-1].append((op, meta, children))
    else:
        get_lowering(op.type)(ctx, op)
    if ctx.cond_uninit and not guarded:
        for n in op.output_arg_names:
            ctx.cond_uninit.discard(n)
    mask = ctx.env.get(SAMPLE_MASK_NAME)
    if mask is not None and not op.type.endswith('_grad'):
        # an output is batch-led iff an input was and it still carries the
        # batch on dim 0; it is of batch ancestry iff an input was
        led = any(n in ctx.batch_led for n in op.input_arg_names)
        tainted = led or any(n in ctx.batch_tainted
                             for n in op.input_arg_names)
        kept = _dp_kept(ctx, op) if tainted and ctx.dp is not None \
            else None
        for n in op.output_arg_names:
            v = ctx.env.get(n)
            if led and getattr(v, 'ndim', 0) >= 1 and \
                    v.shape[0] == mask.shape[0]:
                ctx.batch_led.add(n)
            else:
                ctx.batch_led.discard(n)
            if tainted if kept is None else n in kept:
                ctx.batch_tainted.add(n)
            else:
                ctx.batch_tainted.discard(n)
    if op.type in _SEQ_CONSUMERS or op.type.endswith('_grad'):
        return
    meta = None
    for n in op.input_arg_names:
        meta = ctx.env.get(n + SEQLEN_SUFFIX)
        if meta is not None:
            break
    if meta is not None:
        for n in op.output_arg_names:
            ctx.env.setdefault(n + SEQLEN_SUFFIX, meta)


def _dp_kept(ctx, op):
    """Under data parallelism, the output names of ``op``, which read rows
    the ranks split, that hold split rows too: those its dp-aware lowering
    names, or every output of a row-wise op (``declare_row_wise``), but
    for the ``*2`` ops' XShape.  Any other op raises: its value from the
    local rows would pass for the global one.  Every rank raises at the
    same op, before any later collective."""
    if not any(ctx.dp_split(n) for n in op.input_arg_names):
        return set()
    rows = _DP_AWARE.get(op.type)
    if rows is not None:
        return {n for slot in rows(ctx, op) for n in op.output(slot)}
    when = _ROW_WISE.get(op.type)
    if when is not None and when(ctx, op):
        return set(op.output_arg_names) - set(op.output('XShape'))
    raise NotImplementedError(
        'op %r reads the rows that data-parallel ranks split, and is '
        'neither dp-aware nor row-wise for these attrs and inputs: each '
        'rank would hold a local value for the global one.  Run it with '
        'fluid.Executor, or make its lowering all-reduce over the ranks '
        '(registry.declare_dp_aware)' % op.type)


def _values(ctx, names):
    return [ctx.env.get(n) for n in names]


def _split_rows(ctx, op):
    """Dim 0 of each split input of ``op``."""
    return {int(v.shape[0]) for n, v in zip(op.input_arg_names, _values(
        ctx, op.input_arg_names)) if ctx.dp_split(n)
        and isinstance(v, torch.Tensor) and v.dim() >= 1}


def _outputs(op):
    return [n for n in op.output_arg_names if n not in op.output('XShape')]


def same_rows(ctx, op):
    """Whether every output of ``op`` is a tensor whose dim 0 is its split
    inputs' (one size among them)."""
    rows = _split_rows(ctx, op)
    outs = _values(ctx, _outputs(op))
    return len(rows) == 1 and all(
        isinstance(v, torch.Tensor) and v.dim() >= 1 and
        int(v.shape[0]) in rows for v in outs if v is not None)


def _all_split(ctx, names):
    return all(ctx.dp_split(n) for n in names)


def _axis(op, ndim, name='axis', default=0):
    return op.attrs.get(name, default) % max(ndim, 1)


def _ndim(ctx, op, slot='X'):
    return ctx.env[op.input(slot)[0]].dim()


def _rows_on_axis(name='axis', default=0, slot='X', extra=0):
    """Row-wise iff the op's ``name`` attr (its ``slot`` input's rank
    plus ``extra``) is not dim 0, and the outputs keep the rows."""
    def when(ctx, op):
        ndim = _ndim(ctx, op, slot) + extra
        return ndim >= 2 and _axis(op, ndim, name, default) != 0 and \
            same_rows(ctx, op)
    return when


def _rows_off_axes(name='axes', slot='X', extra=0):
    """Row-wise iff none of the op's ``name`` attr axes is dim 0."""
    def when(ctx, op):
        ndim = _ndim(ctx, op, slot) + extra
        axes = op.attrs.get(name, [])
        axes = [axes] if isinstance(axes, int) else axes
        return all(a % ndim != 0 for a in axes) and same_rows(ctx, op)
    return when


def _binary_rows(ctx, op):
    """An elementwise op of X and Y: X holds the split rows, and Y does
    not, or lines up with them on dim 0 (the elementwise lowerings'
    alignment: ``axis``, or the trailing dims)."""
    xn, yn = op.input('X')[0], op.input('Y')[0]
    if not ctx.dp_split(xn):
        return False
    if ctx.dp_split(yn):
        x, y = ctx.env[xn], ctx.env[yn]
        axis = op.attrs.get('axis', -1)
        xd = ctx.var_desc(xn)
        if axis == -1 or (xd is not None and xd.shape and
                          len(xd.shape) != x.dim()):
            axis = x.dim() - y.dim()
        if axis != 0:
            return False
    return same_rows(ctx, op)


def _matmul_rows(ctx, op):
    """A product whose split operands' dim 0 is a batch dim: X's rows (2-D
    X untransposed, or any X of rank 3 or more) times an unsplit Y of rank
    2 at most, or batched products of split operands."""
    (xn, ), (yn, ) = op.input('X'), op.input('Y')
    x, y = ctx.env[xn], ctx.env[yn]
    xs, ys = ctx.dp_split(xn), ctx.dp_split(yn)
    if xs and ys:
        ok = x.dim() >= 3 and y.dim() >= 3
    elif xs:
        ok = y.dim() <= 2 and (x.dim() >= 3 or
                               not op.attrs.get('transpose_X', False))
    else:
        ok = x.dim() <= 2 and y.dim() >= 3
    return ok and same_rows(ctx, op)


def _unsplit(*slots):
    """Row-wise iff none of ``slots`` (parameters: a filter, a table, a
    weight) holds split rows."""
    def when(ctx, op):
        return not any(ctx.dp_split(n) for s in slots
                       for n in op.input(s)) and same_rows(ctx, op)
    return when


def _reshape_rows(ctx, op):
    """A reshape keeps the rows, flattened into dim 0 or split out of it,
    iff its shape after dim 0 does not depend on the rows: no Shape input
    and no -1 there."""
    shape = op.attrs.get('shape', [])
    return not any(op.input(s) for s in ('Shape', 'ShapeTensor')) and \
        len(shape) >= 1 and all(s != -1 for s in shape[1:])


declare_row_wise(
    # elementwise, one input
    'abs', 'brelu', 'ceil', 'cos', 'elu', 'exp', 'floor', 'hard_shrink',
    'hard_sigmoid', 'leaky_relu', 'log', 'logsigmoid', 'reciprocal', 'relu',
    'relu6', 'round', 'sigmoid', 'sign', 'sin', 'soft_relu', 'softplus',
    'softshrink', 'softsign', 'sqrt', 'square', 'stanh', 'swish', 'tanh',
    'tanh_shrink', 'thresholded_relu', 'pow', 'scale', 'cast', 'clip',
    'dropout', 'assign', 'fill_zeros_like', 'logical_not', 'one_hot',
    # each row's loss from its own logits and labels
    'cross_entropy', 'softmax_with_cross_entropy',
    'sigmoid_cross_entropy_with_logits', 'log_loss', 'hinge_loss',
    'huber_loss', 'modified_huber_loss', 'smooth_l1_loss', 'rank_loss',
    'margin_rank_loss', 'squared_l2_distance',
    # over each sample's own dims: pixels, steps, heads
    'pool2d', 'pad2d', 'maxout', 'flash_attention', 'sequence_pool',
    'sequence_first_step', 'sequence_last_step', 'sequence_softmax')
declare_row_wise(
    *(['elementwise_' + n for n in ('add', 'sub', 'mul', 'div', 'max',
                                    'min', 'pow', 'mod', 'floordiv')] +
      ['equal', 'not_equal', 'less_than', 'less_equal', 'greater_than',
       'greater_equal', 'logical_and', 'logical_or', 'logical_xor']),
    when=_binary_rows)
declare_row_wise('matmul', when=_matmul_rows)
declare_row_wise('mul', when=_unsplit('Y'))
declare_row_wise('conv2d', 'depthwise_conv2d', 'sequence_conv',
                 when=_unsplit('Filter'))
declare_row_wise('lookup_table', when=_unsplit('W'))
declare_row_wise('gather', when=_unsplit('X'))
declare_row_wise('prelu', when=_unsplit('Alpha'))
declare_row_wise('label_smooth', when=_unsplit('PriorDist'))
declare_row_wise('lstm', 'gru', when=_unsplit('Weight', 'Bias'))
declare_row_wise('gru_unit', when=_unsplit('Weight', 'Bias'))
declare_row_wise('layer_norm', when=lambda ctx, op: op.attrs.get(
    'begin_norm_axis', 1) >= 1 and same_rows(ctx, op))
declare_row_wise('softmax', 'top_k', when=lambda ctx, op: _ndim(
    ctx, op) >= 2 and same_rows(ctx, op))
declare_row_wise('sum', 'multiplex', when=lambda ctx, op: _all_split(
    ctx, op.input_arg_names) and same_rows(ctx, op))
declare_row_wise('concat', when=lambda ctx, op: _all_split(
    ctx, op.input('X')) and _rows_on_axis()(ctx, op))
declare_row_wise('stack', when=lambda ctx, op: _all_split(
    ctx, op.input('X')) and _rows_on_axis(extra=1)(ctx, op))
declare_row_wise('split', 'unstack', when=_rows_on_axis())
declare_row_wise('cumsum', 'argsort', 'norm',
                 when=_rows_on_axis(default=-1))
declare_row_wise('argmax', 'arg_max', 'argmin', 'arg_min',
                 when=_rows_on_axis())
declare_row_wise('slice', when=_rows_off_axes(slot='Input'))
declare_row_wise('reverse', when=_rows_off_axes('axis'))
declare_row_wise('squeeze', 'squeeze2', when=lambda ctx, op: bool(
    op.attrs.get('axes')) and _rows_off_axes()(ctx, op))
declare_row_wise('unsqueeze', 'unsqueeze2', when=lambda ctx, op:
                 _rows_off_axes(extra=len(op.attrs['axes']))(ctx, op))
declare_row_wise('transpose', 'transpose2', when=lambda ctx, op: list(
    op.attrs['axis'])[:1] == [0] and same_rows(ctx, op))
declare_row_wise('flatten', 'flatten2',
                 when=lambda ctx, op: op.attrs.get('axis', 1) >= 1)
declare_row_wise('reshape', 'reshape2', when=_reshape_rows)
declare_row_wise('expand', when=lambda ctx, op: list(
    op.attrs['expand_times'])[:1] == [1] and same_rows(ctx, op))
declare_row_wise('pad', when=lambda ctx, op: list(
    op.attrs['paddings'])[:2] == [0, 0] and same_rows(ctx, op))
declare_row_wise(
    'fill_constant_batch_size_like', 'uniform_random_batch_size_like',
    'gaussian_random_batch_size_like', when=lambda ctx, op: op.attrs.get(
        'input_dim_idx', 0) == 0 and op.attrs.get('output_dim_idx', 0) == 0)
declare_row_wise('sequence_mask', when=lambda ctx, op: op.attrs.get(
    'maxlen', -1) > 0 and same_rows(ctx, op))


def store_grad(ctx, gname, g, cotangents=()):
    """Write a gradient as the generic grad writes it: added to a value
    the name already holds (a contribution the rename pass did not split),
    unless the name is one of the op's own ``cotangents``."""
    if ctx.has(gname) and gname not in cotangents:
        g = _tree_add(ctx.lookup(gname), g)
    ctx.store(gname, g)


def dp_scaled_grad(fwd_type, out_slot):
    """The grad of a dp-aware mean-type reduction ``fwd_type``: the
    generic grad, whose replay reduces the local rows only, with the
    cotangent of ``out_slot`` scaled by the local denominator over the
    global one, which the forward left in ``ctx.dp_grad_scale``.  Without
    dp it is the generic grad.  No collective runs: the output is global
    and its cotangent the same on every rank."""
    generic = []

    def grad(ctx, op):
        if not generic:
            generic.append(_make_generic_grad(fwd_type))
        out = op.input(out_slot)[0]
        scale = ctx.dp_grad_scale.get(out)
        ct = out + GRAD_SUFFIX
        if scale is None or not ctx.has(ct):
            return generic[0](ctx, op)
        old = ctx.lookup(ct)
        ctx.store(ct, old * scale.to(old.dtype))
        try:
            generic[0](ctx, op)
        finally:
            if ctx.has(ct):
                ctx.store(ct, old)

    return grad


GRAD_SUFFIX = '@GRAD'
# attr keys on grad ops recording the forward op's slot structure
FWD_IN_SLOTS_ATTR = '__fwd_in_slots__'
FWD_OUT_SLOTS_ATTR = '__fwd_out_slots__'


def fwd_structure(grad_op):
    """Recover (fwd_inputs, fwd_outputs, fwd_attrs) slot->names maps from a
    grad OpDesc built by backward.append_backward."""
    in_slots = grad_op.attrs[FWD_IN_SLOTS_ATTR]
    out_slots = grad_op.attrs[FWD_OUT_SLOTS_ATTR]
    fwd_inputs = {s: grad_op.input(s) for s in in_slots}
    fwd_outputs = {s: grad_op.input(s) for s in out_slots}
    fwd_attrs = {
        k: v
        for k, v in grad_op.attrs.items()
        if k not in (FWD_IN_SLOTS_ATTR, FWD_OUT_SLOTS_ATTR)
    }
    return fwd_inputs, fwd_outputs, fwd_attrs


def _make_generic_grad(fwd_type):
    """Build a grad lowering from the forward lowering via torch.func.vjp.

    The grad OpDesc carries the forward op's inputs, outputs and attrs;
    declared grad outputs ``<slot>@GRAD`` name the inputs that need
    gradients.  A missing output gradient is a zero cotangent.  A gradient
    name that already holds a value (a contribution the rename pass did not
    split) is accumulated into, as in the JAX package.
    """
    fwd_lower = _LOWERINGS[fwd_type]

    def grad_lowering(ctx, op):
        from ..fluid.framework import Operator
        fwd_inputs, fwd_outputs, fwd_attrs = fwd_structure(op)

        # differentiable primal args: those with a declared <slot>@GRAD
        diff_specs = []  # (slot, idx, grad_out_name)
        for slot, in_names in fwd_inputs.items():
            for i, gname in enumerate(op.output(slot + GRAD_SUFFIX)):
                if gname and i < len(in_names):
                    diff_specs.append((slot, i, gname))
        if not diff_specs:
            return

        fwd_input_vals = {slot: [ctx.lookup(n) for n in names]
                          for slot, names in fwd_inputs.items()}
        # only floating primals: an integer or bool input (a loop counter,
        # an index) has no gradient
        diff_specs = [spec for spec in diff_specs
                      if _inexact(fwd_input_vals[spec[0]][spec[1]])]
        if not diff_specs:
            return
        # only outputs the forward produced, and only floating ones: integer
        # outputs (a bounded while's condition and counters) carry no
        # gradient
        out_names = [n for names in fwd_outputs.values() for n in names
                     if ctx.has(n) and _inexact(ctx.lookup(n))]
        faux = Operator(ctx.block, fwd_type,
                        inputs={s: list(n) for s, n in fwd_inputs.items()},
                        outputs={s: list(n) for s, n in fwd_outputs.items()},
                        attrs=fwd_attrs)
        # sequence-length side-band entries the lowering may consult
        seq_entries = {n + SEQLEN_SUFFIX: ctx.lookup(n + SEQLEN_SUFFIX)
                       for names in fwd_inputs.values() for n in names
                       if ctx.has(n + SEQLEN_SUFFIX)}
        # and the ragged-batch mask, so that a masked mean's gradient
        # leaves the padding rows out as its forward did
        if ctx.has(SAMPLE_MASK_NAME):
            seq_entries[SAMPLE_MASK_NAME] = ctx.lookup(SAMPLE_MASK_NAME)

        def primal(*diff_vals):
            env2 = dict(seq_entries)
            vals = {s: list(v) for s, v in fwd_input_vals.items()}
            for (slot, i, _), v in zip(diff_specs, diff_vals):
                vals[slot][i] = v
            for slot, names in fwd_inputs.items():
                for n, v in zip(names, vals[slot]):
                    env2[n] = v
            fwd_lower(ctx.sub_context(env2), faux)
            return tuple(env2[n] for n in out_names)

        diff_vals = [fwd_input_vals[s][i] for s, i, _ in diff_specs]
        primal_outs, vjp_fn = torch.func.vjp(primal, *diff_vals)
        cotangents = tuple(
            _match_cotangent(ctx.lookup(n + GRAD_SUFFIX), ref)
            if ctx.has(n + GRAD_SUFFIX) else _tree_zeros(ref)
            for n, ref in zip(out_names, primal_outs))
        grads = vjp_fn(cotangents)
        # when an op writes a var it also reads, the input-grad name is the
        # output-cotangent name: that value is this op's own cotangent and is
        # overwritten, not accumulated
        cotangent_names = {n + GRAD_SUFFIX for n in out_names}
        for (_, _, gname), g in zip(diff_specs, grads):
            if ctx.has(gname) and gname not in cotangent_names:
                g = _tree_add(ctx.lookup(gname), g)  # not split by renaming
            ctx.store(gname, g)

    return grad_lowering


def _inexact(value):
    """Whether a value carries a gradient: a floating tensor, or a tensor
    array (a list) of them."""
    if isinstance(value, (list, tuple)):
        return bool(value) and _inexact(value[0])
    return isinstance(value, torch.Tensor) and value.is_floating_point()


def _tree_zeros(ref):
    if isinstance(ref, (list, tuple)):
        return [_tree_zeros(r) for r in ref]
    return torch.zeros_like(ref)


def _match_cotangent(ct, ref):
    """A cotangent in its primal's structure and dtypes: a tensor array's
    gradient may be a list (indexed writes) or stacked, and its primal the
    other."""
    if isinstance(ref, (list, tuple)):
        if isinstance(ct, torch.Tensor):
            ct = list(ct.unbind(0))
        return [_match_cotangent(c, r) for c, r in zip(ct, ref)]
    if isinstance(ct, (list, tuple)):
        ct = torch.stack(list(ct))
    return ct.to(ref.dtype)


def _tree_add(a, b):
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return [_tree_add(x, y) for x, y in zip(a, b)]
    return a + b


# ---- mixed precision (bf16 compute / f32 master weights) ----
# As in the JAX package: under AMP the tensor-core operands (matmul and
# convolution inputs) go to bf16, their results land in bf16 (the tensor
# cores accumulate in f32), and parameters, optimizer state, normalization
# statistics and loss reductions stay f32.
_AMP = {'enabled': False}


def set_amp(enabled):
    _AMP['enabled'] = bool(enabled)


def amp_enabled():
    return _AMP['enabled']


def amp_cast_in(*xs):
    """Under AMP, f32 operands of a tensor-core op go to bf16; everything
    else is left as it is."""
    if not _AMP['enabled']:
        return xs
    return tuple(x.to(torch.bfloat16)
                 if x is not None and x.dtype == torch.float32 else x
                 for x in xs)


def amp_cast_out(out):
    """Under AMP a convolution's output lands in bf16: a result that came
    back f32 is cast down."""
    if _AMP['enabled'] and out.dtype == torch.float32:
        return out.to(torch.bfloat16)
    return out


def amp_upcast_f32(x):
    """Precision-sensitive math (softmax/norm statistics, loss exp/log)
    computes in f32 for bf16 inputs."""
    if x is not None and x.dtype == torch.bfloat16:
        return x.float()
    return x


def amp_harmonize(x, y):
    """Under AMP a bf16 activation and an f32 operand (a bias, a scale)
    compute in bf16, where promotion would widen the activation back to
    f32.  Without AMP, ordinary promotion applies."""
    if not _AMP['enabled']:
        return x, y
    if x.dtype == torch.bfloat16 and y.dtype == torch.float32:
        y = y.to(torch.bfloat16)
    elif y.dtype == torch.bfloat16 and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    return x, y


def amp_matmul(x, y):
    """The AMP matmul policy: bf16 operands and a bf16 result, accumulated
    in f32.  Operands of two dtypes outside AMP promote, as ``jnp.matmul``
    promotes them."""
    x, y = amp_cast_in(x, y)
    if x.dtype != y.dtype:
        common = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(common), y.to(common)
    return amp_cast_out(torch.matmul(x, y))
