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

import contextlib
import threading

import torch

__all__ = ['register_lowering', 'register_grad_lowering', 'get_lowering',
           'LoweringContext', 'run_op', 'recording', 'value_meta',
           'fwd_structure', 'SEQLEN_SUFFIX',
           'GRAD_SUFFIX', 'SAMPLE_MASK_NAME', 'declare_uncapturable',
           'capture_refusal', 'register_counter', 'counts', 'set_amp',
           'amp_enabled', 'amp_cast_in', 'amp_cast_out', 'amp_upcast_f32',
           'amp_harmonize', 'amp_matmul']

_LOWERINGS = {}
_GRAD_LOWERINGS = {}
_UNCAPTURABLE = {}  # op type -> (reason, predicate over the op or None)
_COUNTERS = []  # callables -> {name: count}

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

    def __init__(self, block, env, place, generator=None, is_test=False):
        self.block = block
        self.env = env
        self.place = place
        self._generator = generator
        self.is_test = is_test
        # ragged-batch provenance, as in the JAX package: env names derived
        # from batch-led feeds that still carry the batch on dim 0.  Seeded
        # by the executor when a @SAMPLE_MASK rides along, propagated by
        # run_op; the mean lowerings mask only these.
        self.batch_led = set()

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
        """A context over ``env`` that shares this one's block, place and
        mode but has no generator: a replayed forward must draw nothing."""
        return LoweringContext(self.block, env, self.place,
                               is_test=self.is_test)


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
    values, rows = getattr(value, 'values', None), getattr(value, 'rows',
                                                           None)
    if isinstance(values, torch.Tensor) and isinstance(rows, torch.Tensor):
        return tuple(values.shape), (values.numel() * values.element_size()
                                     + rows.numel() * rows.element_size())
    return None


def run_op(ctx, op):
    """Run one op's lowering, then propagate sequence-length metadata from
    its inputs to its outputs."""
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
    mask = ctx.env.get(SAMPLE_MASK_NAME)
    if mask is not None and not op.type.endswith('_grad'):
        # an output is batch-led iff an input was and it still carries the
        # batch on dim 0
        led = any(n in ctx.batch_led for n in op.input_arg_names)
        for n in op.output_arg_names:
            v = ctx.env.get(n)
            if led and getattr(v, 'ndim', 0) >= 1 and \
                    v.shape[0] == mask.shape[0]:
                ctx.batch_led.add(n)
            else:
                ctx.batch_led.discard(n)
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
        # only outputs the forward produced, and only floating ones: integer
        # outputs carry no gradient
        out_names = [n for names in fwd_outputs.values() for n in names
                     if ctx.has(n) and ctx.lookup(n).is_floating_point()]
        faux = Operator(ctx.block, fwd_type,
                        inputs={s: list(n) for s, n in fwd_inputs.items()},
                        outputs={s: list(n) for s, n in fwd_outputs.items()},
                        attrs=fwd_attrs)
        # sequence-length side-band entries the lowering may consult
        seq_entries = {n + SEQLEN_SUFFIX: ctx.lookup(n + SEQLEN_SUFFIX)
                       for names in fwd_inputs.values() for n in names
                       if ctx.has(n + SEQLEN_SUFFIX)}

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
            ctx.lookup(n + GRAD_SUFFIX).to(ref.dtype)
            if ctx.has(n + GRAD_SUFFIX) else torch.zeros_like(ref)
            for n, ref in zip(out_names, primal_outs))
        grads = vjp_fn(cotangents)
        # when an op writes a var it also reads, the input-grad name is the
        # output-cotangent name: that value is this op's own cotangent and is
        # overwritten, not accumulated
        cotangent_names = {n + GRAD_SUFFIX for n in out_names}
        for (_, _, gname), g in zip(diff_specs, grads):
            if ctx.has(gname) and gname not in cotangent_names:
                g = ctx.lookup(gname) + g  # rename pass didn't split it
            ctx.store(gname, g)

    return grad_lowering


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
