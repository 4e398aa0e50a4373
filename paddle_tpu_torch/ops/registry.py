"""Op lowering registry: OpDesc -> PyTorch.

Counterpart of ``paddle_tpu/ops/registry.py``.  Every op type registers a
*lowering*: a function that reads its input tensors from the context's
environment and writes its outputs.  The JAX package traces a whole block
into one XLA computation; here the executor calls the lowerings one op at a
time, eagerly, on the place's device.

The ``@SEQLEN`` side-band (per-row valid lengths riding beside a padded
tensor) propagates from inputs to outputs exactly as in the JAX package.
The AMP helpers are identities until mixed precision is ported.
"""

import torch

__all__ = ['register_lowering', 'get_lowering', 'LoweringContext', 'run_op',
           'SEQLEN_SUFFIX']

_LOWERINGS = {}

SEQLEN_SUFFIX = '@SEQLEN'
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


def get_lowering(op_type):
    fn = _LOWERINGS.get(op_type)
    if fn is None:
        raise NotImplementedError(
            'no PyTorch lowering registered for op %r (not ported yet)' %
            op_type)
    return fn


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

    def var_desc(self, name):
        return self.block._find_var_recursive(name)


def run_op(ctx, op):
    """Run one op's lowering, then propagate sequence-length metadata from
    its inputs to its outputs."""
    get_lowering(op.type)(ctx, op)
    if op.type in _SEQ_CONSUMERS:
        return
    meta = None
    for n in op.input_arg_names:
        meta = ctx.env.get(n + SEQLEN_SUFFIX)
        if meta is not None:
            break
    if meta is not None:
        for n in op.output_arg_names:
            ctx.env.setdefault(n + SEQLEN_SUFFIX, meta)


# ---- mixed precision: identities until AMP is ported ----
def amp_cast_in(*xs):
    return xs


def amp_matmul(x, y):
    return torch.matmul(x, y)


def amp_upcast_f32(x):
    """Precision-sensitive math (softmax/norm statistics, loss exp/log)
    computes in f32 for bf16 inputs."""
    if x is not None and x.dtype == torch.bfloat16:
        return x.float()
    return x
