"""Control-flow op lowerings (counterpart of
``paddle_tpu/ops/control_flow_ops.py``): ``recurrent``, the op that
``StaticRNN`` and ``DynamicRNN`` build.

The JAX package lowers the step sub-block once into a ``lax.scan``; here the
op is a Python loop over T that runs the sub-block's ops through
``registry.run_op`` at every step, in a context whose block is the
sub-block.  The loop is a plain function of tensors (no in-place write to
the carry or to a closure tensor, no ``.item()``), so ``recurrent_grad`` is
the registry's generic ``torch.func.vjp`` of this lowering: it replays the
whole loop and keeps every step's intermediates for the backward pass,
where the JAX package rematerializes them (``jax.checkpoint``).
"""

import torch

from .registry import (register_lowering, LoweringContext, run_op,
                       SEQLEN_SUFFIX)


def _block_reads(block):
    """Every name the block's ops read, in first-read order."""
    reads = []
    for op in block.ops:
        for n in op.input_arg_names:
            if n not in reads:
                reads.append(n)
    return reads


def _run_block(ctx, block, env):
    """Run ``block``'s ops over ``env``; a step draws no randomness."""
    sub = LoweringContext(block, env, ctx.place, is_test=ctx.is_test)
    for op in block.ops:
        run_op(sub, op)


def _rows(mask, ndim):
    """A [B] step mask shaped to broadcast over a [B, ...] value."""
    return torch.reshape(mask, (mask.shape[0], ) + (1, ) * (ndim - 1))


@register_lowering('recurrent')
def _recurrent(ctx, op):
    """StaticRNN / DynamicRNN: one loop over the time axis.

    Sequence inputs arrive padded [B, T, ...] ([T, B, ...] with
    ``time_major``); memories carry across steps; with ``masked`` a row's
    memories advance only while t < its length and its outputs past the
    length are zero (where the reference shrinks the batch)."""
    block = op.attrs['sub_block']
    seq_names = op.input('SeqInputs')
    step_names = op.attrs['step_input_names']
    mem_names = op.attrs['mem_names']
    mem_update_names = op.attrs['mem_update_names']
    mem_init_names = op.input('MemInits')
    out_names = op.attrs['output_names']
    masked = op.attrs.get('masked', False)
    time_major = op.attrs.get('time_major', False)

    seqs = [ctx.lookup(n) for n in seq_names]
    if time_major:
        t, b = seqs[0].shape[0], seqs[0].shape[1]
        xs = list(seqs)
    else:
        t, b = seqs[0].shape[1], seqs[0].shape[0]
        xs = [torch.transpose(s, 0, 1) for s in seqs]  # [T, B, ...]

    lengths = None
    if masked:
        for n in seq_names:
            if (n + SEQLEN_SUFFIX) in ctx.env:
                lengths = ctx.env[n + SEQLEN_SUFFIX]
                break
    device = seqs[0].device
    if lengths is not None:
        step_mask = (torch.arange(t, device=device)[None, :] <
                     lengths[:, None]).t()  # [T, B] bool
    else:
        step_mask = torch.ones((t, b), dtype=torch.bool, device=device)

    # closure: what the step reads from outside, with the lengths of the
    # sequences among it (the attention's sequence ops need them); the
    # step's own slices and memories carry no lengths
    closure = {}
    for n in _block_reads(block):
        if n in step_names or n in mem_names:
            continue
        if ctx.has(n):
            closure[n] = ctx.lookup(n)
        key = n + SEQLEN_SUFFIX
        if key in ctx.env:
            closure[key] = ctx.env[key]

    carry = {m: ctx.lookup(init)
             for m, init in zip(mem_names, mem_init_names)}
    collected = [[] for _ in out_names]
    for i in range(t):
        env = dict(closure)
        env.update({sn: x[i] for sn, x in zip(step_names, xs)})
        env.update(carry)
        _run_block(ctx, block, env)
        m_t = step_mask[i]
        new_carry = {}
        for m, upd in zip(mem_names, mem_update_names):
            new_val = env[upd] if upd is not None else env[m]
            old_val = carry[m]
            # the carry keeps its own dtype (in-step math may promote); the
            # boolean select keeps integer memories (beam ids) exact
            new_carry[m] = torch.where(_rows(m_t, new_val.dim()),
                                       new_val.to(old_val.dtype), old_val)
        carry = new_carry
        for j, on in enumerate(out_names):
            o = env[on]
            collected[j].append(torch.where(_rows(m_t, o.dim()), o,
                                            torch.zeros_like(o)))
    for out_var_name, col in zip(op.output('Out'), collected):
        out = torch.stack(col)
        ctx.store(out_var_name, out if time_major else
                  torch.transpose(out, 0, 1))
        if lengths is not None:
            ctx.env[out_var_name + SEQLEN_SUFFIX] = lengths
