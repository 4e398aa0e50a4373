"""Host ops of the PyTorch port (counterpart of ``paddle_tpu/ops/host_ops.py``):
``chunk_eval``, the port's own copy of the JAX package's chunk extraction,
and ``print`` (``fluid.layers.Print``).

A host op works on numpy: the executor's eager walk copies the op's inputs
(and their ``@SEQLEN`` side-bands) to the host, calls the function, and
puts what it wrote back on the block's device.  A block that holds one is
refused capture (``registry.register_host_op``) and runs op by op.  The
JAX package's ``save``, ``load``, ``save_combine``, ``load_combine`` and
its distributed host ops are not ported yet; its detection host ops are
in ``detection_ops``.
"""

import numpy as np

from .registry import register_host_op, SEQLEN_SUFFIX


@register_host_op('print')
def _print(ctx, op, scope):
    """Print the input's value (its first ``first_n`` runs, all with -1)
    and pass it through to Out."""
    x = ctx.get(op, 'In')
    if x is None:
        x = ctx.get(op, 'X')
    first_n = op.attrs.get('first_n', -1)
    count = op.attrs.setdefault('__print_count__', 0)
    if first_n < 0 or count < first_n:
        arr = np.asarray(x)
        print('%s %s  shape=%s\n%s' % (op.attrs.get('message', ''),
                                        op.input('In') or op.input('X'),
                                        arr.shape, arr))
        op.attrs['__print_count__'] = count + 1
    out_names = op.output('Out')
    if out_names and x is not None:
        ctx.store(out_names[0], x)


# ---- chunk evaluation (reference operators/chunk_eval_op.cc — CPU-only
# kernel there too; chunk parsing is inherently sequential host work) ----
_CHUNK_SCHEMES = {
    # scheme -> (num_tag_types, begin_tag_ids, inside_tag_ids, single_ids)
    'iob': 2, 'ioe': 2, 'iobes': 4, 'plain': 1,
}


def _extract_chunks(seq, scheme, num_chunk_types):
    """Return set of (begin, end, chunk_type) segments from a tag sequence.
    Tag layout matches the reference: tag = chunk_type * num_tag_types +
    tag_type; the 'other' (outside) tag is any id >= num_chunk_types *
    num_tag_types."""
    ntt = _CHUNK_SCHEMES[scheme]
    other = num_chunk_types * ntt
    chunks = []
    start, ctype = None, None

    def flush(end):
        if start is not None:
            chunks.append((start, end, ctype))

    for i, tag in enumerate(seq):
        tag = int(tag)
        if tag >= other or tag < 0:
            flush(i)
            start, ctype = None, None
            continue
        t_type, t_tag = tag // ntt, tag % ntt
        if scheme == 'plain':
            begins, ends = True, True
        elif scheme == 'iob':
            begins = (t_tag == 0) or (ctype != t_type)
            ends = False
        elif scheme == 'ioe':
            begins = (ctype != t_type)
            ends = (t_tag == 1)
        else:  # iobes: B=0 I=1 E=2 S=3
            begins = t_tag in (0, 3) or (ctype != t_type)
            ends = t_tag in (2, 3)
        if begins:
            flush(i)
            start, ctype = i, t_type
        if ends:
            flush(i + 1)
            start, ctype = None, None
    flush(len(seq))
    return set(chunks)


@register_host_op('chunk_eval')
def _chunk_eval(ctx, op, scope):
    inference = np.asarray(ctx.get(op, 'Inference'))
    label = np.asarray(ctx.get(op, 'Label'))
    if inference.ndim == 3:
        inference = inference[..., 0]
    if label.ndim == 3:
        label = label[..., 0]
    lengths = ctx.env.get(op.input('Inference')[0] + SEQLEN_SUFFIX)
    if lengths is None:
        lengths = ctx.env.get(op.input('Label')[0] + SEQLEN_SUFFIX)
    b, t = inference.shape
    lengths = (np.full((b, ), t, np.int64) if lengths is None
               else np.asarray(lengths))
    scheme = op.attrs['chunk_scheme'].lower()
    num_chunk_types = int(op.attrs['num_chunk_types'])
    excluded = set(op.attrs.get('excluded_chunk_types') or [])
    n_infer = n_label = n_correct = 0
    for i in range(b):
        l = int(lengths[i])
        inf_chunks = {c for c in _extract_chunks(
            inference[i, :l], scheme, num_chunk_types)
            if c[2] not in excluded}
        lab_chunks = {c for c in _extract_chunks(
            label[i, :l], scheme, num_chunk_types)
            if c[2] not in excluded}
        n_infer += len(inf_chunks)
        n_label += len(lab_chunks)
        n_correct += len(inf_chunks & lab_chunks)
    precision = n_correct / n_infer if n_infer else 0.0
    recall = n_correct / n_label if n_label else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if n_correct else 0.0)
    ctx.set(op, 'Precision', np.array([precision], np.float32))
    ctx.set(op, 'Recall', np.array([recall], np.float32))
    ctx.set(op, 'F1-Score', np.array([f1], np.float32))
    ctx.set(op, 'NumInferChunks', np.array([n_infer], np.int64))
    ctx.set(op, 'NumLabelChunks', np.array([n_label], np.int64))
    ctx.set(op, 'NumCorrectChunks', np.array([n_correct], np.int64))
