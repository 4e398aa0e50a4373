"""The ragged-batch helper of ``paddle_tpu/fluid/parallel_executor.py``.

``pad_ragged_batch`` pads a lot's batch feeds up to a target row count
with a ``registry.SAMPLE_MASK_NAME`` feed (the serving engine's bucket
padding), on the executor's ``_pad_rows``.  ``ParallelExecutor`` itself
(data-parallel execution on ``torch.distributed``) is not ported yet:
ROADMAP.md, Queue 1 item 7.
"""

from . import core
from .executor import _as_tensor, _pad_rows

__all__ = ['pad_ragged_batch']


def pad_ragged_batch(feed_arrays, target, batch_names):
    """Pad the lot's batch feeds ``batch_names`` up to ``target`` rows by
    repeating the last real row, and add the sample mask (1.0 a real row,
    0.0 padding), so the mean lowerings count the real rows only.  The
    mask is added even when nothing pads, so a full lot and a padded lot
    share one signature.  Returns (feed, real rows, target).  The JAX
    package's ``multiple`` rounding and mesh options (``skip``,
    ``sizes_only``, ``report``) come with ``ParallelExecutor``."""
    fa = {n: (v.tensor() if isinstance(v, core.LoDTensor) else
              _as_tensor(v)) for n, v in feed_arrays.items()}
    out, real = _pad_rows(fa, batch_names, int(target))
    return out, real, int(target)
