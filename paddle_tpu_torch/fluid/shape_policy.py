"""The trailing-dim (sequence length) ladder a LoD feed is padded to.

Counterpart of ``paddle_tpu/fluid/shape_policy.py`` (``SEQ_BUCKET`` and
``bucketed_len``, the same ladder): ``executor._lod_to_padded`` pads a LoD
feed to T = ``bucketed_len(longest row)``.  Multiples of ``SEQ_BUCKET`` up to
16 * SEQ_BUCKET (256 at the default 16), then x1.25 steps rounded up to a
multiple of it.
"""

__all__ = ['SEQ_BUCKET', 'bucketed_len']

SEQ_BUCKET = 16


def bucketed_len(max_len, bucket=SEQ_BUCKET):
    """Padded T for a batch whose longest row is ``max_len``."""
    max_len = int(max_len)
    linear_top = 16 * bucket
    if max_len <= linear_top:
        return max(((max_len + bucket - 1) // bucket) * bucket, bucket)
    t = linear_top
    while t < max_len:
        t = ((t + (t >> 2)) + bucket - 1) // bucket * bucket
    return t
