"""Estimate a program's feed-forward memory footprint (reference:
python/paddle/fluid/contrib/memory_usage_calc.py memory_usage).

Counterpart of ``paddle_tpu/fluid/contrib/memory_usage_calc.py``.  The
reference sums var numel x dtype width over the program with the batch
dim substituted; the executor's release plan frees dead vars, so this is
the upper bound the reference also reported.  The width lookup keys on
``str(var.dtype)``, the VarType enum's number, so every var counts at the
4-byte default, exactly as in the JAX package: the serving arbiter's
admission seeds stay equal across the two packages.
"""

__all__ = ['memory_usage']

_DTYPE_BYTES = {
    'float16': 2, 'bfloat16': 2, 'float32': 4, 'float64': 8,
    'int8': 1, 'uint8': 1, 'int16': 2, 'int32': 4, 'int64': 8, 'bool': 1,
}


def memory_usage(program, batch_size):
    """Rough bytes used by one forward pass at ``batch_size``.

    Returns (min_estimate, max_estimate, unit_str) like the reference
    (its two bounds bracketed allocator slack).
    """
    from ..framework import Program
    if not isinstance(program, Program):
        raise TypeError('memory_usage expects a Program')
    if batch_size <= 0:
        raise ValueError('batch_size must be positive')
    total = 0.0
    for var in program.list_vars():
        shape = getattr(var, 'shape', None)
        if not shape:
            continue
        numel = 1
        for d in shape:
            numel *= batch_size if (d is None or int(d) < 0) else int(d)
        dtype = str(getattr(var, 'dtype', 'float32'))
        total += numel * _DTYPE_BYTES.get(dtype.split('.')[-1], 4)
    low, high = total * 0.9, total * 1.1
    for unit in ('B', 'KB', 'MB', 'GB'):
        if high < 1024 or unit == 'GB':
            return round(low, 2), round(high, 2), unit
        low /= 1024.0
        high /= 1024.0
