"""Parameter-block -> endpoint placement policies (counterpart of
``paddle_tpu/fluid/transpiler/ps_dispatcher.py``; reference:
python/paddle/fluid/transpiler/ps_dispatcher.py:46,70).

The dense pserver path is replaced by data parallelism on
``torch.distributed``; the dispatchers stay as the placement policy for
sharded state, and launchers that drove the reference through these
classes keep working.
"""

__all__ = ['PSDispatcher', 'HashName', 'RoundRobin']


class PSDispatcher(object):
    """Base: holds the endpoint list and a reset/dispatch contract."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError('use HashName or RoundRobin')


def _name_of(var):
    # reference dispatch() receives VarBlock-ish objects exposing name();
    # accept plain strings and Variables too
    name = getattr(var, 'name', var)
    return name() if callable(name) else str(name)


class HashName(PSDispatcher):
    """Stable-hash var names onto endpoints (reference ps_dispatcher.py:46).
    Uses a deterministic FNV-1a instead of Python's salted hash() so the
    placement is reproducible across processes — the property the
    reference relied on PYTHONHASHSEED for."""

    def __init__(self, pserver_endpoints):
        super(HashName, self).__init__(pserver_endpoints)

    def _hash_block(self, block_str, total):
        h = 0xcbf29ce484222325
        for ch in block_str.encode('utf-8'):
            h = ((h ^ ch) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
        return h % total

    def dispatch(self, varlist):
        return [
            self._eps[self._hash_block(_name_of(v), len(self._eps))]
            for v in varlist
        ]


class RoundRobin(PSDispatcher):
    """Cycle endpoints in order (reference ps_dispatcher.py:70)."""

    def __init__(self, pserver_endpoints):
        super(RoundRobin, self).__init__(pserver_endpoints)

    def dispatch(self, varlist):
        out = []
        for _ in varlist:
            out.append(self._eps[self._step % len(self._eps)])
            self._step += 1
        return out
