"""Sharding annotations on program variables (counterpart of
``paddle_tpu/parallel/api.py``).

A Variable annotated with a ``PartitionSpec`` names the mesh axis each of
its dims is split over.  The port's ``ParallelExecutor`` splits every feed
on dim 0 over 'dp' and replicates the parameters; an annotation that names
another axis raises there (ROADMAP.md, Queue 1 item 7).
"""

__all__ = ['shard', 'sharding_of', 'scanned_spec', 'PartitionSpec']

_ATTR = '_sharding_spec'


class PartitionSpec(tuple):
    """The mesh axis (or None) of each dim, as ``jax.sharding.PartitionSpec``
    holds it: ``PartitionSpec('dp', None)`` splits dim 0 over 'dp'."""

    def __new__(cls, *axes):
        return super(PartitionSpec, cls).__new__(cls, axes)

    def __repr__(self):
        return 'PartitionSpec%s' % (tuple.__repr__(self), )


def shard(var, *spec):
    """Annotate a program Variable (or Parameter) with a PartitionSpec.

    Example: shard(w, None, 'tp') names w's dim 1 for a 'tp' mesh axis.
    """
    if len(spec) == 1 and isinstance(spec[0], PartitionSpec):
        setattr(var, _ATTR, spec[0])
    else:
        setattr(var, _ATTR, PartitionSpec(*spec))
    return var


def sharding_of(var, default=None):
    return getattr(var, _ATTR, default)


def scanned_spec(spec):
    """The PartitionSpec of a K-steps-stacked value: the per-step spec
    shifted right of an unsplit leading steps axis (run_multi's stacked
    feeds: [K, B, ...] with B over 'dp', K over nothing)."""
    return PartitionSpec(*((None, ) + tuple(spec)))
