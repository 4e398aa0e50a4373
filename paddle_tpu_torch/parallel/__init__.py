"""Parallelism of the PyTorch port over ``torch.distributed`` (counterpart of
``paddle_tpu/parallel``).

One process runs each rank.  Data parallelism ('dp') is ported:
``make_mesh``, ``shard``, ``init_distributed_env`` and
``fluid.ParallelExecutor``.  The names of the other axes' modules are kept
and raise until their slice lands: ring and Ulysses attention ('sp'), the
pipeline ('pp') and mixture-of-experts ('ep') helpers (ROADMAP.md, Queue 1
item 7).
"""

from .mesh import make_mesh, mesh_axes, DeviceMesh
from .api import shard, sharding_of, scanned_spec, PartitionSpec
from .context_parallel import dense_attention
from .multihost import init_distributed_env, parse_distributed_env

__all__ = [
    'make_mesh', 'mesh_axes', 'DeviceMesh', 'shard', 'sharding_of',
    'scanned_spec', 'PartitionSpec', 'ring_attention', 'ulysses_attention',
    'dense_attention', 'init_distributed_env', 'parse_distributed_env',
    'pipeline_spmd', 'pipeline_apply', 'stack_stage_params',
    'moe_ffn', 'moe_ffn_spmd', 'init_moe_params',
]


def _not_ported(name, axis):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            'parallel.%s (the %r mesh axis) is not ported to PyTorch yet: '
            'the port runs data parallelism only (ROADMAP.md, Queue 1 item '
            '7)' % (name, axis))
    fn.__name__ = name
    return fn


ring_attention = _not_ported('ring_attention', 'sp')
ulysses_attention = _not_ported('ulysses_attention', 'sp')
pipeline_spmd = _not_ported('pipeline_spmd', 'pp')
pipeline_apply = _not_ported('pipeline_apply', 'pp')
stack_stage_params = _not_ported('stack_stage_params', 'pp')
moe_ffn = _not_ported('moe_ffn', 'ep')
moe_ffn_spmd = _not_ported('moe_ffn_spmd', 'ep')
init_moe_params = _not_ported('init_moe_params', 'ep')
