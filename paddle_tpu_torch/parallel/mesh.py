"""Device meshes over ``torch.distributed`` (counterpart of
``paddle_tpu/parallel/mesh.py``).  One process runs each rank; a mesh names
the ranks' axes.  The port runs data parallelism only: a mesh axis other
than 'dp' raises (ROADMAP.md, Queue 1 item 7)."""

import numpy as np

__all__ = ['make_mesh', 'mesh_axes', 'DeviceMesh']


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(axes=None, devices=None):
    """A ``torch.distributed.device_mesh.DeviceMesh`` over every rank, or
    for world size 1 without a process group a one-rank mesh that needs
    none.

    axes: dict axis_name -> size (an axis of -1 is inferred); only 'dp'.
    Default: {'dp': world_size}.  ``devices`` is the device type ('cuda' or
    'cpu', by default 'cuda' where a card is available)."""
    import torch
    world = _world()
    if axes is None:
        axes = {'dp': world}
    names, sizes = list(axes), list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    other = [n for n in names if n != 'dp']
    if other:
        raise NotImplementedError(
            'mesh axes %s: the PyTorch port runs data parallelism only; '
            'tensor, sequence, pipeline and expert parallelism come with '
            'ROADMAP.md, Queue 1 item 7' % other)
    if int(np.prod(sizes)) != world:
        raise ValueError('mesh axes %s do not cover %d ranks' %
                         (dict(zip(names, sizes)), world))
    if devices is None:
        devices = 'cuda' if torch.cuda.is_available() else 'cpu'
    if world == 1:
        return _OneRank(devices)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(devices, tuple(sizes), mesh_dim_names=tuple(names))


def mesh_axes(mesh):
    """{axis name: extent} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


class _OneRank(object):
    """The mesh of one rank without a process group: the
    ``mesh_dim_names``, ``mesh`` and ``device_type`` that the executor reads
    from a ``torch.distributed`` mesh."""

    def __init__(self, device_type):
        import torch
        self.mesh_dim_names = ('dp', )
        self.mesh = torch.zeros((1, ), dtype=torch.int64)
        self.device_type = device_type


class DeviceMesh(object):
    """Thin named wrapper kept for API symmetry with places."""

    def __init__(self, axes=None, devices=None):
        self.mesh = make_mesh(axes, devices)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
