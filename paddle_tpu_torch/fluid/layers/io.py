"""Input layers (counterpart of ``paddle_tpu/fluid/layers/io.py``: ``data``
only; the reader pipeline comes with a later slice of the port)."""

from .. import core
from ..layer_helper import LayerHelper

__all__ = ['data']


def data(name,
         shape,
         append_batch_size=True,
         dtype='float32',
         lod_level=0,
         type=core.VarDesc.VarType.LOD_TENSOR,
         stop_gradient=True):
    """Declare a feed variable.  With ``append_batch_size`` the leading dim
    becomes -1 (batch)."""
    helper = LayerHelper('data', name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name,
        shape=shape,
        dtype=dtype,
        type=type,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
        is_data=True,
        persistable=False)
