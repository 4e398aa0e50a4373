"""Layer functions of the PyTorch port (the Transformer slice's subset of
``paddle_tpu.fluid.layers``)."""

from . import nn
from .nn import *
from . import io
from .io import *
from . import tensor
from .tensor import *
from . import ops
from .ops import *

__all__ = nn.__all__ + io.__all__ + tensor.__all__ + ops.__all__
