"""Layer functions of the PyTorch port (the subset of
``paddle_tpu.fluid.layers`` that the Transformer, stacked-LSTM, dense CV and
seq2seq NMT slices build with)."""

from . import nn
from .nn import *
from . import io
from .io import *
from . import tensor
from .tensor import *
from . import ops
from .ops import *
from . import sequence
from .sequence import *
from . import metric_op
from .metric_op import *
from . import control_flow
from .control_flow import *

__all__ = (nn.__all__ + io.__all__ + tensor.__all__ + ops.__all__ +
           sequence.__all__ + metric_op.__all__ + control_flow.__all__)
