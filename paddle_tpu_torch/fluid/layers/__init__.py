"""Layer functions of the PyTorch port (the subset of
``paddle_tpu.fluid.layers`` that the port's slices build with).  Importing
the package applies ``math_op_patch``'s operator overloads to
``Variable``, as the JAX package does."""

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
from . import learning_rate_scheduler
from .learning_rate_scheduler import *
from . import detection
from .detection import *
from . import math_op_patch  # noqa: F401  (Variable's operator overloads)

__all__ = (nn.__all__ + io.__all__ + tensor.__all__ + ops.__all__ +
           sequence.__all__ + metric_op.__all__ + control_flow.__all__ +
           learning_rate_scheduler.__all__ + detection.__all__)
