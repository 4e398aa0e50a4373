"""Op lowerings of the PyTorch port.

Importing this package registers every ported lowering (counterpart of
``paddle_tpu/ops``).
"""

from .registry import register_lowering, run_op, LoweringContext  # noqa: F401
from . import math_ops  # noqa: F401
from . import activation_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import loss_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import attention_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import metric_ops  # noqa: F401
