"""Op lowerings of the PyTorch port.

Importing this package registers every ported lowering (counterpart of
``paddle_tpu/ops``), then wraps the optimizer lowerings to take a sparse
(``SparseRows``) gradient.
"""

from .registry import register_lowering, run_op, LoweringContext  # noqa: F401
from . import math_ops  # noqa: F401
from . import activation_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import misc_ops  # noqa: F401
from . import loss_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import attention_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import metric_ops  # noqa: F401
from . import control_flow_ops  # noqa: F401
from . import beam_search_ops  # noqa: F401
from . import crf_ops  # noqa: F401
from . import host_ops  # noqa: F401
from . import sparse  # noqa: F401

# the optimizers that take a SparseRows gradient, as the reference has a
# SelectedRows kernel for each
for _opt in ('sgd', 'momentum', 'adam', 'adamax', 'adagrad',
             'decayed_adagrad', 'rmsprop', 'adadelta', 'ftrl'):
    sparse.sparsify_optimizer(_opt)
del _opt
