"""paddle_tpu_torch.fluid — the Fluid-compatible frontend on PyTorch.

The same program-building API as ``paddle_tpu.fluid``, training included
(``append_backward``; ``optimizer.SGD``, ``Momentum`` and ``Adam``),
the image blocks of ``nets``, LoD feeds (``create_lod_tensor``)
flags (``FLAGS``, bootstrapped from ``FLAGS_<name>`` environment
variables), mixed precision (``amp_guard``, ``enable_amp``) and the
inference path (``io.save_inference_model`` / ``load_inference_model``,
``InferenceTranspiler``, ``Float16Transpiler``), ``memory_optimize``,
the ``profiler`` and ``trace`` (spans, flight recorder, cost registry);
``Executor.run``
interprets the program op by op on a torch device, by default the CUDA
card (``CUDAPlace(0)``).
"""

from . import flags
from .flags import FLAGS
# environment bootstrap first, so flags govern everything imported below
flags.try_from_env(flags.TRYFROMENV)
from . import core
from .core import CPUPlace, CUDAPlace, LoDTensor, Scope
from . import framework
from .framework import (Program, Operator, Variable, Parameter,
                        default_main_program, default_startup_program,
                        program_guard)
from . import trace
from . import profiler
from . import executor
from .executor import Executor, global_scope, scope_guard
from . import initializer
from . import layers
from .param_attr import ParamAttr
from . import unique_name
from . import io
from .io import params_from_numpy, persistables_from_numpy
from . import backward
from .backward import append_backward
from . import clip
from . import regularizer
from . import optimizer
from . import nets
from . import lod_tensor
from .lod_tensor import create_lod_tensor, create_random_int_lodtensor
from . import amp
from .amp import amp_guard, enable_amp
from . import transpiler
from .transpiler import (InferenceTranspiler, Float16Transpiler,
                         memory_optimize, release_memory)

__all__ = framework.__all__ + executor.__all__ + [
    'io', 'initializer', 'layers', 'LoDTensor', 'CPUPlace', 'CUDAPlace',
    'Scope', 'ParamAttr', 'unique_name', 'params_from_numpy',
    'persistables_from_numpy', 'backward', 'append_backward', 'clip',
    'regularizer', 'optimizer', 'nets', 'flags', 'FLAGS', 'lod_tensor',
    'create_lod_tensor', 'create_random_int_lodtensor', 'amp', 'amp_guard',
    'enable_amp', 'transpiler', 'InferenceTranspiler', 'Float16Transpiler',
    'memory_optimize', 'release_memory', 'profiler', 'trace',
]
