"""paddle_tpu_torch.fluid — the Fluid-compatible frontend on PyTorch.

The same program-building API as ``paddle_tpu.fluid``, training included
(``append_backward``; ``optimizer.SGD``, ``Momentum`` and ``Adam``),
the image blocks of ``nets``, LoD feeds (``create_lod_tensor``)
flags (``FLAGS``, bootstrapped from ``FLAGS_<name>`` environment
variables), mixed precision (``amp_guard``, ``enable_amp``) and the
inference path (``io.save_inference_model`` / ``load_inference_model``,
``InferenceTranspiler``, ``Float16Transpiler``), ``memory_optimize``,
the ``profiler`` and ``trace`` (spans, flight recorder, cost registry),
``DataFeeder``, the graph-state ``evaluator``s and the numpy ``metrics``,
the common tensor, shape, reduce, loss and metric layers and ``nets``'
``glu``, ``sequence_conv_pool`` and ``scaled_dot_product_attention``,
``Inferencer`` (through the serving engine) and ``contrib.memory_usage``;
the input pipeline (``layers.py_reader`` and the reader layers,
``recordio_writer``, ``FeedPipeline``) and ``Trainer`` with its events and
``CheckpointConfig``; data parallelism on ``torch.distributed``
(``ParallelExecutor``, ``ExecutionStrategy``, ``BuildStrategy``,
``DistributeTranspiler``);
``Executor.run``
interprets the program op by op on a torch device, by default the CUDA
card (``CUDAPlace(0)``).
"""

from . import flags
from .flags import FLAGS
# environment bootstrap first, so flags govern everything imported below
flags.try_from_env(flags.TRYFROMENV)
from . import core
from .core import (CPUPlace, CUDAPlace, CUDAPinnedPlace, LoDTensor,
                   LoDTensorArray, Scope, EOFException, is_compiled_with_cuda,
                   is_compiled_with_tpu)
from . import framework
from .framework import (Program, Operator, Variable, Parameter,
                        default_main_program, default_startup_program,
                        program_guard, name_scope, get_var)
from . import trace
from . import profiler
from . import executor
from .executor import Executor, global_scope, scope_guard, fetch_var
from . import parallel_executor
from .parallel_executor import ParallelExecutor, ExecutionStrategy, \
    BuildStrategy
from . import initializer
from . import layers
from .param_attr import ParamAttr, WeightNormParamAttr
from . import unique_name
from . import io
from .io import (params_from_numpy, persistables_from_numpy, save_vars,
                 save_params, save_persistables, load_vars, load_params,
                 load_persistables, save_inference_model,
                 load_inference_model, get_inference_program)
from . import backward
from .backward import append_backward, calc_gradient, gradients
from . import clip
from .clip import (ErrorClipByValue, GradientClipByValue, GradientClipByNorm,
                   GradientClipByGlobalNorm)
from . import regularizer
from . import optimizer
from . import nets
from . import lod_tensor
from .lod_tensor import create_lod_tensor, create_random_int_lodtensor
from . import amp
from .amp import amp_guard, enable_amp
from . import transpiler
from . import data_feeder
from .data_feeder import DataFeeder
from . import evaluator
from . import metrics
from .transpiler import (InferenceTranspiler, Float16Transpiler,
                         memory_optimize, release_memory,
                         DistributeTranspiler, DistributeTranspilerConfig)
from . import contrib
from . import inferencer
from .inferencer import Inferencer
from . import dataflow
from .dataflow import FeedPipeline
from . import recordio_writer
from . import trainer
from .trainer import (Trainer, BeginEpochEvent, EndEpochEvent,
                      BeginStepEvent, EndStepEvent, CheckpointConfig)

__all__ = framework.__all__ + executor.__all__ + [
    'io', 'initializer', 'layers', 'LoDTensor', 'CPUPlace', 'CUDAPlace',
    'Scope', 'ParamAttr', 'unique_name', 'params_from_numpy',
    'persistables_from_numpy', 'backward', 'append_backward', 'clip',
    'regularizer', 'optimizer', 'nets', 'flags', 'FLAGS', 'lod_tensor',
    'create_lod_tensor', 'create_random_int_lodtensor', 'amp', 'amp_guard',
    'enable_amp', 'transpiler', 'InferenceTranspiler', 'Float16Transpiler',
    'memory_optimize', 'release_memory', 'profiler', 'trace',
    'data_feeder', 'DataFeeder', 'evaluator', 'metrics', 'contrib',
    'inferencer', 'Inferencer', 'CUDAPinnedPlace', 'EOFException',
    'dataflow', 'FeedPipeline', 'recordio_writer', 'trainer', 'Trainer',
    'BeginEpochEvent', 'EndEpochEvent', 'BeginStepEvent', 'EndStepEvent',
    'CheckpointConfig', 'Tensor', 'WeightNormParamAttr',
    'parallel_executor', 'ParallelExecutor', 'ExecutionStrategy',
    'BuildStrategy', 'DistributeTranspiler', 'DistributeTranspilerConfig',
]

Tensor = LoDTensor
