"""Program-to-program transpilers (counterpart of
``paddle_tpu/fluid/transpiler/``): ``InferenceTranspiler`` (batch norm
folded into the conv before it), ``Float16Transpiler`` (an inference
program run in bf16 or fp16), ``memory_optimize`` / ``release_memory`` (the
vars the executor may free after their last use), and
``DistributeTranspiler`` with its dispatchers ``HashName`` and
``RoundRobin`` (the trainer program for ``ParallelExecutor``)."""

from .distribute_transpiler import DistributeTranspiler, \
    DistributeTranspilerConfig
from .inference_transpiler import InferenceTranspiler
from .float16_transpiler import Float16Transpiler
from .memory_optimization_transpiler import memory_optimize, release_memory
from .ps_dispatcher import HashName, RoundRobin

__all__ = [
    'DistributeTranspiler', 'DistributeTranspilerConfig', 'memory_optimize',
    'release_memory', 'InferenceTranspiler', 'Float16Transpiler',
    'HashName', 'RoundRobin',
]
