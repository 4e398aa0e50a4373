"""Program-to-program transpilers (counterpart of
``paddle_tpu/fluid/transpiler/``): ``InferenceTranspiler`` (batch norm
folded into the conv before it) and ``Float16Transpiler`` (an inference
program run in bf16 or fp16) and ``memory_optimize`` /
``release_memory`` (the vars the executor may free after their last use).
The distribute transpiler and its dispatchers are not ported yet."""

from .inference_transpiler import InferenceTranspiler
from .float16_transpiler import Float16Transpiler
from .memory_optimization_transpiler import memory_optimize, release_memory

__all__ = ['InferenceTranspiler', 'Float16Transpiler', 'memory_optimize',
           'release_memory']
