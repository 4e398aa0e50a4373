"""Program-to-program transpilers (counterpart of
``paddle_tpu/fluid/transpiler/``): ``InferenceTranspiler`` (batch norm
folded into the conv before it) and ``Float16Transpiler`` (an inference
program run in bf16 or fp16).  ``memory_optimize``, the distribute
transpiler and its dispatchers are not ported yet."""

from .inference_transpiler import InferenceTranspiler
from .float16_transpiler import Float16Transpiler

__all__ = ['InferenceTranspiler', 'Float16Transpiler']
