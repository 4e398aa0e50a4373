"""paddle_tpu_torch.serving: the inference serving tier on PyTorch.

Counterpart of ``paddle_tpu/serving``, its forward path.  Single model:
``InferenceEngine`` serves a loaded inference program
(``fluid.io.load_inference_model``) request-facing, with dynamic
micro-batching (``MicroBatcher``, EDF/FIFO scheduling with priorities,
deadlines and shedding), batch and trailing-dim shape buckets
(``ShapeBucketSet``, ``TrailingDimBuckets``), multi-step eval dispatch
through ``Executor.run_eval_multi`` (on the card, CUDA-graph replays) and
metrics (``EngineMetrics``, ``ServiceTimeProfile``) in
``fluid.profiler``'s sidecar.  Multiple models: ``ModelRegistry`` hosts N
named engines on one device under ``HBMArbiter``'s budget, with
admission, LRU eviction to host memory and transparent reload.  Every
entry point runs on ``CUDAPlace(0)`` unless given ``CPUPlace()``.

Not ported yet (ROADMAP.md, Queue 1 items 7-9): generation and chunked
prefill (``decode.py``), dp/mesh serving, row-sharded tables and
embedding caches, ``fleet.py`` and ``loadgen.py``.

    reg = serving.ModelRegistry(hbm_budget_bytes=2 << 30)
    reg.load('ranker', '/models/ranker')
    with reg:                                  # starts every worker
        fut = reg.submit('ranker', {'img': x})
        logits, = fut.result()
    print(reg.status())
"""

from .arbiter import HBMArbiter, HBMBudgetError  # noqa: F401
from .batcher import InferenceRequest, MicroBatcher  # noqa: F401
from .buckets import ShapeBucketSet, TrailingDimBuckets  # noqa: F401
from .engine import InferenceEngine, ServingConfig  # noqa: F401
from .errors import DeadlineExceededError, EngineClosedError, \
    OverloadedError  # noqa: F401
from .metrics import EngineMetrics  # noqa: F401
from .profile import ServiceTimeProfile  # noqa: F401
from .registry import ModelRegistry  # noqa: F401

__all__ = ['InferenceEngine', 'ServingConfig', 'MicroBatcher',
           'InferenceRequest', 'ShapeBucketSet', 'TrailingDimBuckets',
           'EngineMetrics', 'ModelRegistry', 'HBMArbiter',
           'HBMBudgetError', 'DeadlineExceededError', 'OverloadedError',
           'EngineClosedError', 'ServiceTimeProfile']
