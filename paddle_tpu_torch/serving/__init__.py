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

Generation: ``InferenceEngine(generation=GenerationSpec)`` serves a
step-decode model (``build_step_decode``) through ``submit_generate``:
prompts prefill in lots (or, under ``prefill_chunk``, in C-token chunks),
admit into a ``SlotStateCache`` slot and decode in K-step dispatches over
the slot batch, chained ``decode_pipeline_depth`` deep;
``ModelRegistry.load(generation=)`` accounts the cache as
``<model>:decode-cache``.

Not ported yet: dp/mesh serving, generation included, ``fleet.py`` and
``loadgen.py`` (ROADMAP.md, Queue 1 item 8), row-sharded tables and
embedding caches (item 9).

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
from .decode import GenerationRequest, GenerationSpec, \
    SlotStateCache  # noqa: F401
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
           'EngineClosedError', 'ServiceTimeProfile', 'GenerationSpec',
           'GenerationRequest', 'SlotStateCache']

# the JAX package's fleet.py and loadgen.py, not ported yet
_NOT_PORTED = {'FleetRouter': 'fleet', 'ReplicaServer': 'fleet',
               'FleetFuture': 'fleet', 'OpenLoopLoadGen': 'loadgen',
               'TrafficClass': 'loadgen', 'fleet': 'fleet',
               'loadgen': 'loadgen'}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            'serving.%s: the serving tier\'s %s.py is not ported to PyTorch '
            'yet (ROADMAP.md, Queue 1 item 8)' % (name, _NOT_PORTED[name]))
    raise AttributeError('module %r has no attribute %r' % (__name__, name))
