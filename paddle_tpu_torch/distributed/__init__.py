"""The distributed tier of the PyTorch port (counterpart of
``paddle_tpu/distributed``): so far the checkpoint store
(``elastic.AsyncShardedCheckpoint``) that the Trainer writes through.  The
rest (``ElasticTrainJob``, the embedding cache, the parameter servers)
waits for ROADMAP.md, Queue 1 item 9."""

from . import elastic
from .elastic import AsyncShardedCheckpoint, CheckpointWriteError

__all__ = ['elastic', 'AsyncShardedCheckpoint', 'CheckpointWriteError']
