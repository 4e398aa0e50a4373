"""Contrib surface (counterpart of ``paddle_tpu/fluid/contrib``):
``memory_usage``.  The decoder DSL (``InitState``, ``StateCell``,
``TrainingDecoder``, ``BeamSearchDecoder``) is not ported yet (ROADMAP
Queue 1 item 3)."""

from .memory_usage_calc import memory_usage

__all__ = ['memory_usage']
