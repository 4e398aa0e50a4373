"""The native runtime of the PyTorch port (counterpart of
``paddle_tpu/runtime``): ctypes bindings over the repository's C++
recordio container and blocking queue (``csrc/``), built at first use
into ``build/runtime/``, with pure-Python paths where no compiler is
found."""

from .native import (lib_available, RecordIOWriter, RecordIOScanner,
                     NativeBlockingQueue)

__all__ = ['lib_available', 'RecordIOWriter', 'RecordIOScanner',
           'NativeBlockingQueue']
