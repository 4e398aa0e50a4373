"""Hand-written Hopper kernels, the counterparts of ``paddle_tpu/ops/pallas``.

Each module holds a kernel's ctypes wrapper, its plain PyTorch version and
its launch counter; the CUDA sources live in ``paddle_tpu_torch/csrc`` and
are built by ``_build`` at first use.
"""
