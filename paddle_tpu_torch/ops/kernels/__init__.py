"""Hand-written Hopper kernels, the counterparts of ``paddle_tpu/ops/pallas``.

Each module holds a kernel's ctypes wrapper, its plain PyTorch version and
its launch counter; the CUDA sources live in ``paddle_tpu_torch/csrc`` and
are built by ``_build`` at first use.
"""

import torch


def unwrapped(t):
    """The plain tensor under torch.func's wrappers.  Under torch.func.vjp an
    autograd.Function's backward receives its saved tensors wrapped, and a
    wrapper has no storage, so no data pointer to hand to a kernel."""
    while t is not None and torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t
