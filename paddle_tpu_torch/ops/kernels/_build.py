"""Build the port's CUDA sources into shared libraries and load them.

Library ``name`` is one ``nvcc`` call over ``paddle_tpu_torch/csrc/<name>.cu``
(a plain C interface, no PyTorch headers), compiled for ``sm_90a`` into
``build/paddle_tpu_torch/`` beside the package, at first use.  The file name
carries a hash of the source, the headers beside it (``csrc/*.cuh``) and the
flags, so an edited source or header builds anew and an unchanged one is
loaded from the previous build.  Libraries are bound with
``ctypes``.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ['build', 'load']

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'paddle_tpu_torch'

NVCC_FLAGS = [
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
]

_lock = threading.Lock()
_loaded = {}


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or \
        '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError(
            'nvcc not found on PATH or under CUDA_HOME (%s): the port\'s '
            'CUDA kernels are built from source at first use' % home)
    return path


def build(name):
    """Build library ``name`` unless an up-to-date build exists.  Returns
    ``(path, log)``: the compiler's output (ptxas register and spill
    counts), or None when the previous build was reused.  Raises with that
    output if ``nvcc`` fails."""
    src = CSRC / (name + '.cu')
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    digest.update(src.read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        digest.update(header.read_bytes())
    out = BUILD_DIR / ('lib%s-%s.so' % (name, digest.hexdigest()[:16]))
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name('%s.%d.tmp' % (out.name, os.getpid()))
    proc = subprocess.run([_nvcc()] + NVCC_FLAGS + ['-o', str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError('CUDA build of %s failed (nvcc exit %d):\n%s' %
                           (name, proc.returncode, proc.stdout))
    os.replace(tmp, out)  # atomic: a reader never sees a partial file
    return out, proc.stdout


def load(name):
    """The ctypes handle of library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[0]))
            _loaded[name] = lib
        return lib
