"""What the kernel profilers share (``profile_lstm_fwd.py``,
``profile_lstm_walk.py``): copies of a kernel source under
``paddle_tpu_torch/csrc/`` with edits put in by matching its text, built in
parallel with the library's nvcc flags, and the card's line.

An edit is an (anchor, replacement) pair; an anchor the source no longer
has stops the profiler with that anchor, so a change to the kernel that
moves a mark shows at once.
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, 'paddle_tpu_torch', 'csrc')
sys.path.insert(0, REPO)

from paddle_tpu_torch.ops.kernels import _build  # noqa: E402


def card_line():
    """The card's name, power limit and clocks, as nvidia-smi gives them."""
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,clocks.max.sm',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def patched(tool, src, edits):
    """src with each (anchor, replacement) of edits applied once."""
    for old, new in edits:
        if old not in src:
            sys.exit('%s: the source no longer has:\n%s' % (tool, old))
        src = src.replace(old, new, 1)
    return src


def build_variants(tool, source, variants, tail):
    """{name: (ctypes library, nvcc's output)}: ``csrc/<source>`` with each
    variant's edits and ``tail`` appended, compiled in parallel into
    ``build/<tool>/`` with ``csrc/`` on the include path."""
    src = open(os.path.join(CSRC, source)).read()
    out_dir = os.path.join(REPO, 'build', tool)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        cu = os.path.join(out_dir, name + '.cu')
        with open(cu, 'w') as f:
            f.write(patched(tool, src, edits) + tail)
        procs[name] = subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS +
            ['-I', CSRC, '-o', os.path.join(out_dir, 'lib%s.so' % name), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit('%s: nvcc failed for %s:\n%s' % (tool, name, log))
        libs[name] = (ctypes.CDLL(os.path.join(out_dir, 'lib%s.so' % name)),
                      log)
    return libs
