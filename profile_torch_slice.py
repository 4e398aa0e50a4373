#!/usr/bin/env python3
"""Where a Transformer-base request's time goes in the PyTorch/CUDA port.

    python3 profile_torch_slice.py [--out build/profile]

Builds Transformer-base at full width (the configuration chip_smoke.py
serves, at its batch of 16 x 256 tokens; random weights from a seed), warms
up, then on one CUDA card:

- host wall time of a request fetching loss and the full prediction, and of
  one fetching the loss only (the difference is the prediction's copy to the
  host);
- one loss-only request under ``torch.profiler``: device time summed by
  kernel name, the flash-attention kernel's share, and the device's idle
  share of the request's wall time.

Prints the card's name and power limit, a table, and one JSON line; writes
the Chrome trace under ``--out``.  Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from chip_smoke import BATCH, SEED, TRANSFORMER_BASE  # noqa: E402

REPS = 5  # request walls per median


def _wall(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=os.path.join(REPO, 'build', 'profile'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('profile_torch_slice: needs a CUDA card')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader',
         '-i', str(torch.cuda.current_device())],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer
    with fluid.unique_name.guard():
        model = transformer.build(**TRANSFORMER_BASE)
    model['startup'].random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(model['startup'], scope=scope)
    seq, vocab = TRANSFORMER_BASE['max_len'], TRANSFORMER_BASE['trg_vocab']
    rng = np.random.RandomState(SEED)
    feed = {n: rng.randint(1, vocab, size=(BATCH, seq)).astype('int64')
            for n in model['feeds']}
    full = lambda: exe.run(model['test'], feed=feed, scope=scope,
                           fetch_list=[model['loss'], model['prediction']])
    loss_only = lambda: exe.run(model['test'], feed=feed, scope=scope,
                                fetch_list=[model['loss']])
    full()
    loss_only()
    wall_full = _wall(full, REPS)
    wall_loss = _wall(loss_only, REPS)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loss_only()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, 'slice_request.json'))

    by_name = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, 'self_device_time_total', None)
        if dev_us is None:
            dev_us = getattr(evt, 'self_cuda_time_total', 0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev_us / 1e3
    busy_ms = sum(by_name.values())
    flash_ms = sum(ms for name, ms in by_name.items()
                   if 'fwd_kernel' in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print('request (batch %d x seq %d) [%s]:' % (BATCH, seq, card))
    print('  wall, loss + prediction fetched : %.4f s' % wall_full)
    print('  wall, loss fetched              : %.4f s' % wall_loss)
    print('  profiled loss-only request wall : %.4f s' % wall_prof)
    if busy_ms == 0:
        print('  device time: not measured (the profiler saw no device '
              'kernels)')
    else:
        print('  device busy %.3f ms, idle share %.3f; flash kernel %.3f ms '
              '(%.3f of busy)' % (busy_ms, 1 - busy_ms / 1e3 / wall_prof,
                                  flash_ms, flash_ms / busy_ms))
        for name, ms in top:
            print('  %9.3f ms  %5.3f  %s' % (ms, ms / busy_ms, name[:100]))
    print(json.dumps({
        'card': card, 'batch': BATCH, 'seq': seq,
        'wall_full_s': wall_full, 'wall_loss_only_s': wall_loss,
        'wall_profiled_s': wall_prof,
        'device_busy_ms': busy_ms if busy_ms else None,
        'flash_kernel_ms': flash_ms if busy_ms else None,
        'top_kernels_ms': dict(top)}))


if __name__ == '__main__':
    main()
