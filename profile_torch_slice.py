#!/usr/bin/env python3
"""Where a Transformer-base request's and training step's time goes in the
PyTorch/CUDA port.

    python3 profile_torch_slice.py [--out build/profile]

Builds Transformer-base at full width (the configuration chip_smoke.py
serves and trains, at its batch of 16 x 256 tokens; random weights from a
seed), warms up, then on one CUDA card:

- host wall time of a request fetching loss and the full prediction, and of
  one fetching the loss only (the difference is the prediction's copy to the
  host);
- one loss-only request under ``torch.profiler``: device time summed by
  kernel name, the flash-attention kernel's share, and the device's idle
  share of the request's wall time;
- host wall time of a training step (backward and Adam, loss fetched), and
  one step under ``torch.profiler``: device time by kernel, the three flash
  kernels' share, the idle share, and the device time of the generic grads'
  forward replays (each ``torch.func.vjp`` call, which replays its op's
  forward, is wrapped in a ``grad/recompute`` range for this run).

Prints the card's name and power limit, tables, and one JSON line; writes
the Chrome traces under ``--out``.  Needs a CUDA card; imports nothing of
JAX.
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

    request = _profile(loss_only, os.path.join(args.out, 'slice_request.json'))
    flash_ms = sum(ms for name, ms in request['by_name'].items()
                   if 'fwd_kernel' in name)
    print('request (batch %d x seq %d) [%s]:' % (BATCH, seq, card))
    print('  wall, loss + prediction fetched : %.4f s' % wall_full)
    print('  wall, loss fetched              : %.4f s' % wall_loss)
    _report(request, {'flash fwd': flash_ms})

    train = lambda: exe.run(model['main'], feed=feed, scope=scope,
                            fetch_list=[model['loss']])
    train()
    train()
    wall_train = _wall(train, REPS)
    real_vjp = torch.func.vjp

    def annotated_vjp(fn, *primals):
        with torch.profiler.record_function(_RECOMPUTE):
            return real_vjp(fn, *primals)

    torch.func.vjp = annotated_vjp
    try:
        step = _profile(train, os.path.join(args.out, 'slice_train_step.json'))
    finally:
        torch.func.vjp = real_vjp
    flash = {kind: sum(ms for name, ms in step['by_name'].items()
                       if kind + '_kernel' in name)
             for kind in ('fwd', 'dq', 'dkv')}
    print('training step (batch %d x seq %d, Adam) [%s]:' % (BATCH, seq, card))
    print('  wall, loss fetched              : %.4f s (median of %d)' %
          (wall_train, REPS))
    _report(step, {'flash ' + k: v for k, v in flash.items()})
    if step['busy_ms']:
        print('  eager recompute: generic grads replaying their forward ops '
              '%.3f ms of device time (%.3f of busy), of which the flash '
              'forward kernel %.3f ms (18 of its 36 launches); the forward '
              'request above took %.3f ms' %
              (step['recompute_ms'], step['recompute_ms'] / step['busy_ms'],
               flash['fwd'] / 2, request['busy_ms']))
    print(json.dumps({
        'card': card, 'batch': BATCH, 'seq': seq,
        'wall_full_s': wall_full, 'wall_loss_only_s': wall_loss,
        'wall_profiled_s': request['wall_s'],
        'device_busy_ms': request['busy_ms'] or None,
        'flash_kernel_ms': flash_ms if request['busy_ms'] else None,
        'top_kernels_ms': dict(request['top']),
        'train_wall_s': wall_train,
        'train_wall_profiled_s': step['wall_s'],
        'train_device_busy_ms': step['busy_ms'] or None,
        'train_flash_ms': flash if step['busy_ms'] else None,
        'train_recompute_ms': step['recompute_ms'],
        'train_top_kernels_ms': dict(step['top'])}))


_RECOMPUTE = 'grad/recompute'


def _profile(fn, trace_path):
    """Run fn once under torch.profiler: device time by kernel name and of
    the kernels launched inside ``_RECOMPUTE`` ranges, and the host wall of
    the run."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    by_name = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, 'self_device_time_total', None)
        if dev_us is None:
            dev_us = getattr(evt, 'self_cuda_time_total', 0)
        # a range's device-side span (idle gaps included) is no kernel
        if evt.key == _RECOMPUTE:
            continue
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev_us / 1e3
    # a host range's device time: the kernels its ops launched (the
    # backward runs on autograd's own thread, outside any range)
    recompute = sum(evt.device_time_total / 1e3 for evt in prof.events()
                    if evt.name == _RECOMPUTE and
                    evt.device_type == torch.autograd.DeviceType.CPU)
    busy = sum(by_name.values())
    return {'wall_s': wall, 'busy_ms': busy, 'by_name': by_name,
            'recompute_ms': recompute,
            'top': sorted(by_name.items(), key=lambda kv: -kv[1])[:12]}


def _report(prof, shares):
    print('  profiled wall                   : %.4f s' % prof['wall_s'])
    busy = prof['busy_ms']
    if busy == 0:
        print('  device time: not measured (the profiler saw no device '
              'kernels)')
        return
    print('  device busy %.3f ms, idle share %.3f' %
          (busy, 1 - busy / 1e3 / prof['wall_s']))
    for label, ms in shares.items():
        print('  %s kernel %.3f ms (%.3f of busy)' % (label, ms, ms / busy))
    for name, ms in prof['top']:
        print('  %9.3f ms  %5.3f  %s' % (ms, ms / busy, name[:100]))


if __name__ == '__main__':
    main()
