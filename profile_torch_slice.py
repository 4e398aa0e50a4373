#!/usr/bin/env python3
"""Where a request's and a training step's time goes in the PyTorch/CUDA
port: Transformer-base, the stacked-LSTM IMDB model and ResNet-50.

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

Each request and training step is profiled twice: on the eager path
(``chip_smoke.eager_run``, every lowering dispatched from the host) and
on the captured path (the executor's default on the card: the block's CUDA
graph, replayed; its host work is the feeds' copy in, the replay launch and
the fetches' copy out).  The grads' forward replay shows as a range on the
eager path only: a graph replay runs no Python.

Then the stacked-LSTM model without peepholes (chip_smoke.py's kernel form,
its published widths, one 128-row LoD batch with lengths up to 64): the
host wall and the profile of a request (prediction fetched) and of a
training step, with the three LSTM kernels' share and the generic grads'
forward replay.

Then ResNet-50 at chip_smoke.py's shape (64 images of 3 x 224 x 224, 1000
classes, Momentum): the host wall and the profile of a request (softmax
fetched) and of a training step, with the convolution kernels' share and
the generic grads' forward replay.

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

from chip_smoke import (BATCH, CV_BATCH, CV_LR, LSTM_BATCH,  # noqa: E402
                        LSTM_LR, RESNET50, SEED, STACKED_LSTM,
                        TRANSFORMER_BASE, conv_ms, eager_run, image_batch,
                        lstm_request, profile_run, stacked_lstm_programs)

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
    fluid.Executor(fluid.CUDAPlace(0)).run(model['startup'], scope=scope)
    seq, vocab = TRANSFORMER_BASE['max_len'], TRANSFORMER_BASE['trg_vocab']
    rng = np.random.RandomState(SEED)
    feed = {n: rng.randint(1, vocab, size=(BATCH, seq)).astype('int64')
            for n in model['feeds']}
    flash = lambda prof, kinds: {
        'flash ' + kind: sum(ms for name, ms in prof['by_name'].items()
                             if kind + '_kernel' in name) for kind in kinds}
    result = {'card': card, 'batch': BATCH, 'seq': seq}
    for path, run in _paths(fluid):
        full = lambda: run(model['test'], feed,
                           [model['loss'], model['prediction']], scope)
        loss_only = lambda: run(model['test'], feed, [model['loss']], scope)
        for _ in range(3):  # the captured path: eager, capture, replay
            full()
            loss_only()
        wall_full = _wall(full, REPS)
        wall_loss = _wall(loss_only, REPS)
        request = profile_run(loss_only, os.path.join(
            args.out, 'slice_request_%s.json' % path))
        print('request (batch %d x seq %d), %s path [%s]:' %
              (BATCH, seq, path, card))
        print('  wall, loss + prediction fetched : %.4f s' % wall_full)
        print('  wall, loss fetched              : %.4f s' % wall_loss)
        _report(request, flash(request, ('fwd', )))

        train = lambda: run(model['main'], feed, [model['loss']], scope)
        for _ in range(3):
            train()
        wall_train = _wall(train, REPS)
        step = profile_run(train, os.path.join(
            args.out, 'slice_train_step_%s.json' % path), recompute=True)
        shares = flash(step, ('fwd', 'dq', 'dkv'))
        print('training step (batch %d x seq %d, Adam), %s path [%s]:' %
              (BATCH, seq, path, card))
        print('  wall, loss fetched              : %.4f s (median of %d)' %
              (wall_train, REPS))
        _report(step, shares)
        if step['recompute_ms']:
            print('  eager recompute: generic grads replaying their forward '
                  'ops %.3f ms of device time (%.3f of busy), of which the '
                  'flash forward kernel %.3f ms (18 of its 36 launches); the '
                  'forward request above took %.3f ms' %
                  (step['recompute_ms'], step['recompute_ms'] /
                   step['busy_ms'], shares['flash fwd'] / 2,
                   request['busy_ms']))
        result[path] = {
            'wall_full_s': wall_full, 'wall_loss_only_s': wall_loss,
            'wall_profiled_s': request['wall_s'],
            'device_busy_ms': request['busy_ms'] or None,
            'idle_share': _idle(request),
            'top_kernels_ms': dict(request['top']),
            'train_wall_s': wall_train,
            'train_wall_profiled_s': step['wall_s'],
            'train_device_busy_ms': step['busy_ms'] or None,
            'train_idle_share': _idle(step),
            'train_flash_ms': shares if step['busy_ms'] else None,
            'train_recompute_ms': step['recompute_ms'],
            'train_top_kernels_ms': dict(step['top'])}
    result['stacked_lstm'] = _profile_lstm(fluid, args.out, card)
    result['resnet50'] = _profile_resnet(fluid, args.out, card)
    print(json.dumps(result))


def _paths(fluid):
    """('eager', run), ('captured', run): ``run(program, feed, fetch_list,
    scope)`` on the eager path of one executor's blocks, and on the
    executor's default path, which replays each block's CUDA graph."""
    eager, captured = (fluid.Executor(fluid.CUDAPlace(0)) for _ in range(2))
    return (('eager', lambda *args: eager_run(eager, *args)),
            ('captured', lambda program, feed, fetch_list, scope:
             captured.run(program, feed=feed, fetch_list=fetch_list,
                          scope=scope)))


def _idle(prof):
    return (1 - prof['busy_ms'] / 1e3 / prof['wall_s']
            if prof['busy_ms'] else None)


_LSTM_KERNELS = {'lstm fwd': 'lstm_fwd_kernel', 'lstm walk': 'lstm_bwd_walk',
                 'lstm dW': 'lstm_dw_'}


def _profile_lstm(fluid, out, card):
    """The stacked-LSTM kernel form: a request and a training step."""
    with fluid.unique_name.guard():
        model = stacked_lstm_programs(fluid, use_peepholes=False, lr=LSTM_LR,
                                      **STACKED_LSTM)
    model['startup'].random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(model['startup'], scope=scope)
    feed = lstm_request(np.random.RandomState(SEED + 4), LSTM_BATCH)
    tokens = len(feed['words'].numpy())
    result = {'batch': LSTM_BATCH, 'tokens': tokens}
    for path, run in _paths(fluid):
        request = lambda: run(model['test'], feed, [model['prediction']],
                              scope)
        train = lambda: run(model['main'], feed, [model['loss']], scope)
        for name, fn in (('request', request), ('train', train)):
            for _ in range(3):  # the captured path: eager, capture, replay
                fn()
            wall = _wall(fn, REPS)
            prof = profile_run(fn, os.path.join(
                out, 'stacked_lstm_%s_%s.json' % (name, path)),
                recompute=name == 'train')
            shares = {label: sum(ms for key, ms in prof['by_name'].items()
                                 if pattern in key)
                      for label, pattern in _LSTM_KERNELS.items()}
            print('stacked LSTM %s (kernel form, %d rows, %d tokens, T=64), '
                  '%s path [%s]:' % (name, LSTM_BATCH, tokens, path, card))
            print('  wall                            : %.4f s (median of %d)'
                  % (wall, REPS))
            _report(prof, shares)
            if prof['recompute_ms']:
                print('  eager recompute: generic grads replaying their '
                      'forward ops %.3f ms of device time (%.3f of busy)' %
                      (prof['recompute_ms'], prof['recompute_ms'] /
                       prof['busy_ms']))
            result['%s_%s' % (name, path)] = {
                'wall_s': wall, 'wall_profiled_s': prof['wall_s'],
                'device_busy_ms': prof['busy_ms'] or None,
                'idle_share': _idle(prof),
                'lstm_kernels_ms': shares if prof['busy_ms'] else None,
                'recompute_ms': prof['recompute_ms'],
                'top_kernels_ms': dict(prof['top'])}
    return result


def _profile_resnet(fluid, out, card):
    """ResNet-50 at chip_smoke.py's shape (64 x 3 x 224 x 224, 1000
    classes, Momentum): a request (softmax fetched) and a training step,
    with the convolution kernels' share and the generic grads' forward
    replay."""
    from paddle_tpu_torch.models import resnet
    with fluid.unique_name.guard():
        model = resnet.build(lr=CV_LR, **RESNET50)
    model['startup'].random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(model['startup'], scope=scope)
    feed = image_batch(np.random.RandomState(SEED + 7), CV_BATCH,
                       RESNET50['image_shape'], RESNET50['class_dim'])
    result = {'batch': CV_BATCH}
    for path, run in _paths(fluid):
        request = lambda: run(model['test'], feed, [model['prediction']],
                              scope)
        train = lambda: run(model['main'], feed, [model['loss']], scope)
        for name, fn in (('request', request), ('train', train)):
            for _ in range(3):  # the captured path: eager, capture, replay
                fn()
            wall = _wall(fn, REPS)
            prof = profile_run(fn, os.path.join(
                out, 'resnet50_%s_%s.json' % (name, path)),
                recompute=name == 'train')
            print('ResNet-50 %s (%d x 3 x 224 x 224), %s path [%s]:' %
                  (name, CV_BATCH, path, card))
            print('  wall                            : %.4f s (median of %d)'
                  % (wall, REPS))
            _report(prof, {'convolution': conv_ms(prof)})
            if prof['recompute_ms']:
                print('  eager recompute: generic grads replaying their '
                      'forward ops %.3f ms of device time (%.3f of busy)' %
                      (prof['recompute_ms'], prof['recompute_ms'] /
                       prof['busy_ms']))
            result['%s_%s' % (name, path)] = {
                'wall_s': wall, 'wall_profiled_s': prof['wall_s'],
                'device_busy_ms': prof['busy_ms'] or None,
                'idle_share': _idle(prof),
                'conv_ms': conv_ms(prof) if prof['busy_ms'] else None,
                'recompute_ms': prof['recompute_ms'],
                'top_kernels_ms': dict(prof['top'])}
    return result


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
