#!/usr/bin/env python3
"""The host's cost of putting small host feeds into a captured graph's feed
buffers, on one CUDA card.

    python3 profile_upload.py [--calls N]   # from the repository root

Two feed sets: a served request's (ids [128, 64] int64 and their lengths
[128] int32, as the stacked LSTM's LoD feed lowers) and a chunk dispatch's
(a [4, 64, 1] int64 token block, [4] int32 lengths, [4, 1] f32 lengths,
two [4] bool masks and a [4] int32 budget).  Each set goes into buffers on
the card four ways:

- ``pageable``: ``buf.copy_(host)``, which synchronizes the stream;
- ``pinned``: ``buf.copy_(host.pin_memory(), non_blocking=True)``;
- ``upload``: ``buf.copy_(executor.upload(host, device, dtype))``: an
  asynchronous copy from the host tensor's own memory into a new tensor
  on the card, then a copy on the card;
- ``copy_in``: ``executor._copy_in(buf, host)``, the executor's way: the
  same asynchronous copy straight into the buffer;

once with the card idle and once with ~1 ms of device work queued before
each call (``torch.cuda._sleep``).  For each, the median and the 90th
percentile of the host's wall of one call, in microseconds.

    python3 profile_upload.py --run-only

times ``Executor.run`` instead: a replayed graph of an embedding, an fc and
a softmax over the request feed set (the ids and a [128, 1] f32 column),
its fetch copied to numpy, with ``torch.profiler`` off and on (the chip
smoke's serving walls are taken under it), then the Python functions that
take the most of its time under ``cProfile``.  It uses only the executor's
public surface, so it runs against an older tree of the port as well.
"""

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

SLEEP_CYCLES = 2000000  # ~1 ms at the H100's boost clock


def feed_sets(rng):
    return {
        'request': [rng.randint(0, 5149, (128, 64)).astype(np.int64),
                    np.full((128, ), 64, np.int32)],
        'chunk': [rng.randint(0, 30000, (4, 64, 1)).astype(np.int64),
                  np.full((4, ), 64, np.int32),
                  np.full((4, 1), 64, np.float32),
                  np.ones((4, ), bool), np.zeros((4, ), bool),
                  np.full((4, ), 24, np.int32)]}


def ways(dev):
    from paddle_tpu_torch.fluid.executor import _copy_in, upload
    return {
        'pageable': lambda buf, t: buf.copy_(t),
        'pinned': lambda buf, t: buf.copy_(t.pin_memory(),
                                           non_blocking=True),
        'upload': lambda buf, t: buf.copy_(upload(t, dev, buf.dtype)),
        'copy_in': _copy_in}


def measure(copy, bufs, hosts, calls, busy):
    walls = []
    for _ in range(calls):
        if busy:
            torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for buf, t in zip(bufs, hosts):
            copy(buf, t)
        walls.append(time.perf_counter() - t0)
        if busy:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    walls.sort()
    return (1e6 * statistics.median(walls),
            1e6 * walls[int(0.9 * (len(walls) - 1))])


def time_run(calls, card):
    """Executor.run's host wall over a replayed graph, profiler off and
    on."""
    import paddle_tpu_torch.fluid as fluid
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup):
        ids = fluid.layers.data(name='ids', shape=[64], dtype='int64')
        col = fluid.layers.data(name='col', shape=[1], dtype='float32')
        emb = fluid.layers.embedding(ids, size=[5149, 128])
        hid = fluid.layers.fc(input=[emb, col], size=128, act='tanh')
        out = fluid.layers.fc(input=hid, size=2, act='softmax')
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    arrays = feed_sets(np.random.RandomState(1))['request']
    feed = {'ids': arrays[0], 'col': np.ones((128, 1), np.float32)}

    def run():
        return exe.run(main_prog, feed=feed, fetch_list=[out], scope=scope)

    for _ in range(5):  # eager, capture, replays
        run()
    for profiled in (False, True):
        walls = []
        ctx = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if profiled else None
        if ctx is not None:
            ctx.__enter__()
        for _ in range(calls):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        if ctx is not None:
            ctx.__exit__(None, None, None)
        walls.sort()
        print(json.dumps({'exe_run': 'replay', 'profiler': profiled,
                          'calls': calls,
                          'host_us_p50': round(1e6 * statistics.median(
                              walls), 2),
                          'host_us_p90': round(1e6 * walls[int(
                              0.9 * (len(walls) - 1))], 2),
                          'card': card}), flush=True)
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        run()
    prof.disable()
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:15]
    print(json.dumps({'exe_run': 'cProfile', 'calls': calls, 'top_tottime_us':
                      [['%s:%d(%s)' % (k[0].split('/')[-1], k[1], k[2]),
                        round(1e6 * v[2] / calls, 2)] for k, v in rows],
                      'card': card}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--calls', type=int, default=500)
    ap.add_argument('--run-only', action='store_true',
                    help='time Executor.run instead of the feed copies')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_upload.py runs on a CUDA card only')
    dev = torch.device('cuda', 0)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '-i', '0'],
        capture_output=True, text=True).stdout.strip()
    if args.run_only:
        time_run(args.calls, card)
        return
    rng = np.random.RandomState(0)
    for name, arrays in feed_sets(rng).items():
        hosts = [torch.as_tensor(a) for a in arrays]
        bufs = [torch.empty(tuple(t.shape), dtype=t.dtype, device=dev)
                for t in hosts]
        for way, copy in ways(dev).items():
            measure(copy, bufs, hosts, 20, False)  # warm the allocators
            for busy in (False, True):
                p50, p90 = measure(copy, bufs, hosts, args.calls, busy)
                print(json.dumps({'feeds': name, 'way': way,
                                  'card_busy': busy, 'calls': args.calls,
                                  'host_us_p50': round(p50, 2),
                                  'host_us_p90': round(p90, 2),
                                  'card': card}), flush=True)
                for buf, t in zip(bufs, hosts):
                    assert torch.equal(buf.cpu(), t)


if __name__ == '__main__':
    main()
