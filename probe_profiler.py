#!/usr/bin/env python3
"""How many device activities torch.profiler loses at a session's head.

    python3 probe_profiler.py [--sessions 40] [--marks 64] [--work 2000]
                              [--replays 100]

Opens ``--sessions`` profiler sessions one after another in one process.
In each it launches ``--marks`` short marker kernels (``torch.cuda._sleep``'s
spin_kernel), one every millisecond, each followed by a synchronize, and
then counts the markers the session recorded.  Prints, for each session,
the markers lost and, for those recorded, the host time of the launch
minus the card's start time (a small negative number where the profiler's
timestamps are right).  Between two sessions, without the profiler, it
launches ``--work`` small kernels one by one in the first half of the
sessions and replays a CUDA graph of ``--work`` small kernels
``--replays`` times in the second half.  Then one session through ``chip_smoke``'s
``_profiled`` (its preamble takes the loss) must record every one of
``--marks`` small products launched inside it.  Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CUDA = torch.autograd.DeviceType.CUDA
MARKER = 'spin_kernel'


def _markers(prof):
    return sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == CUDA and MARKER in e.name())


def session(marks):
    """One session of ``marks`` markers: (lost, host launch minus card start
    of each recorded marker in ms)."""
    host = []
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(marks):
            host.append(time.time_ns())
            torch.cuda._sleep(100)
            torch.cuda.synchronize()
            time.sleep(0.001)
    card = _markers(prof)
    lost = marks - len(card)
    # the loss is at the head: the markers recorded are the last ones
    skew = [(h - c) / 1e6 for h, c in zip(host[lost:], card)]
    return lost, skew


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--sessions', type=int, default=40)
    ap.add_argument('--marks', type=int, default=64)
    ap.add_argument('--work', type=int, default=2000)
    ap.add_argument('--replays', type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('probe_profiler: needs a CUDA card')
    x = torch.zeros(1024, device='cuda')
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        x.add_(1)  # warm up off the default stream, as capture asks
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        for _ in range(args.work):
            x.add_(1)
    lost_by_session = []
    for i in range(args.sessions):
        lost, skew = session(args.marks)
        lost_by_session.append(lost)
        between = 'eager' if 2 * i < args.sessions else 'graph'
        print('session %d (%s work before the next): %d of %d markers lost; '
              'host launch - card start %s ms' % (
                  i + 1, between, lost, args.marks, '%.3f to %.3f' % (
                      min(skew), max(skew)) if skew else '-'), flush=True)
        if between == 'eager':
            for _ in range(args.work):
                x.add_(1)
        else:
            for _ in range(args.replays):
                graph.replay()
        torch.cuda.synchronize()
    sys.path.insert(0, REPO)
    import chip_smoke
    preamble = chip_smoke.PROFILER['preamble']
    with chip_smoke._profiled() as s:
        for _ in range(args.marks):
            x.mul_(1.0)
        torch.cuda.synchronize()
    recorded = sum(e.device_type == CUDA and MARKER not in e.name
                   for e in s.prof.events())
    print('_profiled: its preamble of %d lost %d; %d of the %d products '
          'after it recorded' % (preamble, chip_smoke.PROFILER['lost'][-1],
                                 recorded, args.marks), flush=True)
    print(json.dumps({'card': torch.cuda.get_device_name(0),
                      'torch': torch.__version__,
                      'lost_by_session': lost_by_session,
                      'profiled_recorded': recorded}))
    if recorded != args.marks:
        sys.exit('probe_profiler: _profiled lost activities past its '
                 'preamble')


if __name__ == '__main__':
    main()
