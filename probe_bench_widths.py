#!/usr/bin/env python3
"""Which of bench.py's widths fit on one CUDA card with the release plan.

    python3 probe_bench_widths.py [--configs resnet,transformer,...]

For each configuration of ``chip_smoke.BENCH_WIDTHS`` it runs path E
(``chip_smoke.run_bench_width``: startup, an eager call, the capture,
replays) in a child process at bench.py's batch and, when the child fails,
at each smaller batch of ``CANDIDATES`` until one runs.  Prints every
attempt (path E's record, or the child's last error lines: an
out-of-memory error names the allocation that failed) and one JSON line
with the largest batch that ran for each configuration; chip_smoke.py
takes those as constants.  Needs a CUDA card and nvcc, as chip_smoke.py
does; builds the kernels once, before the children.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

# bench.py's batch first, then smaller ones
CANDIDATES = {
    'resnet': (512, 448, 384, 320, 256),
    'transformer': (128, 112, 96, 80, 64),
    'nmt': (512, 448, 384, 320, 256),
    'stacked_lstm': (128, ),
    'resnet_infer_bf16': (256, ),
    'ctr': (1024, ),
}


def child(name, batch):
    sys.path.insert(0, REPO)
    import chip_smoke
    card = chip_smoke.phase_device()
    chip_smoke.run_bench_width(card, name, batch)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--configs', default=','.join(CANDIDATES))
    ap.add_argument('--child', nargs=2, metavar=('CONFIG', 'BATCH'))
    args = ap.parse_args()
    if args.child:
        child(args.child[0], int(args.child[1]))
        return
    sys.path.insert(0, REPO)
    import chip_smoke
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    fits = {}
    for name in args.configs.split(','):
        fits[name] = None
        for batch in CANDIDATES[name]:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--child', name,
                 str(batch)], capture_output=True, text=True, timeout=900)
            records = [ln for ln in res.stdout.splitlines()
                       if ln.startswith('path E: ')]
            if res.returncode == 0:
                for ln in records:
                    print('probe %s batch %d: %s' % (name, batch, ln[8:]),
                          flush=True)
                fits[name] = batch
                break
            err = [ln for ln in (res.stdout + res.stderr).splitlines()
                   if ln.strip()][-4:]
            print('probe %s batch %d: failed (exit %d): %s' %
                  (name, batch, res.returncode, ' | '.join(err)), flush=True)
    print(json.dumps({'largest_batch_that_ran': fits}), flush=True)


if __name__ == '__main__':
    main()
