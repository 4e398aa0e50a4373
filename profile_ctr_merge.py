#!/usr/bin/env python3
"""Where a sparse CTR step's merge of duplicate ids spends its time, on one
CUDA card.

    python3 profile_ctr_merge.py [--seed N]   # from the repository root

The ids of one CTR batch at ``chip_smoke.py``'s widths (1024 rows of 26
zipf ids over a vocabulary of 1,000,000; D = 64) are merged four ways,
each giving the same (slot_rows, merged) as ``ops/sparse.merge_rows``:

- ``accumulate``: an accumulating ``index_put_`` of the sorted rows onto
  their run's slot (the card's sorted-index kernel walks each run's rows
  one after another, so a hot id's thousands of rows are summed serially);
- ``scan_dim0``: each run's sum as the difference of f64 prefix sums at
  its ends, the scan taken along dim 0 of [N, D];
- ``scan_rows``: the same with the scan taken along the last dim of the
  transposed [D, N];
- ``merge_rows``: the port's ``merge_rows`` as it stands.

For each: the median of 20 CUDA-event timings of one call and its device
time under ``torch.profiler``, and its largest difference from an f64
reference sum; then the most repeated id's row count.
"""

import argparse
import statistics
import subprocess

import numpy as np
import torch

V, D, ROWS, SLOTS = 1000000, 64, 1024, 26


def _runs(rows, height):
    """Sorted rows, their order, each row's slot, and its run's first and
    last flags."""
    n = rows.shape[0]
    r, order = torch.sort(rows, stable=True)
    first = torch.ones((n, ), dtype=torch.bool, device=r.device)
    first[1:] = r[1:] != r[:-1]
    last = torch.ones((n, ), dtype=torch.bool, device=r.device)
    last[:-1] = first[1:]
    seg = torch.cumsum(first, 0) - 1
    slot_rows = torch.full((n, ), height, dtype=r.dtype,
                           device=r.device).index_put_((seg, ), r)
    return r, order, seg, first, last, slot_rows


def accumulate(rows, values, height):
    _, order, seg, _, _, slot_rows = _runs(rows, height)
    v = torch.index_select(values, 0, order)
    return slot_rows, torch.zeros_like(v).index_put_((seg, ), v,
                                                     accumulate=True)


def _scan_merge(rows, values, height, transpose):
    _, order, seg, first, last, slot_rows = _runs(rows, height)
    n = rows.shape[0]
    v = torch.index_select(values, 0, order).double()
    if transpose:
        cs = torch.cumsum(v.t().contiguous(), 1).t()
    else:
        cs = torch.cumsum(v, 0)
    spare = torch.full_like(seg, n)
    ends = torch.zeros((n + 1, ) + tuple(v.shape[1:]), dtype=v.dtype,
                       device=v.device)
    starts = torch.zeros_like(ends)
    ends.index_put_((torch.where(last, seg, spare), ), cs)
    starts.index_put_((torch.where(first, seg, spare), ), cs - v)
    return slot_rows, (ends[:n] - starts[:n]).to(values.dtype)


def scan_dim0(rows, values, height):
    return _scan_merge(rows, values, height, False)


def scan_rows(rows, values, height):
    return _scan_merge(rows, values, height, True)


def _event_ms(fn, calls=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, calls=10):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, 'self_device_time_total', None)
        if us is None:
            us = getattr(evt, 'self_cuda_time_total', 0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            total += us / 1e3
    return total / calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=20261016)
    seed = ap.parse_args().seed
    if not torch.cuda.is_available():
        raise SystemExit('profile_ctr_merge.py needs a CUDA card')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True,
        text=True).stdout.strip(), flush=True)
    from paddle_tpu_torch.dataset import ctr as ctr_data
    from paddle_tpu_torch.ops import sparse
    rng = np.random.RandomState(seed)
    ids = ctr_data.zipf_batch(rng, ROWS, V)['sparse_ids'].reshape(-1)
    dev = torch.device('cuda', 0)
    rows = torch.from_numpy(ids).to(dev)
    values = torch.from_numpy(rng.standard_normal(
        (len(ids), D)).astype('float32') * 1e-3).to(dev)
    want = np.zeros((V, D))
    np.add.at(want, ids, values.cpu().numpy().astype(np.float64))
    uniq = np.unique(ids)
    for name, fn in (('accumulate', accumulate), ('scan_dim0', scan_dim0),
                     ('scan_rows', scan_rows),
                     ('merge_rows', sparse.merge_rows)):
        call = lambda: fn(rows, values, V)
        slot_rows, merged = call()
        got = slot_rows[:len(uniq)].cpu().numpy()
        err = float(np.abs(merged[:len(uniq)].cpu().numpy() -
                           want[uniq]).max())
        assert (got == uniq).all() and not merged[len(uniq):].any(), name
        print('%-10s %.4f ms (device %.4f ms), max|merged - f64 sum| %.3g'
              % (name, _event_ms(call), _device_ms(call), err), flush=True)
    counts = np.bincount(ids)
    print('%d ids, %d distinct; the most repeated id %d: %d rows' %
          (len(ids), len(uniq), int(counts.argmax()), int(counts.max())),
          flush=True)


if __name__ == '__main__':
    main()
