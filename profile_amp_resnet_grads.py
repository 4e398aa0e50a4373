#!/usr/bin/env python3
"""How far ResNet-50's gradients move under mixed precision, on one CUDA
card and on the CPU.

    python3 profile_amp_resnet_grads.py [--seed N]   # from the repository root

ResNet-50 at ``chip_smoke.py``'s widths (1000 classes, 224 x 224, Momentum
0.9 at lr 0.01), random weights from ``--seed``: from its startup state,
and again after five f32 steps on one 64-image batch, one training step of
2 and of 8 images runs four ways from the same state: on the card and on
the CPU, each in f32 and under ``fluid.amp_guard()``.  For each pair it
prints the loss and |dg| / |g| over all trainable gradients (the 2-norm of
the differences over the 2-norm of the second), with the three parameters
whose own |dg| / |g| is largest: AMP against f32 on one device, card
against CPU under AMP, and card against CPU in f32.  TF32 is off, as in
``chip_smoke.py``.
"""

import argparse
import time

import numpy as np

import chip_smoke as cs


def _rel(got, want):
    diff = sum(float(np.square(g - w, dtype=np.float64).sum())
               for g, w in zip(got, want))
    norm = sum(float(np.square(w, dtype=np.float64).sum()) for w in want)
    return (diff / norm)**0.5


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=cs.SEED)
    cs.SEED = ap.parse_args().seed
    card = cs.phase_device()
    import paddle_tpu_torch.fluid as fluid
    model, scope, exe = cs.build_cv_model('resnet', lr=cs.CV_LR,
                                          **cs.RESNET50)
    main_prog = model['main']
    params = [p.name for p in main_prog.all_parameters() if p.trainable]
    fetch = [model['loss'].name] + [p + '@GRAD' for p in params]
    state = [v.name for v in main_prog.list_vars() if v.persistable]
    rng = np.random.RandomState(cs.SEED + 50)
    shape, classes = cs.RESNET50['image_shape'], cs.RESNET50['class_dim']

    def step(place, values, feed, amp):
        sc = fluid.Scope()
        fluid.persistables_from_numpy(main_prog, values, scope=sc,
                                      place=place)
        with fluid.amp_guard(amp), cs.cpu_ftz():
            out = fluid.Executor(place).run(main_prog, feed=feed,
                                            fetch_list=fetch, scope=sc)
        return float(out[0][0]), out[1:]

    for label in ('startup', 'after 5 f32 steps'):
        if label != 'startup':
            batch = cs.image_batch(rng, cs.CV_BATCH, shape, classes)
            for _ in range(5):
                exe.run(main_prog, feed=batch, fetch_list=[model['loss']],
                        scope=scope)
        values = {n: scope.find_var(n).value().cpu().numpy() for n in state}
        for rows in (2, 8):
            feed = cs.image_batch(rng, rows, shape, classes)
            runs = {}
            for dev, place in (('card', fluid.CUDAPlace(0)),
                               ('cpu', fluid.CPUPlace())):
                for amp in (False, True):
                    t0 = time.perf_counter()
                    runs[(dev, amp)] = step(place, values, feed, amp)
                    print('%s, %d images, %s %s: loss %.6f (%.1f s)' %
                          (label, rows, dev, 'AMP' if amp else 'f32',
                           runs[(dev, amp)][0], time.perf_counter() - t0),
                          flush=True)
            for a, b in ((('card', True), ('card', False)),
                         (('cpu', True), ('cpu', False)),
                         (('card', True), ('cpu', True)),
                         (('card', False), ('cpu', False))):
                ga, gb = runs[a][1], runs[b][1]
                worst = sorted(
                    (float(np.linalg.norm(g - w) /
                           max(np.linalg.norm(w), 1e-30)), n)
                    for g, w, n in zip(ga, gb, params))[-3:]
                print('%s, %d images: %s %s against %s %s: |dg| / |g| over '
                      'all %.4g; the largest own: %s [%s]' %
                      (label, rows, a[0], 'AMP' if a[1] else 'f32', b[0],
                       'AMP' if b[1] else 'f32', _rel(ga, gb),
                       ', '.join('%s %.3g' % (n, e) for e, n in worst),
                       card), flush=True)


if __name__ == '__main__':
    main()
