#!/usr/bin/env python3
"""Which side errs where ``chip_smoke.py``'s Transformer training step
disagrees between the card and the CPU: the same step in f64 on the CPU is
the reference.

    python3 check_grad_f64.py [--seeds S ...]   # on a CUDA card

For each seed: Transformer-base as ``chip_smoke.py`` builds it (weights from
the seed), its five training steps on the card (``chip_smoke.phase_train``),
then ``chip_smoke``'s 2 x 256 comparison step from that state, run three
ways: f32 on the card, f32 on the CPU, and f64 on the CPU (every f32 var and
``dtype`` attr of the program made f64, the state cast up).  For every
parameter gradient it takes the card's and the CPU's max|d| from f64 and
``chip_smoke``'s allowance for card vs CPU (``GRAD_RTOL`` of the gradient's
own max|g| plus ``GRAD_ATOL`` of the largest max|g|), prints the gradients
nearest their allowance, and ends with one JSON line of each seed's worst
ratios and which side is nearer f64 how often.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEEDS = (20261016, 20261116, 20261216, 1, 7)


def f64_program(program):
    """A copy of ``program`` computing in f64: every f32 var and every f32
    ``dtype`` attr made f64."""
    from paddle_tpu_torch.fluid import core
    f32, f64 = core.VarDesc.VarType.FP32, core.VarDesc.VarType.FP64
    p = program.clone()
    for blk in p.blocks:
        for v in blk.vars.values():
            if v.dtype == f32:
                v.dtype = f64
        for op in blk.ops:
            if op.attrs.get('dtype') == f32:
                op.attrs['dtype'] = f64
    return p


def check_seed(card, seed):
    import chip_smoke
    import paddle_tpu_torch.fluid as fluid
    chip_smoke.SEED = seed
    model, scope, exe = chip_smoke.build_model()
    chip_smoke.phase_train(card, model, scope, exe)
    main = model['main']
    seq = chip_smoke.TRANSFORMER_BASE['max_len']
    vocab = chip_smoke.TRANSFORMER_BASE['trg_vocab']
    rng = np.random.RandomState(seed + 2)  # phase_train_card_vs_cpu's feed
    feed = {name: rng.randint(1, vocab, size=(2, seq)).astype('int64')
            for name in model['feeds']}
    state = {v.name: scope.find_var(v.name).value().cpu().numpy()
             for v in main.list_vars() if v.persistable}
    params = [p.name for p in main.all_parameters() if p.trainable]
    fetch = [model['loss'].name] + [p + '@GRAD' for p in params]
    runs = {}
    cpu = fluid.CPUPlace()
    for side, prog, cast in (('f64', f64_program(main), np.float64),
                             ('cpu', main, None)):
        s = fluid.Scope()
        fluid.persistables_from_numpy(
            prog, {n: v.astype(cast) if cast and v.dtype == np.float32
                   else v for n, v in state.items()}, scope=s, place=cpu)
        runs[side] = fluid.Executor(cpu).run(prog, feed=feed,
                                             fetch_list=fetch, scope=s)
    runs['card'] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    ref = [np.asarray(v, np.float64) for v in runs['f64']]
    top = max(float(np.abs(g).max()) for g in ref[1:])
    rows = []
    for i, name in enumerate(params, 1):
        own = float(np.abs(ref[i]).max())
        allowed = chip_smoke.GRAD_RTOL * own + chip_smoke.GRAD_ATOL * top
        err = {side: float(np.abs(runs[side][i] - ref[i]).max())
               for side in ('card', 'cpu')}
        pair = float(np.abs(runs['card'][i] - runs['cpu'][i]).max())
        rows.append((pair / allowed, name, pair, err['card'], err['cpu'],
                     own, float(np.linalg.norm(ref[i])), allowed))
    rows.sort(reverse=True)
    print('f64 check, seed %d: loss f64 %.9f, card %.9f, CPU %.9f; largest '
          'max|g| %.4g [%s]' % (seed, ref[0][0], runs['card'][0][0],
                                runs['cpu'][0][0], top, card), flush=True)
    for ratio, name, pair, e_card, e_cpu, own, norm, allowed in rows[:8]:
        print('  %-28s card-CPU %.3g = %.3f of allowance %.3g; from f64: '
              'card %.3g, CPU %.3g; max|g| %.4g, |g| %.4g' %
              (name, pair, ratio, allowed, e_card, e_cpu, own, norm),
              flush=True)
    return {
        'seed': seed,
        'worst': rows[0][1],
        'card_cpu_over_allowance': rows[0][0],
        'card_f64_over_allowance': max(r[3] / r[7] for r in rows),
        'cpu_f64_over_allowance': max(r[4] / r[7] for r in rows),
        'card_nearer': sum(r[3] < r[4] for r in rows),
        'cpu_nearer': sum(r[4] < r[3] for r in rows),
        'grads': len(rows),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seeds', type=int, nargs='+', default=list(SEEDS))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    out = [check_seed(card, seed) for seed in args.seeds]
    print(json.dumps({'f64_check': out, 'card': card}), flush=True)


if __name__ == '__main__':
    main()
