#!/usr/bin/env python3
"""How far the card's and the CPU's steps of an image training row lie from
the same step in float64, layer by layer and tensor by tensor.

    python3 tools/image_witness.py [--rows resnet50,se_resnext,vgg16]
                                   [--batch 4] [--steps 2] [--out DIR]

For each row of chip_smoke.py's phase 18 (the bench's ``resnet50``,
``se_resnext`` and ``vgg16``, their startup programs seeded as there) it
runs chip_smoke.py's `image_hold_runs` on the first ``--batch`` images of
the row's first batch: ``--steps`` steps of the float64 twin of the
float32 program on the card and on the CPU, and one step of the float32
program and of the keep-bf16 AMP program on each side. Every run is held
to the CPU's float64 run:

- ``fwd``: each forward output of the first step (convolutions, batch
  norms, residual adds, pools, the head), its largest difference over its
  largest magnitude;
- ``grad``: each gradient (the velocity after the first step), the same
  measure, and ``grad_rms``, the 2-norm of the difference over the
  float64 gradient's, with the card's distance over the CPU's
  (``ratio_*``);
- ``loss``: each step's loss, relative;
- ``flips``: for each batch norm and residual add (the inputs of the
  ReLUs), the elements whose sign differs from the float64 run's: each
  moves the gradient by a step, not by a rounding.

Prints the card's name and power limit, then one JSON summary line per
row; with ``--out`` the whole tables go to ``DIR/image_witness_<row>.json``.
Exits 2 when there is no card.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def summarize(runs, fwd_names, vels):
    """({run: {fwd, grad, loss}} tables, the summary) against the CPU's
    float64 run."""
    import chip_smoke
    ref = runs['cpu', 'f64']
    tables, summary = {}, {}
    for (side, kind), run in sorted(runs.items()):
        if (side, kind) == ('cpu', 'f64'):
            continue
        key = '%s_%s' % (side, kind)
        fwd = chip_smoke.rel_errs(run['fwd'], ref['fwd'], fwd_names)
        grad = chip_smoke.rel_errs(run['state'][0], ref['state'][0], vels)
        dist = chip_smoke.rms_dist(run['state'][0], ref['state'][0], vels)
        rms = {n: dist[n] / max(float(np.linalg.norm(
            ref['state'][0][n].ravel())), 1e-300) for n in vels}
        loss = [abs(a / b - 1.0) for a, b in zip(run['losses'],
                                                 ref['losses'])]
        # ReLU's kinks: pre-activation elements whose sign differs from
        # the float64 run's, a step in the gradient each
        flips = {n: int(np.sum(np.sign(run['fwd'][n]) !=
                               np.sign(ref['fwd'][n]))) for n in fwd_names
                 if n.startswith(('batch_norm', 'elementwise_add'))}
        tables[key] = dict(fwd=fwd, grad=grad, grad_rms=rms, loss=loss,
                           flips=flips, s=run['s'])
        worst = max(grad, key=grad.get)
        summary[key] = dict(
            flips=sum(flips.values()),
            flipped_outputs=sum(v > 0 for v in flips.values()),
            loss_rel=loss, fwd_first=fwd[fwd_names[0]],
            fwd_last=fwd[fwd_names[-1]], fwd_max=max(fwd.values()),
            grad_max=grad[worst], grad_worst=worst,
            grad_median=float(np.median(list(grad.values()))),
            grad_rms_median=float(np.median(list(rms.values()))),
            grad_rms_max=max(rms.values()), s=run['s'])
    for kind in ('f32', 'amp'):
        for norm in ('grad', 'grad_rms'):
            c = tables['card_' + kind][norm]
            p = tables['cpu_' + kind][norm]
            ratio = {n: c[n] / max(p[n], 1e-300) for n in vels}
            label = 'ratio_%s_%s' % (norm, kind)
            tables[label] = ratio
            summary[label] = dict(
                max=max(ratio.values()), worst=max(ratio, key=ratio.get),
                median=float(np.median(list(ratio.values()))),
                over_2=sum(r > 2 for r in ratio.values()),
                over_4=sum(r > 4 for r in ratio.values()))
    return tables, summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--rows', default='resnet50,se_resnext,vgg16')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--steps', type=int, default=2)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('image_witness: no CUDA device available', file=sys.stderr)
        sys.exit(2)
    import chip_smoke
    import paddle_tpu_torch as fluid
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    rows = {r[0]: r for r in chip_smoke.IMAGE_ROWS}
    for name in args.rows.split(','):
        _, shape, classes, lr, _ = rows[name]
        build = chip_smoke.image_build(name)
        main_p, startup, loss = chip_smoke.image_program(fluid, build, lr)
        main32, _, loss32 = chip_smoke.image_program(fluid, build, lr,
                                                     amp=False)
        s0 = fluid.Scope()
        fluid.Executor().run(startup, scope=s0)
        init = chip_smoke.state_arrays(s0)
        batch = chip_smoke.image_batches(shape, classes, 1)[0]
        feed = {k: v[:args.batch] for k, v in batch.items()}
        runs = chip_smoke.image_hold_runs(
            torch, fluid, main_p, main32,
            {'f32': loss32.name, 'amp': loss.name}, init, feed,
            steps=args.steps, fwd=True)
        vels = sorted(n for n in init if '_velocity_' in n)
        tables, summary = summarize(runs, chip_smoke.forward_outputs(main32),
                                    vels)
        if args.out:
            with open(os.path.join(args.out, 'image_witness_%s.json' % name),
                      'w') as f:
                json.dump(dict(row=name, batch=args.batch, steps=args.steps,
                               tables=tables), f)
        verdict, failures = chip_smoke.image_hold_verdict(runs, main32)
        print(json.dumps(dict(row=name, batch=args.batch, summary=summary,
                              hold=verdict, hold_failures=failures)),
              flush=True)


if __name__ == '__main__':
    main()
