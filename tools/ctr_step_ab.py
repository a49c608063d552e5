#!/usr/bin/env python3
"""Time chip_smoke.py's CTR rows (phase 20) from several checkouts of the
repository on one GPU, in turns.

    python3 tools/ctr_step_ab.py NAME=DIR [NAME=DIR ...] [--reps N]

Each DIR is a checkout (an earlier commit unpacked with ``git archive``,
or this one: ``.``). For each run a fresh Python process starts in DIR,
builds DIR's kernels (``native.build()``, into DIR's own build directory)
and runs DIR's ``chip_smoke.ctr_row`` for both CTR rows (``ctr_sparse``
and ``ctr_sharded_v1m``: five eager steps, ``run_fused`` against
``run()``, and the bench's window of 150 fused steps a call, best round),
so every checkout runs its own code and its own kernels on the same card.
The checkouts run in the order given and back again, ``--reps`` times
(a, b, b, a).

Prints each run's lines from chip_smoke.py, then one JSON line a run
(``ab_run``: the checkout, each row's fused step ms, device ms a step and
launches a step) and last a summary (``ab_summary``: every step ms of each
checkout and row, with the card's name and power limit). Exits 1 if a run
fails and 2 without a card.
"""
import argparse
import json
import os
import subprocess
import sys

RUN = r'''
import json, sys
sys.path.insert(0, '.')
import torch
import chip_smoke as c
import paddle_tpu_torch as fluid
from paddle_tpu_torch import native
from paddle_tpu_torch.ops import kernel_tier as kt
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
native.build()
per_step = dict.fromkeys(kt.KERNELS, 0)
per_step['embedding_gather'] = 1
out = {}
for name, vocab, dim, dist, rounds in c.CTR_ROWS:
    row, _ = c.ctr_row(torch, kt, fluid, sys.argv[1], name, vocab, dim,
                       dist, rounds, per_step)
    out[name] = {k: row[k] for k in ('step_ms', 'device_ms',
                                     'launches_per_step')}
    torch.cuda.empty_cache()
print('AB_RESULT ' + json.dumps(out), flush=True)
'''


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Time the CTR rows' fused steps of several checkouts.")
    parser.add_argument('checkouts', nargs='+', help='NAME=DIR')
    parser.add_argument('--reps', type=int, default=1)
    args = parser.parse_args(argv)
    dirs = dict(c.split('=', 1) for c in args.checkouts)
    try:
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    except (OSError, IndexError):
        print('ctr_step_ab: needs a CUDA card', file=sys.stderr)
        return 2
    order = list(dirs) + list(reversed(list(dirs)))
    summary = {name: {} for name in dirs}
    for _ in range(args.reps):
        for name in order:
            proc = subprocess.run(
                [sys.executable, '-c', RUN, card],
                cwd=os.path.abspath(dirs[name]), capture_output=True,
                text=True)
            sys.stdout.write(proc.stdout)
            if proc.returncode:
                sys.stderr.write(proc.stderr[-4000:])
                return 1
            res = json.loads(proc.stdout.rsplit('AB_RESULT ', 1)[1])
            print(json.dumps(dict(phase='ab_run', checkout=name, **res)),
                  flush=True)
            for row, r in res.items():
                summary[name].setdefault(row, []).append(r['step_ms'])
    print(json.dumps(dict(phase='ab_summary', card=card, step_ms=summary)),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
