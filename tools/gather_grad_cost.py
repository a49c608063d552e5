#!/usr/bin/env python3
"""Time the embedding table's gradient on one GPU at the training rows'
shapes, in the port's form and in the one it replaced.

    python3 tools/gather_grad_cost.py [--reps N]

The port's backward of the embedding gather
(``paddle_tpu_torch/ops/embedding_ops.py`` `_scatter_grad`) sums each row's
gradients in a fixed order: ``index_put_(accumulate=True)``, which sorts the
ids, for a table of more than 64 rows, and a one-hot product for a smaller
one. The form it replaced, ``index_add_``, adds by atomics in an order that
changes from run to run. Both are timed on the same inputs by CUDA-graph
replays (``chip_smoke.cuda_ms``), in turns (a, b, b, a), ``--reps`` times
each, at the ids of:

- the flagship LM at B 64 (V 32000, D 512, 32768 ids), ``lm_large`` at
  B 32 (V 32000, D 1024, 16384 ids) and ``lm_long_seq8k`` at B 2 (V 32000,
  D 512, 16384 ids): ids drawn uniformly, as chip_smoke.py draws them;
- BERT-base at B 128 (its word table, V 30522, and its two segment rows,
  D 768, 16384 ids each): the ids of chip_smoke.py's ``bert_batch``.

Prints the card's name and power limit, one JSON line per table (both
forms' least time and every time, in ms; the most ids on one row), and
exits 2 when there is no card. The two forms' sums are held to each other
(1e-4 of the largest magnitude: only the order of the additions differs).
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tables(torch, dev):
    """[(name, ids on ``dev``, V, D)] of the training rows."""
    import chip_smoke
    from paddle_tpu_torch.models.bert import BertConfig
    g = torch.Generator(device='cpu').manual_seed(0)
    out = []
    for name, n, d in (('lm_b64', 64 * 512, 512),
                       ('lm_large_b32', 32 * 512, 1024),
                       ('lm_long_seq8k_b2', 2 * 8192, 512)):
        out.append((name, torch.randint(0, 32000, (n,), generator=g).to(dev),
                    32000, d))
    cfg = BertConfig()
    feed = chip_smoke.bert_batch(torch, cfg, 128, 3, dev)
    out.append(('bert_word_b128', feed['tokens'].reshape(-1),
                cfg.vocab_size, cfg.d_model))
    out.append(('bert_segment_b128', feed['segments'].reshape(-1),
                cfg.type_vocab_size, cfg.d_model))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    import chip_smoke
    from paddle_tpu_torch.ops import embedding_ops
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(1)
    bad = 0
    for name, ids, V, D in tables(torch, dev):
        ct = torch.randn((ids.numel(), D), generator=g, device=dev)
        forms = {
            'sorted': lambda: embedding_ops._scatter_grad(ids, ct, V),
            'index_add': lambda: torch.zeros(
                (V, D), device=dev).index_add_(0, ids, ct),
        }
        want = forms['index_add']()
        got = forms['sorted']()
        err = float((got - want).abs().max() / want.abs().max())
        times = {k: [] for k in forms}
        order = list(forms)
        for _ in range(args.reps):
            for k in order + order[::-1]:
                times[k].append(chip_smoke.cuda_ms(torch, forms[k]))
        most = int(torch.bincount(ids, minlength=V).max())
        line = dict(table=name, V=V, D=D, ids=ids.numel(),
                    most_ids_a_row=most, rel_err=err,
                    route='one_hot' if V <= embedding_ops._ONE_HOT_ROWS
                    else 'index_put',
                    ms={k: min(v) for k, v in times.items()},
                    all_ms=times)
        print(json.dumps(line), flush=True)
        bad += err > 1e-4
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
