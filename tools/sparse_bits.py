"""Whether the sparse gradient path gives the same bits on the card as on
the CPU, and why it is built the way it is.

Prints one JSON line per check:

- ``merge``: `SelectedRows.merged()` of 13312 rows of a [V, D] table on
  the card and on the CPU, against a Python loop that adds each row's
  values in index order (the JAX scatter's order), at V 100000 (about one
  id a row) and V 50 (about 266), D 1, 16, 32 and 64; beside it
  ``index_put_(accumulate=True)`` on the CPU, which the CPU path does not
  use.
- ``sqrt``: how many of 2^20 float32 values ``torch.sqrt`` rounds
  otherwise than the float64 root rounded once (correctly rounded), on
  the CPU and on the card, and how many the optimizers' ``_sqrt`` does.

Run on a card: ``python3 tools/sparse_bits.py`` (about 10 s); without a
card the card's columns are null.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.core.selected_rows import SelectedRows  # noqa: E402
from paddle_tpu_torch.ops.optimizer_ops import _sqrt  # noqa: E402


def in_order_sum(rows, vals, V):
    out = torch.zeros((V, vals.shape[1]))
    for i in range(rows.shape[0]):
        out[rows[i]] += vals[i]
    return out


def merge_case(V, D, dev):
    g = torch.Generator().manual_seed(20)
    rows = torch.randint(0, V, (13312,), generator=g)
    vals = torch.randn((13312, D), generator=g)
    want = in_order_sum(rows, vals, V)
    r, v = SelectedRows(rows, vals, V).merged()
    n = int((r < V).sum())
    cpu = v[:n]
    want = want[r[:n]]
    out = dict(check='merge', V=V, D=D, distinct_rows=n,
               cpu_in_order=torch.equal(cpu, want),
               cpu_index_put_in_order=torch.equal(
                   torch.zeros((V, D)).index_put_((rows,), vals,
                                                  accumulate=True)[r[:n]],
                   want),
               card_in_order=None, card_equals_cpu=None)
    if dev is not None:
        rc, vc = SelectedRows(rows.to(dev), vals.to(dev), V).merged()
        out['card_in_order'] = torch.equal(vc[:n].cpu(), want)
        out['card_equals_cpu'] = torch.equal(rc.cpu(), r) and \
            torch.equal(vc.cpu(), v)
    return out


def sqrt_case(dev):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(1 << 20, generator=g) * 4 + 0.01
    exact = torch.sqrt(x.double()).float()
    out = dict(check='sqrt', values=x.numel(),
               cpu_torch_sqrt_off=int((torch.sqrt(x) != exact).sum()),
               cpu_port_sqrt_off=int((_sqrt(x) != exact).sum()),
               card_torch_sqrt_off=None)
    if dev is not None:
        out['card_torch_sqrt_off'] = int(
            (torch.sqrt(x.to(dev)).cpu() != exact).sum())
    return out


def main():
    dev = torch.device('cuda', 0) if torch.cuda.is_available() else None
    for V in (100000, 50):
        for D in (1, 16, 32, 64):
            print(json.dumps(merge_case(V, D, dev)), flush=True)
    print(json.dumps(sqrt_case(dev)), flush=True)


if __name__ == '__main__':
    main()
