"""SelectedRows: the sparse (rows, values) gradient of an embedding table.

The port's own copy of paddle_tpu/core/selected_rows.py. ``rows`` (int64
[n]) and ``values`` ([n, d]) say which rows of a [height, d] table the
gradient touches; a row may repeat, and then its values add up (the
reference's un-merged state). Every shape is static and nothing reads a
value on the host (no ``unique``, ``nonzero`` or ``item``), so the
whole sparse path runs inside a CUDA graph of the run plan.

Row indices follow the JAX scatter's rule (``mode='drop'``): a row in
[-height, 0) counts from the end, and any other row outside [0, height)
(the sentinel ``height`` that :meth:`SelectedRows.merged` parks its freed
slots on) is dropped. A torch index op given such a row fails (on the card
with a device-side assert), so :func:`row_index` points it inside the
table and each writer makes the write change nothing:

- an add (:func:`add_rows`) adds -0.0 there, the exact identity of IEEE
  addition;
- a set (:func:`set_rows`) writes, at the first kept slot's row, that
  slot's own new value (or, when no slot is kept, row 0's value as it
  is), so every write of a row writes the same bytes.

Duplicate rows add in a fixed order, never by atomics (`_index_add`), so
a run gives the same bits every time: onto zeros (:meth:`merged`,
:meth:`SelectedRows.to_dense`) each row's values add one after another in
index order, as the JAX scatter adds them on the CPU, and the card and the
CPU give the same bits for rows of two or more elements. The optimizers
add a gradient's merged rows, one add a row.
"""
import torch

__all__ = ['SelectedRows', 'row_index', 'add_rows', 'gather_rows',
           'set_rows']


def _as_rows(mask, like):
    """``mask`` [n] shaped to broadcast against ``like`` [n, ...]."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def row_index(rows, height):
    """(idx, keep): ``rows`` with a row in [-height, 0) counted from the end,
    and which of them lie in [0, height) (the others are dropped)."""
    idx = torch.where(rows < 0, rows + height, rows)
    return idx, (idx >= 0) & (idx < height)


def _index_add(t, idx, vals):
    """``t[idx] += vals`` in place, deterministically: on the CPU
    ``index_add_``, a serial loop in index order; on the card
    ``index_put_(accumulate=True)``, which sorts the indices stably and sums
    each row's values in that order (onto a nonzero row of at most 32
    elements it adds their sum, not each in turn; a row of one element
    sums by a tree). ``index_put_`` on the CPU splits a long run of one
    index across threads, and ``index_add_`` on the card adds by atomics,
    so neither takes the other's place."""
    if t.is_cuda:
        return t.index_put_((idx,), vals, accumulate=True)
    return t.index_add_(0, idx, vals)


def add_rows(t, idx, keep, values):
    """``t[idx] += values`` in place for the kept slots (module
    docstring)."""
    vals = torch.where(_as_rows(keep, values), values,
                       torch.full_like(values, -0.0))
    return _index_add(t, torch.where(keep, idx, torch.zeros_like(idx)), vals)


def gather_rows(t, idx, keep):
    """``t``'s rows at the kept slots' ``idx`` (row 0 at a dropped slot)."""
    return t[torch.where(keep, idx, torch.zeros_like(idx))]


def set_rows(idx, keep, pairs):
    """``t[idx] = new`` in place for each (t, new) of ``pairs``, at the kept
    slots (module docstring)."""
    n = idx.shape[0]
    if n == 0:
        return
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    any_kept = keep.any()
    src = torch.where(keep, torch.arange(n, device=idx.device), first)
    dst = torch.where(any_kept, idx[src], torch.zeros_like(idx))
    for t, new in pairs:
        vals = torch.where(any_kept, new[src], t[:1].expand_as(new))
        t.index_put_((dst,), vals)


class SelectedRows(object):
    """Sparse rows of a [height, d] tensor: rows int64 [n], values [n, d]."""

    def __init__(self, rows, values, height):
        self.rows = rows
        self.values = values
        self.height = int(height)

    def __repr__(self):
        return 'SelectedRows(n=%d, height=%d)' % (self.rows.shape[0],
                                                  self.height)

    def to_dense(self):
        """The dense [height, d] gradient: duplicates add, dropped rows do
        not."""
        z = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                        dtype=self.values.dtype, device=self.values.device)
        return add_rows(z, *row_index(self.rows, self.height), self.values)

    def merged(self):
        """(rows, values) with duplicate rows summed (reference
        math/selected_rows_functor.h MergeAdd), all shapes static: the
        output has the same length n, the distinct rows first in ascending
        order, and each slot that merging freed carries row ``height`` and
        zero values."""
        n = self.rows.shape[0]
        r, order = torch.sort(self.rows, stable=True)
        v = self.values[order]
        first = torch.ones_like(r, dtype=torch.bool)
        first[1:] = r[1:] != r[:-1]
        seg = torch.cumsum(first.to(torch.int64), 0) - 1
        summed = _index_add(torch.zeros_like(v), seg, v)
        rows = torch.full((n,), self.height, dtype=torch.int64,
                          device=r.device).scatter_(0, seg, r)
        return rows, summed

    def scale(self, s):
        return SelectedRows(self.rows, self.values * s, self.height)
