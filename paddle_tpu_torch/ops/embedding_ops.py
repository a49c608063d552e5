"""Embedding gather (+ optional bias).

Counterpart of paddle_tpu/ops/embedding_ops.py (`embedding_gather`,
`_gather_pallas`) and of the `lookup_table` lowering. Ids are clamped to
[0, V - 1] as the TPU kernel clamps them (`_gather_pallas`): an
out-of-range id reads the first or last row, it does not raise.

On a CUDA tensor the wrapper launches ``csrc/embedding_gather.cu``; on the
CPU it runs :func:`_gather_ref`. Where autograd records the call it is an
``autograd.Function`` whose backward is the JAX package's
`_gather_grad_bwd`: a scatter-add of the output gradient into a zero
table, with the same bits at every run (an ``index_add_`` adds by atomics,
in an order that changes from run to run, so two runs of one training step
drifted apart). A table of more than 64 rows takes
``index_put_(accumulate=True)``, which on the card sorts the ids and sums
each row's gradients in order; a smaller one (BERT's two segment rows, fed
16384 ids at B 128) takes the product of the ids' one-hot transpose and
the gradient, since the sorted sum runs one row's ids one after another
(the cutoff of 64 rows is not measured, see `_ONE_HOT_ROWS`). The
backward does NOT mirror the forward's clamp: it follows
``.at[ids].add(..., mode='drop')``, which first wraps an id in [-V, 0) to
id + V (NumPy's negative indexing) and then drops any id still outside
[0, V) — so an out-of-range id reads a clamped row but adds its gradient
to a wrapped row or to none.

The program ops `lookup_table` and `fused_embedding_gather` (the bias
form) gather through :func:`embedding_gather`, zero the ``padding_idx``
rows and shape the rows as the ids (a trailing 1 of the ids folds into the
embedding dim), as the JAX lowerings do. An ``is_sparse`` table's lookup
in a backward's forward gathers its rows once as a leaf of their own
(`_lookup_rows`), from which the backward builds the table's SelectedRows
gradient (core/lowering.py).
"""
import ctypes

import torch

from .. import native
from ..core.registry import register_op
from . import kernel_tier

__all__ = ['embedding_gather']

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int64
        _fn = native.function('embedding_gather', 'ptt_embedding_gather',
                              [P, P, P, P, I, I, I, P])
    return _fn


def _gather_ref(w, ids, bias=None):
    """Plain version: ``w[clamp(ids)] (+ bias)``."""
    out = w[ids.clamp(0, w.shape[0] - 1)]
    return out if bias is None else out + bias.reshape(1, -1)


# tables of at most this many rows take their gradient as a one-hot
# product. The cutoff is not measured: it lies between the tables whose
# gradient was timed on the card, BERT's 2-row segment table (the one-hot
# product) and the 512- to 32000-row ones (the sorted scatter). What slows
# the sorted sum is how many ids fall on one row, not the row count.
_ONE_HOT_ROWS = 64


def _scatter_grad(ids, ct, V):
    """The table's gradient [V, D]: ``ct`` rows added at ``ids`` with the
    JAX scatter's rule (ids in [-V, 0) wrap, the rest outside [0, V) are
    dropped), deterministically (module docstring). Dropped rows add an
    exact 0 to row 0 instead of being filtered out, which would need a
    host sync."""
    idx = torch.where(ids < 0, ids + V, ids)
    keep = (idx >= 0) & (idx < V)
    idx = torch.where(keep, idx, torch.zeros_like(idx))
    ct = torch.where(keep[:, None], ct, torch.zeros_like(ct))
    if V <= _ONE_HOT_ROWS:
        rows = torch.arange(V, device=ct.device)
        return (rows[:, None] == idx[None, :]).to(ct.dtype) @ ct
    return torch.zeros((V, ct.shape[1]), dtype=ct.dtype,
                       device=ct.device).index_put_((idx,), ct,
                                                    accumulate=True)


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, ids, bias):
        ctx.save_for_backward(ids)
        ctx.V = w.shape[0]
        ctx.has_bias = bias is not None
        return _gather(w, ids, bias)

    @staticmethod
    def backward(ctx, ct):
        ids, = ctx.saved_tensors
        db = ct.sum(dim=0) if ctx.has_bias else None
        return _scatter_grad(ids, ct, ctx.V), None, db


def embedding_gather(w, ids, bias=None):
    """Rows of ``w`` [V, D] at ``ids`` (any integer shape, flattened),
    plus ``bias`` [D] if given. Returns [n_ids, D]. Differentiable in
    ``w`` and ``bias`` where autograd records the call."""
    ids = ids.reshape(-1)
    if kernel_tier.records_grad(w, bias):
        return _Gather.apply(w, ids, bias)
    return _gather(w, ids, bias)


def _gather(w, ids, bias):
    """The kernel on CUDA tensors, the plain version on the CPU."""
    if not kernel_tier.on_cuda(w, ids, bias):
        return _gather_ref(w, ids, bias)
    if w.dim() != 2:
        raise ValueError('embedding table must be [V, D], got %s'
                         % (tuple(w.shape),))
    V, D = w.shape
    kernel_tier.require(w, 'table', (V, D))
    ids = ids.to(torch.int64).contiguous()
    if ids.device != w.device:
        raise ValueError('ids lie on %s, table on %s' % (ids.device, w.device))
    if bias is not None:
        kernel_tier.require(bias, 'bias', (D,), device=w.device)
    n = ids.numel()
    if not 0 < V < 2 ** 31 - 2 ** 24 or max(n, D) >= 2 ** 31 - 2 ** 24:
        raise ValueError('embedding_gather takes a table of 1 to 2^31 - 2^24 '
                         'rows and fewer ids and columns, got [%d, %d] and %d'
                         % (V, D, n))
    out = torch.empty((n, D), dtype=w.dtype, device=w.device)
    rc = _kernel()(w.data_ptr(), ids.data_ptr(), kernel_tier.ptr(bias),
                   out.data_ptr(), n, V, D, kernel_tier.stream_ptr(w))
    native.check(rc, 'embedding_gather')
    kernel_tier.count('embedding_gather')
    return out


def _lookup_rows(ctx, op, w, flat, bias=None):
    """The rows a lookup site gathers (plus ``bias``). In the forward of a
    ``backward`` whose ``sparse_wrt`` holds the site's table the rows are
    gathered once, with no autograd through the table, and made a leaf
    that requires grad, recorded in ``ctx.sparse_sites``
    (core/lowering.py); the bias stays on autograd."""
    name = op.input('W')[0]
    if name not in ctx.sparse_tables:
        return embedding_gather(w, flat, bias)
    rows = embedding_gather(w.detach(), flat).requires_grad_()
    ctx.sparse_sites.append((name, flat.to(torch.int64), rows))
    return rows if bias is None else rows + bias.reshape(1, -1)


def _epilogue(ctx, op, out, flat, ids, w):
    """Zero the ``padding_idx`` rows and shape the rows as the ids (a
    trailing 1 of the ids folds into the embedding dim)."""
    pad = op.attr('padding_idx', -1)
    if pad is not None and pad != -1:
        pad = pad if pad >= 0 else pad + w.shape[0]
        out = torch.where((flat == pad)[:, None], torch.zeros_like(out), out)
    lead = tuple(ids.shape[:-1]) if ids.dim() and ids.shape[-1] == 1 \
        else tuple(ids.shape)
    ctx.out(op, 'Out', out.reshape(lead + (w.shape[1],)))


@register_op('lookup_table')
def _lookup_table(ctx, op):
    """``is_distributed`` (a vocabulary-sharded table in the JAX package)
    computes the plain lookup on one device, as the JAX lowering does with
    no mesh."""
    w, ids = ctx.in1(op, 'W'), ctx.in1(op, 'Ids')
    flat = ids.reshape(-1)
    _epilogue(ctx, op, _lookup_rows(ctx, op, w, flat), flat, ids, w)


@register_op('fused_embedding_gather')
def _fused_embedding_gather(ctx, op):
    """The gather with its per-feature ``Bias`` [D] added in the kernel
    (the bias form), then the lookup's epilogue."""
    w, ids = ctx.in1(op, 'W'), ctx.in1(op, 'Ids')
    flat = ids.reshape(-1)
    out = _lookup_rows(ctx, op, w, flat, ctx.in1(op, 'Bias'))
    _epilogue(ctx, op, out, flat, ids, w)
