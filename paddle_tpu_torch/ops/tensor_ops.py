"""Position encoding, and the shape ops of a Program.

The port's own copy of paddle_tpu/ops/tensor_ops.py
`position_encoding_table` and the `add_position_encoding` lowering. The
table is built in numpy exactly as the JAX package builds it, so that a
token's embedding is bit-identical whether it entered through a prefill
(rows 0..T-1 added at once) or a decode step (one row gathered by
position).

The program ops `reshape2` (0 copies a dimension, -1 is inferred),
`transpose2`, `slice` and `squeeze2` are views where torch can make one;
their ``XShape`` output (an empty [0, *x.shape] tensor in the JAX package)
is made only when something reads it. `gather` (BERT's masked positions)
is :func:`gather`. `top_k` (``layers.accuracy``) is ``torch.topk`` over
the last axis, largest first, its indices int64.
`merge_selected_rows` and `get_tensor_from_selected_rows` take a
SelectedRows gradient (core/selected_rows.py) apart.
"""
import numpy as np
import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows

__all__ = ['position_encoding_table', 'add_position_encoding', 'gather']


def position_encoding_table(max_len, d_model):
    """The sinusoid table as a [max_len, d_model] float32 numpy array."""
    pos = np.arange(max_len)[:, None]
    half = d_model // 2
    freq = np.power(10000.0, -np.arange(half) / float(half))
    enc = np.zeros((max_len, d_model), dtype=np.float32)
    enc[:, :half] = np.sin(pos * freq)
    enc[:, half:2 * half] = np.cos(pos * freq)
    return enc


def add_position_encoding(x, alpha=1.0, beta=1.0, table=None):
    """``alpha * x + beta * table[:L]`` for x [N, L, D]. ``table`` is a
    precomputed [>= L, D] tensor on x's device (built when None)."""
    L, D = x.shape[-2], x.shape[-1]
    if table is None:
        table = torch.from_numpy(position_encoding_table(L, D)).to(x.device)
    return alpha * x + beta * table[:L]


def _take_fill(dtype):
    """The value ``jnp.take`` gives an index outside [-n, n) in its default
    mode: NaN for floats, the most negative value for signed integers (an
    int64 program computes in int32 in the JAX package, so int32's), the
    largest for unsigned ones and True for bool."""
    if dtype.is_floating_point:
        return float('nan')
    if dtype == torch.bool:
        return True
    info = torch.iinfo(torch.int32 if dtype == torch.int64 else dtype)
    return info.min if info.min < 0 else info.max


def gather(x, index):
    """Rows of ``x`` at ``index`` (flattened, cast to int32 as the JAX op
    casts it) along axis 0, as the JAX ``gather`` op's ``jnp.take``
    computes them in its default mode, for any dtype: an index in [-n, 0)
    counts from the end, and one outside [-n, n) gives a row of the fill
    value (`_take_fill`; NaN for floats, whose gradient is dropped). No
    index reaches the tensor out of range (on the card that is a
    device-side assert). The backward is autograd's scatter-add of the
    rows' gradients."""
    n = x.shape[0]
    idx = index.reshape(-1).to(torch.int32).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = ((idx >= 0) & (idx < n)).reshape((-1,) + (1,) * (x.dim() - 1))
    rows = x[idx.clamp(0, max(n - 1, 0))]
    return torch.where(inside, rows, torch.full((), _take_fill(x.dtype),
                                                dtype=x.dtype,
                                                device=x.device))


# ---------------------------------------------------------------------------
# the program ops


def _xshape(ctx, op, x):
    if ctx.needed(op, 'XShape'):
        ctx.out(op, 'XShape', x.new_zeros((0,) + tuple(x.shape)))


def _infer_reshape(x, shape):
    shape = list(shape)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape[shape.index(-1)] = x.numel() // max(known, 1)
    return tuple(shape)


@register_op('reshape2')
def _reshape2(ctx, op):
    x = ctx.in1(op, 'X')
    ctx.out(op, 'Out', x.reshape(_infer_reshape(x, op.attr('shape'))))
    _xshape(ctx, op, x)


@register_op('transpose2', share_lod=False)
def _transpose2(ctx, op):
    x = ctx.in1(op, 'X')
    ctx.out(op, 'Out', x.permute(*op.attr('axis')))
    _xshape(ctx, op, x)


@register_op('squeeze2')
def _squeeze2(ctx, op):
    x = ctx.in1(op, 'X')
    axes = op.attr('axes', [])
    if axes:
        shape = tuple(s for i, s in enumerate(x.shape)
                      if not (i in axes and s == 1))
    else:
        shape = tuple(s for s in x.shape if s != 1)
    ctx.out(op, 'Out', x.reshape(shape))
    _xshape(ctx, op, x)


@register_op('slice')
def _slice(ctx, op):
    x = ctx.in1(op, 'Input')
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(op.attr('axes'), op.attr('starts'), op.attr('ends')):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    name = op.input('Input')[0]
    if len(op.attr('axes')) == 1 and e - s == 1 and \
            _axis_slices(ctx, name, a) > 1:
        # one index of one axis that other slices of x cut too: a view out
        # of the run's one unbind of x, which they share, so that their
        # gradients stack into one tensor (as ``q, k, v = qkv`` does)
        # instead of each adding a zero-filled copy of x (12 adds and 18
        # copies a step of the flagship, 0.8 ms on an H100). A lone slice
        # (BERT's first position of 128) indexes: an unbind's backward
        # would fill a zero tensor for every other index
        parts = ctx.run_memo(name, ('unbind', a), lambda: x.unbind(a))
        ctx.out(op, 'Out', parts[s].unsqueeze(a))
        return
    ctx.out(op, 'Out', x[tuple(idx)])


def _axis_slices(ctx, name, axis):
    """How many `slice` ops of the program cut variable ``name`` along
    ``axis`` alone (counted once a run plan)."""
    return ctx.memo(('axis_slices', name, axis), lambda: sum(
        1 for op in ctx.block.ops if op.type == 'slice'
        and op.input('Input') == [name] and list(op.attr('axes')) == [axis]))


@register_op('gather', share_lod=False)
def _gather(ctx, op):
    ctx.out(op, 'Out', gather(ctx.in1(op, 'X'), ctx.in1(op, 'Index')))


@register_op('top_k')
def _top_k(ctx, op):
    vals, idx = torch.topk(ctx.in1(op, 'X'), op.attr('k', 1), dim=-1)
    ctx.out(op, 'Out', vals)
    ctx.out(op, 'Indices', idx)


@register_op('add_position_encoding')
def _add_position_encoding(ctx, op):
    x = ctx.in1(op, 'X')                    # (N, L, D)
    L, D = x.shape[-2], x.shape[-1]
    table = ctx.memo(('position_encoding', L, D), lambda: torch.from_numpy(
        position_encoding_table(L, D)).to(x.device))
    ctx.out(op, 'Out', add_position_encoding(
        x, op.attr('alpha', 1.0), op.attr('beta', 1.0), table=table))


@register_op('get_tensor_from_selected_rows')
def _get_tensor_from_selected_rows(ctx, op):
    """A SelectedRows' values tensor (a dense input passes as it is)."""
    x = ctx.in1(op, 'X')
    ctx.out(op, 'Out', x.values if isinstance(x, SelectedRows) else x)


@register_op('merge_selected_rows')
def _merge_selected_rows(ctx, op):
    """A SelectedRows with its duplicate rows summed
    (`SelectedRows.merged`: the freed slots carry the sentinel row)."""
    x = ctx.in1(op, 'X')
    if isinstance(x, SelectedRows):
        x = SelectedRows(*x.merged(), x.height)
    ctx.out(op, 'Out', x)
