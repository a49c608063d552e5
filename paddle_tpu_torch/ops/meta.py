"""Framework ops: ``backward``, constants, ``assign``, ``scale``, ``clip``
and ``clip_by_norm``.

The port's own lowerings of paddle_tpu/ops/meta.py's `backward`,
`fill_constant`, `assign`, `assign_value`, `scale`, `clip` and
`clip_by_norm` (dense, and on a SelectedRows gradient as the JAX
lowerings take one), in plain PyTorch (the JAX package lowers them to
plain XLA too).
"""
import numpy as np
import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows
from .common import attr_dtype

__all__ = []


@register_op('backward')
def _backward(ctx, op):
    # core/lowering.py lower_block runs the backward meta-op itself
    raise RuntimeError("'backward' op must be handled by lower_block")


@register_op('fill_constant')
def _fill_constant(ctx, op):
    ctx.out(op, 'Out', torch.full(tuple(op.attr('shape', ())),
                                  op.attr('value', 0.0),
                                  dtype=attr_dtype(op.attr('dtype')),
                                  device=ctx.device))


@register_op('assign')
def _assign(ctx, op):
    ctx.out(op, 'Out', ctx.in1(op, 'X'))


@register_op('assign_value')
def _assign_value(ctx, op):
    """The op's values as a tensor, built once per run plan; a persistable
    output (a parameter's NumpyArray init, which the optimizer then updates
    in place) gets a copy of its own."""
    def build():
        arr = np.asarray(op.attr('values'),
                         dtype=np.dtype(op.attr('dtype') or 'float32'))
        return torch.from_numpy(arr.reshape(tuple(op.attr('shape')))).to(
            ctx.device)

    v = ctx.memo(('assign_value', ctx.op_index), build)
    var = ctx.var(op.output('Out')[0])
    ctx.out(op, 'Out', v.clone() if var is not None and var.persistable
            else v)


@register_op('scale')
def _scale(ctx, op):
    """``x * scale + bias`` (``bias_after_scale``) or ``(x + bias) * scale``;
    a bias of 0 is not added (it changes nothing but the sign of a
    zero). A SelectedRows keeps its rows under a bias of 0 and densifies
    under any other (the bias would touch every row)."""
    x = ctx.in1(op, 'X')
    scale = op.attr('scale', 1.0)
    bias = op.attr('bias', 0.0)
    if isinstance(x, SelectedRows):
        if not bias:
            ctx.out(op, 'Out', x.scale(scale))
            return
        x = x.to_dense()
    if not bias:
        out = x * scale
    elif op.attr('bias_after_scale', True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.out(op, 'Out', out.to(x.dtype))


@register_op('clip')
def _clip(ctx, op):
    """A SelectedRows merges its duplicate rows first: a clip does not
    distribute over their sum."""
    x = ctx.in1(op, 'X')
    lo, hi = op.attr('min'), op.attr('max')
    if isinstance(x, SelectedRows):
        rows, vals = x.merged()
        ctx.out(op, 'Out', SelectedRows(rows, torch.clamp(vals, lo, hi),
                                        x.height))
        return
    ctx.out(op, 'Out', torch.clamp(x, lo, hi))


def _norm_factor(x, max_norm):
    norm = torch.sqrt((x.float() ** 2).sum())
    return torch.where(norm > max_norm,
                       max_norm / torch.clamp(norm, min=1e-12),
                       torch.ones_like(norm)).to(x.dtype)


@register_op('clip_by_norm')
def _clip_by_norm(ctx, op):
    """``x * max_norm / norm`` where the float32 L2 norm of all of ``x``
    passes ``max_norm``, else ``x``; the factor is a tensor on the device
    (no host read), cast to ``x``'s dtype as the JAX lowering casts it. A
    SelectedRows takes the norm of its merged rows."""
    x = ctx.in1(op, 'X')
    max_norm = op.attr('max_norm')
    if isinstance(x, SelectedRows):
        rows, vals = x.merged()
        ctx.out(op, 'Out', SelectedRows(
            rows, vals * _norm_factor(vals, max_norm), x.height))
        return
    ctx.out(op, 'Out', x * _norm_factor(x, max_norm))
