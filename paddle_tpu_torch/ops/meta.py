"""Framework ops: ``backward``, constants, ``assign``, ``scale``, ``clip``
and ``clip_by_norm``.

The port's own lowerings of paddle_tpu/ops/meta.py's `backward`,
`fill_constant`, `assign`, `assign_value`, `scale`, `clip` and
`clip_by_norm` (dense: a SelectedRows gradient waits for sparse
gradients), in plain PyTorch (the JAX package lowers them to plain XLA
too).
"""
import numpy as np
import torch

from ..core.registry import register_op
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
    zero)."""
    x = ctx.in1(op, 'X')
    scale = op.attr('scale', 1.0)
    bias = op.attr('bias', 0.0)
    if not bias:
        out = x * scale
    elif op.attr('bias_after_scale', True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.out(op, 'Out', out.to(x.dtype))


@register_op('clip')
def _clip(ctx, op):
    ctx.out(op, 'Out', torch.clamp(ctx.in1(op, 'X'), op.attr('min'),
                                   op.attr('max')))


@register_op('clip_by_norm')
def _clip_by_norm(ctx, op):
    """``x * max_norm / norm`` where the float32 L2 norm of all of ``x``
    passes ``max_norm``, else ``x``; the factor is a tensor on the device
    (no host read), cast to ``x``'s dtype as the JAX lowering casts it."""
    x = ctx.in1(op, 'X')
    max_norm = op.attr('max_norm')
    norm = torch.sqrt((x.float() ** 2).sum())
    factor = torch.where(norm > max_norm,
                         max_norm / torch.clamp(norm, min=1e-12),
                         torch.ones_like(norm))
    ctx.out(op, 'Out', x * factor.to(x.dtype))
