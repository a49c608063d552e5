"""Compare and logical ops.

The port's own lowerings of paddle_tpu/ops/compare_ops.py: `equal`,
`not_equal`, `less_than`, `less_equal`, `greater_than`, `greater_equal`,
`logical_and`, `logical_or`, `logical_xor` (``Y`` broadcast along the
``axis`` attr as the elementwise ops broadcast it), `logical_not`, and
`isfinite`, which is one bool, all of ``X`` finite, of shape [1] (not an
elementwise mask). Plain PyTorch: the JAX package computes them in
``jnp`` outside any kernel.
"""
import torch

from ..core.registry import register_op
from .common import broadcast_y_to

__all__ = []


def _register_cmp(name, fn):
    @register_op(name)
    def _lower(ctx, op):
        x, y = ctx.in1(op, 'X'), ctx.in1(op, 'Y')
        ctx.out(op, 'Out', fn(x, broadcast_y_to(x, y, op.attr('axis', -1))))


_register_cmp('equal', torch.eq)
_register_cmp('not_equal', torch.ne)
_register_cmp('less_than', torch.lt)
_register_cmp('less_equal', torch.le)
_register_cmp('greater_than', torch.gt)
_register_cmp('greater_equal', torch.ge)
_register_cmp('logical_and', torch.logical_and)
_register_cmp('logical_or', torch.logical_or)
_register_cmp('logical_xor', torch.logical_xor)


@register_op('logical_not')
def _logical_not(ctx, op):
    ctx.out(op, 'Out', torch.logical_not(ctx.in1(op, 'X')))


@register_op('isfinite')
def _isfinite(ctx, op):
    ctx.out(op, 'Out', torch.isfinite(ctx.in1(op, 'X')).all().reshape(1))
