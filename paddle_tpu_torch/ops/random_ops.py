"""Dropout in the ``upscale_in_train`` form, and the FFN's keep mask.

Counterpart of paddle_tpu/ops/random_ops.py (the `dropout` lowering) and of
the fused FFN tail's `_dropout_mask` in paddle_tpu/ops/ffn_ops.py. The JAX
package draws ``keep = bernoulli(key, 1 - p)`` from its counted threefry
stream; here every draw takes an explicit ``torch.Generator`` on the
tensor's device (there is no global RNG), so the two packages draw
different bits from the same seed and agree only at ``p = 0``. Neither side
has a Pallas kernel here: the draw and the multiply are plain PyTorch.

The program ops (paddle_tpu/ops/random_ops.py): `dropout` (both
implementations, train and test), `uniform_random`, `gaussian_random` and
`truncated_gaussian_random`, drawing from the run's generator (or, with a
``seed`` attr, from one seeded by (seed, op index)); core/lowering.py says
how a run's generator is seeded.
"""
import math

import torch

from ..core.registry import register_op
from .common import attr_dtype

__all__ = ['dropout', 'keep_mask', 'train_dropout']


def _check_generator(generator, device):
    if generator is None:
        raise ValueError('dropout needs an explicit torch.Generator: the '
                         'port keeps no global random state')
    if torch.device(generator.device).type != torch.device(device).type:
        raise ValueError('the generator lies on %s, the tensor on %s'
                         % (generator.device, device))


def keep_mask(shape, p, generator, device):
    """The float32 keep mask of dropout probability ``p``, pre-scaled for
    ``upscale_in_train``: 1 / (1 - p) where a uniform draw is below 1 - p,
    else 0 (all 0 when p >= 1)."""
    _check_generator(generator, device)
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    if p >= 1.0:
        return torch.zeros_like(u)
    return (u < 1.0 - p).to(torch.float32) / (1.0 - p)


def dropout(x, p, generator=None):
    """``upscale_in_train`` dropout: ``x * keep / (1 - p)`` with keep drawn
    at rate 1 - p (0 everywhere when p >= 1); ``x`` itself when p is 0."""
    if not p:
        return x
    _check_generator(generator, x.device)
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=torch.float32)
    if p >= 1.0:
        return x * 0.0
    return x * (u < 1.0 - p).to(x.dtype) / (1.0 - p)


# ---------------------------------------------------------------------------
# the program ops


def train_dropout(x, p, upscale, generator):
    """The dropout op in training: (out, the 0/1 keep mask) with keep drawn
    at rate 1 - p; ``upscale`` (``upscale_in_train``) divides the kept
    values by 1 - p (and gives 0 everywhere at p >= 1), else
    (``downgrade_in_infer``) they pass as they are."""
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=torch.float32)
    mask = (u < 1.0 - p).to(x.dtype)
    if not upscale:
        return x * mask, mask
    if p < 1.0:
        return x * mask / (1.0 - p), mask
    return torch.zeros_like(x), mask


def _generator(ctx, op):
    return ctx.op_rng() if op.attr('seed', 0) else ctx.rng()


@register_op('dropout', needs_rng=lambda op: not op.attr('is_test', False))
def _dropout_op(ctx, op):
    x = ctx.in1(op, 'X')
    p = op.attr('dropout_prob', 0.5)
    upscale = op.attr('dropout_implementation',
                      'downgrade_in_infer') == 'upscale_in_train'
    if op.attr('is_test', False):
        ctx.out(op, 'Out', x if upscale else x * (1.0 - p))
        if ctx.needed(op, 'Mask'):
            ctx.out(op, 'Mask', torch.ones_like(x))
        return
    out, mask = train_dropout(x, p, upscale, _generator(ctx, op))
    ctx.out(op, 'Out', out)
    if ctx.needed(op, 'Mask'):
        ctx.out(op, 'Mask', mask)


@register_op('uniform_random', needs_rng=True)
def _uniform_random(ctx, op):
    lo, hi = op.attr('min', -1.0), op.attr('max', 1.0)
    u = torch.rand(tuple(op.attr('shape')), generator=_generator(ctx, op),
                   device=ctx.device, dtype=torch.float32)
    ctx.out(op, 'Out', (u * (hi - lo) + lo).to(attr_dtype(op.attr('dtype'))))


@register_op('gaussian_random', needs_rng=True)
def _gaussian_random(ctx, op):
    z = torch.randn(tuple(op.attr('shape')), generator=_generator(ctx, op),
                    device=ctx.device, dtype=torch.float32)
    out = op.attr('mean', 0.0) + op.attr('std', 1.0) * z
    ctx.out(op, 'Out', out.to(attr_dtype(op.attr('dtype'))))


@register_op('truncated_gaussian_random', needs_rng=True)
def _truncated_gaussian_random(ctx, op):
    """A standard normal truncated to [-2, 2] (as jax.random.truncated_normal
    draws it for the JAX op), by the inverse CDF of a uniform draw."""
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))
    lo, hi = cdf(-2.0), cdf(2.0)
    u = torch.rand(tuple(op.attr('shape')), generator=_generator(ctx, op),
                   device=ctx.device, dtype=torch.float32)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    out = op.attr('mean', 0.0) + op.attr('std', 1.0) * z.clamp(-2.0, 2.0)
    ctx.out(op, 'Out', out.to(attr_dtype(op.attr('dtype'))))
