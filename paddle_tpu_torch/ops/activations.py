"""Activation ops of a Program: the 36 of paddle_tpu/ops/activations.py.

The port's own copy of the JAX module: each op is one plain elementwise
PyTorch expression of the jnp one, with autograd's gradients, and every
attribute takes the JAX default. GELU is the FFN's (ops/ffn_ops.py
`_gelu`), the form jax.nn.gelu(approximate=False) computes. Where the
two libraries' forms differ, the JAX one is written out:

- ``jnp.clip``, ``jnp.maximum`` and ``jnp.minimum`` give half of the
  gradient to each side of a tie; ``torch.clamp`` gives all of it to x.
  So the clips (``brelu``, ``relu6``, ``hard_sigmoid``, ``soft_relu``)
  run on ops/common.py `clip`, which splits ties as JAX does.
- ``jax.nn.softplus`` is ``logaddexp(x, 0)`` at every x
  (``F.softplus`` turns into x above 20), and ``jax.nn.log_sigmoid`` is
  ``-softplus(-x)``.
- ``jnp.abs``'s gradient at 0 is 1, ``torch.abs``'s 0 (ops/common.py
  `abs_`).
- ``round`` is half-to-even in both.

The JAX lowering's NHWC-twin branch (a layout of its conv stacks) has no
counterpart here: every op takes the plain branch.
"""
import torch

from ..core.registry import register_op
from .common import abs_, clip as _clip
from .ffn_ops import _gelu

__all__ = []


def _register_act(name, fn, attrs=()):
    @register_op(name)
    def _lower(ctx, op):
        kw = {a: op.attr(a, d) for a, d in attrs}
        ctx.out(op, 'Out', fn(ctx.in1(op, 'X'), **kw))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _elu(x, alpha):
    return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


_register_act('sigmoid', torch.sigmoid)
_register_act('logsigmoid', lambda x: -_softplus(-x))
_register_act('exp', torch.exp)
_register_act('relu', torch.relu)
_register_act('gelu', _gelu)
_register_act('tanh', torch.tanh)
_register_act('sqrt', torch.sqrt)
_register_act('rsqrt', torch.rsqrt)
_register_act('abs', abs_)
_register_act('ceil', torch.ceil)
_register_act('floor', torch.floor)
_register_act('cos', torch.cos)
_register_act('sin', torch.sin)
_register_act('round', torch.round)
_register_act('reciprocal', lambda x: 1.0 / x)
_register_act('log', torch.log)
_register_act('square', torch.square)
_register_act('softplus', _softplus)
_register_act('softsign', lambda x: x / (abs_(x) + 1))
_register_act('tanh_shrink', lambda x: x - torch.tanh(x))

_register_act('softshrink',
              lambda x, lambda_: torch.where(
                  x > lambda_, x - lambda_,
                  torch.where(x < -lambda_, x + lambda_, 0.0)),
              attrs=(('lambda_', 0.5),))
_register_act('brelu', lambda x, t_min, t_max: _clip(x, t_min, t_max),
              attrs=(('t_min', 0.0), ('t_max', 24.0)))
_register_act('soft_relu',
              lambda x, threshold: torch.log1p(
                  torch.exp(_clip(x, -threshold, threshold))),
              attrs=(('threshold', 40.0),))
_register_act('pow', lambda x, factor: torch.pow(x, factor),
              attrs=(('factor', 1.0),))
_register_act('stanh',
              lambda x, scale_a, scale_b: scale_b * torch.tanh(scale_a * x),
              attrs=(('scale_a', 0.67), ('scale_b', 1.7159)))
_register_act('relu6', lambda x, threshold: _clip(x, 0.0, threshold),
              attrs=(('threshold', 6.0),))
_register_act('leaky_relu',
              lambda x, alpha: torch.where(x >= 0, x, alpha * x),
              attrs=(('alpha', 0.02),))
_register_act('elu', _elu, attrs=(('alpha', 1.0),))
_register_act('hard_shrink',
              lambda x, threshold: torch.where(torch.abs(x) > threshold, x,
                                               0.0),
              attrs=(('threshold', 0.5),))
_register_act('hard_sigmoid',
              lambda x, slope, offset: _clip(slope * x + offset, 0.0, 1.0),
              attrs=(('slope', 0.2), ('offset', 0.5)))
_register_act('swish', lambda x, beta: x * torch.sigmoid(beta * x),
              attrs=(('beta', 1.0),))
_register_act('thresholded_relu',
              lambda x, threshold: torch.where(x > threshold, x, 0.0),
              attrs=(('threshold', 1.0),))
_register_act('selu', lambda x, scale, alpha: scale * _elu(x, alpha),
              attrs=(('scale', 1.0507009873554805),
                     ('alpha', 1.6732632423543772)))
_register_act('prelu_simple',
              lambda x, alpha: torch.where(x >= 0, x, alpha * x),
              attrs=(('alpha', 0.25),))


@register_op('prelu')
def _prelu(ctx, op):
    """``Alpha`` one value (mode ``all``), one a channel (``channel``,
    axis 1) or one an element of a sample (``element``); kept at x's rank,
    so that its dtype promotes with x's as the JAX reshape's does."""
    x, alpha = ctx.in1(op, 'X'), ctx.in1(op, 'Alpha')
    mode = op.attr('mode', 'all')
    if mode == 'all':
        a = alpha.reshape((1,) * x.dim())
    elif mode == 'channel':
        a = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    else:
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    ctx.out(op, 'Out', torch.where(x >= 0, x, a * x))


@register_op('maxout')
def _maxout(ctx, op):
    """NCHW: the channels in ``groups`` consecutive runs, each run's
    largest (a tie's gradient split evenly, as JAX's max)."""
    x = ctx.in1(op, 'X')
    groups = op.attr('groups')
    n, c, h, w = x.shape
    ctx.out(op, 'Out', x.reshape(n, c // groups, groups, h, w).amax(dim=2))
