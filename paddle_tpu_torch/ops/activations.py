"""Activation ops of a Program: ``relu``, ``gelu`` (exact, erf), ``tanh``
and ``square``.

The port's own copy of the activations of paddle_tpu/ops/activations.py
that its programs run (`fc(act=...)` appends one after the bias add):
plain elementwise PyTorch, as the JAX package's are plain jnp, with
autograd's gradients. GELU is the FFN's (ops/ffn_ops.py `_gelu`), the
form jax.nn.gelu(approximate=False) computes.
"""
import torch

from ..core.registry import register_op
from .ffn_ops import _gelu

__all__ = []


def _register_act(name, fn):
    @register_op(name)
    def _lower(ctx, op):
        ctx.out(op, 'Out', fn(ctx.in1(op, 'X')))


_register_act('relu', torch.relu)
_register_act('gelu', _gelu)
_register_act('tanh', torch.tanh)
_register_act('square', torch.square)
