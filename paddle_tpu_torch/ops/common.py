"""Helpers the op lowerings share: the port's own copy of
paddle_tpu/ops/common.py (`broadcast_y_to`, `flatten_to_2d`) on torch
tensors, an op attr's dtype as a torch dtype, and the gradient rules of
``jnp.clip`` (`clip`) and ``jnp.abs`` (`abs_`)."""
import torch

from ..core.types import torch_dtype

__all__ = ['abs_', 'attr_dtype', 'broadcast_y_to', 'clip', 'flatten_to_2d']


def attr_dtype(attr_val, default='float32'):
    """The torch dtype of a numpy dtype (or name) held in an op attr."""
    return torch_dtype(default if attr_val is None else attr_val)


def broadcast_y_to(x, y, axis):
    """Fluid's elementwise broadcast: y's dims align with x's starting at
    ``axis`` (-1: trailing alignment, as numpy broadcasts)."""
    if axis is None:
        axis = -1
    if y.dim() == x.dim() or y.dim() == 0 or axis == -1:
        return y
    target = [1] * x.dim()
    for i, s in enumerate(y.shape):
        target[axis + i] = s
    return y.reshape(target)


def flatten_to_2d(x, num_col_dims):
    """The ``mul`` op's x_num_col_dims rule: the leading ``num_col_dims``
    axes become rows, the rest columns."""
    lead = 1
    for s in x.shape[:num_col_dims]:
        lead *= s
    tail = 1
    for s in x.shape[num_col_dims:]:
        tail *= s
    return x.reshape(lead, tail)


def clip(x, lo=None, hi=None):
    """``jnp.clip(x, lo, hi)``: ``jnp.maximum`` with lo, then
    ``jnp.minimum`` with hi, each bound in x's dtype. At a tie JAX gives
    half of the gradient to each side, as ``torch.maximum`` and
    ``torch.minimum`` do (``torch.clamp`` gives all of it to x)."""
    if lo is not None:
        x = torch.maximum(x, torch.full((), lo, dtype=x.dtype,
                                        device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.full((), hi, dtype=x.dtype,
                                        device=x.device))
    return x


def abs_(x):
    """``jnp.abs``, whose gradient at 0 is 1 (``torch.abs``'s is 0)."""
    return torch.where(x >= 0, x, -x)
