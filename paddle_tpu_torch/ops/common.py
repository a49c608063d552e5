"""Helpers the op lowerings share: the port's own copy of
paddle_tpu/ops/common.py (`broadcast_y_to`, `flatten_to_2d`) on torch
tensors, and an op attr's dtype as a torch dtype."""
from ..core.types import torch_dtype

__all__ = ['attr_dtype', 'broadcast_y_to', 'flatten_to_2d']


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
