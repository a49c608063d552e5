"""Convolution, pooling and batch norm of a Program: ``conv2d``,
``depthwise_conv2d``, ``pool2d`` and ``batch_norm``.

Counterparts in paddle_tpu/ops/nn_ops.py: `_conv2d`, `_depthwise_conv2d`,
`_pool` with `_pool2d`, and `_batch_norm`. No Pallas kernel lies here: the
JAX package computes the convolution with ``lax.conv_general_dilated`` and
the pooling with ``lax.reduce_window``, so the port computes them with
library calls (cuDNN's convolution through ``F.conv2d``, ATen's pooling),
as a plain product stays ``torch.matmul``. Everything is NCHW: the JAX
convolution's channels-minor twin is a TPU layout device inside its
lowering and never shows in the program.

- :func:`conv2d` is float32 with TF32 off whatever
  ``torch.backends.cudnn.allow_tf32`` (True by default) says, backward
  included: cuDNN would otherwise round the operands to TF32, about 1e-3
  off the reference. Under the op's AMP mark (``policy``) the operands are
  cast to bf16, cuDNN accumulates in float32 and returns bf16 (no flag to
  clear, so no lock), and the result is cast to the variable's dtype, as
  the JAX branch computes (its ``preferred_element_type`` is None for
  bf16); under the keep mark (``keep``, core/amp.py `op_keeps`) the bf16
  result is returned as it is.
- :func:`pool2d` follows `_pool`: the right side padded as far as
  ``ceil_mode`` needs, -inf padding for max, ``exclusive`` dividing by
  the count of in-bounds elements, global and adaptive windows. It pools
  an explicitly padded tensor with unpadded windows, since torch's own
  ``ceil_mode`` drops a window that starts in the right padding and its
  ``count_include_pad=False`` is not ``exclusive`` there.
- `batch_norm` takes the statistics in float32 (a float64 input's in
  float64) with a two-pass variance
  (a channel of large mean and tiny variance keeps its variance) from its
  input (cast to bf16 under an AMP mark), normalizes with them (a bf16
  ``x - mean`` promotes to float32) and casts ``Y`` back to that input's
  dtype: a bf16 activation stays bf16, marked or not;
  ``MeanOut = momentum * mean + (1 - momentum) * batch_mean`` in training,
  ``SavedVariance = 1 / sqrt(var + eps)``, and the moving statistics under
  ``is_test`` or ``use_global_stats``. ``MeanOut`` and ``VarianceOut``
  name the persistable ``Mean`` and ``Variance``, so the run plan writes
  them back to the scope (core/lowering.py `analyze_state`).
"""
import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..core import amp
from ..core.registry import register_op

__all__ = ['conv2d', 'pool2d']

# torch.backends.cudnn.allow_tf32 is process-wide: one conv at a time
# sets it and puts it back
_tf32_lock = threading.Lock()


@contextlib.contextmanager
def _f32_cudnn(x):
    """cuDNN's float32 convolutions without TF32 for the calls inside, for
    a float32 ``x`` on a CUDA device (the CPU has no TF32, and a bf16
    convolution none to clear)."""
    if x.device.type != 'cuda' or x.dtype != torch.float32:
        yield
        return
    with _tf32_lock:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` whose forward and backward both run without TF32."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        with _f32_cudnn(x):
            return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        with _f32_cudnn(x):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dy, x, w, None, stride, padding, dilation, False, [0, 0],
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False])
        return dx, dw, None, None, None, None


def conv2d(x, w, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups=1,
           policy=None, keep=False):
    """NCHW ``x`` convolved with the OIHW filter ``w`` (I = C / groups):
    float32 without TF32, or under ``policy`` bf16 operands with the bf16
    result cast back to ``x``'s dtype (kept bf16 with ``keep``).
    Differentiable."""
    out_dtype = x.dtype
    x, w = amp.cast_compute(policy, x, w)
    out = _Conv2d.apply(x, w, list(stride), list(padding), list(dilation),
                        int(groups))
    return out.to(amp.result_dtype(policy, x, out_dtype, keep))


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


@register_op('conv2d')
def _conv2d_op(ctx, op):
    ctx.out(op, 'Output', conv2d(
        ctx.in1(op, 'Input'), ctx.in1(op, 'Filter'),
        _pair(op.attr('strides', [1, 1])), _pair(op.attr('paddings', [0, 0])),
        _pair(op.attr('dilations', [1, 1])), op.attr('groups', 1) or 1,
        amp.op_policy(op), amp.op_keeps(op)))


@register_op('depthwise_conv2d')
def _depthwise_conv2d_op(ctx, op):
    _conv2d_op(ctx, op)


def pool2d(x, ksize, strides=(1, 1), pads=(0, 0), ptype='max',
           exclusive=True, adaptive=False, global_pool=False,
           ceil_mode=False):
    """Window pooling of NCHW ``x`` by `_pool`'s rules (module
    docstring)."""
    sp = tuple(x.shape[2:4])
    if global_pool:
        ksize, pads, strides = sp, (0, 0), (1, 1)
    if adaptive:
        # the output size is ksize, in even splits
        strides = tuple(i // o for i, o in zip(sp, ksize))
        ksize = tuple(i - (o - 1) * s for i, o, s in zip(sp, ksize, strides))
        pads = (0, 0)
    lo_hi = [(p, p) for p in pads]
    if ceil_mode:
        lo_hi = []
        for i, (p, k, s) in enumerate(zip(pads, ksize, strides)):
            out_dim = -(-(sp[i] + 2 * p - k) // s) + 1
            lo_hi.append((p, max(p, (out_dim - 1) * s + k - sp[i] - p)))
    # F.pad takes the last axis first
    pad = lo_hi[1] + lo_hi[0]
    ksize, strides = tuple(ksize), tuple(strides)
    if ptype == 'max':
        xp = F.pad(x, pad, value=float('-inf')) if any(pad) else x
        return F.max_pool2d(xp, ksize, strides)
    xp = F.pad(x, pad) if any(pad) else x
    # window sums
    s = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
    if exclusive:
        ones = torch.ones((1, 1) + sp, dtype=x.dtype, device=x.device)
        ones = F.pad(ones, pad) if any(pad) else ones
        return s / F.avg_pool2d(ones, ksize, strides, divisor_override=1)
    return s / float(np.prod(ksize))


@register_op('pool2d')
def _pool2d_op(ctx, op):
    ctx.out(op, 'Out', pool2d(
        ctx.in1(op, 'X'), _pair(op.attr('ksize')),
        _pair(op.attr('strides', [1, 1])), _pair(op.attr('paddings', [0, 0])),
        op.attr('pooling_type', 'max'), op.attr('exclusive', True),
        op.attr('adaptive', False), op.attr('global_pooling', False),
        op.attr('ceil_mode', False)))


@register_op('batch_norm')
def _batch_norm_op(ctx, op):
    x = amp.cast_compute(amp.op_policy(op), ctx.in1(op, 'X'))
    scale, bias = ctx.in1(op, 'Scale'), ctx.in1(op, 'Bias')
    mean, var = ctx.in1(op, 'Mean'), ctx.in1(op, 'Variance')
    momentum = op.attr('momentum', 0.9)
    eps = op.attr('epsilon', 1e-5)
    if op.attr('data_layout', 'NCHW') == 'NCHW':
        axes = (0,) + tuple(range(2, x.dim()))
        bshape = (1, -1) + (1,) * (x.dim() - 2)
    else:
        axes = tuple(range(x.dim() - 1))
        bshape = (1,) * (x.dim() - 1) + (-1,)
    if op.attr('use_global_stats', False) or op.attr('is_test', False):
        m, v = mean, var
        ctx.out(op, 'MeanOut', mean)
        ctx.out(op, 'VarianceOut', var)
    else:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        m = xf.mean(dim=axes)
        v = ((xf - m.reshape(bshape)) ** 2).mean(dim=axes)
        ctx.out(op, 'MeanOut', momentum * mean + (1.0 - momentum) * m.detach())
        ctx.out(op, 'VarianceOut',
                momentum * var + (1.0 - momentum) * v.detach())
    if ctx.needed(op, 'SavedMean'):
        ctx.out(op, 'SavedMean', m)
    if ctx.needed(op, 'SavedVariance'):
        ctx.out(op, 'SavedVariance', 1.0 / torch.sqrt(v + eps))
    y = (x - m.reshape(bshape)) / torch.sqrt(v.reshape(bshape) + eps)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    ctx.out(op, 'Y', y.to(x.dtype))
