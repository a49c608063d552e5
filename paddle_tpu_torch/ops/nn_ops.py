"""LayerNorm and the fused residual-add + LayerNorm.

Counterparts in paddle_tpu/ops/nn_ops.py: the `layer_norm` lowering and
`fused_ln_residual` with its Pallas kernels `_ln_res_fwd_pallas` and
`_ln_res_bwd_pallas`.

:func:`fused_ln_residual` on a CUDA tensor launches the forward of
``csrc/ln_residual.cu``; on the CPU it runs :func:`_ln_res_ref`, the TPU
kernel's arithmetic in the same two-pass order. Where autograd records it
(grad mode on and an input that requires grad) it is an
``autograd.Function`` whose backward launches the backward kernel of the
same source for dx (the gradient of both x and r), or runs
:func:`_ln_res_bwd_ref` on the CPU; the scale and bias gradients are plain
column sums over the recomputed x_hat, as in the JAX package. Serving calls
it under ``no_grad`` and gets the bare forward. :func:`layer_norm` is plain
PyTorch everywhere: in the JAX package it is an XLA lowering with no Pallas
kernel (the decode path uses it once per forward, at layer 0's entry).

The program ops (paddle_tpu/ops/nn_ops.py): `fused_ln_residual` calls
:func:`fused_ln_residual` where the JAX op is fusable (scale and bias
given, the normalized axis the last), and otherwise runs the JAX op's own
composition, elementwise_add then layer_norm over ``begin_norm_axis``..;
`layer_norm`, `softmax`, `softmax_with_cross_entropy` (hard labels:
ce_ops.fused_softmax_ce on [N, V] logits; soft labels: log-softmax) and
`cross_entropy` (of probabilities clipped to [1e-20, 1]; a hard label is
picked as ``jnp.take_along_axis`` picks it: a negative one wraps, one out
of range gives NaN, ``ignore_index`` gives 0) as the JAX lowerings compute
them.
"""
import ctypes

import torch

from .. import native
from ..core.registry import register_op
from . import ce_ops, kernel_tier

__all__ = ['layer_norm', 'fused_ln_residual']

_fns = {}


def _kernel(which):
    fn = _fns.get(which)
    if fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int64
        if which == 'fwd':
            fn = native.function('ln_residual', 'ptt_ln_residual_fwd',
                                 [P, P, P, P, P, P, P, P, I, I,
                                  ctypes.c_float, P])
        else:
            fn = native.function('ln_residual', 'ptt_ln_residual_bwd',
                                 [P, P, P, P, P, P, P, I, I, P])
        _fns[which] = fn
    return fn


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis, as the JAX `layer_norm` lowering
    computes it: ``(x - mean) / sqrt(var + eps) * scale + bias``."""
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * scale + bias


def _ln_res_ref(x, r, scale, bias, eps):
    """Plain version of the kernel: (y, s, mean, rstd) for rows [N, D]."""
    s = x + r
    m = s.mean(dim=-1)
    c = s - m[:, None]
    rstd = 1.0 / torch.sqrt((c * c).mean(dim=-1) + eps)
    y = c * rstd[:, None] * scale + bias
    return y, s, m, rstd


def _ln_res_bwd_ref(s, m, rstd, scale, dy, ds):
    """Plain version of the backward kernel: dx [N, D]."""
    xhat = (s - m[:, None]) * rstd[:, None]
    dyw = dy * scale
    mean1 = dyw.mean(dim=-1, keepdim=True)
    mean2 = (dyw * xhat).mean(dim=-1, keepdim=True)
    return rstd[:, None] * (dyw - mean1 - xhat * mean2) + ds


# the widest row the CUDA kernels take (csrc/ln_residual.cu kMaxD), the JAX
# package's Pallas limit; rows up to 4096 stay in registers
_MAX_D = 8192


def _check_width(D):
    if D > _MAX_D:
        raise ValueError('fused_ln_residual: the CUDA kernels take D <= %d, '
                         'got %d' % (_MAX_D, D))


def _ln_res_fwd(x2, r2, scale, bias, eps):
    """(y, s, mean, rstd) for rows [N, D]: the kernel on CUDA tensors, the
    plain version on the CPU."""
    if not kernel_tier.on_cuda(x2, r2, scale, bias):
        return _ln_res_ref(x2, r2, scale, bias, eps)
    n, D = x2.shape
    _check_width(D)
    dev = x2.device
    kernel_tier.require(x2, 'x', (n, D))
    kernel_tier.require(r2, 'residual', (n, D), device=dev)
    kernel_tier.require(scale, 'scale', (D,), device=dev)
    kernel_tier.require(bias, 'bias', (D,), device=dev)
    s = torch.empty_like(x2)
    y = torch.empty_like(x2)
    m = torch.empty((n,), dtype=torch.float32, device=dev)
    rs = torch.empty((n,), dtype=torch.float32, device=dev)
    rc = _kernel('fwd')(x2.data_ptr(), r2.data_ptr(), scale.data_ptr(),
                        bias.data_ptr(), s.data_ptr(), y.data_ptr(),
                        m.data_ptr(), rs.data_ptr(), n, D, float(eps),
                        kernel_tier.stream_ptr(x2))
    native.check(rc, 'fused_ln_residual')
    kernel_tier.count('fused_ln_residual')
    return y, s, m, rs


def _ln_res_bwd(s, m, rstd, scale, dy, ds):
    """dx [N, D]: the kernel on CUDA tensors, the plain version on the
    CPU."""
    if not kernel_tier.on_cuda(s, m, rstd, scale, dy, ds):
        return _ln_res_bwd_ref(s, m, rstd, scale, dy, ds)
    n, D = s.shape
    _check_width(D)
    dev = s.device
    kernel_tier.require(s, 's', (n, D))
    kernel_tier.require(m, 'mean', (n,), device=dev)
    kernel_tier.require(rstd, 'rstd', (n,), device=dev)
    kernel_tier.require(scale, 'scale', (D,), device=dev)
    kernel_tier.require(dy, 'dy', (n, D), device=dev)
    kernel_tier.require(ds, 'ds', (n, D), device=dev)
    dx = torch.empty_like(s)
    rc = _kernel('bwd')(s.data_ptr(), m.data_ptr(), rstd.data_ptr(),
                        scale.data_ptr(), dy.data_ptr(), ds.data_ptr(),
                        dx.data_ptr(), n, D, kernel_tier.stream_ptr(s))
    native.check(rc, 'fused_ln_residual_bwd')
    kernel_tier.count('fused_ln_residual_bwd')
    return dx


class _FusedLNResidual(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, r2, scale, bias, eps):
        y, s, m, rs = _ln_res_fwd(x2, r2, scale, bias, eps)
        ctx.save_for_backward(s, m, rs, scale)
        ctx.mark_non_differentiable(m, rs)
        return y, s, m, rs

    @staticmethod
    def backward(ctx, dy, ds, _dm, _drs):
        s, m, rs, scale = ctx.saved_tensors
        dy = dy.contiguous()
        dx = _ln_res_bwd(s, m, rs, scale, dy, ds.contiguous())
        # scale/bias grads: plain column sums over the recomputed x_hat
        xhat = (s - m[:, None]) * rs[:, None]
        return dx, dx, (dy * xhat).sum(dim=0), dy.sum(dim=0), None


def fused_ln_residual(x, r, scale, bias, eps=1e-5):
    """``s = x + r``; ``y = LayerNorm(s) * scale + bias`` over the last
    axis. ``x`` and ``r`` are [..., D] (flattened to rows internally).
    Returns (y, s, mean, rstd) with y and s shaped like x and the
    statistics [N] f32 (not differentiable). Differentiable in x, r, scale
    and bias where autograd records the call."""
    lead = x.shape[:-1]
    D = x.shape[-1]
    x2 = x.reshape(-1, D)
    r2 = r.reshape(-1, D)
    if kernel_tier.records_grad(x2, r2, scale, bias):
        y, s, m, rs = _FusedLNResidual.apply(x2, r2, scale, bias, eps)
    else:
        y, s, m, rs = _ln_res_fwd(x2, r2, scale, bias, eps)
    return y.reshape(lead + (D,)), s.reshape(lead + (D,)), m, rs


# ---------------------------------------------------------------------------
# the program ops


def _layer_norm_nd(x, scale, bias, eps, bna):
    """The `layer_norm` op over axes bna.. (the JAX lowering's arithmetic:
    the mean, then the mean of the squared deviation): (y, mean, var)."""
    axes = tuple(range(bna, x.dim()))
    m = x.mean(dim=axes, keepdim=True)
    v = ((x - m) ** 2).mean(dim=axes, keepdim=True)
    y = (x - m) / torch.sqrt(v + eps)
    tail = tuple(x.shape[bna:])
    if scale is not None:
        y = y * scale.reshape((1,) * bna + tail)
    if bias is not None:
        y = y + bias.reshape((1,) * bna + tail)
    return y, m.reshape(-1), v.reshape(-1)


@register_op('layer_norm')
def _layer_norm_op(ctx, op):
    x = ctx.in1(op, 'X')
    y, m, v = _layer_norm_nd(x, ctx.in1(op, 'Scale'), ctx.in1(op, 'Bias'),
                             op.attr('epsilon', 1e-5),
                             op.attr('begin_norm_axis', 1))
    ctx.out(op, 'Y', y)
    ctx.out(op, 'Mean', m)
    ctx.out(op, 'Variance', v)


@register_op('fused_ln_residual')
def _fused_ln_residual_op(ctx, op):
    x, r = ctx.in1(op, 'X'), ctx.in1(op, 'Residual')
    scale, bias = ctx.in1(op, 'Scale'), ctx.in1(op, 'Bias')
    eps = op.attr('epsilon', 1e-5)
    bna = op.attr('begin_norm_axis', x.dim() - 1)
    if scale is not None and bias is not None and bna == x.dim() - 1 and \
            x.dim() >= 2:
        y, s, _, _ = fused_ln_residual(x.contiguous(), r.contiguous(),
                                       scale, bias, eps)
    else:
        s = x + r
        y = _layer_norm_nd(s, scale, bias, eps, bna)[0]
    ctx.out(op, 'Y', y)
    ctx.out(op, 'ResidualOut', s)


@register_op('softmax')
def _softmax_op(ctx, op):
    ctx.out(op, 'Out', torch.softmax(ctx.in1(op, 'X'), dim=-1))


@register_op('cross_entropy')
def _cross_entropy_op(ctx, op):
    x, label = ctx.in1(op, 'X'), ctx.in1(op, 'Label')
    xc = x.clamp(1e-20, 1.0)
    if op.attr('soft_label', False):
        ctx.out(op, 'Y', -(label * torch.log(xc)).sum(dim=-1, keepdim=True))
        return
    lab = label.reshape(-1).to(torch.int32)
    n = xc.shape[-1]
    idx = torch.where(lab < 0, lab + n, lab).long()
    valid = ((idx >= 0) & (idx < n))[:, None]
    p = torch.gather(xc, -1, idx.clamp(0, n - 1)[:, None])
    # a fill on the device, not a host value: the op runs inside captured
    # CUDA graphs (a bound training step)
    out = -torch.log(torch.where(valid, p, torch.full_like(p, float('nan'))))
    keep = (lab != op.attr('ignore_index', -100))[:, None]
    ctx.out(op, 'Y', torch.where(keep, out, out.new_zeros(())))


@register_op('softmax_with_cross_entropy')
def _softmax_with_ce_op(ctx, op):
    logits, label = ctx.in1(op, 'Logits'), ctx.in1(op, 'Label')
    if op.attr('soft_label', False):
        log_sm = torch.log_softmax(logits, dim=-1)
        ctx.out(op, 'Softmax', torch.exp(log_sm))
        ctx.out(op, 'Loss', -(label * log_sm).sum(dim=-1, keepdim=True))
        return
    if logits.dim() != 2:
        raise NotImplementedError(
            'softmax_with_cross_entropy with hard labels takes [N, V] '
            'logits, got %s' % (tuple(logits.shape),))
    loss = ce_ops.fused_softmax_ce(logits.contiguous(), label,
                                   op.attr('ignore_index', -100))
    ctx.out(op, 'Loss', loss[:, None])
    if ctx.needed(op, 'Softmax'):
        ctx.out(op, 'Softmax', torch.softmax(logits, dim=-1))
