"""Fused FFN tail: ``y = (gelu(x @ W1 + b1) @ W2 + b2) * mask``.

Counterpart of paddle_tpu/ops/ffn_ops.py `fused_ffn_core` with its Pallas
forward `_ffn_fwd_pallas` and its backward `_ffn_bwd`. GELU is the exact
(erf) form, ``0.5 * x * erfc(-x / sqrt(2))`` as
jax.nn.gelu(approximate=False) computes it. Weights keep the JAX layout
[in, out].

On CUDA tensors the forward makes two launches of ``csrc/ffn_gemm.cu``
(bias + GELU epilogue writing pre1 on request, then bias + mask epilogue)
and counts them as one call of the fused unit; on the CPU it runs
:func:`_ffn_ref`. Where autograd records the call, :func:`fused_ffn_core`
is an ``autograd.Function`` over that forward that saves (x, pre1, mask)
and whose backward is `_ffn_bwd` in plain PyTorch (the mask on dy, GELU's
factor recomputed from pre1, four matmuls): the JAX package computes it
outside any Pallas kernel too.
"""
import ctypes
import math

import torch

from .. import native
from . import kernel_tier

__all__ = ['fused_ffn_core']

_SQRT_HALF = math.sqrt(0.5)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int64
        _fn = native.function('ffn_gemm', 'ptt_ffn_gemm',
                              [P, P, P, P, P, P, I, I, I, ctypes.c_int, P])
    return _fn


def _gelu(x):
    return 0.5 * x * torch.special.erfc(-x * _SQRT_HALF)


def _ffn_ref(x, w1, b1, w2, b2, mask=None):
    """Plain version: (y, pre1) for rows x [N, d_in]."""
    pre1 = torch.matmul(x, w1) + b1
    y = torch.matmul(_gelu(pre1), w2) + b2
    if mask is not None:
        y = y * mask
    return y, pre1


def _ffn_fwd(x, w1, b1, w2, b2, mask=None, want_pre1=False):
    """(y, pre1 or None): the kernel on CUDA tensors, the plain version on
    the CPU."""
    if not kernel_tier.on_cuda(x, w1, b1, w2, b2, mask):
        y, pre1 = _ffn_ref(x, w1, b1, w2, b2, mask)
        return y, (pre1 if want_pre1 else None)
    n, d_in = x.shape
    d_ff = w1.shape[1]
    d_out = w2.shape[1]
    dev = x.device
    kernel_tier.require(x, 'x', (n, d_in))
    kernel_tier.require(w1, 'w1', (d_in, d_ff), device=dev)
    kernel_tier.require(b1, 'b1', (d_ff,), device=dev)
    kernel_tier.require(w2, 'w2', (d_ff, d_out), device=dev)
    kernel_tier.require(b2, 'b2', (d_out,), device=dev)
    if mask is not None:
        kernel_tier.require(mask, 'mask', (n, d_out), device=dev)
    if (n + 63) // 64 > 65535:
        raise ValueError('fused_ffn_core: at most 65535*64 rows per call')
    fn = _kernel()
    stream = kernel_tier.stream_ptr(x)
    h = torch.empty((n, d_ff), dtype=torch.float32, device=dev)
    pre1 = torch.empty_like(h) if want_pre1 else None
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), None, h.data_ptr(),
            kernel_tier.ptr(pre1), n, d_ff, d_in, 1, stream)
    native.check(rc, 'fused_ffn (gemm 1)')
    y = torch.empty((n, d_out), dtype=torch.float32, device=dev)
    rc = fn(h.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            kernel_tier.ptr(mask), y.data_ptr(), None, n, d_out, d_ff, 0,
            stream)
    native.check(rc, 'fused_ffn (gemm 2)')
    kernel_tier.count('fused_ffn')
    return y, pre1


def _ffn_bwd(x, w1, w2, pre1, mask, dy):
    """`_ffn_bwd` of the JAX package: (dx, dw1, db1, dw2, db2)."""
    if mask is not None:
        dy = dy * mask
    cdf = 0.5 * torch.special.erfc(-pre1 * _SQRT_HALF)
    h = pre1 * cdf
    db2 = dy.sum(dim=0)
    dh = torch.matmul(dy, w2.t())
    dw2 = torch.matmul(h.t(), dy)
    phi = torch.exp(-0.5 * pre1 * pre1) * _INV_SQRT_2PI
    dpre1 = dh * (cdf + pre1 * phi)
    db1 = dpre1.sum(dim=0)
    dx = torch.matmul(dpre1, w1.t())
    dw1 = torch.matmul(x.t(), dpre1)
    return dx, dw1, db1, dw2, db2


class _FusedFFN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, mask):
        y, pre1 = _ffn_fwd(x, w1, b1, w2, b2, mask, want_pre1=True)
        ctx.save_for_backward(x, w1, w2, pre1, mask)
        ctx.mark_non_differentiable(pre1)
        return y, pre1

    @staticmethod
    def backward(ctx, dy, _dpre1):
        x, w1, w2, pre1, mask = ctx.saved_tensors
        return _ffn_bwd(x, w1, w2, pre1, mask, dy) + (None,)


def fused_ffn_core(x, w1, b1, w2, b2, mask=None, want_pre1=False):
    """y [N, d_out] for rows x [N, d_in]; ``mask`` is the pre-scaled keep
    mask [N, d_out] or None (it takes no gradient). Returns (y, pre1):
    pre1 = x @ W1 + b1 [N, d_ff] f32 when ``want_pre1`` is set (the
    backward's residual), else None. Differentiable in x and the weights
    where autograd records the call."""
    if kernel_tier.records_grad(x, w1, b1, w2, b2):
        y, pre1 = _FusedFFN.apply(x, w1, b1, w2, b2, mask)
        return y, (pre1 if want_pre1 else None)
    return _ffn_fwd(x, w1, b1, w2, b2, mask, want_pre1)
