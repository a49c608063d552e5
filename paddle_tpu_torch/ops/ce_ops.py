"""Fused softmax cross-entropy with hard labels, forward and backward.

Counterpart of paddle_tpu/ops/ce_ops.py (`fused_softmax_ce` with its Pallas
kernels `_fused_ce_fwd_pallas` and `_fused_ce_bwd_pallas`) and of the
`softmax_with_cross_entropy` lowering's hard-label branch in
paddle_tpu/ops/nn_ops.py.

:func:`fused_softmax_ce` is an ``autograd.Function``: its forward saves
(logits, labels, lse) and its backward recomputes the probabilities from
them, so no [N, V] softmax or one-hot is ever kept. On CUDA tensors the two
halves launch ``csrc/softmax_ce.cu``; on the CPU they run
:func:`_ce_fwd_ref` and :func:`_ce_bwd_ref`, the arithmetic of the XLA tier
(`_ce_fwd_xla`, `_ce_bwd_xla`) with the Pallas kernels' label rule. The
rule: labels are narrowed to int32; a row whose label equals
``ignore_index`` has loss 0 and gradient exactly 0; a label outside [0, V)
that is not ``ignore_index`` matches no column, so it picks 0 (loss = lse)
and takes no one-hot term in the gradient.
"""
import ctypes

import torch

from .. import native
from . import kernel_tier

__all__ = ['fused_softmax_ce']

_fns = {}


def _kernel(which):
    fn = _fns.get(which)
    if fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int64
        if which == 'fwd':
            fn = native.function('softmax_ce', 'ptt_softmax_ce_fwd',
                                 [P, P, P, P, I, I, I, P])
        else:
            fn = native.function('softmax_ce', 'ptt_softmax_ce_bwd',
                                 [P, P, P, P, P, I, I, I, P])
        _fns[which] = fn
    return fn


def _ce_fwd_ref(x, labels, ignore_index=-100):
    """Plain version of the forward: (loss [N], lse [N])."""
    lab = labels.to(torch.int32)
    V = x.shape[1]
    m = x.max(dim=1).values
    l = torch.exp(x - m[:, None]).sum(dim=1)
    lse = m + torch.log(l.clamp_min(1e-30))
    # x[row, label] for labels in [0, V), else 0
    pick = torch.gather(x, 1, lab.clamp(0, V - 1).long()[:, None])[:, 0]
    pick = torch.where((lab >= 0) & (lab < V), pick, torch.zeros_like(pick))
    loss = torch.where(lab != int(ignore_index), lse - pick,
                       torch.zeros_like(lse))
    return loss, lse


def _ce_bwd_ref(x, labels, lse, ct, ignore_index=-100):
    """Plain version of the backward: dlogits [N, V]."""
    lab = labels.to(torch.int32)
    ct = torch.where(lab != int(ignore_index), ct, torch.zeros_like(ct))
    g = torch.exp(x - lse[:, None])
    V = x.shape[1]
    hit = torch.arange(V, device=x.device)[None, :] == lab[:, None]
    return (g - hit.to(g.dtype)) * ct[:, None]


def _check(x, labels):
    n, V = x.shape
    kernel_tier.require(x, 'logits', (n, V))
    kernel_tier.require(labels, 'labels', (n,), dtype=torch.int64,
                        device=x.device)
    if n >= 2 ** 31:
        raise ValueError('fused_softmax_ce takes < 2^31 rows per call')
    return n, V


def _ce_fwd(x, labels, ignore_index):
    """(loss, lse): the kernel on CUDA tensors, the plain version on the
    CPU."""
    if not kernel_tier.on_cuda(x, labels):
        return _ce_fwd_ref(x, labels, ignore_index)
    n, V = _check(x, labels)
    loss = torch.empty((n,), dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    rc = _kernel('fwd')(x.data_ptr(), labels.data_ptr(), loss.data_ptr(),
                        lse.data_ptr(), n, V, int(ignore_index),
                        kernel_tier.stream_ptr(x))
    native.check(rc, 'softmax_ce_fwd')
    kernel_tier.count('softmax_ce_fwd')
    return loss, lse


def _ce_bwd(x, labels, lse, ct, ignore_index):
    """dlogits: the kernel on CUDA tensors, the plain version on the CPU."""
    if not kernel_tier.on_cuda(x, labels, lse, ct):
        return _ce_bwd_ref(x, labels, lse, ct, ignore_index)
    n, V = _check(x, labels)
    kernel_tier.require(lse, 'lse', (n,), device=x.device)
    kernel_tier.require(ct, 'ct', (n,), device=x.device)
    dx = torch.empty_like(x)
    rc = _kernel('bwd')(x.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                        ct.data_ptr(), dx.data_ptr(), n, V,
                        int(ignore_index), kernel_tier.stream_ptr(x))
    native.check(rc, 'softmax_ce_bwd')
    kernel_tier.count('softmax_ce_bwd')
    return dx


class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, ignore_index):
        loss, lse = _ce_fwd(logits, labels, ignore_index)
        ctx.save_for_backward(logits, labels, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, ct):
        logits, labels, lse = ctx.saved_tensors
        # the mean's cotangent arrives expanded (stride 0)
        dx = _ce_bwd(logits, labels, lse, ct.contiguous(), ctx.ignore_index)
        return dx, None, None


def fused_softmax_ce(logits, labels, ignore_index=-100):
    """Per-row loss [N] of softmax cross-entropy for logits [N, V] f32 and
    integer labels [N] (or [N, 1]), differentiable in the logits."""
    labels = labels.reshape(-1).to(torch.int64).contiguous()
    return _FusedCE.apply(logits, labels, int(ignore_index))
