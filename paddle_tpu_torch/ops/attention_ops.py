"""Flash attention, forward and backward.

Counterpart of paddle_tpu/ops/attention_ops.py `flash_attention` with its
three Pallas kernels: the forward `_flash_fwd_pallas` and the two backward
kernels of `_flash_bwd_pallas` (dQ, and dK with dV), each with and without
the per-key padding bias [B, L] that BERT's masks use (row ``b`` of the
[BH, L, dh] operands reads batch ``b // n_heads``; a key whose bias is
-1e8 or lower gets exactly zero probability).

On CUDA tensors :func:`flash_attention` launches ``csrc/flash_attn_fwd.cu``
and, where autograd records the call, its backward launches the two
kernels of ``csrc/flash_attn_bwd.cu``; ``delta = rowsum(dO * O)`` is plain
PyTorch between them, as the JAX package computes it outside Pallas. On
the CPU the forward is :func:`_attention_ref` and the backward
:func:`_flash_bwd_ref`, the kernels' own arithmetic (P recomputed from the
saved LSE, then the three products), not autograd of the forward. The bias
is a mask and takes no gradient.
"""
import ctypes

import torch

from .. import native
from . import kernel_tier

__all__ = ['flash_attention']

_NEG_INF = -1e30
# a key whose bias is at or below this is dropped exactly (the -1e9 padding
# convention lies well under it)
_BIAS_DROP = -1e8
_fns = {}


def _kernel(which):
    fn = _fns.get(which)
    if fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        tail = [I, I, I, I, F, ctypes.c_int, P]
        if which == 'fwd':
            fn = native.function('flash_attn_fwd', 'ptt_flash_attn_fwd',
                                 [P] * 6 + tail)
        elif which == 'dq':
            fn = native.function('flash_attn_bwd', 'ptt_flash_attn_bwd_dq',
                                 [P] * 8 + tail)
        else:
            fn = native.function('flash_attn_bwd', 'ptt_flash_attn_bwd_dkv',
                                 [P] * 9 + tail)
        _fns[which] = fn
    return fn


def _scores(q, k, scale, causal, bias, n_heads):
    """(s, keep): the scaled, biased scores [BH, L, L] with masked entries
    at -1e30, and the bool mask of the entries that keep a probability."""
    s = torch.einsum('bqd,bkd->bqk', q, k) * scale
    L = s.shape[1]
    keep = torch.ones((L, L), dtype=torch.bool, device=s.device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None]
    if bias is not None:
        rows = bias.to(torch.float32).repeat_interleave(n_heads, dim=0)
        s = s + rows[:, None, :]
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
        keep = keep & (rows > _BIAS_DROP)[:, None, :]
    else:
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    return s, keep


def _attention_ref(q, k, v, scale, causal, bias=None, n_heads=1):
    """Plain version of the forward kernel over [BH, L, dh]: (O, LSE).
    Masked and dropped keys get exactly zero weight; a row with every key
    dropped gives O = 0 and LSE = max + log(1e-30), as the kernel does."""
    s, keep = _scores(q, k, scale, causal, bias, n_heads)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum('bqk,bkd->bqd', p / l.clamp_min(1e-30), v)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return o, lse


def _p_and_ds(q, k, v, do, lse, delta, scale, causal, bias, n_heads):
    """What both backward kernels recompute, over [BH, L, L]:
    P = exp(S - LSE), set to 0 by a select where the entry is masked or its
    key dropped (in a row whose keys are all dropped the exponential alone
    would be ~e^69), and dS = P (dO V^T - delta) scale."""
    s, keep = _scores(q, k, scale, causal, bias, n_heads)
    p = torch.where(keep, torch.exp(s - lse[:, :, None]),
                    torch.zeros_like(s))
    dp = torch.einsum('bqd,bkd->bqk', do, v)
    return p, p * (dp - delta[:, :, None]) * scale


def _bwd_dq_ref(q, k, v, do, lse, delta, scale, causal, bias=None,
                n_heads=1):
    """Plain version of the dQ kernel: dQ = dS K."""
    _, ds = _p_and_ds(q, k, v, do, lse, delta, scale, causal, bias, n_heads)
    return torch.einsum('bqk,bkd->bqd', ds, k)


def _bwd_dkv_ref(q, k, v, do, lse, delta, scale, causal, bias=None,
                 n_heads=1):
    """Plain version of the dK/dV kernel: (dK = dS^T Q, dV = P^T dO)."""
    p, ds = _p_and_ds(q, k, v, do, lse, delta, scale, causal, bias, n_heads)
    return (torch.einsum('bqk,bqd->bkd', ds, q),
            torch.einsum('bqk,bqd->bkd', p, do))


def _flash_bwd_ref(q, k, v, o, lse, do, scale, causal, bias=None, n_heads=1):
    """Plain version of the backward over [BH, L, dh]: (dQ, dK, dV), as the
    kernels compute them: delta = rowsum(dO * O), then each kernel's own
    recomputation of P and dS from the saved LSE, and its products."""
    delta = (do * o).sum(dim=-1)
    dq = _bwd_dq_ref(q, k, v, do, lse, delta, scale, causal, bias, n_heads)
    dk, dv = _bwd_dkv_ref(q, k, v, do, lse, delta, scale, causal, bias,
                          n_heads)
    return dq, dk, dv


def _check_cuda_operands(q, k, v, bias, n_heads):
    """Validate the kernels' operands; returns (bh, L, dh, device)."""
    bh, L, dh = q.shape
    if dh not in (16, 32, 64, 128):
        raise ValueError('flash_attention: the CUDA kernels take head '
                         'width 16, 32, 64 or 128, got %d' % dh)
    if bh > 65535:
        raise ValueError('flash_attention: batch*heads must be <= 65535')
    dev = q.device
    kernel_tier.require(q, 'q', (bh, L, dh))
    kernel_tier.require(k, 'k', (bh, L, dh), device=dev)
    kernel_tier.require(v, 'v', (bh, L, dh), device=dev)
    if bias is not None:
        kernel_tier.require(bias, 'key_padding_bias', (bh // n_heads, L),
                            device=dev)
    return bh, L, dh, dev


def _flash_fwd(q, k, v, scale, causal, bias=None, n_heads=1):
    """(O, LSE) over [BH, L, dh]: the kernel on CUDA tensors, the plain
    version on the CPU."""
    if not kernel_tier.on_cuda(q, k, v, bias):
        return _attention_ref(q, k, v, scale, causal, bias, n_heads)
    bh, L, dh, dev = _check_cuda_operands(q, k, v, bias, n_heads)
    o = torch.empty_like(q)
    lse = torch.empty((bh, L), dtype=torch.float32, device=dev)
    rc = _kernel('fwd')(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        kernel_tier.ptr(bias), o.data_ptr(), lse.data_ptr(),
                        bh, L, dh, n_heads, scale, int(causal),
                        kernel_tier.stream_ptr(q))
    native.check(rc, 'flash_attention')
    kernel_tier.count('flash_attention')
    return o, lse


def _bwd_operands(q, k, v, do, lse, delta, bias, n_heads):
    """Validate the backward kernels' operands; returns the leading
    pointer arguments and the trailing scalar ones' head (bh, L, dh)."""
    bh, L, dh, dev = _check_cuda_operands(q, k, v, bias, n_heads)
    kernel_tier.require(do, 'do', (bh, L, dh), device=dev)
    kernel_tier.require(lse, 'lse', (bh, L), device=dev)
    kernel_tier.require(delta, 'delta', (bh, L), device=dev)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), kernel_tier.ptr(bias)), \
        (bh, L, dh)


def _flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, bias=None,
                  n_heads=1):
    """dQ over [BH, L, dh]: the kernel on CUDA tensors, the plain version
    on the CPU."""
    if not kernel_tier.on_cuda(q, k, v, do, lse, delta, bias):
        return _bwd_dq_ref(q, k, v, do, lse, delta, scale, causal, bias,
                           n_heads)
    ins, dims = _bwd_operands(q, k, v, do, lse, delta, bias, n_heads)
    dq = torch.empty_like(q)
    rc = _kernel('dq')(*ins, dq.data_ptr(), *dims, n_heads, scale,
                       int(causal), kernel_tier.stream_ptr(q))
    native.check(rc, 'flash_attention_bwd_dq')
    kernel_tier.count('flash_attention_bwd_dq')
    return dq


def _flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, bias=None,
                   n_heads=1):
    """(dK, dV) over [BH, L, dh]: the kernel on CUDA tensors, the plain
    version on the CPU."""
    if not kernel_tier.on_cuda(q, k, v, do, lse, delta, bias):
        return _bwd_dkv_ref(q, k, v, do, lse, delta, scale, causal, bias,
                            n_heads)
    ins, dims = _bwd_operands(q, k, v, do, lse, delta, bias, n_heads)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _kernel('dkv')(*ins, dk.data_ptr(), dv.data_ptr(), *dims, n_heads,
                        scale, int(causal), kernel_tier.stream_ptr(q))
    native.check(rc, 'flash_attention_bwd_dkv')
    kernel_tier.count('flash_attention_bwd_dkv')
    return dk, dv


def _flash_bwd(q, k, v, o, lse, do, scale, causal, bias=None, n_heads=1):
    """(dQ, dK, dV) over [BH, L, dh]: delta = rowsum(dO * O) in plain
    PyTorch, then the two kernels (their plain versions on the CPU)."""
    delta = (do * o).sum(dim=-1)
    dq = _flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, bias, n_heads)
    dk, dv = _flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, bias,
                            n_heads)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, n_heads):
        o, lse = _flash_fwd(q, k, v, scale, causal, bias, n_heads)
        ctx.save_for_backward(q, k, v, o, lse, bias)
        ctx.args = (scale, causal, n_heads)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, bias = ctx.saved_tensors
        scale, causal, n_heads = ctx.args
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do.contiguous(), scale,
                                causal, bias, n_heads)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, scale=None, causal=True, return_lse=False,
                    key_padding_bias=None, num_heads=1):
    """Softmax attention of q over k, v: [B, H, L, dh] or [BH, L, dh].
    ``scale`` defaults to dh**-0.5. ``key_padding_bias`` is an optional
    [B, L] f32 bias added to every query's score of a key (0 keeps a key,
    -1e9 drops it exactly); with [BH, L, dh] operands ``num_heads`` says
    how many consecutive rows share one bias row. Returns O shaped like q,
    and with ``return_lse=True`` also the per-row log-sum-exp ([B, H, L]
    or [BH, L], f32, not differentiable). Differentiable in q, k and v
    where autograd records the call; the bias takes no gradient."""
    shape4 = q.dim() == 4
    if shape4:
        b, h, L, dh = q.shape
        num_heads = h
        q, k, v = (t.reshape(b * h, L, dh) for t in (q, k, v))
    bh, L, dh = q.shape
    scale = float(dh ** -0.5 if scale is None else scale)
    num_heads = int(num_heads)
    bias = key_padding_bias
    if bias is not None:
        if num_heads < 1 or bh % num_heads or \
                tuple(bias.shape) != (bh // num_heads, L):
            raise ValueError(
                'key_padding_bias must be [batch, L] = %s for %d rows of %d '
                'heads, got %s' % ((bh // max(num_heads, 1), L), bh,
                                   num_heads, tuple(bias.shape)))
        bias = bias.detach().to(torch.float32).contiguous()
    # the kernels take contiguous [BH, L, dh]; the models hand in permuted
    # views of the QKV product
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kernel_tier.records_grad(q, k, v):
        o, lse = _FlashAttention.apply(q, k, v, bias, scale, bool(causal),
                                       num_heads)
    else:
        o, lse = _flash_fwd(q, k, v, scale, bool(causal), bias, num_heads)
    if shape4:
        o = o.reshape(b, h, L, dh)
        lse = lse.reshape(b, h, L)
    return (o, lse) if return_lse else o
