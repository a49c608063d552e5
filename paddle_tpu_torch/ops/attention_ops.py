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

Under bf16 AMP (``policy``, core/amp.py) float32 q, k and v are cast to
bf16 and the same three products run in the kernels' bf16 form
(``csrc/flash_attn_bf16_fwd.cu``, ``csrc/flash_attn_bf16_bwd.cu``), as the
JAX package's kernels run on bf16 operands: S = Q K^T with float32
accumulation; the scale, bias, mask, the online (m, l) and LSE in float32;
P rounded to bf16 before P V and before P^T dO, dS rounded to bf16 before
dS K and dS^T Q; delta = rowsum(dO * O) in float32 over the bf16 values; O,
dQ, dK and dV come out in bf16. O goes back to float32 (and its cotangent
is rounded to bf16 on the way in), as the JAX op's ``astype`` does. The
plain versions take either dtype and repeat the bf16 roundings for bf16
operands; the float32 arithmetic is unchanged.

The kernels are instantiated at head widths 16, 32, 64 and 128;
:func:`_flash_fwd` and :func:`_flash_bwd` take any width up to 128 on the
card by zero-padding q, k and v (and dO) along dh to the next of those,
launching the kernels there and slicing O, dQ, dK and dV back
(:func:`_pad_dh`); the dQ and dK/dV wrappers take the kernels' widths.
That is exact: a zero column adds 0 to every Q·Kᵀ score, the scale stays
the caller's (dh^-0.5 of the true width by default), and the padded
columns of O, dQ, dK and dV are 0. A width above 128 raises.

The program op `flash_attention` (Q, K, V [B, H, L, dh], an optional
KeyPaddingBias [B, L], attrs ``scale`` (missing or 0: dh^-0.5) and
``causal``) calls :func:`flash_attention`, as the JAX op calls its own,
with the op's AMP mark as the policy: a marked op launches the bf16
kernels on the card (or raises), never the float32 ones.
"""
import ctypes

import torch

from .. import native
from ..core import amp
from ..core.registry import register_op
from . import kernel_tier

__all__ = ['flash_attention']

_NEG_INF = -1e30
# a key whose bias is at or below this is dropped exactly (the -1e9 padding
# convention lies well under it)
_BIAS_DROP = -1e8
_fns = {}


# per operand dtype: the kernel library of the forward and of the backward,
# and the counted names of the forward, dQ and dK/dV kernels
_ROUTES = {
    torch.float32: ('flash_attn_fwd', 'flash_attn_bwd', 'ptt_flash_attn',
                    ('flash_attention', 'flash_attention_bwd_dq',
                     'flash_attention_bwd_dkv')),
    torch.bfloat16: ('flash_attn_bf16_fwd', 'flash_attn_bf16_bwd',
                     'ptt_flash_attn_bf16',
                     ('flash_attention_bf16', 'flash_attention_bf16_bwd_dq',
                      'flash_attention_bf16_bwd_dkv')),
}


def _kernel(which, dtype):
    fn = _fns.get((which, dtype))
    if fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        tail = [I, I, I, I, F, ctypes.c_int, P]
        fwd_lib, bwd_lib, prefix, _ = _ROUTES[dtype]
        if which == 'fwd':
            fn = native.function(fwd_lib, prefix + '_fwd', [P] * 6 + tail)
        elif which == 'dq':
            fn = native.function(bwd_lib, prefix + '_bwd_dq', [P] * 8 + tail)
        else:
            fn = native.function(bwd_lib, prefix + '_bwd_dkv',
                                 [P] * 9 + tail)
        _fns[(which, dtype)] = fn
    return fn


def _bf16_fwd_plan(bh, L, dh, causal, biased, scale):
    """(query rows a block, query rows a warp, raw) of the bf16 forward
    kernel's launch with these arguments; ``raw``: its scores are the
    products themselves (no bias, 0 < scale < 1e4). It builds the kernel
    library: card machines only."""
    fn = _fns.get('bf16_plan')
    if fn is None:
        I = ctypes.c_int64
        fn = _fns['bf16_plan'] = native.function(
            _ROUTES[torch.bfloat16][0], 'ptt_flash_attn_bf16_fwd_plan',
            [I, I, I, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p])
    plan = (ctypes.c_int * 3)()
    native.check(fn(bh, L, dh, int(causal), int(biased), scale, plan),
                 'flash_attention_bf16 plan')
    return plan[0], plan[1], bool(plan[2])


def _bf16_bwd_plan(bh, L, dh):
    """Rows a block (query rows for dQ, keys for dK/dV; 16 a warp) of the
    bf16 backward kernels' launch with these arguments. It builds the
    kernel library: card machines only."""
    fn = _fns.get('bf16_bwd_plan')
    if fn is None:
        I = ctypes.c_int64
        fn = _fns['bf16_bwd_plan'] = native.function(
            _ROUTES[torch.bfloat16][1], 'ptt_flash_attn_bf16_bwd_plan',
            [I, I, I, ctypes.c_void_p])
    plan = (ctypes.c_int * 1)()
    native.check(fn(bh, L, dh, plan), 'flash_attention_bf16_bwd plan')
    return plan[0]


def _names(dtype):
    """The counted names (forward, dQ, dK/dV) of the kernels for operands
    of ``dtype``."""
    return _ROUTES[dtype][3]


def _round(x, dtype):
    """``x`` rounded to ``dtype`` and back to float32 (no-op for float32):
    where the bf16 kernels round P and dS before a product."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _scores(q, k, scale, causal, bias, n_heads):
    """(s, keep): the scaled, biased scores [BH, L, L] with masked entries
    at -1e30, and the bool mask of the entries that keep a probability."""
    s = torch.einsum('bqd,bkd->bqk', q.float(), k.float()) * scale
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
    dropped gives O = 0 and LSE = max + log(1e-30), as the kernel does.
    For bf16 operands, P is rounded to bf16 before P V, the sum is divided
    by l afterwards and O is returned in bf16, as the bf16 kernel does."""
    s, keep = _scores(q, k, scale, causal, bias, n_heads)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if q.dtype == torch.float32:
        o = torch.einsum('bqk,bkd->bqd', p / l.clamp_min(1e-30), v)
    else:
        o = (torch.einsum('bqk,bkd->bqd', _round(p, q.dtype), v.float())
             / l.clamp_min(1e-30)).to(q.dtype)
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
    dp = torch.einsum('bqd,bkd->bqk', do.float(), v.float())
    return p, p * (dp - delta[:, :, None]) * scale


def _bwd_dq_ref(q, k, v, do, lse, delta, scale, causal, bias=None,
                n_heads=1):
    """Plain version of the dQ kernel: dQ = dS K (for bf16 operands dS
    rounded to bf16 first and dQ returned in bf16)."""
    _, ds = _p_and_ds(q, k, v, do, lse, delta, scale, causal, bias, n_heads)
    dq = torch.einsum('bqk,bkd->bqd', _round(ds, q.dtype), k.float())
    return dq.to(q.dtype)


def _bwd_dkv_ref(q, k, v, do, lse, delta, scale, causal, bias=None,
                 n_heads=1):
    """Plain version of the dK/dV kernel: (dK = dS^T Q, dV = P^T dO) (for
    bf16 operands P and dS rounded to bf16 first and dK, dV returned in
    bf16)."""
    p, ds = _p_and_ds(q, k, v, do, lse, delta, scale, causal, bias, n_heads)
    dt = q.dtype
    return (torch.einsum('bqk,bqd->bkd', _round(ds, dt), q.float()).to(dt),
            torch.einsum('bqk,bqd->bkd', _round(p, dt), do.float()).to(dt))


def _flash_bwd_ref(q, k, v, o, lse, do, scale, causal, bias=None, n_heads=1):
    """Plain version of the backward over [BH, L, dh]: (dQ, dK, dV), as the
    kernels compute them: delta = rowsum(dO * O), then each kernel's own
    recomputation of P and dS from the saved LSE, and its products."""
    delta = _delta(do, o)
    dq = _bwd_dq_ref(q, k, v, do, lse, delta, scale, causal, bias, n_heads)
    dk, dv = _bwd_dkv_ref(q, k, v, do, lse, delta, scale, causal, bias,
                          n_heads)
    return dq, dk, dv


def _delta(do, o):
    """delta = rowsum(dO * O) [BH, L] in float32 (over the bf16 values for
    bf16 operands)."""
    return (do.float() * o.float()).sum(dim=-1)


# the head widths the kernels are instantiated at
_WIDTHS = (16, 32, 64, 128)


def _kernel_width(dh):
    """The head width the kernels run a ``dh``-wide head at: the next
    instantiated one (ValueError above 128)."""
    w = next((w for w in _WIDTHS if w >= dh), None)
    if w is None or dh < 1:
        raise ValueError('flash_attention: the CUDA kernels take head '
                         'widths 1 to %d, got %d' % (_WIDTHS[-1], dh))
    return w


def _pad_dh(w, *ts):
    """Each tensor of ``ts`` ([BH, L, dh], one dh) zero-padded along dh to
    ``w`` columns (itself when it is that wide)."""
    if len(set(t.shape[-1] for t in ts)) != 1:
        raise ValueError('flash_attention: q, k, v and dO must share one '
                         'head width, got %s' % [t.shape[-1] for t in ts])
    return tuple(t if t.shape[-1] == w else
                 torch.nn.functional.pad(t, (0, w - t.shape[-1]))
                 for t in ts)


def _unpad(dh, *ts):
    """The first ``dh`` columns of each tensor, contiguous."""
    return tuple(t if t.shape[-1] == dh else t[..., :dh].contiguous()
                 for t in ts)


def _check_cuda_operands(q, k, v, bias, n_heads):
    """Validate the kernels' operands (float32, or bf16 for the bf16
    kernels, at the head width of an instantiation); returns (bh, L, dh,
    device)."""
    bh, L, dh = q.shape
    if dh not in _WIDTHS:
        raise ValueError('flash_attention: the CUDA kernels take head '
                         'width 16, 32, 64 or 128, got %d (_flash_bwd '
                         'pads to those)' % dh)
    if q.dtype not in _ROUTES:
        raise ValueError('flash_attention: the CUDA kernels take float32 '
                         'or bfloat16 operands, got %s' % q.dtype)
    dev = q.device
    kernel_tier.require(q, 'q', (bh, L, dh), dtype=q.dtype)
    kernel_tier.require(k, 'k', (bh, L, dh), dtype=q.dtype, device=dev)
    kernel_tier.require(v, 'v', (bh, L, dh), dtype=q.dtype, device=dev)
    if bias is not None:
        kernel_tier.require(bias, 'key_padding_bias', (bh // n_heads, L),
                            device=dev)
    return bh, L, dh, dev


def _flash_fwd(q, k, v, scale, causal, bias=None, n_heads=1):
    """(O, LSE) over [BH, L, dh]: the kernel on CUDA tensors, the plain
    version on the CPU."""
    if not kernel_tier.on_cuda(q, k, v, bias):
        return _attention_ref(q, k, v, scale, causal, bias, n_heads)
    width = q.shape[-1]
    q, k, v = _pad_dh(_kernel_width(width), q, k, v)
    bh, L, dh, dev = _check_cuda_operands(q, k, v, bias, n_heads)
    o = torch.empty_like(q)
    lse = torch.empty((bh, L), dtype=torch.float32, device=dev)
    rc = _kernel('fwd', q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kernel_tier.ptr(bias),
        o.data_ptr(), lse.data_ptr(), bh, L, dh, n_heads, scale, int(causal),
        kernel_tier.stream_ptr(q))
    name = _names(q.dtype)[0]
    native.check(rc, name)
    kernel_tier.count(name)
    return _unpad(width, o)[0], lse


def _bwd_operands(q, k, v, do, lse, delta, bias, n_heads):
    """Validate the backward kernels' operands; returns the leading
    pointer arguments and the trailing scalar ones' head (bh, L, dh)."""
    bh, L, dh, dev = _check_cuda_operands(q, k, v, bias, n_heads)
    kernel_tier.require(do, 'do', (bh, L, dh), dtype=q.dtype, device=dev)
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
    rc = _kernel('dq', q.dtype)(*ins, dq.data_ptr(), *dims, n_heads, scale,
                                int(causal), kernel_tier.stream_ptr(q))
    name = _names(q.dtype)[1]
    native.check(rc, name)
    kernel_tier.count(name)
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
    rc = _kernel('dkv', q.dtype)(*ins, dk.data_ptr(), dv.data_ptr(), *dims,
                                 n_heads, scale, int(causal),
                                 kernel_tier.stream_ptr(q))
    name = _names(q.dtype)[2]
    native.check(rc, name)
    kernel_tier.count(name)
    return dk, dv


def _flash_bwd(q, k, v, o, lse, do, scale, causal, bias=None, n_heads=1):
    """(dQ, dK, dV) over [BH, L, dh]: delta = rowsum(dO * O) in plain
    PyTorch, then the two kernels (their plain versions on the CPU); on
    the card q, k, v and dO are zero-padded once to the kernels' width and
    dQ, dK and dV sliced back."""
    delta = _delta(do, o)
    width = q.shape[-1]
    if kernel_tier.on_cuda(q, k, v, do, lse, delta, bias):
        q, k, v, do = _pad_dh(_kernel_width(width), q, k, v, do)
    dq = _flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, bias, n_heads)
    dk, dv = _flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, bias,
                            n_heads)
    return _unpad(width, dq, dk, dv)


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
                    key_padding_bias=None, num_heads=1, policy=None):
    """Softmax attention of q over k, v: [B, H, L, dh] or [BH, L, dh].
    ``scale`` defaults to dh**-0.5. ``key_padding_bias`` is an optional
    [B, L] f32 bias added to every query's score of a key (0 keeps a key,
    -1e9 drops it exactly); with [BH, L, dh] operands ``num_heads`` says
    how many consecutive rows share one bias row. Returns O shaped like q,
    and with ``return_lse=True`` also the per-row log-sum-exp ([B, H, L]
    or [BH, L], f32, not differentiable). Differentiable in q, k and v
    where autograd records the call; the bias takes no gradient. Under the
    AMP ``policy`` (core/amp.py) float32 q, k and v are cast to bf16, the
    bf16 kernels run and O comes back in q's dtype."""
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
    out_dtype = q.dtype
    q, k, v = amp.cast_compute(policy, q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kernel_tier.records_grad(q, k, v):
        o, lse = _FlashAttention.apply(q, k, v, bias, scale, bool(causal),
                                       num_heads)
    else:
        o, lse = _flash_fwd(q, k, v, scale, bool(causal), bias, num_heads)
    o = o.to(out_dtype)
    if shape4:
        o = o.reshape(b, h, L, dh)
        lse = lse.reshape(b, h, L)
    return (o, lse) if return_lse else o


@register_op('flash_attention')
def _flash_attention_op(ctx, op):
    """The JAX op's lowering: q, k and v cast under the AMP mark (the bf16
    kernels then run), the key-padding bias float32, the output in q's
    float32."""
    q, k, v = ctx.in1(op, 'Q'), ctx.in1(op, 'K'), ctx.in1(op, 'V')
    bias = ctx.in1(op, 'KeyPaddingBias')
    if bias is not None and q.dim() != 4:
        raise NotImplementedError(
            'flash_attention KeyPaddingBias needs 4-d [B, H, L, dh] Q')
    scale = op.attr('scale', None)
    scale = None if scale is None or scale == 0.0 else float(scale)
    ctx.out(op, 'Out', flash_attention(q, k, v, scale=scale,
                                       causal=op.attr('causal', True),
                                       key_padding_bias=bias,
                                       policy=amp.op_policy(op)))
