"""Fused FFN tail: ``y = (gelu(x @ W1 + b1) @ W2 + b2) * mask``.

Counterpart of paddle_tpu/ops/ffn_ops.py `fused_ffn_core` with its Pallas
forward `_ffn_fwd_pallas` and its backward `_ffn_bwd`. GELU is the exact
(erf) form, ``0.5 * x * erfc(-x / sqrt(2))`` as
jax.nn.gelu(approximate=False) computes it. Weights keep the JAX layout
[in, out].

On CUDA tensors the forward runs ``csrc/ffn_gemm.cu`` by one of two
routes, chosen by :func:`_plan` from the row count and the widths alone
(never from the data), so a row's bits depend only on that row and on the
row count of its call: the skinny route for at most ``_SKINNY_MAX_ROWS``
rows (the decode step: each block owns a slice of d_ff, h stays on chip, a
second launch sums the slices' partials in order), else the tile route
(two 3xTF32 tensor-core GEMMs with fused epilogues: bias + GELU writing
pre1 on request, then bias + mask; a deterministic split-K where the tiles
alone would leave SMs idle). Either way it counts as one call of the fused
unit. On the CPU it runs :func:`_ffn_ref`. Where autograd records the call,
:func:`fused_ffn_core` is an ``autograd.Function`` over that forward that
saves (x, pre1, mask) and whose backward is `_ffn_bwd` in plain PyTorch
(the mask on dy, GELU's factor recomputed from pre1, four matmuls): the JAX
package computes it outside any Pallas kernel too. At an AMP-marked site
the JAX package stands the Pallas kernel down and runs its XLA tier on bf16
operands: :func:`fused_ffn_amp` is that math, with no kernel.

The program op `fused_ffn_tail` calls :func:`fused_ffn_core` where the JAX
op is fusable (trailing-axis products on float32 rows; dropout, if live,
``upscale_in_train`` with p < 1), or :func:`fused_ffn_amp` where it also
carries the AMP mark, its pre-scaled keep mask drawn from the run's
generator (random_ops.keep_mask), and otherwise runs the JAX op's own
composition: mul, add, GELU, mul, add, dropout (each mul cast under the
mark).
"""
import ctypes
import math

import torch

from .. import native
from ..core import amp
from ..core.registry import register_op
from . import kernel_tier, math_ops, random_ops
from .common import broadcast_y_to, flatten_to_2d

__all__ = ['fused_ffn_core', 'fused_ffn_amp']

_SQRT_HALF = math.sqrt(0.5)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
# rows up to which the skinny route runs (its kernel takes at most 32): on
# an H100 at d 512 / d_ff 2048 it beats the tile route at 8 rows (0.0110
# against 0.0162 ms) and loses at 16 (0.0169 against 0.0163) and 32
# (chip_smoke.py's ffn_routes lines)
_SKINNY_MAX_ROWS = 8
_SKINNY_SLICE = 16            # d_ff columns per skinny block
_SMEM_LIMIT = 232448          # dynamic shared memory of one block (sm_90)
_FILL = 128                   # blocks that fill an H100's 132 SMs
_BK = 32                      # the tile GEMM's K step
_fns = {}


def _kernel(which):
    fn = _fns.get(which)
    if fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int64
        if which == 'gemm':
            fn = native.function('ffn_gemm', 'ptt_ffn_gemm',
                                 [P] * 7 + [I, I, I, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, I, P])
        else:
            fn = native.function('ffn_gemm', 'ptt_ffn_skinny',
                                 [P] * 9 + [I, I, I, I, P])
        _fns[which] = fn
    return fn


def _skinny_smem(rows, d_in, d_out):
    """Shared-memory bytes of a skinny block (its kernel's layout: x, the
    W2 slice, the per-warp sums and h, at the row count rounded up to 8,
    16 or 32)."""
    mb = 8 if rows <= 8 else 16 if rows <= 16 else 32
    r4 = lambda n: (n + 3) // 4 * 4
    return (mb * r4(d_in) + _SKINNY_SLICE * r4(d_out)
            + 9 * mb * _SKINNY_SLICE) * 4


def _gemm_plan(m, n, k):
    """(tile, splits, kchunk) of one tile-route GEMM [m, k] @ [k, n]:
    64 x 128 tiles (tile 1) where they give at least _FILL blocks, else
    64 x 64 tiles (tile 0), split along K into chunks (multiples of 32,
    at least 128 deep) where even those give fewer."""
    blocks = -(-m // 64) * -(-n // 128)
    if blocks >= _FILL:
        return 1, 1, -(-k // _BK) * _BK
    blocks = -(-m // 64) * -(-n // 64)
    splits = max(1, min(-(-_FILL // blocks), k // (4 * _BK)))
    chunk = -(-(-(-k // splits)) // _BK) * _BK
    return 0, -(-k // chunk), chunk


def _plan(rows, d_in, d_ff, d_out):
    """How the kernels run ``rows`` rows: ('skinny', slices) or ('tile',
    GEMM 1's plan, GEMM 2's plan). A function of the shapes alone, so every
    call with the same row count takes the same route."""
    if rows <= _SKINNY_MAX_ROWS and \
            _skinny_smem(rows, d_in, d_out) <= _SMEM_LIMIT:
        return ('skinny', -(-d_ff // _SKINNY_SLICE))
    return ('tile', _gemm_plan(rows, d_ff, d_in), _gemm_plan(rows, d_out,
                                                             d_ff))


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
    plan = _plan(n, d_in, d_ff, d_out)
    stream = kernel_tier.stream_ptr(x)
    pre1 = torch.empty((n, d_ff), dtype=torch.float32, device=dev) \
        if want_pre1 else None
    y = torch.empty((n, d_out), dtype=torch.float32, device=dev)
    if plan[0] == 'skinny':
        ws = torch.empty((plan[1], n, d_out), dtype=torch.float32,
                         device=dev)
        rc = _kernel('skinny')(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), kernel_tier.ptr(mask), y.data_ptr(),
            kernel_tier.ptr(pre1), ws.data_ptr(), n, d_in, d_ff, d_out,
            stream)
        native.check(rc, 'fused_ffn (skinny)')
    else:
        fn = _kernel('gemm')
        (t1, s1, c1), (t2, s2, c2) = plan[1], plan[2]
        h = torch.empty((n, d_ff), dtype=torch.float32, device=dev)
        # one workspace for whichever GEMM splits K: [splits, n, width]
        ws = torch.empty((max(s1 * d_ff if s1 > 1 else 0,
                              s2 * d_out if s2 > 1 else 0) * n,),
                         dtype=torch.float32, device=dev)
        rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), None,
                h.data_ptr(), kernel_tier.ptr(pre1), ws.data_ptr(), n, d_ff,
                d_in, 1, t1, s1, c1, stream)
        native.check(rc, 'fused_ffn (gemm 1)')
        rc = fn(h.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                kernel_tier.ptr(mask), y.data_ptr(), None, ws.data_ptr(), n,
                d_out, d_ff, 0, t2, s2, c2, stream)
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


def _gelu_cdf(pre1):
    """Phi(x), the erf factor of exact GELU, as the JAX package's XLA tier
    writes it."""
    return 0.5 * (1.0 + torch.erf(pre1 * _SQRT_HALF))


def _round(x, dtype):
    return x.to(dtype).float()


class _FusedFFNAmp(torch.autograd.Function):
    """The FFN tail of a marked site: the JAX package's XLA tier of
    `fused_ffn_core` on bf16 x, W1, W2 (:func:`fused_ffn_amp`)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, mask, dtype):
        xc, w1c, w2c = (t.to(dtype) for t in (x, w1, w2))
        pre1 = math_ops.bf16_product(xc, w1c) + b1
        cdf = _gelu_cdf(pre1)
        h = (pre1 * cdf).to(dtype)
        y = (math_ops.bf16_product(h, w2c) + b2).to(dtype)
        ctx.save_for_backward(xc, w1c, w2c, pre1, cdf, mask)
        # without a mask the output is bf16 until the op's cast back to
        # float32, whose transpose rounds the cotangent to bf16
        return y.float() if mask is None else y.float() * mask

    @staticmethod
    def backward(ctx, dy):
        xc, w1c, w2c, pre1, cdf, mask = ctx.saved_tensors
        dt = xc.dtype
        if mask is None:
            dy = _round(dy, dt)
        else:
            dy = dy * mask
        # `_ffn_bwd`: float32 products on the bf16-valued residuals, each
        # gradient rounded to its residual's dtype (b1 and b2 to the
        # weights' bf16, as the JAX package rounds them)
        h = pre1 * cdf
        db2 = _round(dy.sum(dim=0), dt)
        dh = torch.matmul(dy, w2c.float().t())
        dw2 = _round(torch.matmul(h.t(), dy), dt)
        phi = torch.exp(-0.5 * pre1 * pre1) * _INV_SQRT_2PI
        dpre1 = dh * (cdf + pre1 * phi)
        db1 = _round(dpre1.sum(dim=0), dt)
        dx = _round(torch.matmul(dpre1, w1c.float().t()), dt)
        dw1 = _round(torch.matmul(xc.float().t(), dpre1), dt)
        return dx, dw1, db1, dw2, db2, None, None


def fused_ffn_amp(x, w1, b1, w2, b2, mask=None, policy='bfloat16'):
    """The FFN tail of an AMP-marked site, y [N, d_out] float32 for rows x
    [N, d_in] float32. Under AMP the JAX package stands its Pallas kernel
    down and runs the XLA tier of `fused_ffn_core` on bf16 x, W1 and W2:
    pre1 = x W1 (bf16 operands, float32 accumulation) + b1, h =
    gelu(pre1) rounded to bf16, y = (h W2 + b2) rounded to bf16, times the
    float32 ``mask``, returned as float32. So this launches no kernel: the
    products are bf16 library GEMMs (ops/math_ops.py). Its backward is
    `_ffn_bwd`: float32 products on the bf16-valued residuals (four
    float32 GEMMs), dx, dW1, db1, dW2 and db2 rounded to bf16."""
    dt = amp.compute_dtype(policy)
    return _FusedFFNAmp.apply(x, w1, b1, w2, b2, mask, dt)


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


# ---------------------------------------------------------------------------
# the program op


def _ffn_rng_active(op):
    """Only a training-mode op with live dropout draws."""
    return (not op.attr('is_test', False)
            and op.attr('dropout_prob', 0.0) > 0.0)


@register_op('fused_ffn_tail', needs_rng=_ffn_rng_active)
def _fused_ffn_tail_op(ctx, op):
    """The fusable form runs :func:`fused_ffn_core` (the kernel), or under
    the AMP mark :func:`fused_ffn_amp` (the JAX op stands its Pallas kernel
    down there), with the keep mask drawn at the same point of the run's
    stream either way; any other form runs the JAX op's composition, each
    product cast under the mark."""
    x = ctx.in1(op, 'X')
    w1, b1 = ctx.in1(op, 'W1'), ctx.in1(op, 'B1')
    w2, b2 = ctx.in1(op, 'W2'), ctx.in1(op, 'B2')
    xnc = op.attr('x_num_col_dims', 1)
    prob = op.attr('dropout_prob', 0.0)
    is_test = op.attr('is_test', False)
    dimpl = op.attr('dropout_implementation', 'upscale_in_train')
    drop_active = bool(prob) and not is_test
    policy = amp.op_policy(op)
    seed = op.attr('seed', 0)
    gen = (lambda: ctx.op_rng(seed)) if seed else ctx.rng
    fusable = (tuple(x.shape[xnc:]) == tuple(w1.shape[:1])
               and x.dim() == xnc + 1 and x.dtype == torch.float32
               and (not drop_active or (dimpl == 'upscale_in_train'
                                        and prob < 1.0)))
    lead = tuple(x.shape[:xnc])
    if fusable:
        x2 = x.reshape(-1, w1.shape[0]).contiguous()
        mask = random_ops.keep_mask((x2.shape[0], w2.shape[1]), prob, gen(),
                                    x.device) if drop_active else None
        if policy:
            y2 = fused_ffn_amp(x2, w1, b1, w2, b2, mask, policy=policy)
        else:
            y2, _ = fused_ffn_core(x2, w1, b1, w2, b2, mask)
        ctx.out(op, 'Out', y2.reshape(lead + (w2.shape[1],)))
        return
    # the JAX op's composition (its 'off' tier)
    h = math_ops.mul(flatten_to_2d(x, xnc), flatten_to_2d(w1, 1), policy)
    h = h.reshape(lead + tuple(w1.shape[1:]))
    h = _gelu(h + broadcast_y_to(h, b1, xnc))
    y = math_ops.mul(flatten_to_2d(h, xnc), flatten_to_2d(w2, 1), policy)
    y = y.reshape(lead + tuple(w2.shape[1:]))
    y = y + broadcast_y_to(y, b2, xnc)
    if drop_active:
        y, _ = random_ops.train_dropout(y, prob,
                                        dimpl == 'upscale_in_train', gen())
    elif is_test and prob and dimpl == 'downgrade_in_infer':
        y = y * (1.0 - prob)
    ctx.out(op, 'Out', y)
