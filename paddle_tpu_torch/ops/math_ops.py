"""Matrix products: ``mul`` (every fc) and ``matmul``, float32 or marked;
and the elementwise, ``sum``, ``sign``, ``log_loss`` and reduction ops of
a Program.

Counterpart of paddle_tpu/ops/math_ops.py `_mul` and `_matmul`. Unmarked
(``policy`` None) they are float32 products. Marked (the AMP policy, see
core/amp.py) they cast their float32 operands to bf16, multiply with float32
accumulation and return float32, as the JAX lowerings do with
``preferred_element_type=float32``; the program ops then round the result
to their ``X`` input's dtype, as the JAX ops do (bf16 for a bf16 input).
These are plain products outside any Pallas kernel, so on the card they
are library calls (cuBLAS).

The one place the port's bf16 product lives is :func:`bf16_product`:
bf16 operands, float32 accumulation, one rounding to the output dtype. On
the card it is ``torch.mm``/``torch.bmm`` with ``out_dtype=float32`` (a
bf16 GEMM writing float32) or a bf16 GEMM writing bf16; on the CPU the
operands are upcast (exactly) and multiplied in float32, then rounded once.

The backward of a marked product (:class:`_Bf16Matmul`) follows JAX's
transpose rules: each product takes the float32 cotangent g against the
other operand's bf16 values, sums in float32, and the result is rounded to
bf16 before the cast's transpose hands it back as float32 (dX =
bf16(g · Wᵀ), dW = bf16(Xᵀ · g)). A tensor-core product needs both
operands in bf16, so :func:`split` takes g apart into two bf16 terms,
g_hi = bf16(g) and g_lo = bf16(g - g_hi) (together within 2^-16 of g),
once per backward, and :func:`split_product` runs two bf16 products summed
in float32: **every backward product has bf16 operands**, at twice the
operations of one pass, and the result matches the JAX package's
float32-g product before its rounding to bf16. One pass on
bf16(g) alone (what a TPU's default precision does to a float32 operand)
moves the gradients as far from the JAX package's as bf16 AMP moves them
from float32 (tests/test_torch_amp.py measures both).
"""
import torch

from ..core import amp
from ..core.registry import register_op
from ..core.selected_rows import SelectedRows
from .common import abs_, broadcast_y_to, clip, flatten_to_2d

__all__ = ['mul', 'matmul', 'bf16_product', 'split', 'split_product']


def bf16_product(a, b, out_dtype=torch.float32):
    """a @ b for bf16 ``a`` [..., m, k] and ``b`` [..., k, n] (the same
    leading dims, or none): float32 accumulation, rounded once to
    ``out_dtype``."""
    if a.device.type != 'cuda':
        return torch.matmul(a.float(), b.float()).to(out_dtype)
    if a.dim() == 2:
        if out_dtype == torch.bfloat16:
            return torch.mm(a, b)
        return torch.mm(a, b, out_dtype=out_dtype)
    lead = a.shape[:-2]
    a3 = a.reshape(-1, *a.shape[-2:])
    b3 = b.reshape(-1, *b.shape[-2:])
    out = torch.bmm(a3, b3) if out_dtype == torch.bfloat16 else \
        torch.bmm(a3, b3, out_dtype=out_dtype)
    return out.reshape(*lead, *out.shape[-2:])


def split(g, dtype):
    """(hi, lo) = (bf16(g), bf16(g - hi)) for float32 ``g``: two bf16 terms
    within 2^-16 of g. ``g - hi`` is exact in float32 and written straight
    to bf16 (one pass over g for each term)."""
    hi = g.to(dtype)
    lo = torch.empty_like(hi)
    torch.sub(g, hi, out=lo)
    return hi, lo


def split_product(hi, lo, b, g_left=True):
    """g @ b (``g_left``) or b @ g for g = hi + lo (:func:`split`) and bf16
    ``b``: two bf16 products summed in float32, rounded once to bf16 (the
    dtype of a marked operand's gradient)."""
    if g_left:
        out = bf16_product(hi, b) + bf16_product(lo, b)
    else:
        out = bf16_product(b, hi) + bf16_product(b, lo)
    return out.to(b.dtype)


class _Bf16Matmul(torch.autograd.Function):
    """x @ y for float32 x, y cast to ``dtype``: the forward's float32
    product and the backward's bf16-rounded gradients (module docstring)."""

    @staticmethod
    def forward(ctx, x, y, dtype):
        xc, yc = x.to(dtype), y.to(dtype)
        ctx.save_for_backward(xc, yc)
        return bf16_product(xc, yc)

    @staticmethod
    def backward(ctx, g):
        xc, yc = ctx.saved_tensors
        hi, lo = split(g, xc.dtype)
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = split_product(hi, lo, yc.transpose(-1, -2)).float()
        if ctx.needs_input_grad[1]:
            dy = split_product(hi, lo, xc.transpose(-1, -2),
                               g_left=False).float()
        return dx, dy, None


def matmul(x, y, policy=None):
    """x @ y over the last two axes ([..., m, k] @ [..., k, n], the same
    leading dims): float32, or under ``policy`` bf16 operands with a
    float32 result."""
    dt = amp.compute_dtype(policy)
    if dt is None:
        return torch.matmul(x, y)
    return _Bf16Matmul.apply(x, y, dt)


def mul(x, w, policy=None):
    """The ``mul`` of an fc: x [..., d_in] @ w [d_in, d_out], the leading
    axes flattened into rows; float32, or marked as :func:`matmul`."""
    dt = amp.compute_dtype(policy)
    if dt is None:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    out = _Bf16Matmul.apply(x.reshape(-1, x.shape[-1]), w, dt)
    return out.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# the program ops (paddle_tpu/ops/math_ops.py `_mul`, `_matmul`, the
# elementwise family's add, sub, mul, div, max, min, pow, mod and
# floordiv, `_sum`, `_sign`, `_squared_l2_norm`, `_log_loss`, `_mean`, the
# reductions): the products
# above, float32 or under the op's AMP mark, and plain elementwise
# PyTorch. A SelectedRows gradient meets the elementwise ops, `sum` and
# `squared_l2_norm` on its way through the clips and the decay, and is
# taken as the JAX lowerings take it.


@register_op('mul')
def _mul_op(ctx, op):
    """The product of the flattened operands, returned in ``X``'s dtype as
    the JAX lowering returns it: float32 in the LM and BERT, bf16 where a
    kept bf16 activation feeds an fc (the image models' heads)."""
    x, y = ctx.in1(op, 'X'), ctx.in1(op, 'Y')
    xnc = op.attr('x_num_col_dims', 1)
    ynk = op.attr('y_num_col_dims', 1)
    out = mul(flatten_to_2d(x, xnc), flatten_to_2d(y, ynk),
              amp.op_policy(op)).to(x.dtype)
    ctx.out(op, 'Out', out.reshape(tuple(x.shape[:xnc]) +
                                   tuple(y.shape[ynk:])))


@register_op('matmul')
def _matmul_op(ctx, op):
    """Transposes, then the product (cast under the AMP mark, a float32
    result rounded to ``X``'s dtype), then ``alpha``, in the JAX lowering's
    order."""
    x, y = ctx.in1(op, 'X'), ctx.in1(op, 'Y')
    if x.dim() == 1:
        x = x.reshape(1, -1)
    if y.dim() == 1:
        y = y.reshape(-1, 1)
    if op.attr('transpose_X', False):
        x = x.transpose(-1, -2)
    if op.attr('transpose_Y', False):
        y = y.transpose(-1, -2)
    out = matmul(x, y, amp.op_policy(op)).to(x.dtype)
    alpha = op.attr('alpha', 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.out(op, 'Out', out)


def _register_elementwise(name, fn):
    @register_op(name)
    def _lower(ctx, op):
        x, y = ctx.in1(op, 'X'), ctx.in1(op, 'Y')
        if isinstance(x, SelectedRows):
            # only a product or quotient by one element (the global-norm
            # clip's factor) leaves the untouched rows at zero; any other
            # op must see the dense tensor
            if name in ('elementwise_mul', 'elementwise_div') and \
                    y.numel() == 1:
                ctx.out(op, 'Out', SelectedRows(
                    x.rows, fn(x.values, y.reshape(())), x.height))
                return
            x = x.to_dense()
        ctx.out(op, 'Out', fn(x, broadcast_y_to(x, y, op.attr('axis', -1))))


# torch promotes as JAX does between two tensors of one dim or more (a
# bf16 activation times a float32 gate is float32); a 0-dim float32 tensor
# would take a bf16 operand's dtype in torch and not in JAX, which is why
# the programs' scalars keep their declared shape [1]
_register_elementwise('elementwise_add', torch.add)
_register_elementwise('elementwise_sub', torch.sub)
_register_elementwise('elementwise_mul', torch.mul)
_register_elementwise('elementwise_div', torch.div)
_register_elementwise('elementwise_max', torch.maximum)
_register_elementwise('elementwise_min', torch.minimum)
_register_elementwise('elementwise_pow', torch.pow)
# ``jnp.mod`` and ``jnp.floor_divide``: the remainder takes the divisor's
# sign and the quotient is floored (not C's truncation)
_register_elementwise('elementwise_mod', torch.remainder)
_register_elementwise('elementwise_floordiv', torch.floor_divide)


@register_op('sum')
def _sum_op(ctx, op):
    """The inputs added in order (the regularizer's grad + decay, the
    global-norm clip's squared norms); a SelectedRows input densifies."""
    xs = [x.to_dense() if isinstance(x, SelectedRows) else x
          for x in ctx.in_list(op, 'X')]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.out(op, 'Out', out)


@register_op('sign')
def _sign_op(ctx, op):
    ctx.out(op, 'Out', torch.sign(ctx.in1(op, 'X')))


@register_op('squared_l2_norm')
def _squared_l2_norm_op(ctx, op):
    """A SelectedRows merges first, so that duplicate rows add before
    squaring: the norm of the dense gradient."""
    x = ctx.in1(op, 'X')
    if isinstance(x, SelectedRows):
        x = x.merged()[1]
    ctx.out(op, 'Out', (x * x).sum().reshape(1))


@register_op('log_loss')
def _log_loss_op(ctx, op):
    """-y log(p + eps) - (1 - y) log(1 - p + eps), elementwise."""
    p, y = ctx.in1(op, 'Predicted'), ctx.in1(op, 'Labels')
    eps = op.attr('epsilon', 1e-4)
    ctx.out(op, 'Loss', -y * torch.log(p + eps) -
            (1.0 - y) * torch.log(1.0 - p + eps))


@register_op('mean')
def _mean_op(ctx, op):
    ctx.out(op, 'Out', ctx.in1(op, 'X').mean().reshape(1))


def _reduce_dims(op, x):
    """The axes a reduction takes: every one under ``reduce_all``, else
    ``dim`` (an int or a list) modulo the rank."""
    if op.attr('reduce_all', False):
        return tuple(range(x.dim()))
    dim = op.attr('dim', [0])
    dim = dim if isinstance(dim, (list, tuple)) else [dim]
    return tuple(d % x.dim() for d in dim)


def _prod(x, dims, keepdim):
    for d in sorted(dims, reverse=True):
        x = x.prod(dim=d, keepdim=keepdim)
    return x


def _mean(x, dims, keepdim):
    # jnp.mean of integers is floating (float32 with x64 off)
    x = x if x.is_floating_point() else x.to(torch.float32)
    return x.mean(dim=dims, keepdim=keepdim)


def _register_reduce(name, fn):
    @register_op(name)
    def _lower(ctx, op):
        x = ctx.in1(op, 'X')
        ctx.out(op, 'Out', fn(x, _reduce_dims(op, x),
                              op.attr('keep_dim', False)))


# paddle_tpu/ops/math_ops.py `_register_reduce`; max and min split the
# gradient evenly between ties, as JAX's reductions do (amax, amin)
_register_reduce('reduce_sum', lambda x, d, k: x.sum(dim=d, keepdim=k))
_register_reduce('reduce_mean', _mean)
_register_reduce('reduce_max', lambda x, d, k: x.amax(dim=d, keepdim=k))
_register_reduce('reduce_min', lambda x, d, k: x.amin(dim=d, keepdim=k))
_register_reduce('reduce_prod', _prod)
_register_reduce('reduce_all', lambda x, d, k: x.bool().all(dim=d,
                                                              keepdim=k))
_register_reduce('reduce_any', lambda x, d, k: x.bool().any(dim=d,
                                                              keepdim=k))


# -- the rest of paddle_tpu/ops/math_ops.py: norms, distances and losses,
# plain torch as the jnp expressions there (``jnp.maximum``'s and
# ``jnp.clip``'s ties split evenly, ``jnp.abs``'s gradient at 0 is 1:
# ops/common.py `clip`, `abs_`)

def _logaddexp0(x):
    """``jnp.logaddexp(0.0, x)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rows_sum(x):
    """The sum over every axis but the first, kept."""
    return x.sum(dim=tuple(range(1, x.dim())), keepdim=True)


@register_op('minus')
def _minus_op(ctx, op):
    ctx.out(op, 'Out', ctx.in1(op, 'X') - ctx.in1(op, 'Y'))


@register_op('cumsum')
def _cumsum_op(ctx, op):
    """Along ``axis`` in x's dtype; ``exclusive`` subtracts x, ``reverse``
    runs from the end."""
    x = ctx.in1(op, 'X')
    axis = op.attr('axis', -1)
    reverse = op.attr('reverse', False)
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, axis, dtype=x.dtype)
    if op.attr('exclusive', False):
        out = out - x
    if reverse:
        out = torch.flip(out, (axis,))
    ctx.out(op, 'Out', out)


@register_op('l1_norm')
def _l1_norm_op(ctx, op):
    ctx.out(op, 'Out', abs_(ctx.in1(op, 'X')).sum().reshape(()))


@register_op('squared_l2_distance')
def _squared_l2_distance_op(ctx, op):
    sub = ctx.in1(op, 'X') - ctx.in1(op, 'Y')
    ctx.out(op, 'sub_result', sub)
    ctx.out(op, 'Out', _rows_sum(sub * sub))


@register_op('cos_sim')
def _cos_sim_op(ctx, op):
    x, y = ctx.in1(op, 'X'), ctx.in1(op, 'Y')
    xn = torch.sqrt((x * x).sum(-1, keepdim=True))
    yn = torch.sqrt((y * y).sum(-1, keepdim=True))
    ctx.out(op, 'Out', (x * y).sum(-1, keepdim=True) / (xn * yn + 1e-12))
    ctx.out(op, 'XNorm', xn)
    ctx.out(op, 'YNorm', yn)


@register_op('norm')
def _norm_op(ctx, op):
    x = ctx.in1(op, 'X')
    norm = torch.sqrt((x * x).sum(op.attr('axis', -1), keepdim=True) +
                      op.attr('epsilon', 1e-10))
    ctx.out(op, 'Norm', norm)
    ctx.out(op, 'Out', x / norm)


@register_op('bilinear_tensor_product')
def _bilinear_tensor_product_op(ctx, op):
    """out[n, k] = x[n] · W[k] · y[n] (+ Bias)."""
    x, y, w = ctx.in1(op, 'X'), ctx.in1(op, 'Y'), ctx.in1(op, 'Weight')
    out = torch.einsum('nm,kmp,np->nk', x, w, y)
    bias = ctx.in1(op, 'Bias')
    if bias is not None:
        out = out + bias
    ctx.out(op, 'Out', out)


@register_op('huber_loss')
def _huber_loss_op(ctx, op):
    delta = op.attr('delta', 1.0)
    r = ctx.in1(op, 'Y') - ctx.in1(op, 'X')
    ar = torch.abs(r)
    ctx.out(op, 'Residual', r)
    ctx.out(op, 'Out', torch.where(ar <= delta, 0.5 * r * r,
                                   delta * (ar - 0.5 * delta)))


@register_op('hinge_loss')
def _hinge_loss_op(ctx, op):
    logits, labels = ctx.in1(op, 'Logits'), ctx.in1(op, 'Labels')
    ctx.out(op, 'Loss', clip(1.0 - (2.0 * labels - 1.0) * logits, 0.0))


@register_op('rank_loss')
def _rank_loss_op(ctx, op):
    d = ctx.in1(op, 'Left') - ctx.in1(op, 'Right')
    ctx.out(op, 'Out', _logaddexp0(d) - ctx.in1(op, 'Label') * d)


@register_op('margin_rank_loss')
def _margin_rank_loss_op(ctx, op):
    x1 = ctx.in1(op, 'X1')
    out = clip(-ctx.in1(op, 'Label') * (x1 - ctx.in1(op, 'X2')) +
               op.attr('margin', 0.0), 0.0)
    ctx.out(op, 'Out', out)
    ctx.out(op, 'Activated', (out > 0).to(x1.dtype))


@register_op('smooth_l1_loss')
def _smooth_l1_loss_op(ctx, op):
    """Each row's sum of the smooth L1 of (x - y) · InsideWeight, times
    OutsideWeight; ``Diff`` the weighted difference."""
    s2 = op.attr('sigma', 1.0) ** 2
    d = ctx.in1(op, 'X') - ctx.in1(op, 'Y')
    iw, ow = ctx.in1(op, 'InsideWeight'), ctx.in1(op, 'OutsideWeight')
    if iw is not None:
        d = d * iw
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    if ow is not None:
        loss = loss * ow
    ctx.out(op, 'Diff', d)
    ctx.out(op, 'Out', _rows_sum(loss))


@register_op('bpr_loss')
def _bpr_loss_op(ctx, op):
    """Bayesian personalized ranking: each row's mean over the other
    classes of -log sigmoid(x_label - x_j)."""
    x = ctx.in1(op, 'X')
    lab = ctx.in1(op, 'Label').reshape(-1).to(torch.int64)
    pos = torch.gather(x, 1, lab[:, None])
    p = 1.0 / (1.0 + torch.exp(-(x - pos)))
    loss = -torch.log(clip(p, 1e-20, 1.0))
    mask = torch.ones_like(loss).scatter(1, lab[:, None], 0.0)
    ctx.out(op, 'Y', (loss * mask).sum(1, keepdim=True) / (x.shape[1] - 1))


@register_op('teacher_student_sigmoid_loss')
def _ts_sigmoid_loss_op(ctx, op):
    x = ctx.in1(op, 'X')
    z = clip(x, op.attr('soft_max_lower_bound', -15.0),
             op.attr('soft_max_up_bound', 15.0))
    ctx.out(op, 'Y', _logaddexp0(z) - ctx.in1(op, 'Label') * z)
