"""Matrix products: ``mul`` (every fc) and ``matmul``, float32 or marked.

Counterpart of paddle_tpu/ops/math_ops.py `_mul` and `_matmul`. Unmarked
(``policy`` None) they are float32 products. Marked (the AMP policy, see
core/amp.py) they cast their float32 operands to bf16, multiply with float32
accumulation and return float32, as the JAX lowerings do with
``preferred_element_type=float32``. These are plain products outside any
Pallas kernel, so on the card they are library calls (cuBLAS).

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
from .common import broadcast_y_to, flatten_to_2d

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
# elementwise family's add and sub, `_mean`, ``reduce_sum``): the products
# above, float32 or under the op's AMP mark, and plain elementwise PyTorch.


@register_op('mul')
def _mul_op(ctx, op):
    x, y = ctx.in1(op, 'X'), ctx.in1(op, 'Y')
    xnc = op.attr('x_num_col_dims', 1)
    ynk = op.attr('y_num_col_dims', 1)
    out = mul(flatten_to_2d(x, xnc), flatten_to_2d(y, ynk),
              amp.op_policy(op))
    ctx.out(op, 'Out', out.reshape(tuple(x.shape[:xnc]) +
                                   tuple(y.shape[ynk:])))


@register_op('matmul')
def _matmul_op(ctx, op):
    """Transposes, then the product (cast under the AMP mark, a float32
    result), then ``alpha`` in float32, in the JAX lowering's order."""
    x, y = ctx.in1(op, 'X'), ctx.in1(op, 'Y')
    if x.dim() == 1:
        x = x.reshape(1, -1)
    if y.dim() == 1:
        y = y.reshape(-1, 1)
    if op.attr('transpose_X', False):
        x = x.transpose(-1, -2)
    if op.attr('transpose_Y', False):
        y = y.transpose(-1, -2)
    out = matmul(x, y, amp.op_policy(op))
    alpha = op.attr('alpha', 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.out(op, 'Out', out)


def _register_elementwise(name, fn):
    @register_op(name)
    def _lower(ctx, op):
        x, y = ctx.in1(op, 'X'), ctx.in1(op, 'Y')
        ctx.out(op, 'Out', fn(x, broadcast_y_to(x, y, op.attr('axis', -1))))


_register_elementwise('elementwise_add', torch.add)
_register_elementwise('elementwise_sub', torch.sub)


@register_op('mean')
def _mean_op(ctx, op):
    ctx.out(op, 'Out', ctx.in1(op, 'X').mean().reshape(1))


@register_op('reduce_sum')
def _reduce_sum_op(ctx, op):
    """The sum over ``dim``, or over every axis with ``reduce_all``."""
    x = ctx.in1(op, 'X')
    dims = tuple(range(x.dim())) if op.attr('reduce_all', False) else \
        tuple(d % x.dim() for d in op.attr('dim', [0]))
    ctx.out(op, 'Out', x.sum(dim=dims, keepdim=op.attr('keep_dim', False)))
