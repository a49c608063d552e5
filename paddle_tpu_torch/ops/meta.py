"""Framework ops: ``backward``, constants, ``assign``, ``scale``, ``clip``,
``clip_by_norm``, casts and the shape and counter ops.

The port's own lowerings of paddle_tpu/ops/meta.py's `backward`,
`fill_constant`, `assign`, `assign_value`, `scale`, `clip` and
`clip_by_norm` (dense, and on a SelectedRows gradient as the JAX
lowerings take one), `cast`, `fill`, `fill_zeros_like`,
`fill_constant_batch_size_like`, `shape`, `increment`, `one_hot` and
`is_empty`, in plain PyTorch (the JAX package lowers them to plain XLA
too). The JAX package runs with 64-bit types off, so its int64 and
float64 values are int32 and float32; the port keeps the program's
declared dtypes (`shape` is int32 in both).
"""
import numpy as np
import torch

from ..core.registry import register_op
from ..core.types import convert_np_dtype_to_dtype_
from ..core.selected_rows import SelectedRows
from .common import attr_dtype, clip

__all__ = []


@register_op('backward')
def _backward(ctx, op):
    # core/lowering.py lower_block runs the backward meta-op itself
    raise RuntimeError("'backward' op must be handled by lower_block")


@register_op('fill_constant')
def _fill_constant(ctx, op):
    """A small constant (16 elements or fewer) is also recorded as a static
    value, as in the JAX lowering: an array write at a constant index
    keeps the array's static length."""
    shape = tuple(op.attr('shape', ()))
    value = op.attr('value', 0.0)
    dtype = op.attr('dtype') or 'float32'
    ctx.out(op, 'Out', torch.full(shape, value, dtype=attr_dtype(dtype),
                                  device=ctx.device))
    if int(np.prod(shape or (1,))) <= 16:
        ctx.set_static(op.output('Out')[0], np.full(
            shape, value, dtype=convert_np_dtype_to_dtype_(dtype)))


@register_op('assign')
def _assign(ctx, op):
    ctx.out(op, 'Out', ctx.in1(op, 'X'))


@register_op('assign_value')
def _assign_value(ctx, op):
    """The op's values as a tensor, built once per run plan; a persistable
    output (a parameter's NumpyArray init, which the optimizer then updates
    in place) gets a copy of its own."""
    def build():
        arr = np.asarray(op.attr('values'),
                         dtype=np.dtype(op.attr('dtype') or 'float32'))
        return torch.from_numpy(arr.reshape(tuple(op.attr('shape')))).to(
            ctx.device)

    v = ctx.memo(('assign_value', ctx.op_index), build)
    var = ctx.var(op.output('Out')[0])
    ctx.out(op, 'Out', v.clone() if var is not None and var.persistable
            else v)


@register_op('scale')
def _scale(ctx, op):
    """``x * scale + bias`` (``bias_after_scale``) or ``(x + bias) * scale``;
    a bias of 0 is not added (it changes nothing but the sign of a
    zero). A SelectedRows keeps its rows under a bias of 0 and densifies
    under any other (the bias would touch every row)."""
    x = ctx.in1(op, 'X')
    scale = op.attr('scale', 1.0)
    bias = op.attr('bias', 0.0)
    if isinstance(x, SelectedRows):
        if not bias:
            ctx.out(op, 'Out', x.scale(scale))
            return
        x = x.to_dense()
    if not bias:
        out = x * scale
    elif op.attr('bias_after_scale', True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.out(op, 'Out', out.to(x.dtype))


@register_op('clip')
def _clip(ctx, op):
    """``jnp.clip`` (a gradient at a bound split in half, common.py
    `clip`). A SelectedRows merges its duplicate rows first: a clip does
    not distribute over their sum."""
    x = ctx.in1(op, 'X')
    lo, hi = op.attr('min'), op.attr('max')
    if isinstance(x, SelectedRows):
        rows, vals = x.merged()
        ctx.out(op, 'Out', SelectedRows(rows, clip(vals, lo, hi), x.height))
        return
    ctx.out(op, 'Out', clip(x, lo, hi))


def _norm_factor(x, max_norm):
    norm = torch.sqrt((x.float() ** 2).sum())
    return torch.where(norm > max_norm,
                       max_norm / torch.clamp(norm, min=1e-12),
                       torch.ones_like(norm)).to(x.dtype)


@register_op('clip_by_norm')
def _clip_by_norm(ctx, op):
    """``x * max_norm / norm`` where the float32 L2 norm of all of ``x``
    passes ``max_norm``, else ``x``; the factor is a tensor on the device
    (no host read), cast to ``x``'s dtype as the JAX lowering casts it. A
    SelectedRows takes the norm of its merged rows."""
    x = ctx.in1(op, 'X')
    max_norm = op.attr('max_norm')
    if isinstance(x, SelectedRows):
        rows, vals = x.merged()
        ctx.out(op, 'Out', SelectedRows(
            rows, vals * _norm_factor(vals, max_norm), x.height))
        return
    ctx.out(op, 'Out', x * _norm_factor(x, max_norm))


@register_op('cast')
def _cast(ctx, op):
    x = ctx.in1(op, 'X')
    ctx.out(op, 'Out', x.to(attr_dtype(op.attr('out_dtype'))))


@register_op('fill')
def _fill(ctx, op):
    """The ``value`` attr (a flat list) as a tensor of ``shape``."""
    arr = np.asarray(op.attr('value'), dtype=np.dtype(
        op.attr('dtype') or 'float32')).reshape(tuple(op.attr('shape')))
    ctx.out(op, 'Out', torch.from_numpy(arr).to(ctx.device))


@register_op('fill_zeros_like')
def _fill_zeros_like(ctx, op):
    ctx.out(op, 'Out', torch.zeros_like(ctx.in1(op, 'X')))


@register_op('fill_constant_batch_size_like')
def _fill_constant_batch_size_like(ctx, op):
    """``shape`` with dimension ``output_dim_idx`` taken from the input's
    dimension ``input_dim_idx`` (its batch size), filled with ``value``."""
    x = ctx.in1(op, 'Input')
    shape = list(op.attr('shape'))
    shape[op.attr('output_dim_idx', 0)] = x.shape[op.attr('input_dim_idx',
                                                           0)]
    ctx.out(op, 'Out', torch.full(tuple(shape), op.attr('value', 0.0),
                                  dtype=attr_dtype(op.attr('dtype')),
                                  device=ctx.device))


@register_op('shape')
def _shape(ctx, op):
    x = ctx.in1(op, 'Input')
    ctx.out(op, 'Out', torch.tensor(tuple(x.shape), dtype=torch.int32,
                                    device=ctx.device))


@register_op('increment')
def _increment(ctx, op):
    """``x + step`` in x's dtype: the step is rounded to x's dtype first,
    as the JAX lowering's ``jnp.asarray(step, x.dtype)``, and added as a
    Python number, so that a captured step (the schedules' counter under
    `bind` and `run_fused`) copies nothing from the host."""
    x = ctx.in1(op, 'X')
    step = torch.tensor(op.attr('step', 1.0)).to(x.dtype).item()
    ctx.out(op, 'Out', x + step)


@register_op('one_hot')
def _one_hot(ctx, op):
    """float32 rows of ``depth``, a trailing axis of 1 on the ids folded;
    an id outside [0, depth) gives a row of zeros (``jax.nn.one_hot``)."""
    x = ctx.in1(op, 'X')
    ids = x.reshape(x.shape[:-1]) if x.dim() and x.shape[-1] == 1 else x
    depth = op.attr('depth')
    cols = torch.arange(depth, device=ids.device)
    ctx.out(op, 'Out', (ids.unsqueeze(-1).long() == cols).to(torch.float32))


@register_op('is_empty')
def _is_empty(ctx, op):
    x = ctx.in1(op, 'X')
    ctx.out(op, 'Out', torch.tensor(x.numel() == 0, device=ctx.device))
