"""The training-health stat op (health.py): ``health_stats``.

The port's own lowering of paddle_tpu/ops/health_ops.py. One op at the end
of an instrumented training program reduces every gradient, parameter,
pre-update copy and tapped activation into one small float32 vector, the
one extra fetch the health observatory reads on the step's own dispatch
(under ``bind`` and ``run_fused`` it is part of the captured graph).
Output layout, the JAX op's:

    [ per-grad L2 norm            x len(Grads)
      per-param update/param     x len(Params)   (||p - p_pre|| / ||p_pre||,
                                                  0 where ||p_pre|| is 0)
      per-site activation RMS    x len(Acts)
      global grad L2 norm
      global param L2 norm
      non-finite grad entries (count)
      |g| > attr('large') entries (count)
      mean loss                               ]  (only when Loss is given)

Float32 reductions, a SelectedRows gradient reduced over its values. The
launches do not grow with the tensor count: the norms are multi-tensor
passes (``torch._foreach_norm``, and ``torch._foreach_sub`` for the
updates), and the two counts run over one flat float32 copy of every
gradient (one ``torch.cat``, then an ``isfinite`` and a compare, each
summed). A norm is the square root of the tensor's sum of squares, as in
the JAX op; its rounding differs from XLA's (another order of the sum).
"""
import math

import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows

__all__ = ['health_stats']


def _f32(x):
    if isinstance(x, SelectedRows):
        x = x.values
    return x if x.dtype == torch.float32 else x.float()


def _norms(ts):
    return torch.stack(torch._foreach_norm(ts)) if ts else None


def health_stats(grads, params, pres, acts, loss=None, large=1e3):
    """The stat vector (module docstring) of float32 tensors on one
    device: ``grads`` (tensors or SelectedRows), ``params`` and their
    pre-update copies ``pres``, the tapped activations ``acts`` and the
    loss (or None)."""
    grads = [_f32(g) for g in grads]
    params = [_f32(p) for p in params]
    pres = [_f32(p) for p in pres]
    acts = [_f32(a) for a in acts]
    dev = (grads or params or acts or [loss])[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    parts = []
    gn = _norms(grads)
    if gn is not None:
        parts.append(gn)
        gsq = (gn * gn).sum()
        flat = torch.cat([g.reshape(-1) for g in grads])
        nonfinite = (~torch.isfinite(flat)).sum().float()
        big = (flat.abs() > large).sum().float()
    else:
        gsq, nonfinite, big = zero, zero, zero
    if params:
        pn = _norms(params)
        pre = _norms(pres)
        dn = _norms(torch._foreach_sub(params, pres))
        parts.append(torch.where(pre > 0, dn / (pre + 1e-12),
                                 torch.zeros_like(pre)))
        psq = (pn * pn).sum()
    else:
        psq = zero
    if acts:
        # the RMS as the norm over the square root of the count: a scalar a
        # tensor, so that a captured step copies nothing from the host
        parts.append(torch.stack(torch._foreach_mul(
            torch._foreach_norm(acts),
            [1.0 / math.sqrt(max(a.numel(), 1)) for a in acts])))
    tail = [torch.sqrt(gsq), torch.sqrt(psq), nonfinite, big]
    if loss is not None:
        tail.append(loss.float().mean())
    parts.append(torch.stack(tail))
    return torch.cat(parts)


@register_op('health_stats', share_lod=False)
def _health_stats(ctx, op):
    loss = ctx.in1(op, 'Loss')
    ctx.out(op, 'Out', health_stats(
        ctx.in_list(op, 'Grads'), ctx.in_list(op, 'Params'),
        ctx.in_list(op, 'Pre'), ctx.in_list(op, 'Acts'), loss,
        float(op.attr('large', 1e3))))
