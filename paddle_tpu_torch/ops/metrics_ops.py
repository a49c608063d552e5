"""Metric ops of a Program: ``accuracy``.

The port's own copy of the `accuracy` lowering of
paddle_tpu/ops/metrics_ops.py: a row is correct when its label is among
its ``top_k`` indices; ``Accuracy`` is the float32 share of correct rows,
``Correct`` and ``Total`` their int32 counts, each of shape [1].
"""
import torch

from ..core.registry import register_op

__all__ = []


@register_op('accuracy')
def _accuracy(ctx, op):
    indices = ctx.in1(op, 'Indices')        # [N, k] from top_k
    label = ctx.in1(op, 'Label')            # [N, 1]
    correct = (indices == label.to(indices.dtype)).any(dim=1)
    num_correct = correct.to(torch.int32).sum()
    total = indices.shape[0]
    ctx.out(op, 'Accuracy',
            (num_correct.to(torch.float32) / total).reshape(1))
    ctx.out(op, 'Correct', num_correct.reshape(1))
    # a fill on the device (no host-to-device copy inside a captured graph)
    ctx.out(op, 'Total', torch.full((1,), total, dtype=torch.int32,
                                    device=indices.device))
