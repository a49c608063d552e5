"""Adam, per parameter and fused over a parameter set, Momentum and SGD.

Counterpart of paddle_tpu/ops/optimizer_ops.py: the `adam` lowering,
`_adam_dense`, and `fused_adam` with its Pallas kernel `_fused_adam_flat`;
the dense `momentum` and `sgd` lowerings.
The update places eps as Paddle does (outside the square root of the
bias-corrected moment, inside the step size)::

    lr_t = lr * sqrt(1 - beta2_pow) / (1 - beta1_pow)
    m1 = b1 * m1 + (1 - b1) * g
    m2 = b2 * m2 + (1 - b2) * g * g
    p  = p - lr_t * m1 / (sqrt(m2) + eps)

and then every beta power advances (``beta1_pow *= b1``). This is not
``torch.optim.Adam``, whose eps sits beside sqrt(m2 / (1 - beta2_pow)).

The JAX package is functional; here the state tensors are updated in
place. :func:`fused_adam` takes lr_t from the FIRST parameter's beta powers
(all advance alike) and on CUDA tensors launches ``csrc/fused_adam.cu``
once for the whole set (lr_t computed on the card, no host read); on the
CPU it runs :func:`_fused_adam_ref`. :func:`adam` is the per-parameter
update of the `adam` op (an XLA lowering with no Pallas kernel), plain
PyTorch on every device.

The program ops `fused_adam`, `adam`, `momentum` and `sgd` update the
scope's tensors in place (the JAX ops return new state, which its executor
writes back) and write the same tensors to their outputs.

:func:`momentum` is the `momentum` op's dense update (plain math, outside
any Pallas kernel in the JAX package too)::

    v = mu * v + g
    p = p - lr * v                  (use_nesterov: p - (g + mu * v) * lr)

over a whole parameter set with ``torch._foreach_*`` ops: a program holds
one `momentum` op a parameter (ResNet-50 has 161), and three ATen calls
for each would make the step launch-bound. The program op applies it to
each run of consecutive `momentum` ops that share ``mu``, ``use_nesterov``
and the learning-rate variable, at the run's first op
(:func:`_momentum_runs`); the others only name their outputs. A sparse
(SelectedRows) gradient waits for sparse gradients.
"""
import ctypes

import torch

from .. import native
from ..core.registry import register_op
from . import kernel_tier

__all__ = ['adam', 'fused_adam', 'momentum']

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        PP = ctypes.POINTER(ctypes.c_void_p)
        _fn = native.function('fused_adam', 'ptt_fused_adam',
                              [PP, PP, PP, PP, PP, PP,
                               ctypes.POINTER(ctypes.c_int64), I, P, P,
                               F, F, F, F, F, P])
    return _fn


def _lr_t(lr, b1p, b2p):
    return lr * torch.sqrt(1 - b2p) / (1 - b1p)


def _adam_dense(p, g, m1, m2, lr_t, b1, b2, eps):
    """The `adam` op's dense expressions: (p', m1', m2'), new tensors."""
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * g * g
    return p - lr_t * m1o / (torch.sqrt(m2o) + eps), m1o, m2o


@torch.no_grad()
def adam(p, g, m1, m2, b1p, b2p, lr, beta1=0.9, beta2=0.999, eps=1e-8):
    """One parameter's Adam step in place: p, m1, m2 and the one-element
    beta powers b1p, b2p; ``lr`` is a one-element tensor."""
    po, m1o, m2o = _adam_dense(p, g, m1, m2, _lr_t(lr, b1p, b2p), beta1,
                               beta2, eps)
    p.copy_(po)
    m1.copy_(m1o)
    m2.copy_(m2o)
    b1p.mul_(beta1)
    b2p.mul_(beta2)


def _fused_adam_ref(params, grads, m1s, m2s, b1ps, b2ps, lr, beta1, beta2,
                    eps):
    """Plain version of the kernel, in place."""
    lr_t = _lr_t(lr, b1ps[0], b2ps[0])
    for p, g, m1, m2 in zip(params, grads, m1s, m2s):
        po, m1o, m2o = _adam_dense(p, g, m1, m2, lr_t, beta1, beta2, eps)
        p.copy_(po)
        m1.copy_(m1o)
        m2.copy_(m2o)
    for b1p, b2p in zip(b1ps, b2ps):
        b1p.mul_(beta1)
        b2p.mul_(beta2)


@torch.no_grad()
def fused_adam(params, grads, m1s, m2s, b1ps, b2ps, lr, beta1=0.9,
               beta2=0.999, eps=1e-8):
    """Adam over a whole parameter set in place, with one lr_t taken from
    the first parameter's beta powers; every beta power then advances.
    ``params``, ``grads``, ``m1s``, ``m2s`` are lists of f32 tensors of
    matching shapes, ``b1ps``/``b2ps`` lists of one-element f32 tensors,
    ``lr`` a one-element f32 tensor."""
    n = len(params)
    if not (n == len(grads) == len(m1s) == len(m2s) == len(b1ps)
            == len(b2ps)) or n == 0:
        raise ValueError('fused_adam needs one grad, two moments and two '
                         'beta powers for each of its (>= 1) parameters')
    everything = list(params) + list(grads) + list(m1s) + list(m2s) + \
        list(b1ps) + list(b2ps) + [lr]
    if not kernel_tier.on_cuda(*everything):
        _fused_adam_ref(params, grads, m1s, m2s, b1ps, b2ps, lr, beta1,
                        beta2, eps)
        return
    dev = params[0].device
    for i, (p, g, m1, m2, b1p, b2p) in enumerate(
            zip(params, grads, m1s, m2s, b1ps, b2ps)):
        shape = tuple(p.shape)
        kernel_tier.require(p, 'param %d' % i, shape, device=dev)
        kernel_tier.require(g, 'grad %d' % i, shape, device=dev)
        kernel_tier.require(m1, 'moment1 %d' % i, shape, device=dev)
        kernel_tier.require(m2, 'moment2 %d' % i, shape, device=dev)
        kernel_tier.require(b1p, 'beta1_pow %d' % i, (1,), device=dev)
        kernel_tier.require(b2p, 'beta2_pow %d' % i, (1,), device=dev)
    kernel_tier.require(lr, 'learning rate', (1,), device=dev)
    arr = ctypes.c_void_p * n
    lr_t = torch.empty((1,), dtype=torch.float32, device=dev)
    rc = _kernel()(arr(*[t.data_ptr() for t in params]),
                   arr(*[t.data_ptr() for t in grads]),
                   arr(*[t.data_ptr() for t in m1s]),
                   arr(*[t.data_ptr() for t in m2s]),
                   arr(*[t.data_ptr() for t in b1ps]),
                   arr(*[t.data_ptr() for t in b2ps]),
                   (ctypes.c_int64 * n)(*[t.numel() for t in params]), n,
                   lr.data_ptr(), lr_t.data_ptr(), float(beta1),
                   float(1.0 - beta1), float(beta2), float(1.0 - beta2),
                   float(eps), kernel_tier.stream_ptr(lr))
    native.check(rc, 'fused_adam')
    kernel_tier.count('fused_adam')


# ---------------------------------------------------------------------------
# the program ops


def _outs(ctx, op, pairs):
    for slot, ts in pairs:
        for i, t in enumerate(ts):
            ctx.out(op, slot, t, idx=i)


@register_op('fused_adam', stateful=True)
def _fused_adam_op(ctx, op):
    ps = ctx.in_list(op, 'Params')
    gs = [g.contiguous() for g in ctx.in_list(op, 'Grads')]
    m1s, m2s = ctx.in_list(op, 'Moment1s'), ctx.in_list(op, 'Moment2s')
    b1ps, b2ps = ctx.in_list(op, 'Beta1Pows'), ctx.in_list(op, 'Beta2Pows')
    fused_adam(ps, gs, m1s, m2s, b1ps, b2ps, ctx.in1(op, 'LearningRate'),
               op.attr('beta1', 0.9), op.attr('beta2', 0.999),
               op.attr('epsilon', 1e-8))
    _outs(ctx, op, (('ParamsOut', ps), ('Moment1sOut', m1s),
                    ('Moment2sOut', m2s), ('Beta1PowsOut', b1ps),
                    ('Beta2PowsOut', b2ps)))


@register_op('adam', stateful=True)
def _adam_op(ctx, op):
    p, m1, m2 = (ctx.in1(op, s) for s in ('Param', 'Moment1', 'Moment2'))
    b1p, b2p = ctx.in1(op, 'Beta1Pow'), ctx.in1(op, 'Beta2Pow')
    adam(p, ctx.in1(op, 'Grad'), m1, m2, b1p, b2p,
         ctx.in1(op, 'LearningRate'), op.attr('beta1', 0.9),
         op.attr('beta2', 0.999), op.attr('epsilon', 1e-8))
    _outs(ctx, op, (('ParamOut', [p]), ('Moment1Out', [m1]),
                    ('Moment2Out', [m2]), ('Beta1PowOut', [b1p]),
                    ('Beta2PowOut', [b2p])))


@torch.no_grad()
def momentum(params, grads, velocities, lr, mu, use_nesterov=False):
    """Momentum over a parameter set in place: ``params``, ``grads`` and
    ``velocities`` are lists of tensors of matching shapes, ``lr`` a
    one-element tensor (module docstring). Each expression is one
    ``torch._foreach_*`` pass over the set, in the JAX lowering's order of
    operations."""
    lr = lr.reshape(())
    torch._foreach_mul_(velocities, mu)
    torch._foreach_add_(velocities, grads)
    if use_nesterov:
        step = torch._foreach_mul(velocities, mu)
        torch._foreach_add_(step, grads)
        torch._foreach_mul_(step, lr)
    else:
        step = torch._foreach_mul(velocities, lr)
    torch._foreach_sub_(params, step)


def _momentum_runs(plan):
    """{index of a run's first op: the run's op indices} for the runs of
    consecutive `momentum` ops of ``plan`` with one ``mu``,
    ``use_nesterov`` and learning-rate variable."""
    runs, first, prev = {}, None, None
    for i, op in enumerate(plan.ops):
        key = (op.attr('mu'), bool(op.attr('use_nesterov', False)),
               tuple(op.input('LearningRate'))) \
            if op.type == 'momentum' else None
        if key is not None and key == prev:
            runs[first].append(i)
        elif key is not None:
            first = i
            runs[i] = [i]
        prev = key
    return runs


@register_op('momentum', stateful=True)
def _momentum_op(ctx, op):
    run = ctx.memo('momentum_runs',
                   lambda: _momentum_runs(ctx.plan)).get(ctx.op_index)
    if run is not None:
        ops = [ctx.plan.ops[i] for i in run]
        grads = [ctx.in1(o, 'Grad') for o in ops]
        if not all(isinstance(g, torch.Tensor) for g in grads):
            raise NotImplementedError(
                'momentum: sparse (SelectedRows) gradients wait for a '
                'later slice of paddle_tpu_torch')
        momentum([ctx.in1(o, 'Param') for o in ops], grads,
                 [ctx.in1(o, 'Velocity') for o in ops],
                 ctx.in1(op, 'LearningRate'), op.attr('mu'),
                 op.attr('use_nesterov', False))
    ctx.out(op, 'ParamOut', ctx.in1(op, 'Param'))
    ctx.out(op, 'VelocityOut', ctx.in1(op, 'Velocity'))


@register_op('sgd', stateful=True)
def _sgd_op(ctx, op):
    p = ctx.in1(op, 'Param')
    lr = ctx.in1(op, 'LearningRate').reshape(())
    p.sub_(lr.to(p.dtype) * ctx.in1(op, 'Grad').to(p.dtype))
    ctx.out(op, 'ParamOut', p)
