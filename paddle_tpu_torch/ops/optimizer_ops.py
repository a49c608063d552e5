"""The optimizer ops: Adam, per parameter and fused over a parameter set,
Momentum, SGD, Adagrad, and the dense-only LARS, Adamax, DecayedAdagrad,
Adadelta, RMSProp, Ftrl and the proximal updates.

Counterpart of paddle_tpu/ops/optimizer_ops.py: the `adam` lowering,
`_adam_dense`, `_adam_sparse` and `fused_adam` with its Pallas kernel
`_fused_adam_flat`; the `momentum`, `sgd` and `adagrad` lowerings, dense
and SelectedRows; the other lowerings, which densify a SelectedRows
gradient (`_dense_grad`).
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

The program ops update the scope's tensors in place (the JAX ops return
new state, which its executor writes back) and write the same tensors to
their outputs.

A sparse (SelectedRows, core/selected_rows.py) gradient of an embedding
table updates only the rows it touches: `sgd` adds its merged rows;
`momentum`, `adam` and `adagrad` merge them, gather the rows' state,
update it and write it back (the reference's "lazy" functors: an
untouched row keeps its parameter and moments bitwise, while Adam's beta
powers advance for the whole table); in `fused_adam` a sparse gradient
leaves the kernel for the per-parameter update, and the dense float32
group keeps the kernel. Every step has static shapes and no host read.

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
gradient in a run takes :func:`momentum_rows` instead.
"""
import ctypes

import torch

from .. import native
from ..core.registry import register_op
from ..core.selected_rows import (SelectedRows, add_rows, gather_rows,
                                  row_index, set_rows)
from . import kernel_tier

__all__ = ['adam', 'adagrad_rows', 'fused_adam', 'momentum',
           'momentum_rows', 'sgd_rows']

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


def _sqrt(x):
    """The correctly rounded square root on both devices: ``torch.sqrt``
    on the card; on the CPU (whose float32 ``torch.sqrt`` rounds about one
    value in 160 one step off) the float64 root rounded once, which is
    exact to the float32 step, since float64 holds more than twice
    float32's digits. So an update gives the card's bits on the CPU."""
    if x.is_cuda or x.dtype == torch.float64:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def _lr_t(lr, b1p, b2p):
    return lr * _sqrt(1 - b2p) / (1 - b1p)


def _adam_dense(p, g, m1, m2, lr_t, b1, b2, eps):
    """The `adam` op's dense expressions: (p', m1', m2'), new tensors."""
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * g * g
    return p - lr_t * m1o / (_sqrt(m2o) + eps), m1o, m2o


def _adam_rows(p, g, m1, m2, lr_t, b1, b2, eps):
    """The `adam` op's SelectedRows update in place: the merged rows of
    ``g`` and their moments, lazily (the other rows keep their parameters
    and moments)."""
    rows, gv = g.merged()
    gv = gv.to(p.dtype)
    idx, keep = row_index(rows, g.height)
    m1r = b1 * gather_rows(m1, idx, keep) + (1 - b1) * gv
    m2r = b2 * gather_rows(m2, idx, keep) + (1 - b2) * gv * gv
    p_r = gather_rows(p, idx, keep) - lr_t * m1r / (_sqrt(m2r) + eps)
    set_rows(idx, keep, ((p, p_r), (m1, m1r), (m2, m2r)))


@torch.no_grad()
def adam(p, g, m1, m2, b1p, b2p, lr, beta1=0.9, beta2=0.999, eps=1e-8):
    """One parameter's Adam step in place: p, m1, m2 and the one-element
    beta powers b1p, b2p; ``lr`` is a one-element tensor. A SelectedRows
    ``g`` updates its rows only; the beta powers advance all the same."""
    lr_t = _lr_t(lr, b1p, b2p)
    if isinstance(g, SelectedRows):
        _adam_rows(p, g, m1, m2, lr_t, beta1, beta2, eps)
    else:
        po, m1o, m2o = _adam_dense(p, g.to(p.dtype), m1, m2, lr_t, beta1,
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


def _lr(ctx, op):
    return ctx.in1(op, 'LearningRate').reshape(())


def _dense_grad(ctx, op):
    """The op's gradient, densified if it is a SelectedRows (an op with no
    row-wise update, as the reference's ops without a SelectedRows
    kernel)."""
    g = ctx.in1(op, 'Grad')
    return g.to_dense() if isinstance(g, SelectedRows) else g


def _records(ctx, op):
    """True when autograd records the op: a gradient is taken through the
    update itself (the `backward` op's ``wrt`` includes its inputs). The
    update then makes new tensors, as the JAX lowering does, in place of
    writing its state in place."""
    return kernel_tier.records_grad(*(
        t for slot in op.inputs for t in ctx.in_list(op, slot)
        if isinstance(t, torch.Tensor)))


def _update(ctx, op, pairs):
    """Copy each new value into its state tensor (the input ``slot``) in
    place and name that tensor as the output ``out``: ``pairs`` is
    [(slot, out, new value)]. Where autograd records the op the new values
    are the outputs themselves."""
    recording = _records(ctx, op)
    for slot, out, new in pairs:
        t = new
        if not recording:
            t = ctx.in1(op, slot)
            t.copy_(new)
        ctx.out(op, out, t)


@register_op('fused_adam', stateful=True)
def _fused_adam_op(ctx, op):
    """The dense float32 gradients through the kernel in one launch; a
    SelectedRows gradient (or another dtype) leaves it for the per-parameter
    update, as the JAX op's per-op fallback rule says."""
    ps = ctx.in_list(op, 'Params')
    gs = ctx.in_list(op, 'Grads')
    m1s, m2s = ctx.in_list(op, 'Moment1s'), ctx.in_list(op, 'Moment2s')
    b1ps, b2ps = ctx.in_list(op, 'Beta1Pows'), ctx.in_list(op, 'Beta2Pows')
    lr = ctx.in1(op, 'LearningRate')
    b1, b2 = op.attr('beta1', 0.9), op.attr('beta2', 0.999)
    eps = op.attr('epsilon', 1e-8)
    fused = [i for i, g in enumerate(gs) if not isinstance(g, SelectedRows)
             and ps[i].dtype == torch.float32]
    if fused:
        pick = lambda xs: [xs[i] for i in fused]
        fused_adam(pick(ps), [gs[i].contiguous() for i in fused], pick(m1s),
                   pick(m2s), pick(b1ps), pick(b2ps), lr, b1, b2, eps)
    for i in sorted(set(range(len(ps))) - set(fused)):
        adam(ps[i], gs[i], m1s[i], m2s[i], b1ps[i], b2ps[i], lr, b1, b2, eps)
    _outs(ctx, op, (('ParamsOut', ps), ('Moment1sOut', m1s),
                    ('Moment2sOut', m2s), ('Beta1PowsOut', b1ps),
                    ('Beta2PowsOut', b2ps)))


@register_op('adam', stateful=True)
def _adam_op(ctx, op):
    p, m1, m2 = (ctx.in1(op, s) for s in ('Param', 'Moment1', 'Moment2'))
    b1p, b2p = ctx.in1(op, 'Beta1Pow'), ctx.in1(op, 'Beta2Pow')
    lr, g = ctx.in1(op, 'LearningRate'), ctx.in1(op, 'Grad')
    b1, b2 = op.attr('beta1', 0.9), op.attr('beta2', 0.999)
    if _records(ctx, op) and not isinstance(g, SelectedRows):
        p, m1, m2 = _adam_dense(p, g.to(p.dtype), m1, m2,
                                _lr_t(lr, b1p, b2p), b1, b2,
                                op.attr('epsilon', 1e-8))
        b1p, b2p = b1p * b1, b2p * b2
    else:
        adam(p, g, m1, m2, b1p, b2p, lr, b1, b2, op.attr('epsilon', 1e-8))
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


@torch.no_grad()
def momentum_rows(p, g, v, lr, mu, use_nesterov=False):
    """The `momentum` op's SelectedRows update in place: the merged rows of
    ``g``, their velocities and parameters; the other rows keep stale
    velocities (the reference's lazy SparseMomentumFunctor)."""
    lr = lr.reshape(())
    rows, gv = g.merged()
    gv = gv.to(p.dtype)
    idx, keep = row_index(rows, g.height)
    v_r = mu * gather_rows(v, idx, keep) + gv
    if use_nesterov:
        p_r = gather_rows(p, idx, keep) - (gv + mu * v_r) * lr
    else:
        p_r = gather_rows(p, idx, keep) - lr * v_r
    set_rows(idx, keep, ((p, p_r), (v, v_r)))


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
    """The run's dense gradients in one `momentum` pass, each SelectedRows
    gradient by `momentum_rows`."""
    if _records(ctx, op) and \
            not isinstance(ctx.in1(op, 'Grad'), SelectedRows):
        # a gradient through the update: new tensors, the same expressions
        p, g, v = (ctx.in1(op, s) for s in ('Param', 'Grad', 'Velocity'))
        lr, mu = _lr(ctx, op), op.attr('mu')
        v = v * mu + g
        step = (v * mu + g) * lr if op.attr('use_nesterov', False) \
            else v * lr
        ctx.out(op, 'ParamOut', p - step)
        ctx.out(op, 'VelocityOut', v)
        return
    run = ctx.memo('momentum_runs',
                   lambda: _momentum_runs(ctx.plan)).get(ctx.op_index)
    if run is not None:
        ops = [ctx.plan.ops[i] for i in run
               if not _records(ctx, ctx.plan.ops[i])]
        lr, mu = ctx.in1(op, 'LearningRate'), op.attr('mu')
        nesterov = op.attr('use_nesterov', False)
        dense = []
        for o in ops:
            g = ctx.in1(o, 'Grad')
            if isinstance(g, SelectedRows):
                momentum_rows(ctx.in1(o, 'Param'), g, ctx.in1(o, 'Velocity'),
                              lr, mu, nesterov)
            else:
                dense.append(o)
        if dense:
            momentum([ctx.in1(o, 'Param') for o in dense],
                     [ctx.in1(o, 'Grad') for o in dense],
                     [ctx.in1(o, 'Velocity') for o in dense], lr, mu,
                     nesterov)
    ctx.out(op, 'ParamOut', ctx.in1(op, 'Param'))
    ctx.out(op, 'VelocityOut', ctx.in1(op, 'Velocity'))


@torch.no_grad()
def sgd_rows(p, g, lr):
    """The `sgd` op's SelectedRows update in place: ``-lr`` times each
    merged row added to its parameter row (the dense update's bits where
    the dense gradient is the merged sum; the JAX op adds the unmerged
    rows one by one, which rounds otherwise)."""
    lr = lr.reshape(())
    rows, gv = g.merged()
    add_rows(p, *row_index(rows, g.height),
             (-lr).to(p.dtype) * gv.to(p.dtype))


@register_op('sgd', stateful=True)
def _sgd_op(ctx, op):
    p = ctx.in1(op, 'Param')
    lr = _lr(ctx, op)
    g = ctx.in1(op, 'Grad')
    if isinstance(g, SelectedRows):
        sgd_rows(p, g, lr)
    elif _records(ctx, op):
        p = p - lr.to(p.dtype) * g.to(p.dtype)
    else:
        p.sub_(lr.to(p.dtype) * g.to(p.dtype))
    ctx.out(op, 'ParamOut', p)


@torch.no_grad()
def adagrad_rows(p, g, m, lr, eps=1e-6):
    """The `adagrad` op's SelectedRows update in place: the merged rows of
    ``g``, their moments and parameters only (the reference's
    SparseAdagradFunctor); ``lr`` a one-element tensor."""
    lr = lr.reshape(())
    rows, gv = g.merged()
    gv = gv.to(p.dtype)
    idx, keep = row_index(rows, g.height)
    m_r = gather_rows(m, idx, keep) + gv * gv
    p_r = gather_rows(p, idx, keep) - lr * gv / (_sqrt(m_r) + eps)
    set_rows(idx, keep, ((p, p_r), (m, m_r)))


@register_op('adagrad', stateful=True)
def _adagrad_op(ctx, op):
    p, m, g = ctx.in1(op, 'Param'), ctx.in1(op, 'Moment'), \
        ctx.in1(op, 'Grad')
    lr = _lr(ctx, op)
    eps = op.attr('epsilon', 1e-6)
    if isinstance(g, SelectedRows):
        adagrad_rows(p, g, m, lr, eps)
        ctx.out(op, 'ParamOut', p)
        ctx.out(op, 'MomentOut', m)
        return
    mo = m + g * g
    _update(ctx, op, (('Param', 'ParamOut',
                       p - lr * g / (_sqrt(mo) + eps)),
                      ('Moment', 'MomentOut', mo)))


# ---------------------------------------------------------------------------
# the optimizers with a dense update only: a SelectedRows gradient
# densifies (`_dense_grad`)


@register_op('lars_momentum', stateful=True)
def _lars_momentum_op(ctx, op):
    p, v, g = ctx.in1(op, 'Param'), ctx.in1(op, 'Velocity'), \
        _dense_grad(ctx, op)
    lr = _lr(ctx, op)
    mu = op.attr('mu')
    coeff = op.attr('lars_coeff', 0.001)
    decay = op.attr('lars_weight_decay', 0.0005)
    pn = _sqrt(torch.sum(p * p))
    gn = _sqrt(torch.sum(g * g))
    local_lr = torch.where(pn > 0, lr * coeff * pn /
                           (gn + decay * pn + 1e-12), lr)
    v_out = mu * v + local_lr * (g + decay * p)
    _update(ctx, op, (('Param', 'ParamOut', p - v_out),
                      ('Velocity', 'VelocityOut', v_out)))


@register_op('adamax', stateful=True)
def _adamax_op(ctx, op):
    """The beta1 power advances in a `scale` op after it
    (`AdamaxOptimizer._finish_update`)."""
    p, m, inf = (ctx.in1(op, s) for s in ('Param', 'Moment', 'InfNorm'))
    g = _dense_grad(ctx, op)
    b1p = ctx.in1(op, 'Beta1Pow').reshape(())
    lr = _lr(ctx, op)
    b1, b2 = op.attr('beta1', 0.9), op.attr('beta2', 0.999)
    eps = op.attr('epsilon', 1e-8)
    mo = b1 * m + (1 - b1) * g
    info = torch.maximum(b2 * inf, torch.abs(g))
    lr_t = lr / (1 - b1p)
    _update(ctx, op, (('Param', 'ParamOut', p - lr_t * mo / (info + eps)),
                      ('Moment', 'MomentOut', mo),
                      ('InfNorm', 'InfNormOut', info)))


@register_op('decayed_adagrad', stateful=True)
def _decayed_adagrad_op(ctx, op):
    p, m, g = ctx.in1(op, 'Param'), ctx.in1(op, 'Moment'), \
        _dense_grad(ctx, op)
    lr = _lr(ctx, op)
    decay = op.attr('decay', 0.95)
    eps = op.attr('epsilon', 1e-6)
    mo = decay * m + (1 - decay) * g * g
    _update(ctx, op, (('Param', 'ParamOut',
                       p - lr * g / (_sqrt(mo) + eps)),
                      ('Moment', 'MomentOut', mo)))


@register_op('adadelta', stateful=True)
def _adadelta_op(ctx, op):
    p, g = ctx.in1(op, 'Param'), _dense_grad(ctx, op)
    eg, ex = ctx.in1(op, 'AvgSquaredGrad'), ctx.in1(op, 'AvgSquaredUpdate')
    rho = op.attr('rho', 0.95)
    eps = op.attr('epsilon', 1e-6)
    ego = rho * eg + (1 - rho) * g * g
    update = -_sqrt((ex + eps) / (ego + eps)) * g
    exo = rho * ex + (1 - rho) * update * update
    _update(ctx, op, (('Param', 'ParamOut', p + update),
                      ('AvgSquaredGrad', 'AvgSquaredGradOut', ego),
                      ('AvgSquaredUpdate', 'AvgSquaredUpdateOut', exo)))


@register_op('rmsprop', stateful=True)
def _rmsprop_op(ctx, op):
    """``centered`` subtracts the squared mean gradient from the mean
    square; otherwise MeanGrad stays as it is."""
    p, g = ctx.in1(op, 'Param'), _dense_grad(ctx, op)
    ms, mom = ctx.in1(op, 'MeanSquare'), ctx.in1(op, 'Moment')
    lr = _lr(ctx, op)
    rho = op.attr('decay', 0.95)
    eps = op.attr('epsilon', 1e-6)
    mso = rho * ms + (1 - rho) * g * g
    new = [('MeanSquare', 'MeanSquareOut', mso)]
    if op.attr('centered', False):
        mgo = rho * ctx.in1(op, 'MeanGrad') + (1 - rho) * g
        denom = mso - mgo * mgo + eps
        new.append(('MeanGrad', 'MeanGradOut', mgo))
    else:
        denom = mso + eps
        if op.input('MeanGrad'):
            ctx.out(op, 'MeanGradOut', ctx.in1(op, 'MeanGrad'))
    momo = op.attr('momentum', 0.0) * mom + lr * g / _sqrt(denom)
    _update(ctx, op, new + [('Moment', 'MomentOut', momo),
                            ('Param', 'ParamOut', p - momo)])


@register_op('ftrl', stateful=True)
def _ftrl_op(ctx, op):
    p, g = ctx.in1(op, 'Param'), _dense_grad(ctx, op)
    sq = ctx.in1(op, 'SquaredAccumulator')
    lin = ctx.in1(op, 'LinearAccumulator')
    lr = _lr(ctx, op)
    l1, l2 = op.attr('l1', 0.0), op.attr('l2', 0.0)
    power = op.attr('lr_power', -0.5)
    new_sq = sq + g * g
    sigma = (new_sq ** -power - sq ** -power) / lr
    lino = lin + g - sigma * p
    y = new_sq ** -power / lr + 2 * l2
    p_out = torch.where(torch.abs(lino) > l1,
                        (torch.sign(lino) * l1 - lino) / y,
                        torch.zeros_like(lino))
    _update(ctx, op, (('Param', 'ParamOut', p_out),
                      ('SquaredAccumulator', 'SquaredAccumOut', new_sq),
                      ('LinearAccumulator', 'LinearAccumOut', lino)))


def _proximal(prox, lr_t, l1, l2):
    return torch.sign(prox) * torch.clamp(torch.abs(prox) - lr_t * l1,
                                          min=0.0) / (1.0 + lr_t * l2)


@register_op('proximal_gd', stateful=True)
def _proximal_gd_op(ctx, op):
    p, g = ctx.in1(op, 'Param'), _dense_grad(ctx, op)
    lr = _lr(ctx, op)
    _update(ctx, op, (('Param', 'ParamOut', _proximal(
        p - lr * g, lr, op.attr('l1', 0.0), op.attr('l2', 0.0))),))


@register_op('proximal_adagrad', stateful=True)
def _proximal_adagrad_op(ctx, op):
    p, m, g = ctx.in1(op, 'Param'), ctx.in1(op, 'Moment'), \
        _dense_grad(ctx, op)
    lr = _lr(ctx, op)
    mo = m + g * g
    lr_t = lr / _sqrt(mo)
    _update(ctx, op, (('Param', 'ParamOut', _proximal(
        p - lr_t * g, lr_t, op.attr('l1', 0.0), op.attr('l2', 0.0))),
                      ('Moment', 'MomentOut', mo)))
