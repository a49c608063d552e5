"""Learning-rate schedules as ops over a persistable step counter.

The port's own copy of paddle_tpu/layers/learning_rate_scheduler.py: each
schedule reads the auto-incremented ``@LR_DECAY_COUNTER@`` (an int64
persistable, advanced by one ``increment`` at the top of each run) and
computes the rate with Variable arithmetic (layers/math_op_patch.py), so
the rate is a one-element tensor computed on the device inside the step:
no host read, and a bound or fused step replays it with the rest of the
graph. ``piecewise_decay`` is branch-free (comparisons cast to float).
``append_LARS`` replaces each parameter's local rate by a Variable that
the optimizer's ``_create_param_lr`` takes.
"""
import math

from .nn import autoincreased_step_counter
from . import tensor
from . import nn
from . import ops as _ops

__all__ = [
    'exponential_decay', 'natural_exp_decay', 'inverse_time_decay',
    'polynomial_decay', 'piecewise_decay', 'noam_decay', 'cosine_decay',
    'append_LARS', 'linear_lr_warmup',
]


def _decay_step_counter(begin=0):
    counter = autoincreased_step_counter(counter_name='@LR_DECAY_COUNTER@',
                                         begin=begin, step=1)
    return tensor.cast(counter, 'float32')


def noam_decay(d_model, warmup_steps):
    step = _decay_step_counter(1)
    a = step ** -0.5
    b = (warmup_steps ** -1.5) * step
    return (d_model ** -0.5) * nn.elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = _ops.floor(div)
    return learning_rate * (decay_rate ** div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = _ops.floor(div)
    return learning_rate * _ops.exp(-1 * decay_rate * div)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = _ops.floor(div)
    return learning_rate / (1 + decay_rate * div)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _decay_step_counter()
    if cycle:
        div_res = _ops.ceil(step / float(decay_steps))
        # max(div, 1): at step 0 the first cycle
        zero_check = nn.elementwise_max(div_res, div_res * 0.0 + 1.0)
        decay_steps_var = zero_check * float(decay_steps)
        frac = 1.0 - step / decay_steps_var
    else:
        step = nn.elementwise_min(step, step * 0.0 + float(decay_steps))
        frac = 1.0 - step / float(decay_steps)
    return (learning_rate - end_learning_rate) * (frac ** power) + \
        end_learning_rate


def piecewise_decay(boundaries, values):
    """values[i] while the step is below boundaries[i], values[-1] after
    the last; computed with comparisons, no branch."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries)+1")
    step = _decay_step_counter()
    lr = step * 0.0 + float(values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        is_before = tensor.cast(step < float(b), 'float32')
        lr = is_before * float(v) + (1.0 - is_before) * lr
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _decay_step_counter()
    epoch = _ops.floor(step / step_each_epoch)
    return learning_rate * 0.5 * (
        _ops.cos(epoch * math.pi / epochs) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """From ``start_lr`` to ``end_lr`` linearly over ``warmup_steps``, then
    ``learning_rate`` (a float or another schedule's Variable)."""
    step = _decay_step_counter()
    before = tensor.cast(step < float(warmup_steps), 'float32')
    warm = start_lr + (end_lr - start_lr) * step / float(warmup_steps)
    return before * warm + (1.0 - before) * learning_rate


def append_LARS(params_grads, learning_rate, weight_decay):
    """Layer-wise adaptive rate scaling: each parameter's local rate
    becomes lr * ||p|| / (||g|| + weight_decay * ||p||), a Variable stored
    in ``param.optimize_attr['learning_rate']``."""
    def _balanced_weight(param_norm, grad_norm):
        if weight_decay == 1.0:
            return grad_norm + param_norm
        return grad_norm + weight_decay * param_norm

    for param, grad in params_grads:
        param_lr = param.optimize_attr.get('learning_rate', 1.0)
        param_norm = _ops.sqrt(nn.reduce_sum(_ops.square(param)))
        grad_norm = _ops.sqrt(nn.reduce_sum(_ops.square(grad)))
        if isinstance(param_lr, float) and param_lr == 1.0:
            decayed_lr = learning_rate * param_norm / \
                _balanced_weight(param_norm, grad_norm)
        else:
            decayed_lr = learning_rate * param_lr * param_norm / \
                _balanced_weight(param_norm, grad_norm)
        param.optimize_attr['learning_rate'] = decayed_lr
