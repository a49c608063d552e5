"""Optimizers: Fluid's program-building optimizers, and Adam on tensors.

The port's own copy of paddle_tpu/optimizer.py `Optimizer` (``backward``,
``apply_gradients``, ``minimize``) and its optimizers, with their aliases:
``SGD``, ``Momentum``, ``LarsMomentum``, ``Adagrad`` (with
``initial_accumulator_value``), ``Adam``, ``Adamax``, ``DecayedAdagrad``,
``Adadelta``, ``RMSProp`` and ``Ftrl``.
``minimize(loss)`` appends the ``backward`` meta-op (backward.py), the
gradient clips (clip.py), the weight decay (regularizer.py) and the update
ops to the loss's program, and the learning rate and the accumulators to
the startup program, under the JAX package's names (``learning_rate_0``,
``<param>_velocity_0``, ``<param>_moment1_0``, ``<param>_beta1_pow_acc_0``,
...). ``Adam(fuse=True)`` emits one ``fused_adam`` op over the parameter
set, ``fuse=False`` one ``adam`` op a parameter; ``Momentum`` one
``momentum`` op a parameter, which the Executor applies a run at a time
(ops/optimizer_ops.py); the others one op a parameter (``Adamax`` then a
``scale`` op a parameter for its beta1 power). A sparse (SelectedRows)
gradient updates its rows only under ``SGD``, ``Momentum``, ``Adagrad``
and ``Adam``, and densifies under the rest. ``ModelAverage`` waits for a
later slice and raises NotImplementedError.

:class:`TensorAdam` is the same Adam over tensors, for a model driven
without a Program (`TransformerLM.loss`, `BertPretrain.loss`): each
parameter has its moment1, moment2 (zeros, its shape) and its one-element
beta1_pow and beta2_pow (starting at beta1 and beta2), all on the
parameters' device; the learning rate is a one-element tensor there too,
as the JAX scope holds ``learning_rate_0``. ``fuse=True`` applies
:func:`ops.optimizer_ops.fused_adam` to the whole set in one launch, as
the JAX package's ``fuse=True`` emits one `fused_adam` op; ``fuse=False``
runs the per-parameter `adam` update.
"""
import collections.abc

import torch

from . import health, unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework import Variable, default_main_program
from .initializer import Constant
from .layer_helper import LayerHelper
from .ops import optimizer_ops
from .regularizer import append_regularization_ops

__all__ = ['SGD', 'Momentum', 'Adagrad', 'Adam', 'Adamax', 'DecayedAdagrad',
           'Ftrl', 'SGDOptimizer', 'MomentumOptimizer', 'AdagradOptimizer',
           'AdamOptimizer', 'AdamaxOptimizer', 'DecayedAdagradOptimizer',
           'RMSPropOptimizer', 'FtrlOptimizer', 'Adadelta',
           'AdadeltaOptimizer', 'ModelAverage', 'LarsMomentum',
           'LarsMomentumOptimizer', 'RMSProp', 'Optimizer', 'TensorAdam']


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._learning_rate_map = {}
        self._accumulators = {}
        self.helper = None

    def _create_global_learning_rate(self):
        program = default_main_program()
        lr = self._learning_rate_map.get(program)
        if lr is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        if not isinstance(self._learning_rate, float):
            raise TypeError("learning rate must be float or Variable")
        helper = LayerHelper('learning_rate')
        lr_name = unique_name.generate("learning_rate")
        lr_var = helper.create_or_get_global_variable(
            name=lr_name, dtype='float32', shape=(1,))
        lr_var.persistable = True
        lr_var.stop_gradient = True
        helper.set_variable_initializer(
            lr_var, Constant(float(self._learning_rate)))
        self._learning_rate_map[program] = lr_var

    @property
    def _global_learning_rate(self):
        return self._learning_rate_map[default_main_program()]

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = getattr(param, 'optimize_attr', {}).get(
            'learning_rate', 1.0)
        if isinstance(param_lr, Variable):
            return param_lr
        base = self._global_learning_rate
        if param_lr == 1.0:
            return base
        helper = LayerHelper('param_lr')
        out = helper.create_variable_for_type_inference('float32',
                                                        shape=(1,))
        helper.append_op(type='scale', inputs={'X': [base]},
                         outputs={'Out': [out]},
                         attrs={'scale': float(param_lr), 'bias': 0.0})
        return out

    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if self._name is not None:
            name = self._name + "_" + name
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        helper = LayerHelper(name)
        var = helper.create_or_get_global_variable(
            name=unique_name.generate(param.name + "_" + name),
            dtype=dtype or param.dtype,
            shape=tuple(shape) if shape is not None else param.shape)
        var.persistable = True
        var.stop_gradient = True
        helper.set_variable_initializer(var, Constant(float(fill_value)))
        self._accumulators[key] = var
        return var

    def _get_accumulator(self, name, param):
        if self._name is not None:
            name = self._name + "_" + name
        return self._accumulators[(name, param.name)]

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, parameters_and_grads):
        pass

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        program = default_main_program()
        with program._role_guard('Optimize'):
            params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
            # the final (clipped, regularized) names the health
            # observatory harvests
            health.note_params_grads(program, params_grads)
            self._create_global_learning_rate()
            block = program.global_block()
            self._create_accumulators(block, [pg[0] for pg in params_grads])
            optimize_ops = self._append_optimize_ops(block, params_grads)
            self._finish_update(block, params_grads)
        return optimize_ops

    def _append_optimize_ops(self, block, params_grads):
        """One update op a parameter; Adam with fuse=True overrides this."""
        return [self._append_optimize_op(block, pg) for pg in params_grads]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        super(SGDOptimizer, self).__init__(learning_rate, regularization,
                                           name)
        self.type = 'sgd'

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type='sgd',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]]})


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super(MomentumOptimizer, self).__init__(learning_rate,
                                                regularization, name)
        self.type = 'momentum'
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator(self._velocity_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type='momentum',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'Velocity': [velocity],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'VelocityOut': [velocity]},
            attrs={'mu': self._momentum,
                   'use_nesterov': self._use_nesterov})


class LarsMomentumOptimizer(MomentumOptimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        super(LarsMomentumOptimizer, self).__init__(
            learning_rate, momentum, False, regularization, name)
        self.type = 'lars_momentum'
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator(self._velocity_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type='lars_momentum',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'Velocity': [velocity],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'VelocityOut': [velocity]},
            attrs={'mu': self._momentum, 'lars_coeff': self._lars_coeff,
                   'lars_weight_decay': self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        super(AdagradOptimizer, self).__init__(learning_rate,
                                               regularization, name)
        self.type = 'adagrad'
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p,
                                  fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        return block.append_op(
            type='adagrad',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'Moment': [moment],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'MomentOut': [moment]},
            attrs={'epsilon': self._epsilon})


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False, fuse=False):
        super(AdamOptimizer, self).__init__(learning_rate, regularization,
                                            name)
        self.type = 'adam'
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode
        # fuse=True: ONE fused_adam op over the parameter set (the CUDA
        # kernel's one launch); parameters with their own learning-rate
        # multiplier keep their own adam op
        self._fuse = bool(fuse)

    def _append_optimize_ops(self, block, params_grads):
        if not self._fuse:
            return super(AdamOptimizer, self)._append_optimize_ops(
                block, params_grads)
        plain, custom_lr = [], []
        for pg in params_grads:
            lr_mult = getattr(pg[0], 'optimize_attr', {}).get(
                'learning_rate', 1.0)
            (plain if not isinstance(lr_mult, Variable)
             and lr_mult == 1.0 else custom_lr).append(pg)
        optimize_ops = []
        if plain:
            acc = self._get_accumulator
            inputs = {
                'Params': [pg[0] for pg in plain],
                'Grads': [pg[1] for pg in plain],
                'Moment1s': [acc(self._moment1_acc_str, pg[0])
                             for pg in plain],
                'Moment2s': [acc(self._moment2_acc_str, pg[0])
                             for pg in plain],
                'Beta1Pows': [acc(self._beta1_pow_acc_str, pg[0])
                              for pg in plain],
                'Beta2Pows': [acc(self._beta2_pow_acc_str, pg[0])
                              for pg in plain],
                'LearningRate': [self._global_learning_rate],
            }
            optimize_ops.append(block.append_op(
                type='fused_adam',
                inputs=inputs,
                outputs={'ParamsOut': inputs['Params'],
                         'Moment1sOut': inputs['Moment1s'],
                         'Moment2sOut': inputs['Moment2s'],
                         'Beta1PowsOut': inputs['Beta1Pows'],
                         'Beta2PowsOut': inputs['Beta2Pows']},
                attrs={'beta1': self._beta1, 'beta2': self._beta2,
                       'epsilon': self._epsilon}))
        for pg in custom_lr:
            optimize_ops.append(self._append_optimize_op(block, pg))
        return optimize_ops

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])
            self._add_accumulator(self._beta2_pow_acc_str, p,
                                  fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        m1 = self._get_accumulator(self._moment1_acc_str, param_and_grad[0])
        m2 = self._get_accumulator(self._moment2_acc_str, param_and_grad[0])
        b1p = self._get_accumulator(self._beta1_pow_acc_str,
                                    param_and_grad[0])
        b2p = self._get_accumulator(self._beta2_pow_acc_str,
                                    param_and_grad[0])
        return block.append_op(
            type='adam',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'LearningRate': [self._create_param_lr(param_and_grad)],
                    'Moment1': [m1], 'Moment2': [m2],
                    'Beta1Pow': [b1p], 'Beta2Pow': [b2p]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'Moment1Out': [m1], 'Moment2Out': [m2],
                     'Beta1PowOut': [b1p], 'Beta2PowOut': [b2p]},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon, 'lazy_mode': self._lazy_mode})


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super(AdamaxOptimizer, self).__init__(learning_rate, regularization,
                                              name)
        self.type = 'adamax'
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        inf_norm = self._get_accumulator(self._inf_norm_acc_str,
                                         param_and_grad[0])
        b1p = self._get_accumulator(self._beta1_pow_acc_str,
                                    param_and_grad[0])
        op = block.append_op(
            type='adamax',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'LearningRate': [self._create_param_lr(param_and_grad)],
                    'Moment': [moment], 'InfNorm': [inf_norm],
                    'Beta1Pow': [b1p]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'MomentOut': [moment], 'InfNormOut': [inf_norm]},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon})
        return op

    def _finish_update(self, block, parameters_and_grads):
        for param, _ in parameters_and_grads:
            b1p = self._get_accumulator(self._beta1_pow_acc_str, param)
            block.append_op(type='scale', inputs={'X': [b1p]},
                            outputs={'Out': [b1p]},
                            attrs={'scale': self._beta1, 'bias': 0.0})


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super(DecayedAdagradOptimizer, self).__init__(
            learning_rate, regularization, name)
        self.type = 'decayed_adagrad'
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        return block.append_op(
            type='decayed_adagrad',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'Moment': [moment],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'MomentOut': [moment]},
            attrs={'decay': self._decay, 'epsilon': self._epsilon})


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        super(AdadeltaOptimizer, self).__init__(learning_rate,
                                                regularization, name)
        self.type = 'adadelta'
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        eg = self._get_accumulator(self._avg_squared_grad_acc_str,
                                   param_and_grad[0])
        ex = self._get_accumulator(self._avg_squared_update_acc_str,
                                   param_and_grad[0])
        return block.append_op(
            type='adadelta',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'AvgSquaredGrad': [eg], 'AvgSquaredUpdate': [ex]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'AvgSquaredGradOut': [eg],
                     'AvgSquaredUpdateOut': [ex]},
            attrs={'epsilon': self._epsilon, 'rho': self._rho})


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"
    _mean_grad_acc_str = "mean_grad"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super(RMSPropOptimizer, self).__init__(learning_rate,
                                               regularization, name)
        self.type = 'rmsprop'
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)
            self._add_accumulator(self._mean_grad_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        momentum = self._get_accumulator(self._momentum_acc_str,
                                         param_and_grad[0])
        mean_square = self._get_accumulator(self._mean_square_acc_str,
                                            param_and_grad[0])
        mean_grad = self._get_accumulator(self._mean_grad_acc_str,
                                          param_and_grad[0])
        return block.append_op(
            type='rmsprop',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'Moment': [momentum], 'MeanSquare': [mean_square],
                    'MeanGrad': [mean_grad],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'MomentOut': [momentum],
                     'MeanSquareOut': [mean_square],
                     'MeanGradOut': [mean_grad]},
            attrs={'epsilon': self._epsilon, 'decay': self._rho,
                   'momentum': self._momentum, 'centered': self._centered})


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super(FtrlOptimizer, self).__init__(learning_rate, regularization,
                                            name)
        self.type = 'ftrl'
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        sq = self._get_accumulator(self._squared_acc_str, param_and_grad[0])
        lin = self._get_accumulator(self._linear_acc_str, param_and_grad[0])
        return block.append_op(
            type='ftrl',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'SquaredAccumulator': [sq],
                    'LinearAccumulator': [lin],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'SquaredAccumOut': [sq], 'LinearAccumOut': [lin]},
            attrs={'l1': self._l1, 'l2': self._l2,
                   'lr_power': self._lr_power})


class ModelAverage(Optimizer):
    """Parameter averages over a sliding window (the `average_accumulates`
    op): waits for a later slice of paddle_tpu_torch."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        raise NotImplementedError(
            'ModelAverage (the average_accumulates op) waits for a later '
            'slice of paddle_tpu_torch')


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer


class TensorAdam(object):
    """``TensorAdam(parameters, learning_rate=1e-3, beta1=0.9, beta2=0.999,
    epsilon=1e-8, fuse=False)``. ``parameters`` is a {name: tensor}
    mapping (such as `TransformerLM.p`) or a sequence of tensors (named by
    position). :meth:`step` applies the update to the parameters that have
    a ``.grad``; :meth:`minimize` is backward, step and clearing the
    gradients, as Fluid's ``minimize`` runs them in one program."""

    def __init__(self, parameters, learning_rate=1e-3, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, fuse=False):
        if isinstance(parameters, collections.abc.Mapping):
            named = list(parameters.items())
        else:
            named = [(str(i), p) for i, p in enumerate(parameters)]
        if not named:
            raise ValueError('TensorAdam needs at least one parameter')
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)
        self.fuse = bool(fuse)
        dev = self.params[0].device
        self.lr = torch.full((1,), float(learning_rate), dtype=torch.float32,
                             device=dev)
        self.moment1 = [torch.zeros_like(p) for p in self.params]
        self.moment2 = [torch.zeros_like(p) for p in self.params]
        self.beta1_pow = [torch.full((1,), self.beta1, dtype=torch.float32,
                                     device=dev) for _ in self.params]
        self.beta2_pow = [torch.full((1,), self.beta2, dtype=torch.float32,
                                     device=dev) for _ in self.params]

    def state(self):
        """{parameter name: {'moment1', 'moment2', 'beta1_pow',
        'beta2_pow'}} — the live tensors, not copies."""
        return {n: dict(moment1=a, moment2=b, beta1_pow=c, beta2_pow=d)
                for n, a, b, c, d in zip(self.names, self.moment1,
                                         self.moment2, self.beta1_pow,
                                         self.beta2_pow)}

    def load_state(self, state, learning_rate=None):
        """Copy ``state`` (as :meth:`state` returns it, tensors or arrays)
        and, if given, the learning rate into this optimizer's tensors."""
        with torch.no_grad():
            for i, n in enumerate(self.names):
                s = state[n]
                for key, dst in (('moment1', self.moment1[i]),
                                 ('moment2', self.moment2[i]),
                                 ('beta1_pow', self.beta1_pow[i]),
                                 ('beta2_pow', self.beta2_pow[i])):
                    dst.copy_(torch.as_tensor(s[key]).reshape(dst.shape))
            if learning_rate is not None:
                self.lr.copy_(torch.as_tensor(learning_rate).reshape(1))

    @torch.no_grad()
    def step(self):
        idx = [i for i, p in enumerate(self.params) if p.grad is not None]
        if not idx:
            return
        pick = lambda xs: [xs[i] for i in idx]
        if self.fuse:
            optimizer_ops.fused_adam(
                pick(self.params), [self.params[i].grad for i in idx],
                pick(self.moment1), pick(self.moment2), pick(self.beta1_pow),
                pick(self.beta2_pow), self.lr, self.beta1, self.beta2,
                self.epsilon)
            return
        for i in idx:
            optimizer_ops.adam(self.params[i], self.params[i].grad,
                               self.moment1[i], self.moment2[i],
                               self.beta1_pow[i], self.beta2_pow[i], self.lr,
                               self.beta1, self.beta2, self.epsilon)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def backward(self, loss):
        """``loss.backward()``; returns [(parameter, gradient)] for the
        parameters that received one, as Fluid's ``backward`` returns its
        params_grads."""
        loss.backward()
        return [(p, p.grad) for p in self.params if p.grad is not None]

    def apply_gradients(self, params_grads):
        """:meth:`step` over the parameters' gradients (``params_grads`` as
        :meth:`backward` returns them: each parameter's own ``.grad``),
        then clear them."""
        self.step()
        self.zero_grad()

    def minimize(self, loss):
        """:meth:`backward` then :meth:`apply_gradients`, as Fluid's
        ``minimize`` runs them in one program. Returns the loss,
        detached."""
        self.apply_gradients(self.backward(loss))
        return loss.detach()
