"""Parameter initializers: each appends its init op to the startup program.

The port's own copy of paddle_tpu/initializer.py (Constant, Uniform,
Normal, TruncatedNormal, Xavier, MSRA and NumpyArray): the same ops with
the same attrs, so the two packages' startup programs serialize alike.
What the random ops draw differs (core/lowering.py, the counted RNG
stream): a scope carried over from the JAX package is how the two start
from the same weights. ``Bilinear`` waits for conv2d_transpose.
"""
import numpy as np

__all__ = [
    'Constant', 'Uniform', 'Normal', 'TruncatedNormal', 'Xavier', 'MSRA',
    'NumpyArrayInitializer', 'ConstantInitializer', 'UniformInitializer',
    'NormalInitializer', 'TruncatedNormalInitializer', 'XavierInitializer',
    'MSRAInitializer',
]


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = value

    def __call__(self, var, block):
        return block.append_op(
            type='fill_constant',
            outputs={'Out': [var.name]},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'value': float(self._value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low, self._high, self._seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type='uniform_random',
            outputs={'Out': [var.name]},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'min': self._low, 'max': self._high, 'seed': self._seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type='gaussian_random',
            outputs={'Out': [var.name]},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'mean': self._mean, 'std': self._std, 'seed': self._seed})


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type='truncated_gaussian_random',
            outputs={'Out': [var.name]},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'mean': self._mean, 'std': self._std, 'seed': self._seed})


def _fans(var):
    shape = var.shape
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) >= 3:
        receptive = int(np.prod(shape[2:]))
        return shape[1] * receptive, shape[0] * receptive
    return shape[0], shape[0]


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform = uniform
        self._fan_in, self._fan_out, self._seed = fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fans(var)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        if self._uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = float(np.sqrt(2.0 / (fi + fo)))
        return NormalInitializer(0.0, std, self._seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform, self._fan_in, self._seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fans(var)
        fi = self._fan_in if self._fan_in is not None else fi
        if self._uniform:
            limit = float(np.sqrt(6.0 / fi))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = float(np.sqrt(2.0 / fi))
        return NormalInitializer(0.0, std, self._seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self._value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            type='assign_value',
            outputs={'Out': [var.name]},
            attrs={'shape': list(self._value.shape), 'dtype': var.dtype,
                   'values': self._value.flatten().tolist()})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
