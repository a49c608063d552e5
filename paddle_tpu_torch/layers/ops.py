"""Activation layers: one op on one input, with the input's dtype and shape.

The port's own copy of the generated layers of paddle_tpu/layers/ops.py
(its ``__acts__`` list, ``cumsum`` and ``uniform_random``), and of
``relu`` and ``sigmoid`` (paddle_tpu/layers/nn.py), which append their op
the same way.
"""
from ..layer_helper import LayerHelper

__acts__ = [
    'softshrink', 'exp', 'tanh', 'sqrt', 'rsqrt', 'abs', 'ceil', 'floor',
    'cos', 'sin', 'round', 'reciprocal', 'square', 'softplus', 'softsign',
    'tanh_shrink', 'logsigmoid', 'gelu', 'elu', 'relu6', 'pow', 'stanh',
    'hard_shrink', 'hard_sigmoid', 'thresholded_relu', 'relu', 'sigmoid',
]

__all__ = list(__acts__) + ['cumsum', 'uniform_random']


def _make_act(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                        shape=x.shape)
        helper.append_op(type=op_type, inputs={'X': [x]},
                         outputs={'Out': [out]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    layer.__doc__ = "activation %s (ops/activations.py)" % op_type
    return layer


for _a in __acts__:
    globals()[_a] = _make_act(_a)


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper('cumsum')
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(type='cumsum', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'axis': axis, 'exclusive': exclusive,
                            'reverse': reverse})
    return out


def uniform_random(shape, dtype='float32', min=-1.0, max=1.0, seed=0):
    helper = LayerHelper('uniform_random')
    out = helper.create_variable_for_type_inference(dtype, shape=shape)
    helper.append_op(type='uniform_random', outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'dtype': out.dtype,
                            'min': min, 'max': max, 'seed': seed})
    return out
