"""Activation layers: one op on one input, with the input's dtype and shape.

The port's own copy of the generated layers of paddle_tpu/layers/ops.py
whose op the port lowers (``tanh``, ``sqrt``, ``square``, ``gelu``), and
of ``relu`` and ``sigmoid`` (paddle_tpu/layers/nn.py), which append their
op the same way. The other activations of the JAX list wait for their
lowerings.
"""
from ..layer_helper import LayerHelper

__acts__ = ['tanh', 'sqrt', 'square', 'gelu', 'relu', 'sigmoid']

__all__ = list(__acts__)


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
