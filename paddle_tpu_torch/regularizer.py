"""Weight decay appended as ops: the port's own copy of
paddle_tpu/regularizer.py (`L2DecayRegularizer`, `L1DecayRegularizer`, the
``L2Decay`` and ``L1Decay`` aliases, `append_regularization_ops`).

A regularizer turns (param, grad) into a decay term built in the
gradient's block: ``scale(param, coeff)`` for L2, ``scale(sign(param),
coeff)`` for L1. `append_regularization_ops`, which ``minimize`` calls
after the gradient clips, adds it to the gradient with a ``sum`` op into
``<grad>.reg``. A parameter's own ``ParamAttr(regularizer=)`` takes
precedence over the optimizer's ``regularization=``::

    fluid.optimizer.Momentum(0.1, 0.9,
                             regularization=fluid.regularizer.L2Decay(1e-4))
"""

__all__ = ['L1Decay', 'L2Decay', 'L1DecayRegularizer', 'L2DecayRegularizer',
           'append_regularization_ops']


class WeightDecayRegularizer(object):
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op(type='scale', inputs={'X': [param]},
                        outputs={'Out': [decay]},
                        attrs={'scale': self._regularization_coeff,
                               'bias': 0.0})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op(type='sign', inputs={'X': [param]},
                        outputs={'Out': [sign]})
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op(type='scale', inputs={'X': [sign]},
                        outputs={'Out': [decay]},
                        attrs={'scale': self._regularization_coeff,
                               'bias': 0.0})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """[(param, grad + decay)] for the parameters with a regularizer (their
    own, else ``regularization``), the others' pairs as they are."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        regularization_term = None
        if getattr(param, 'regularizer', None) is not None:
            regularization_term = param.regularizer(param, grad, grad.block)
        elif regularization is not None:
            regularization_term = regularization(param, grad, grad.block)
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        new_grad = block.create_var(shape=grad.shape, dtype=grad.dtype,
                                    name=grad.name + '.reg')
        block.append_op(type='sum',
                        inputs={'X': [grad, regularization_term]},
                        outputs={'Out': [new_grad]})
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
