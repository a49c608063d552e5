"""Weight-decay regularization: the entry point the optimizer calls.

The port keeps only `append_regularization_ops` of
paddle_tpu/regularizer.py: with no regularizer set (on the optimizer or on
a parameter) it passes the (parameter, gradient) list through unchanged;
with one set it raises NotImplementedError. The L1 and L2 decay classes
wait for a later slice.
"""

__all__ = ['append_regularization_ops']


def append_regularization_ops(parameters_and_grads, regularization=None):
    named = [p.name for p, _ in parameters_and_grads
             if getattr(p, 'regularizer', None) is not None]
    if regularization is not None or named:
        raise NotImplementedError(
            'regularization (%s) waits for a later slice of '
            'paddle_tpu_torch' % (named or 'the optimizer\'s'))
    return list(parameters_and_grads)
