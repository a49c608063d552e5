"""ParamAttr: a parameter's name, initializer, learning-rate multiplier,
regularizer, trainability and gradient clip.

The port's own copy of paddle_tpu/param_attr.py. ``WeightNormParamAttr``
waits for the weight-norm layers.
"""
from .initializer import Initializer

__all__ = ['ParamAttr']


class ParamAttr(object):
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=False):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError("cannot convert %r to ParamAttr" % (arg,))

    def _to_kwargs(self, with_initializer=False):
        kw = {
            'name': self.name,
            'optimize_attr': {'learning_rate': self.learning_rate},
            'regularizer': self.regularizer,
            'trainable': self.trainable,
            'gradient_clip_attr': self.gradient_clip,
            'do_model_average': self.do_model_average,
        }
        if with_initializer:
            kw['initializer'] = self.initializer
        return kw
