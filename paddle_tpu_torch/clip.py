"""Gradient clipping appended as ops: the port's own copy of
paddle_tpu/clip.py (`ErrorClipByValue`, `GradientClipByValue`,
`GradientClipByNorm`, `GradientClipByGlobalNorm` with ``group_name``,
`set_gradient_clip`, `append_gradient_clip_ops`, `error_clip_callback`).

`set_gradient_clip(clip)` puts ``clip`` on every parameter of the program
(or of ``param_list``); ``minimize`` then calls
`append_gradient_clip_ops` before the weight decay:

- `GradientClipByValue`: a ``clip`` op into ``<grad>.clipped``;
- `GradientClipByNorm`: a ``clip_by_norm`` op (each gradient by its own
  L2 norm) into ``<grad>.clipped``;
- `GradientClipByGlobalNorm`: ``squared_l2_norm`` of every gradient it
  holds, their ``sum``, ``sqrt``, then the factor clip_norm /
  max(global_norm, clip_norm) (``fill_constant``, ``elementwise_max``,
  ``elementwise_div``, all shape [1] on the device: no host read) and an
  ``elementwise_mul`` of each gradient into ``<grad>.gclipped``.

``ErrorClipByValue`` is kept for the API; as in the JAX package,
`error_clip_callback` appends nothing.
"""
from .framework import default_main_program

__all__ = ['ErrorClipByValue', 'GradientClipByValue', 'GradientClipByNorm',
           'GradientClipByGlobalNorm', 'set_gradient_clip',
           'append_gradient_clip_ops', 'error_clip_callback']


class BaseErrorClipAttr(object):
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max


def error_clip_callback(block, context):
    pass


class BaseGradientClipAttr(object):
    def _create_operators(self, param, grad):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(shape=grad.shape, dtype=grad.dtype,
                               name=grad.name + '.clipped')
        block.append_op(type='clip', inputs={'X': [grad]},
                        outputs={'Out': [out]},
                        attrs={'min': self.min, 'max': self.max})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(shape=grad.shape, dtype=grad.dtype,
                               name=grad.name + '.clipped')
        block.append_op(type='clip_by_norm', inputs={'X': [grad]},
                        outputs={'Out': [out]},
                        attrs={'max_norm': self.clip_norm})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale the gradients it holds by clip_norm / max(global_norm,
    clip_norm), the global norm computed in the step (module
    docstring)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name
        self._grads = []

    def _create_operators(self, param, grad):
        self._grads.append((param, grad))
        return param, grad

    def _finalize(self, params_grads):
        grads, self._grads = self._grads, []  # consumed: reusable
        if not grads:
            return params_grads
        block = grads[0][1].block
        sq_norms = []
        for _, g in grads:
            sq = block.create_var(shape=(1,), dtype=g.dtype,
                                  name=g.name + '.sq_l2')
            block.append_op(type='squared_l2_norm', inputs={'X': [g]},
                            outputs={'Out': [sq]})
            sq_norms.append(sq)
        total = block.create_var(shape=(1,), dtype=sq_norms[0].dtype)
        block.append_op(type='sum', inputs={'X': sq_norms},
                        outputs={'Out': [total]})
        gnorm = block.create_var(shape=(1,), dtype=total.dtype)
        block.append_op(type='sqrt', inputs={'X': [total]},
                        outputs={'Out': [gnorm]})
        clip_var = block.create_var(shape=(1,), dtype=gnorm.dtype)
        block.append_op(type='fill_constant', outputs={'Out': [clip_var]},
                        attrs={'shape': [1], 'dtype': gnorm.dtype,
                               'value': float(self.clip_norm)})
        denom = block.create_var(shape=(1,), dtype=gnorm.dtype)
        block.append_op(type='elementwise_max',
                        inputs={'X': [gnorm], 'Y': [clip_var]},
                        outputs={'Out': [denom]})
        factor = block.create_var(shape=(1,), dtype=gnorm.dtype)
        block.append_op(type='elementwise_div',
                        inputs={'X': [clip_var], 'Y': [denom]},
                        outputs={'Out': [factor]})
        clipped = {}
        for p, g in grads:
            out = g.block.create_var(shape=g.shape, dtype=g.dtype,
                                     name=g.name + '.gclipped')
            g.block.append_op(type='elementwise_mul',
                              inputs={'X': [g], 'Y': [factor]},
                              outputs={'Out': [out]})
            clipped[g.name] = out
        return [(p, clipped.get(g.name, g)) for p, g in params_grads]


def set_gradient_clip(clip, param_list=None, program=None):
    if program is None:
        program = default_main_program()
    if param_list is None:
        param_list = program.all_parameters()
    param_list = [program.global_block().var(p) if isinstance(p, str) else p
                  for p in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    """The clipped (param, grad) list: each parameter's clip, then each
    global-norm clip over the gradients it collected."""
    res = []
    global_norm_clips = {}
    for p, g in param_grads:
        clip_attr = getattr(p, 'gradient_clip_attr', None)
        if clip_attr is None:
            res.append((p, g))
            continue
        if isinstance(clip_attr, GradientClipByGlobalNorm):
            global_norm_clips[id(clip_attr)] = clip_attr
        res.append(clip_attr._create_operators(p, g))
    for clip_attr in global_norm_clips.values():
        res = clip_attr._finalize(res)
    return res
