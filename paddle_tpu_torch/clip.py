"""Gradient clipping: the entry points the optimizer calls.

The port keeps only `append_gradient_clip_ops` and `error_clip_callback`
of paddle_tpu/clip.py: with no clip set on any parameter the
(parameter, gradient) list passes through unchanged; with one set it
raises NotImplementedError. The clip classes and `set_gradient_clip` wait
for a later slice.
"""

__all__ = ['append_gradient_clip_ops', 'error_clip_callback']


def error_clip_callback(block, context):
    pass


def append_gradient_clip_ops(param_grads):
    named = [p.name for p, _ in param_grads
             if getattr(p, 'gradient_clip_attr', None) is not None]
    if named:
        raise NotImplementedError(
            'gradient clipping (set on %s) waits for a later slice of '
            'paddle_tpu_torch' % named)
    return list(param_grads)
