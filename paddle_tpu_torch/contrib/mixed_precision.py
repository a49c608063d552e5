"""Automatic mixed precision (bf16): the white and black lists, the model
pass and the decorated optimizer.

Counterpart of paddle_tpu/contrib/mixed_precision.py. The JAX package's
``decorate(opt).minimize(loss)`` rewrites the Program before appending the
backward: every op of the white list gets the AMP mark, which its lowering
reads (core/amp.py). The port has no Program, and its forward has run by the
time ``minimize`` sees the loss, so the mark goes on the model before the
forward: :func:`rewrite_model_bf16` is the counterpart of
`rewrite_program_bf16`. A user writes two lines::

    mixed_precision.rewrite_model_bf16(model)
    opt = mixed_precision.decorate(
        optimizer.TensorAdam(model.p, 1e-4, fuse=True))
    opt.minimize(model.loss(tokens, labels, generator))

In the LM and BERT the marked sites are every fc's ``mul``, the unfused
attention's two ``matmul``s, ``flash_attention`` and ``fused_ffn_tail``.
Parameters stay float32 (master weights) and there is no loss scaling:
bf16 keeps float32's exponent range, and ``decorate`` rejects a loss scale
rather than apply it without the unscale step.
"""
from ..core.amp import AMP_ATTR, AMP_KEEP_ATTR

__all__ = ['WHITE_LIST', 'BLACK_LIST', 'AutoMixedPrecisionLists',
           'rewrite_model_bf16', 'decorate', 'OptimizerWithMixedPrecision',
           'AMP_ATTR', 'AMP_KEEP_ATTR']

# ops whose flops dominate and that are numerically safe in bf16 with
# float32 accumulation
WHITE_LIST = {
    'mul', 'matmul', 'fc', 'flash_attention', 'fused_ffn_tail',
    'conv2d', 'depthwise_conv2d', 'conv2d_transpose',
    'depthwise_conv2d_transpose', 'conv3d', 'conv3d_transpose',
}

# numerically sensitive ops that stay float32 (for the custom lists'
# checks: nothing casts them)
BLACK_LIST = {
    'softmax', 'softmax_with_cross_entropy', 'cross_entropy',
    'sigmoid_cross_entropy_with_logits', 'layer_norm', 'batch_norm',
    'group_norm', 'mean', 'reduce_mean', 'reduce_sum', 'sum', 'exp', 'log',
}


class AutoMixedPrecisionLists(object):
    """The op types that compute in bf16 (``white_list``) and those that
    stay float32 (``black_list``), with custom additions: an op in
    ``custom_white_list`` that is also in the black list raises; an op in
    ``custom_black_list`` leaves the white list."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        for t in (custom_white_list or []):
            if t in self.black_list:
                raise ValueError(
                    "op %r is in both custom white list and black list" % t)
            self.white_list.add(t)
        for t in (custom_black_list or []):
            self.white_list.discard(t)
            self.black_list.add(t)


def rewrite_model_bf16(model, amp_lists=None, dtype='bfloat16'):
    """Mark every site of ``model`` whose op type is in the white list to
    compute in ``dtype``, as `rewrite_program_bf16` marks a Program's ops.
    ``model`` is a `TransformerLM` or `BertPretrain` (a `TransformerStack`):
    its ``amp`` map {op type: dtype} is what its sites read. Returns how
    many marked sites one training forward runs, the count the JAX pass
    returns for the same model's program."""
    amp_lists = amp_lists or AutoMixedPrecisionLists()
    model.amp = {t: dtype for t in model.SITE_TYPES
                 if t in amp_lists.white_list}
    return sum(1 for t in model.forward_sites() if t in model.amp)


class OptimizerWithMixedPrecision(object):
    """The optimizer of a bf16-marked model: rejects loss scaling and
    otherwise hands ``minimize``, ``backward``, ``apply_gradients`` and
    every other attribute to the wrapped optimizer, whose parameters stay
    float32. The marks are :func:`rewrite_model_bf16`'s: the forward has
    run before ``minimize`` sees the loss."""

    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False, dtype='bfloat16',
                 keep_bf16_activations=False):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        if use_dynamic_loss_scaling or float(init_loss_scaling) != 1.0:
            raise ValueError(
                "loss scaling is unnecessary for bf16 (same exponent range "
                "as fp32); use init_loss_scaling=1.0 and "
                "use_dynamic_loss_scaling=False")
        self._dtype = dtype
        # the JAX package keeps conv/batch_norm outputs bf16 with this; no
        # site of the port's models is one of those ops
        self._keep_acts = keep_bf16_activations

    def minimize(self, loss, *args, **kwargs):
        return self._optimizer.minimize(loss, *args, **kwargs)

    def backward(self, *args, **kwargs):
        return self._optimizer.backward(*args, **kwargs)

    def apply_gradients(self, *args, **kwargs):
        return self._optimizer.apply_gradients(*args, **kwargs)

    def __getattr__(self, name):
        # the wrapped optimizer's state, step, zero_grad, ...
        return getattr(self.__dict__['_optimizer'], name)


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             use_dynamic_loss_scaling=False, keep_bf16_activations=False):
    """Wrap ``optimizer`` for bf16 mixed-precision training, with the JAX
    package's signature, defaults and checks."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists=amp_lists, init_loss_scaling=init_loss_scaling,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling,
        keep_bf16_activations=keep_bf16_activations)
