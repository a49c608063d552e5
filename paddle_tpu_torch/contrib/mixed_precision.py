"""Automatic mixed precision (bf16): the white and black lists, the program
pass, the model pass and the decorated optimizer.

Counterpart of paddle_tpu/contrib/mixed_precision.py. ``decorate(opt)`` of
a program optimizer (``optimizer.Adam``, ...) rewrites the loss's Program
before ``minimize`` appends the backward: :func:`rewrite_program_bf16`
gives every op of the white list the AMP mark, which its lowering reads
(core/amp.py), exactly as the JAX package's pass does::

    opt = mixed_precision.decorate(fluid.optimizer.Adam(1e-4, fuse=True))
    opt.minimize(avg_loss)         # marks the program, appends backward

A model driven without a Program (`TransformerLM.loss`,
`BertPretrain.loss`) has run its forward by the time ``minimize`` sees the
loss, so its mark goes on the model first: :func:`rewrite_model_bf16`, and
``decorate`` of a `TensorAdam` only delegates::

    mixed_precision.rewrite_model_bf16(model)
    opt = mixed_precision.decorate(
        optimizer.TensorAdam(model.p, 1e-4, fuse=True))
    opt.minimize(model.loss(tokens, labels, generator))

In the LM and BERT the marked ops are every fc's ``mul``, the unfused
attention's two ``matmul``s, ``flash_attention`` and ``fused_ffn_tail``; in
the conv nets every ``conv2d``, whose output, with
``keep_bf16_activations=True``, stays bf16.
Parameters stay float32 (master weights) and there is no loss scaling:
bf16 keeps float32's exponent range, and ``decorate`` rejects a loss scale
rather than apply it without the unscale step.
"""
from ..core.amp import AMP_ATTR, AMP_KEEP_ATTR
from ..framework import Variable

__all__ = ['WHITE_LIST', 'BLACK_LIST', 'KEEP_ACTIVATION_OPS',
           'AutoMixedPrecisionLists',
           'rewrite_program_bf16', 'rewrite_model_bf16', 'decorate',
           'OptimizerWithMixedPrecision', 'AMP_ATTR', 'AMP_KEEP_ATTR']

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


# the conv-net bandwidth mode: these ops' outputs stay in the compute dtype
KEEP_ACTIVATION_OPS = {'conv2d', 'depthwise_conv2d', 'batch_norm'}


def rewrite_program_bf16(program, amp_lists=None, dtype='bfloat16',
                         keep_bf16_activations=False):
    """Mark every op of ``program`` whose type is in the white list to
    compute in ``dtype`` (``AMP_ATTR``), as the JAX pass does. With
    ``keep_bf16_activations`` (the conv-net bandwidth mode) every op of
    `KEEP_ACTIVATION_OPS` outside the black list is marked too, with
    ``AMP_KEEP_ATTR``: its output stays bf16 (core/amp.py). With the
    default lists that is the convolutions (``batch_norm`` is black-listed:
    unmarked, it returns its bf16 input's dtype all the same), and ReLU,
    pooling and the residual adds keep bf16 as they preserve dtype; a
    dense head's marked ``mul`` returns its input's dtype and its float32
    bias add float32, as in JAX. Bumps the program's version, so that the
    Executor builds a new run plan for it. Returns the count of
    white-listed ops marked."""
    amp_lists = amp_lists or AutoMixedPrecisionLists()
    n = 0
    for block in program.blocks:
        for op in block.ops:
            if op.type in amp_lists.white_list:
                op.attrs[AMP_ATTR] = dtype
                n += 1
            if keep_bf16_activations and op.type in KEEP_ACTIVATION_OPS \
                    and op.type not in amp_lists.black_list:
                op.attrs[AMP_ATTR] = dtype
                op.attrs[AMP_KEEP_ATTR] = True
    program._bump_version()
    return n


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
    """A bf16 optimizer: rejects loss scaling; ``minimize`` of a program's
    loss (a `Variable`) marks its program (:func:`rewrite_program_bf16`)
    and then minimizes; a model's loss (a tensor, under `TensorAdam`) is
    minimized as it is, the marks being :func:`rewrite_model_bf16`'s.
    ``backward``, ``apply_gradients`` and every other attribute go to the
    wrapped optimizer, whose parameters stay float32."""

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
        self._keep_acts = keep_bf16_activations

    def minimize(self, loss, *args, **kwargs):
        if isinstance(loss, Variable):
            rewrite_program_bf16(loss.block.program, self._amp_lists,
                                 self._dtype,
                                 keep_bf16_activations=self._keep_acts)
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
    package's signature, defaults and checks. ``keep_bf16_activations``
    keeps the outputs of `KEEP_ACTIVATION_OPS` outside the black list
    bf16 (the bench's image rows)::

        opt = decorate(fluid.optimizer.Momentum(0.02, 0.9),
                       keep_bf16_activations=True)
        opt.minimize(avg_cost)
    """
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists=amp_lists, init_loss_scaling=init_loss_scaling,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling,
        keep_bf16_activations=keep_bf16_activations)
