"""The bf16 mixed-precision policy, as the marked ops and sites apply it.

Counterpart of paddle_tpu/core/amp.py. The program pass
(`contrib.mixed_precision.rewrite_program_bf16`, the JAX package's own
pass) marks the ops of its white list with ``AMP_ATTR``; each marked op's
lowering reads the mark (:func:`op_policy`) and hands it, the *policy*
(the AMP dtype's name, or None for an unmarked op), to the op functions,
which take ``policy=``. A model driven without a Program is marked by
:func:`..contrib.mixed_precision.rewrite_model_bf16` and hands the same
policy to the same functions. A marked op casts its float32 compute
inputs to bf16 (:func:`cast_compute`), multiplies with float32
accumulation and casts its output back to the variable's float32, so
that:

- parameters stay float32 (master weights: the cast is part of the op);
- the rest of the program (LayerNorm, softmax, the loss, Adam) runs in
  float32;
- no loss scaling is needed: bf16 keeps float32's exponent range.

Under ``AMP_KEEP_ATTR`` (the pass's ``keep_bf16_activations``, the
conv nets' bandwidth mode: :func:`op_keeps`) a marked op's output keeps
the compute dtype instead (:func:`result_dtype`), so that a convolution's
bf16 activations stay bf16 through batch norm, ReLU, pooling and the
residual adds, which preserve their input's dtype.

The port keeps its own copy of these names (it imports nothing of the JAX
package); the dtypes are torch's.
"""
import torch

__all__ = ['AMP_ATTR', 'AMP_KEEP_ATTR', 'op_policy', 'op_keeps',
           'compute_dtype',
           'cast_compute', 'accum_dtype', 'result_dtype']

AMP_ATTR = '__amp_dtype__'
AMP_KEEP_ATTR = '__amp_keep_out__'

_DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16}


def op_policy(op):
    """The policy an op's lowering hands to the op functions: the op's
    ``AMP_ATTR`` mark, or None for an unmarked op."""
    return op.attr(AMP_ATTR) or None


def op_keeps(op):
    """Whether a marked op's output keeps the compute dtype: the op's
    ``AMP_KEEP_ATTR`` mark."""
    return bool(op.attr(AMP_KEEP_ATTR, False))


def compute_dtype(policy):
    """The torch dtype a site marked with ``policy`` computes in, or None
    for an unmarked site (``policy`` None or empty)."""
    if not policy:
        return None
    if isinstance(policy, torch.dtype):
        return policy
    try:
        return _DTYPES[policy]
    except KeyError:
        raise ValueError('unknown AMP dtype %r (expected one of %s)'
                         % (policy, sorted(_DTYPES)))


def accum_dtype(x):
    """The accumulation dtype of a product over ``x``: float32 for float32
    and for AMP-cast inputs alike (the port's bf16 products always sum in
    float32; the JAX package returns None for bf16 only to satisfy its
    convolution's transpose rule)."""
    return torch.float32


def result_dtype(policy, computed, declared, keep=False):
    """Output dtype of a marked site (the JAX package's `result_dtype`):
    the declared variable dtype (float32 master activations), or with
    ``keep`` (:func:`op_keeps`) the dtype of ``computed``, the cast
    compute input."""
    if policy and keep:
        return computed.dtype
    return declared


def cast_compute(policy, *tensors):
    """Cast the float32 tensors among ``tensors`` to the dtype of
    ``policy``, into contiguous memory (one pass for a permuted view, such
    as attention's q, k and v); other tensors (integers, already-cast values, None) pass
    through. Unmarked (``policy`` None or empty): the inputs unchanged.
    Returns one tensor for one input, else a tuple, as the JAX package's
    `cast_compute` does. The cast is differentiable: its backward hands the
    bf16 cotangent back as float32."""
    dt = compute_dtype(policy)
    if dt is None:
        out = tensors
    else:
        out = tuple(t.to(dt, memory_format=torch.contiguous_format)
                    if t is not None and t.dtype == torch.float32 else t
                    for t in tensors)
    return out if len(out) != 1 else out[0]
