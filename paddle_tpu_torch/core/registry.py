"""The op registry: op type -> lowering on torch tensors.

The port's own copy of paddle_tpu/core/registry.py. A lowering
``fn(ctx, op)`` reads its inputs from the LowerContext (core/lowering.py),
computes on torch tensors by calling the port's op functions (which launch
the CUDA kernels on the card) and writes its outputs back. ``needs_rng`` is
a bool, or a predicate over the op instance for ops whose random draws
depend on their attrs (a fused FFN tail draws only in training with live
dropout); ``stateful`` marks ops that update their inputs in place (the
optimizers). Gradients come from ``torch.autograd`` over the lowerings
(the `backward` meta-op), so no op registers a gradient.

Two flags concern ragged (LoD) sequences, as in the JAX registry.
``static_inputs`` names the input slots whose values set the layout of the
output (``sequence_slice``'s Offset and Length, ``sequence_unpad``'s
Length): the executor keys the run plan by those feeds' values and hands
them to the lowering as numpy (`LowerContext.static_value`).
``share_lod=False`` marks an op whose output rows are not its LoD input's
rows in order (``transpose2``, ``gather``): the default propagation
(core/lowering.py `_share_lod`) then gives its outputs no LoD, whatever
their leading dimension.
"""

__all__ = ['OpDef', 'register_op', 'get_op', 'has_op', 'all_ops']


class OpDef(object):
    __slots__ = ('type', 'lower', 'stateful', 'needs_rng', 'static_inputs',
                 'share_lod')

    def __init__(self, type, lower, stateful=False, needs_rng=False,
                 static_inputs=(), share_lod=True):
        self.type = type
        self.lower = lower
        self.stateful = stateful
        self.needs_rng = needs_rng
        self.static_inputs = tuple(static_inputs)
        self.share_lod = bool(share_lod)


_ops = {}


def register_op(type, stateful=False, needs_rng=False, static_inputs=(),
                share_lod=True):
    """Decorator: register ``fn(ctx, op)`` as the lowering of op ``type``."""
    def deco(fn):
        if type in _ops:
            raise KeyError("op %r already registered" % type)
        _ops[type] = OpDef(type, fn, stateful=stateful, needs_rng=needs_rng,
                           static_inputs=static_inputs, share_lod=share_lod)
        return fn
    return deco


def get_op(type):
    if type not in _ops:
        raise NotImplementedError(
            "op %r has no lowering registered in paddle_tpu_torch" % type)
    return _ops[type]


def has_op(type):
    return type in _ops


def all_ops():
    return sorted(_ops)
