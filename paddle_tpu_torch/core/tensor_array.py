"""TensorArray: the LOD_TENSOR_ARRAY variable on torch tensors.

The port's own copy of paddle_tpu/core/tensor_array.py: a fixed-capacity
buffer ``[capacity, *elem_shape]``, a ``length`` that is a device tensor
(int32, so that a loop on the card never reads it on the host) and
``static_length``, a Python int when every write so far used an index
known when the plan runs (a ``fill_constant``), else None:
``tensor_array_to_tensor`` then returns exactly the written prefix. An
array carried through a loop or a conditional block drops it
(:meth:`clear_static`), as the JAX package's loop carries must.

Writes are out of place (``index_copy``, not ``index_copy_``), so that
autograd sees every write of a differentiated loop, except to an array
marked ``in_place``: the buffer of a loop captured in a CUDA graph
(ops/control_flow_ops.py `_graph_loop`), which a trip's write updates
itself (one slot moved, not the whole buffer twice). The mark does not
survive :meth:`clear_static`, so the carry of a nested block writes out
of place. A negative index
counts from the end and an index is then clamped into [0, capacity), as
``lax.dynamic_update_index_in_dim`` and ``lax.dynamic_index_in_dim`` take
it; the length counts the index as given (``max(length, i + 1)``), as the
JAX package counts it.
"""
import torch

__all__ = ['TensorArray']


def _index(i, capacity, device):
    """The slot of index ``i`` (an int or a one-element tensor) as an int64
    tensor [1] on ``device`` (a negative index counts from the end, then
    the index is clamped, as ``lax.dynamic_slice`` takes it), and ``i`` as
    an int32 scalar tensor."""
    if not isinstance(i, torch.Tensor):
        i = torch.full((), int(i), dtype=torch.int32, device=device)
    i = i.reshape(()).to(torch.int32)
    slot = torch.where(i < 0, i + capacity, i).clamp(0, capacity - 1)
    return slot.to(torch.int64).reshape(1), i


class TensorArray(object):
    """Fixed-capacity stacked array of same-shaped tensors."""

    __slots__ = ('buffer', 'length', 'static_length', 'in_place')

    def __init__(self, buffer, length, static_length=None, in_place=False):
        self.buffer = buffer
        self.length = length
        self.static_length = static_length
        self.in_place = in_place

    @classmethod
    def empty(cls, capacity, elem_shape, dtype, device):
        buf = torch.zeros((int(capacity),) + tuple(int(d) for d in elem_shape),
                          dtype=dtype, device=device)
        return cls(buf, torch.zeros((), dtype=torch.int32, device=device), 0)

    @classmethod
    def from_list(cls, tensors, capacity=None):
        stacked = torch.stack(list(tensors), 0)
        n = stacked.shape[0]
        if capacity is not None and int(capacity) > n:
            pad = stacked.new_zeros((int(capacity) - n,) +
                                    tuple(stacked.shape[1:]))
            stacked = torch.cat([stacked, pad], 0)
        return cls(stacked, torch.full((), n, dtype=torch.int32,
                                       device=stacked.device), n)

    @property
    def capacity(self):
        return self.buffer.shape[0]

    @property
    def elem_shape(self):
        return tuple(self.buffer.shape[1:])

    def write(self, i, value, static_i=None):
        """The array with ``value`` at index ``i``; its length becomes
        max(length, i + 1). ``static_i``: the index's value when it is
        known before the run (a constant)."""
        idx, i = _index(i, self.capacity, self.buffer.device)
        value = value.to(self.buffer.dtype).reshape((1,) + self.elem_shape)
        if self.in_place:
            buf = self.buffer.index_copy_(0, idx, value)
        else:
            buf = self.buffer.index_copy(0, idx, value)
        new_len = torch.maximum(self.length, i + 1)
        new_static = (max(self.static_length, int(static_i) + 1)
                      if self.static_length is not None and
                      static_i is not None else None)
        return TensorArray(buf, new_len, new_static, self.in_place)

    def clear_static(self):
        """The array without its static length (carried through a loop or
        a conditional block), written out of place."""
        return TensorArray(self.buffer, self.length, None)

    def read(self, i):
        idx, _ = _index(i, self.capacity, self.buffer.device)
        return self.buffer.index_select(0, idx).reshape(self.elem_shape)

    def stack(self):
        """The [capacity, ...] buffer; the valid prefix is [:length]."""
        return self.buffer

    def masked_stack(self, fill=0):
        """The buffer with every slot at or past the length set to
        ``fill``."""
        idx = torch.arange(self.capacity, device=self.buffer.device)
        mask = (idx < self.length).reshape(
            (self.capacity,) + (1,) * (self.buffer.dim() - 1))
        return torch.where(mask, self.buffer,
                           torch.full((), fill, dtype=self.buffer.dtype,
                                      device=self.buffer.device))

    def select(self, pred, other):
        """``self`` where the scalar ``pred`` holds, else ``other`` (an
        array of the same capacity and element shape): the carry select of
        a masked loop iteration or a conditional block."""
        return TensorArray(torch.where(pred, self.buffer, other.buffer),
                           torch.where(pred, self.length, other.length))
