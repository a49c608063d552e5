"""DataFeeder: minibatch rows of Python or numpy values as a feed dict.

The port's own copy of paddle_tpu/data_feeder.py. ``DataFeeder(feed_list,
place, program).feed(rows)`` takes one row a sample, a value for each
variable of ``feed_list`` (Variables or names), and returns {name: value}
for `Executor.run`. A dense variable's values are stacked, each reshaped
to the variable's shape without its batch dimension, as the JAX feeder
stacks them. A variable declared with ``lod_level=1`` takes one sequence a
sample (a list of token ids, or of rows): the sequences are concatenated
along the leading dimension and fed as ``(array, lod)``, the pair
`Executor.run` reads as a ragged feed (the reference Fluid feeder's
LoDTensor; the JAX feeder stacks such rows as dense ones, so it takes only
sequences of one length there). ``feed_parallel`` splits one batch into
equal shares, one a device.
"""
import numpy as np

from .core.lod import lod_from_lengths
from .framework import Variable, default_main_program

__all__ = ['DataFeeder']


class DataToLoDTensorConverter(object):
    def __init__(self, shape, dtype, lod_level=0):
        self.shape = [s if s is not None and s >= 0 else -1 for s in shape]
        self.dtype = dtype
        self.lod_level = lod_level
        self.data = []

    def feed(self, data):
        self.data.append(np.asarray(data))

    def done(self):
        tail = self.shape[1:] if self.shape and self.shape[0] == -1 \
            else self.shape
        if self.lod_level:
            return self._ragged(tail)
        arrs = []
        for d in self.data:
            a = np.asarray(d, dtype=self.dtype)
            if tail and all(s >= 0 for s in tail) and \
                    a.shape != tuple(tail):
                a = a.reshape(tail)
            arrs.append(a)
        return np.stack(arrs)

    def _ragged(self, tail):
        """One sequence a sample, concatenated: each step shaped as the
        variable's row (``tail``), with the lengths as a one-level LoD."""
        if self.lod_level != 1:
            raise NotImplementedError(
                'DataFeeder takes sequences of lod_level 1, not %d'
                % self.lod_level)
        row = tuple(tail) if tail and all(s >= 0 for s in tail) else None
        seqs = []
        for d in self.data:
            a = np.asarray(d, dtype=self.dtype)
            n = a.shape[0] if a.ndim else 1
            seqs.append(a.reshape((n,) + row) if row is not None else a)
        lens = [len(a) for a in seqs]
        arr = np.concatenate(seqs) if seqs else \
            np.zeros((0,) + (row or ()), self.dtype)
        return arr, [list(l) for l in lod_from_lengths([lens])]


class DataFeeder(object):
    def __init__(self, feed_list, place=None, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_levels = []
        if program is None:
            program = default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list entries must be Variables/names")
            self.feed_names.append(each_var.name)
            self.feed_shapes.append(each_var.shape)
            self.feed_dtypes.append(each_var.dtype)
            self.feed_lod_levels.append(each_var.lod_level or 0)
        self.place = place

    def feed(self, iterable):
        converters = [DataToLoDTensorConverter(shape, dtype, lod_level)
                      for shape, dtype, lod_level in zip(
                          self.feed_shapes, self.feed_dtypes,
                          self.feed_lod_levels)]
        for each_sample in iterable:
            assert len(each_sample) == len(converters), \
                "sample width != number of feed vars"
            for value, conv in zip(each_sample, converters):
                conv.feed(value)
        return {name: conv.done()
                for name, conv in zip(self.feed_names, converters)}

    def feed_parallel(self, iterable, num_places=None):
        """Split one batch across devices (reference multi-device feed);
        returns a list of per-device feed dicts. Ragged feeds do not
        split."""
        full = self.feed([s for chunk in iterable for s in chunk]) \
            if isinstance(iterable[0], (list, tuple)) else self.feed(iterable)
        if not num_places or num_places <= 1:
            return [full]
        if any(isinstance(v, tuple) for v in full.values()):
            raise NotImplementedError(
                'feed_parallel of ragged (lod_level 1) feeds')
        out = []
        for i in range(num_places):
            d = {}
            for k, v in full.items():
                n = v.shape[0] // num_places
                d[k] = v[i * n:(i + 1) * n]
            out.append(d)
        return out
