"""LoDTensor construction: the port's own copy of paddle_tpu/lod_tensor.py.

A `LoDTensor` is a host container: a numpy array and its static LoD
(core/lod.py). Fed to `Executor.run`, `bind` or `run_fused`, its LoD keys
the run plan and its array goes to the device.
"""
import numpy as np

from .core.lod import normalize_lod, lod_from_lengths, lengths_from_offsets

__all__ = ['LoDTensor', 'create_lod_tensor', 'create_random_int_lodtensor']


class LoDTensor(object):
    def __init__(self, data, lod=()):
        self._data = np.asarray(data)
        self._lod = normalize_lod(lod)

    def __array__(self, dtype=None):
        return self._data.astype(dtype) if dtype else self._data

    @property
    def shape(self):
        return self._data.shape

    def lod(self):
        return [list(l) for l in self._lod]

    def set_lod(self, lod):
        self._lod = normalize_lod(lod)

    def recursive_sequence_lengths(self):
        return [list(lengths_from_offsets(l)) for l in self._lod]

    def set_recursive_sequence_lengths(self, lengths):
        self._lod = lod_from_lengths(lengths)

    def has_valid_recursive_sequence_lengths(self):
        try:
            from .core.lod import check_lod
            check_lod(self._lod, first_dim=self._data.shape[0])
            return True
        except (ValueError, IndexError):
            return False

    def __repr__(self):
        return "LoDTensor(shape=%s, lod=%s)" % (self._data.shape,
                                                [list(l) for l in self._lod])


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Create a LoDTensor from data + recursive sequence lengths
    (length-based, e.g. [[2, 3]]), matching the reference API."""
    if isinstance(data, list):
        # list of per-sequence lists: flatten; lengths from the data itself
        arr = np.concatenate(
            [np.asarray(seq).reshape(len(seq), -1) for seq in data])
        lens = [len(seq) for seq in data]
        return LoDTensor(arr, lod_from_lengths([lens]))
    arr = np.asarray(data)
    return LoDTensor(arr, lod_from_lengths(recursive_seq_lens))


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    total = sum(recursive_seq_lens[-1])
    shape = (total,) + tuple(base_shape)
    data = np.random.randint(low, high + 1, shape).astype('int64')
    return LoDTensor(data, lod_from_lengths(recursive_seq_lens))
