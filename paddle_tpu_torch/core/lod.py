"""Static LoD: the metadata of ragged ("level-of-detail") sequences.

The port's own copy of paddle_tpu/core/lod.py. A LoD is a tuple of levels,
each a monotone tuple of row offsets (Fluid's framework/lod_tensor.h). As
in the JAX package it is static: a run plan is keyed by the LoDs of its
feeds (executor.py), so every sequence op knows its ragged row layout when
the plan is built, and builds its index maps from it with numpy once per
plan (core/lowering.py `LowerContext.memo`), as device tensors the plan
keeps. A new ragged pattern builds a new plan; readers bucket their
sequences to bound the number of plans.
"""
import numpy as np

__all__ = [
    'normalize_lod', 'lod_from_lengths', 'lengths_from_offsets',
    'segment_ids', 'check_lod', 'LoD', 'context_maps',
]


def context_maps(offsets, ctx_len, ctx_start):
    """Static per-row context-window gather maps for ragged sequences:
    (idx (T, ctx_len), valid (T, ctx_len)). Row p's j-th context element is
    row p+ctx_start+j when inside p's sequence, else masked. Shared by
    sequence_conv (reference math/context_project.h) and row_conv
    (ctx_start=0)."""
    total = offsets[-1]
    idx = np.zeros((total, ctx_len), dtype=np.int32)
    valid = np.zeros((total, ctx_len), dtype=bool)
    for s in range(len(offsets) - 1):
        lo, hi = offsets[s], offsets[s + 1]
        for p in range(lo, hi):
            for j in range(ctx_len):
                q = p + ctx_start + j
                if lo <= q < hi:
                    idx[p, j] = q
                    valid[p, j] = True
    return idx, valid


def normalize_lod(lod):
    """Canonicalize a user LoD into a tuple of tuples of int offsets.

    Accepts either offset-based levels ([[0, 2, 5]]) or, when a level does not
    start with 0, length-based levels ([[2, 3]]) like the reference's
    `recursive_sequence_lengths` API — converted to offsets."""
    if lod is None:
        return ()
    out = []
    for level in lod:
        level = [int(x) for x in level]
        if not level:
            continue
        if level[0] != 0:
            level = _offsets_from_lengths(level)
        out.append(tuple(level))
    return tuple(out)


def _offsets_from_lengths(lengths):
    off = [0]
    for n in lengths:
        off.append(off[-1] + int(n))
    return off


def lod_from_lengths(lengths_levels):
    return tuple(tuple(_offsets_from_lengths(l)) for l in lengths_levels)


def lengths_from_offsets(offsets):
    return tuple(int(offsets[i + 1] - offsets[i])
                 for i in range(len(offsets) - 1))


def segment_ids(offsets, total=None):
    """Row -> sequence-index map for one offset level, as a numpy int32 array.

    Static (numpy) on purpose: a lowering turns it into a device tensor
    once per run plan."""
    offsets = list(offsets)
    if total is None:
        total = offsets[-1]
    ids = np.zeros(int(total), dtype=np.int32)
    for i in range(len(offsets) - 1):
        ids[offsets[i]:offsets[i + 1]] = i
    return ids


def check_lod(lod, first_dim=None):
    """Validate monotone offsets and (optionally) that the last level covers
    the tensor's leading dim (reference lod_tensor.cc CheckLoD)."""
    lod = normalize_lod(lod)
    for level in lod:
        if level[0] != 0:
            raise ValueError("LoD level must start at 0: %s" % (level,))
        for a, b in zip(level, level[1:]):
            if b < a:
                raise ValueError("LoD offsets must be monotone: %s" % (level,))
    for upper, lower in zip(lod, lod[1:]):
        if upper[-1] != len(lower) - 1:
            raise ValueError(
                "LoD level %s does not index into next level %s"
                % (upper, lower))
    if first_dim is not None and lod and lod[-1][-1] != first_dim:
        raise ValueError(
            "last LoD level ends at %d but tensor's first dim is %d"
            % (lod[-1][-1], first_dim))
    return lod


class LoD(tuple):
    """Immutable normalized LoD (tuple of offset tuples)."""

    def __new__(cls, lod=()):
        return super(LoD, cls).__new__(cls, normalize_lod(lod))

    @property
    def last_level(self):
        return self[-1]

    def lengths(self):
        return [list(lengths_from_offsets(l)) for l in self]
