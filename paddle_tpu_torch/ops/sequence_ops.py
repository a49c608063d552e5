"""Sequence (ragged, LoD) ops: the lowerings of paddle_tpu/ops/sequence_ops.py
on torch tensors.

A ragged tensor is its rows [T, ...] and a static LoD (core/lod.py). Each
op derives its index maps from the LoD with numpy, as the JAX lowering
does, but builds them as device tensors once per run plan
(:func:`index_map`, `LowerContext.memo` keyed by the op's index): a run
copies nothing from the host, and a CUDA graph of the plan replays no
host-to-device copy.

Reductions over a sequence run on a padded [N, maxT, ...] gather of its
rows (`_padded_gather`), never on atomics: SUM, AVERAGE and SQRT pooling
and the softmax's denominator are :class:`_SegmentSum` (a masked sum over
the padded axis, whose gradient is the cotangent gathered back to each
row, as the transpose of the JAX ``segment_sum``); MAX is ``torch.amax``
over the padded axis with -inf in the empty lanes, whose gradient splits a
tie evenly among the tied rows, as the JAX ``segment_max`` VJP splits it.
An empty sequence pools to 0 (`_zero_empty`). ``sequence_slice`` and
``sequence_unpad`` take their Offset and Length as static feeds
(``static_inputs``), ``sequence_pad`` records its Length as one.
``sequence_enumerate``, ``sequence_erase``, ``sequence_scatter`` and
``fused_embedding_seq_pool`` wait for a later slice.

Every gather of rows by an index map that may repeat a row goes through
:func:`gather_rows`, whose gradient adds a repeated row's cotangents in
index order on the card, so that a training step is bitwise from run to
run (``index_select``'s gradient adds them by atomics there).
"""
import numpy as np
import torch

from ..core.lod import (context_maps, lengths_from_offsets, lod_from_lengths,
                        normalize_lod, segment_ids)
from ..core.registry import register_op
from .common import attr_dtype
from .math_ops import matmul

__all__ = ['index_map', 'padded_maps', 'to_padded', 'gather_rows']


def index_map(ctx, key, build, dtype=torch.int64):
    """The device tensor of ``build()`` (numpy), built once per run plan
    for the running op and ``key``."""
    return ctx.memo((ctx.op_index, key), lambda: torch.as_tensor(
        np.ascontiguousarray(build())).to(dtype).to(ctx.device))


def padded_maps(offsets, reverse=False):
    """(gather_idx [N, maxT], scatter_idx [T], N, maxT) between ragged rows
    and a padded [N, maxT] layout (the JAX package's `_padded_maps`):
    scatter_idx[t] = n * maxT + step of row t; a padded lane gathers row 0
    and is never scattered back. ``reverse`` walks each sequence from its
    end."""
    lens = lengths_from_offsets(offsets)
    n, maxt = len(lens), (max(lens) if lens else 0)
    gidx = np.zeros((n, maxt), dtype=np.int64)
    sidx = np.zeros((offsets[-1],), dtype=np.int64)
    for i, ln in enumerate(lens):
        rows = np.arange(offsets[i], offsets[i + 1])
        if reverse:
            rows = rows[::-1]
        gidx[i, :ln] = rows
        sidx[rows] = i * maxt + np.arange(ln)
    return gidx, sidx, n, maxt


def _lane_mask(offsets):
    lens = np.asarray(lengths_from_offsets(offsets))
    maxt = int(lens.max()) if lens.size else 0
    return np.arange(maxt)[None, :] < lens[:, None]


def _padded_maps(ctx, offsets):
    """The padded gather [N, maxT] and the valid lanes [N, maxT] (bool) of
    ``offsets`` on the device."""
    return (index_map(ctx, 'pad.g', lambda: padded_maps(offsets)[0]),
            index_map(ctx, 'pad.m', lambda: _lane_mask(offsets),
                      torch.bool))


def gather_rows(x, idx):
    """The rows of ``x`` at the int64 index vector ``idx``. On the card by
    indexing, whose gradient is ``index_put_(accumulate=True)``: it adds a
    repeated row's cotangents in index order (a sort), so the sum is the
    same from run to run. On the CPU ``index_select``, whose gradient
    ``index_add_`` adds them in index order there (the CPU's
    ``index_put_`` does not: ROADMAP, where the port's bits come
    from)."""
    return x[idx] if x.is_cuda else x.index_select(0, idx)


def to_padded(x, gidx):
    """The rows of ``x`` at the padded gather ``gidx`` [N, maxT]: [N,
    maxT, ...]."""
    return gather_rows(x, gidx.reshape(-1)).reshape(
        tuple(gidx.shape) + tuple(x.shape[1:]))


def _padded_gather(ctx, x, offsets):
    """(x's rows as [N, maxT, ...], the valid lanes [N, maxT] bool)."""
    gidx, mask = _padded_maps(ctx, offsets)
    return to_padded(x, gidx), mask


def _lanes(mask, x):
    """``mask`` with a unit axis for each trailing axis of ``x``."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - mask.dim()))


class _SegmentSum(torch.autograd.Function):
    """The per-sequence sum of ragged rows: forward a masked sum over the
    padded gather, backward the cotangent of each sequence gathered to its
    rows (the transpose of ``segment_sum``)."""

    @staticmethod
    def forward(ctx, x, gidx, mask, ids):
        xp = to_padded(x, gidx)
        ctx.save_for_backward(ids)
        return torch.where(_lanes(mask, xp), xp, xp.new_zeros(())).sum(1)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return g.index_select(0, ids), None, None, None


def _segment_sum(ctx, x, offsets):
    """The sum of each sequence's rows of ``x`` [T, ...]: [N, ...]."""
    gidx, mask = _padded_maps(ctx, offsets)
    ids = index_map(ctx, 'pad.ids', lambda: segment_ids(offsets))
    if x.shape[0] == 0:
        return x.new_zeros((len(offsets) - 1,) + tuple(x.shape[1:]))
    return _SegmentSum.apply(x, gidx, mask, ids)


def _segment_max(ctx, x, offsets):
    """(per-sequence max [N, ...], padded rows, lanes): -inf for an empty
    sequence; a tie's gradient splits evenly (``torch.amax``)."""
    xp, mask = _padded_gather(ctx, x, offsets)
    xp = torch.where(_lanes(mask, xp), xp,
                     xp.new_full((), float('-inf')))
    return xp.amax(1), xp, mask


def _zero_empty(ctx, out, offsets):
    """0 for an empty sequence's row of ``out`` (the reference's value)."""
    lens = lengths_from_offsets(offsets)
    if all(lens):
        return out
    empty = index_map(ctx, 'empty', lambda: np.asarray(lens) == 0,
                      torch.bool)
    return torch.where(_lanes(empty, out), out.new_zeros(()), out)


def _require_lod(ctx, op, slot='X'):
    lod = ctx.in1_lod(op, slot)
    if not lod:
        raise ValueError(
            "op %s requires a LoD (ragged) input in slot %s — feed it as "
            "(array, lod) or create_lod_tensor" % (op.type, slot))
    return lod


def _take(ctx, x, key, build):
    """Rows of ``x`` at the static indices ``build()`` (numpy)."""
    idx = index_map(ctx, key, build)
    if idx.numel() == 0:
        return x.new_zeros((0,) + tuple(x.shape[1:]))
    return gather_rows(x, idx)


# ---------------------------------------------------------------------------
# sequence_pool (and the first and last steps)

@register_op('sequence_pool')
def _sequence_pool(ctx, op):
    x = ctx.in1(op, 'X')
    lod = _require_lod(ctx, op)
    offsets = lod[-1]
    n = len(offsets) - 1
    pooltype = op.attr('pooltype', 'AVERAGE').upper()
    total = offsets[-1]
    if pooltype in ('SUM', 'AVERAGE', 'SQRT'):
        out = _segment_sum(ctx, x, offsets)
        if pooltype != 'SUM':
            root = np.sqrt if pooltype == 'SQRT' else np.asarray
            lens = np.asarray(lengths_from_offsets(offsets), np.float32)
            lens = index_map(ctx, 'lens', lambda: root(np.maximum(
                lens, np.float32(1))), torch.float32)
            out = out / lens.reshape((-1,) + (1,) * (out.dim() - 1))
    elif pooltype == 'MAX':
        if total == 0:
            out = x.new_zeros((n,) + tuple(x.shape[1:]))
        else:
            out, xp, mask = _segment_max(ctx, x, offsets)
            out = _zero_empty(ctx, out, offsets)
    elif pooltype == 'LAST':
        out = _take(ctx, x, 'last', lambda: np.maximum(
            np.asarray(offsets[1:]) - 1, 0))
        out = _zero_empty(ctx, out, offsets)
    elif pooltype == 'FIRST':
        out = _take(ctx, x, 'first', lambda: np.minimum(
            np.asarray(offsets[:-1]), max(total - 1, 0)))
        out = _zero_empty(ctx, out, offsets)
    else:
        raise NotImplementedError("sequence_pool pooltype %r" % pooltype)
    ctx.out(op, 'Out', out)
    # pooling consumes the last LoD level
    ctx.set_lod(op.output('Out')[0], lod[:-1])
    if ctx.needed(op, 'MaxIndex'):
        if pooltype == 'MAX' and total:
            # the first row (within x) attaining its sequence's max
            gidx, _ = _padded_maps(ctx, offsets)
            rows = gidx.reshape(tuple(gidx.shape) + (1,) * (x.dim() - 1))
            hit = (xp == out.unsqueeze(1)) & _lanes(mask, xp)
            cand = torch.where(hit, rows, rows.new_full((), total))
            midx = cand.amin(1) if cand.shape[1] else \
                cand.new_full(out.shape, total)
            midx = torch.where(midx == total, midx.new_zeros(()), midx)
            if not all(lengths_from_offsets(offsets)):
                # an empty sequence's index is segment_min's identity, the
                # int32 maximum, as in the JAX lowering
                empty = index_map(ctx, 'empty', lambda: np.asarray(
                    lengths_from_offsets(offsets)) == 0, torch.bool)
                midx = torch.where(_lanes(empty, midx),
                                   midx.new_full((), 2 ** 31 - 1), midx)
            ctx.out(op, 'MaxIndex', midx.to(torch.int32))
        else:
            ctx.out(op, 'MaxIndex', torch.zeros(
                (n,) + tuple(x.shape[1:]), dtype=torch.int32,
                device=x.device))


# ---------------------------------------------------------------------------
# sequence_softmax

@register_op('sequence_softmax')
def _sequence_softmax(ctx, op):
    """A softmax over the rows of each sequence, per trailing feature."""
    x = ctx.in1(op, 'X')
    lod = _require_lod(ctx, op)
    offsets = lod[-1]
    ids = index_map(ctx, 'pad.ids', lambda: segment_ids(offsets))
    if x.shape[0] == 0:
        out = x
    else:
        seg_max, _, _ = _segment_max(ctx, x, offsets)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                              seg_max.new_zeros(()))
        e = torch.exp(x - gather_rows(seg_max, ids))
        denom = _segment_sum(ctx, e, offsets)
        out = e / gather_rows(denom, ids)
    ctx.out(op, 'Out', out)
    ctx.set_lod(op.output('Out')[0], lod)


# ---------------------------------------------------------------------------
# sequence_expand and sequence_expand_as

@register_op('sequence_expand')
def _sequence_expand(ctx, op):
    x = ctx.in1(op, 'X')
    x_lod = ctx.in1_lod(op, 'X')
    y_lod = _require_lod(ctx, op, 'Y')
    ref_level = op.attr('ref_level', -1)
    if ref_level == -1:
        ref_level = len(y_lod) - 1
    reps = lengths_from_offsets(y_lod[ref_level])
    x_off = x_lod[0] if x_lod else tuple(range(x.shape[0] + 1))
    if len(x_off) - 1 != len(reps):
        raise ValueError(
            "sequence_expand: X has %d sequences but Y ref level has %d"
            % (len(x_off) - 1, len(reps)))
    idx, out_lens = [], []
    for i, rep in enumerate(reps):
        seq = list(range(x_off[i], x_off[i + 1]))
        for _ in range(rep):
            idx.extend(seq)
            if x_lod:
                out_lens.append(len(seq))
    ctx.out(op, 'Out', _take(ctx, x, 'idx', lambda: np.asarray(
        idx, np.int64)))
    if x_lod:
        ctx.set_lod(op.output('Out')[0], lod_from_lengths([out_lens]))


@register_op('sequence_expand_as')
def _sequence_expand_as(ctx, op):
    x = ctx.in1(op, 'X')
    y_lod = _require_lod(ctx, op, 'Y')
    reps = lengths_from_offsets(y_lod[-1])
    if x.shape[0] != len(reps):
        raise ValueError("sequence_expand_as: X rows (%d) != Y sequences "
                         "(%d)" % (x.shape[0], len(reps)))
    ctx.out(op, 'Out', _take(ctx, x, 'idx', lambda: np.repeat(
        np.arange(len(reps)), np.asarray(reps, np.int64))))
    ctx.set_lod(op.output('Out')[0], (tuple(y_lod[-1]),))


# ---------------------------------------------------------------------------
# sequence_concat, sequence_slice, sequence_reshape

@register_op('sequence_concat')
def _sequence_concat(ctx, op):
    names = op.input('X')
    xs = [ctx.get(n) for n in names]
    offs = []
    for n in names:
        lod = ctx.lod_of(n)
        if not lod:
            raise ValueError("sequence_concat input %r has no LoD" % n)
        offs.append(lod[-1])
    n_seq = len(offs[0]) - 1
    if any(len(o) - 1 != n_seq for o in offs):
        raise ValueError("sequence_concat inputs disagree on sequence count")
    bases = np.cumsum([0] + [x.shape[0] for x in xs])
    idx, out_lens = [], []
    for i in range(n_seq):
        ln = 0
        for k, off in enumerate(offs):
            idx.extend(range(bases[k] + off[i], bases[k] + off[i + 1]))
            ln += off[i + 1] - off[i]
        out_lens.append(ln)
    ctx.out(op, 'Out', _take(ctx, torch.cat(xs, 0), 'idx',
                             lambda: np.asarray(idx, np.int64)))
    ctx.set_lod(op.output('Out')[0], lod_from_lengths([out_lens]))


@register_op('sequence_slice', static_inputs=('Offset', 'Length'))
def _sequence_slice(ctx, op):
    x = ctx.in1(op, 'X')
    offsets = _require_lod(ctx, op)[-1]
    off = np.asarray(ctx.in1_static(op, 'Offset')).reshape(-1) \
        .astype(np.int64)
    length = np.asarray(ctx.in1_static(op, 'Length')).reshape(-1) \
        .astype(np.int64)
    n = len(offsets) - 1
    if off.size != n or length.size != n:
        raise ValueError("sequence_slice: Offset/Length must have one entry "
                         "per sequence")
    idx = []
    for i in range(n):
        start = offsets[i] + int(off[i])
        idx.extend(range(start, start + int(length[i])))
    ctx.out(op, 'Out', _take(ctx, x, 'idx', lambda: np.asarray(
        idx, np.int64)))
    ctx.set_lod(op.output('Out')[0],
                lod_from_lengths([[int(l) for l in length]]))


@register_op('sequence_reshape')
def _sequence_reshape(ctx, op):
    x = ctx.in1(op, 'X')
    offsets = _require_lod(ctx, op)[-1]
    new_dim = int(op.attr('new_dim'))
    dim = int(np.prod(x.shape[1:])) if x.dim() > 1 else 1
    out_lens = []
    for ln in lengths_from_offsets(offsets):
        if ln * dim % new_dim:
            raise ValueError(
                "sequence_reshape: sequence of %d elements not divisible by "
                "new_dim %d" % (ln * dim, new_dim))
        out_lens.append(ln * dim // new_dim)
    ctx.out(op, 'Out', x.reshape(-1, new_dim))
    ctx.set_lod(op.output('Out')[0], lod_from_lengths([out_lens]))


# ---------------------------------------------------------------------------
# sequence_pad and sequence_unpad

@register_op('sequence_pad')
def _sequence_pad(ctx, op):
    x = ctx.in1(op, 'X')
    pad_value = ctx.in1(op, 'PadValue')
    offsets = _require_lod(ctx, op)[-1]
    lens = lengths_from_offsets(offsets)
    n = len(lens)
    maxlen = max(lens) if lens else 0
    padded = int(op.attr('padded_length', -1))
    if padded == -1:
        padded = maxlen
    if padded < maxlen:
        raise ValueError("sequence_pad: padded_length %d < longest sequence "
                         "%d" % (padded, maxlen))
    step = tuple(x.shape[1:])

    def maps():
        idx = np.zeros((n, padded), dtype=np.int64)
        mask = np.zeros((n, padded), dtype=bool)
        for i in range(n):
            idx[i, :lens[i]] = np.arange(offsets[i], offsets[i + 1])
            mask[i, :lens[i]] = True
        return idx, mask

    idx = index_map(ctx, 'idx', lambda: maps()[0])
    mask = index_map(ctx, 'mask', lambda: maps()[1], torch.bool)
    gathered = gather_rows(x, idx.reshape(-1)).reshape(
        (n, padded) + step) if idx.numel() else \
        x.new_zeros((n, padded) + step)
    if pad_value.numel() > 0:
        pv = pad_value.to(x.dtype).expand((n, padded) + step)
    else:
        pv = gathered.new_zeros(())
    out = torch.where(mask.reshape((n, padded) + (1,) * len(step)),
                      gathered, pv)
    ctx.out(op, 'Out', out)
    if op.output('Length'):
        length = np.asarray(lens, np.int64)
        ctx.out(op, 'Length', index_map(ctx, 'length', lambda: length))
        # Length is a function of the static LoD: a sequence_unpad
        # downstream reads it as a static value
        ctx.set_static(op.output('Length')[0], length)


@register_op('sequence_unpad', static_inputs=('Length',))
def _sequence_unpad(ctx, op):
    x = ctx.in1(op, 'X')              # [N, pad_len, ...]
    lens = np.asarray(ctx.in1_static(op, 'Length')).reshape(-1) \
        .astype(np.int64)
    n, pad_len = int(x.shape[0]), int(x.shape[1])
    idx = []
    for i in range(n):
        idx.extend(i * pad_len + j for j in range(int(min(lens[i],
                                                          pad_len))))
    flat = x.reshape((n * pad_len,) + tuple(x.shape[2:]))
    ctx.out(op, 'Out', _take(ctx, flat, 'idx', lambda: np.asarray(
        idx, np.int64)))
    ctx.set_lod(op.output('Out')[0],
                lod_from_lengths([[int(l) for l in lens]]))


# ---------------------------------------------------------------------------
# sequence_reverse

@register_op('sequence_reverse')
def _sequence_reverse(ctx, op):
    x = ctx.in1(op, 'X')
    lod = _require_lod(ctx, op)
    offsets = lod[-1]

    def idx():
        out = np.arange(x.shape[0], dtype=np.int64)
        for i in range(len(offsets) - 1):
            out[offsets[i]:offsets[i + 1]] = \
                out[offsets[i]:offsets[i + 1]][::-1]
        return out

    ctx.out(op, 'Y', _take(ctx, x, 'idx', idx))
    ctx.set_lod(op.output('Y')[0], lod)


# ---------------------------------------------------------------------------
# sequence_conv (Fluid's context projection, then one product)

@register_op('sequence_conv')
def _sequence_conv(ctx, op):
    x = ctx.in1(op, 'X')          # [T, d]
    filt = ctx.in1(op, 'Filter')  # [context_length * d, out_d]
    lod = _require_lod(ctx, op)
    offsets = lod[-1]
    ctx_len = int(op.attr('contextLength'))
    ctx_start = int(op.attr('contextStart', -(ctx_len // 2)))
    if int(op.attr('contextStride', 1)) != 1:
        raise NotImplementedError("sequence_conv contextStride must be 1 "
                                  "(reference enforces the same)")
    t, d = x.shape
    idx = index_map(ctx, 'ctx.idx', lambda: context_maps(
        offsets, ctx_len, ctx_start)[0].reshape(-1))
    valid = index_map(ctx, 'ctx.valid', lambda: context_maps(
        offsets, ctx_len, ctx_start)[1], torch.float32).to(x.dtype)
    if t:
        ctx_mat = gather_rows(x, idx).reshape(t, ctx_len, d) * \
            valid[:, :, None]
    else:
        ctx_mat = x.new_zeros((0, ctx_len, d))
    pad_names = op.input('PaddingData')
    if pad_names and op.attr('paddingTrainable', False):
        pad_data = ctx.get(pad_names[0])   # [up + down, d]
        up = max(0, -ctx_start)
        down = max(0, ctx_start + ctx_len - 1)
        rows, cols, pidx = [], [], []
        for s in range(len(offsets) - 1):
            lo, hi = offsets[s], offsets[s + 1]
            for p in range(lo, hi):
                for j in range(ctx_len):
                    q = p + ctx_start + j
                    if q < lo and up:
                        rows.append(p)
                        cols.append(j)
                        pidx.append(q - lo + up)
                    elif q >= hi and down:
                        rows.append(p)
                        cols.append(j)
                        pidx.append(up + q - hi)
        if rows:
            at = (index_map(ctx, 'pad.rows', lambda: np.asarray(rows)),
                  index_map(ctx, 'pad.cols', lambda: np.asarray(cols)))
            pad_rows = gather_rows(pad_data, index_map(
                ctx, 'pad.idx', lambda: np.asarray(pidx)))
            ctx_mat = ctx_mat.index_put(at, pad_rows.to(x.dtype),
                                        accumulate=True)
    ctx.out(op, 'Out', matmul(ctx_mat.reshape(t, ctx_len * d), filt))
    ctx.set_lod(op.output('Out')[0], lod)


# ---------------------------------------------------------------------------
# lod_reset and sequence_mask

@register_op('lod_reset')
def _lod_reset(ctx, op):
    """X's rows under a new LoD: Y's last level, Y's value as offsets (a
    static value), or the ``target_lod`` attr."""
    x = ctx.in1(op, 'X')
    y_names = op.input('Y')
    if y_names:
        y_lod = ctx.lod_of(y_names[0])
        if y_lod:
            new_lod = (y_lod[-1],)
        else:
            off = np.asarray(ctx.static_value(y_names[0])).reshape(-1)
            new_lod = (tuple(int(v) for v in off),)
    else:
        new_lod = normalize_lod([list(op.attr('target_lod', []))])
    ctx.out(op, 'Out', x)
    ctx.set_lod(op.output('Out')[0], new_lod)


@register_op('sequence_mask')
def _sequence_mask(ctx, op):
    x = ctx.in1(op, 'X')
    maxlen = op.attr('maxlen', -1)
    if maxlen is None or maxlen < 0:
        raise NotImplementedError(
            "sequence_mask with a maxlen taken from the data: pass maxlen")
    steps = ctx.memo((ctx.op_index, 'steps'), lambda: torch.arange(
        int(maxlen), device=ctx.device))
    mask = steps < x.reshape(tuple(x.shape) + (1,))
    ctx.out(op, 'Y', mask.to(attr_dtype(op.attr('out_dtype', 'int64'))))
