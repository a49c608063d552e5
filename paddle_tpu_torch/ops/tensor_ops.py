"""Position encoding, and the shape ops of a Program.

The port's own copy of paddle_tpu/ops/tensor_ops.py
`position_encoding_table` and the `add_position_encoding` lowering. The
table is built in numpy exactly as the JAX package builds it, so that a
token's embedding is bit-identical whether it entered through a prefill
(rows 0..T-1 added at once) or a decode step (one row gathered by
position).

The program ops `reshape`/`reshape2` (0 copies a dimension, -1 is
inferred), `transpose`/`transpose2`, `slice`, `squeeze`/`squeeze2`,
`unsqueeze`/`unsqueeze2` and `flatten`/`flatten2` are views where torch
can make one; their ``XShape`` output (an empty [0, *x.shape] tensor in
the JAX package) is made only when something reads it. `gather` (BERT's
masked positions) is :func:`gather`. `top_k` (``layers.accuracy``) is
``torch.topk`` over the last axis, largest first, its indices int64.
`merge_selected_rows` and `get_tensor_from_selected_rows` take a
SelectedRows gradient (core/selected_rows.py) apart.

The rest of paddle_tpu/ops/tensor_ops.py follows its lowerings in plain
PyTorch: `concat`, `split` (``num`` or ``sections``), `stack`, `unstack`,
`expand` and `tile` (``jnp.tile``), `pad`, `pad2d` (constant, reflect,
edge), `pad_constant_like`, `strided_slice` (Python slices, negative
strides too), `crop`, `reverse`, `scatter`, `gather_nd`, `where`,
`multiplex`, `arg_max`/`arg_min` (the first extreme, int64), `argsort`
(stable, as ``jnp.argsort``), `diag`, `label_smooth`, `space_to_depth`,
`shuffle_channel`, `hash` and `sampling_id`. `scatter` overwrites with the
last update of each repeated id (the JAX CPU result) and adds in
``index_add`` with ``overwrite=False``; an id in [-n, 0) counts from the
end and one outside [-n, n) is dropped. `hash` multiplies and sums in
uint32 with wraparound, computed in int64 on 16-bit halves of the
multiplier and masked to 32 bits (torch has no full uint32 arithmetic).
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows

__all__ = ['position_encoding_table', 'add_position_encoding', 'gather']


def position_encoding_table(max_len, d_model):
    """The sinusoid table as a [max_len, d_model] float32 numpy array."""
    pos = np.arange(max_len)[:, None]
    half = d_model // 2
    freq = np.power(10000.0, -np.arange(half) / float(half))
    enc = np.zeros((max_len, d_model), dtype=np.float32)
    enc[:, :half] = np.sin(pos * freq)
    enc[:, half:2 * half] = np.cos(pos * freq)
    return enc


def add_position_encoding(x, alpha=1.0, beta=1.0, table=None):
    """``alpha * x + beta * table[:L]`` for x [N, L, D]. ``table`` is a
    precomputed [>= L, D] tensor on x's device (built when None)."""
    L, D = x.shape[-2], x.shape[-1]
    if table is None:
        table = torch.from_numpy(position_encoding_table(L, D)).to(x.device)
    return alpha * x + beta * table[:L]


def _take_fill(dtype):
    """The value ``jnp.take`` gives an index outside [-n, n) in its default
    mode: NaN for floats, the most negative value for signed integers (an
    int64 program computes in int32 in the JAX package, so int32's), the
    largest for unsigned ones and True for bool."""
    if dtype.is_floating_point:
        return float('nan')
    if dtype == torch.bool:
        return True
    info = torch.iinfo(torch.int32 if dtype == torch.int64 else dtype)
    return info.min if info.min < 0 else info.max


def gather(x, index):
    """Rows of ``x`` at ``index`` (flattened, cast to int32 as the JAX op
    casts it) along axis 0, as the JAX ``gather`` op's ``jnp.take``
    computes them in its default mode, for any dtype: an index in [-n, 0)
    counts from the end, and one outside [-n, n) gives a row of the fill
    value (`_take_fill`; NaN for floats, whose gradient is dropped). No
    index reaches the tensor out of range (on the card that is a
    device-side assert). The backward is autograd's scatter-add of the
    rows' gradients."""
    n = x.shape[0]
    idx = index.reshape(-1).to(torch.int32).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = ((idx >= 0) & (idx < n)).reshape((-1,) + (1,) * (x.dim() - 1))
    rows = x[idx.clamp(0, max(n - 1, 0))]
    return torch.where(inside, rows, torch.full((), _take_fill(x.dtype),
                                                dtype=x.dtype,
                                                device=x.device))


# ---------------------------------------------------------------------------
# the program ops


def _xshape(ctx, op, x):
    if ctx.needed(op, 'XShape'):
        ctx.out(op, 'XShape', x.new_zeros((0,) + tuple(x.shape)))


def _infer_reshape(x, shape):
    shape = list(shape)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape[shape.index(-1)] = x.numel() // max(known, 1)
    return tuple(shape)


def _with_xshape(lower):
    """The ``*2`` form of a shape op: the same output, and ``XShape``."""
    def lower2(ctx, op):
        lower(ctx, op)
        _xshape(ctx, op, ctx.in1(op, 'X'))
    return lower2


def _reshape(ctx, op):
    x = ctx.in1(op, 'X')
    ctx.out(op, 'Out', x.reshape(_infer_reshape(x, op.attr('shape'))))


def _transpose(ctx, op):
    ctx.out(op, 'Out', ctx.in1(op, 'X').permute(*op.attr('axis')))


def _squeeze(ctx, op):
    x = ctx.in1(op, 'X')
    axes = op.attr('axes', [])
    if axes:
        shape = tuple(s for i, s in enumerate(x.shape)
                      if not (i in axes and s == 1))
    else:
        shape = tuple(s for s in x.shape if s != 1)
    ctx.out(op, 'Out', x.reshape(shape))


def _unsqueeze(ctx, op):
    out = ctx.in1(op, 'X')
    for a in sorted(op.attr('axes')):
        out = out.unsqueeze(a)
    ctx.out(op, 'Out', out)


def _flatten(ctx, op):
    x = ctx.in1(op, 'X')
    axis = op.attr('axis', 1)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    ctx.out(op, 'Out', x.reshape(lead, -1))


for _name, _lower, _kw in (
        ('reshape', _reshape, {}), ('transpose', _transpose,
                                    {'share_lod': False}),
        ('squeeze', _squeeze, {}), ('unsqueeze', _unsqueeze, {}),
        ('flatten', _flatten, {})):
    register_op(_name, **_kw)(_lower)
    register_op(_name + '2', **_kw)(_with_xshape(_lower))


@register_op('slice')
def _slice(ctx, op):
    x = ctx.in1(op, 'Input')
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(op.attr('axes'), op.attr('starts'), op.attr('ends')):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    name = op.input('Input')[0]
    if len(op.attr('axes')) == 1 and e - s == 1 and \
            _axis_slices(ctx, name, a) > 1:
        # one index of one axis that other slices of x cut too: a view out
        # of the run's one unbind of x, which they share, so that their
        # gradients stack into one tensor (as ``q, k, v = qkv`` does)
        # instead of each adding a zero-filled copy of x (12 adds and 18
        # copies a step of the flagship, 0.8 ms on an H100). A lone slice
        # (BERT's first position of 128) indexes: an unbind's backward
        # would fill a zero tensor for every other index
        parts = ctx.run_memo(name, ('unbind', a), lambda: x.unbind(a))
        ctx.out(op, 'Out', parts[s].unsqueeze(a))
        return
    ctx.out(op, 'Out', x[tuple(idx)])


def _axis_slices(ctx, name, axis):
    """How many `slice` ops of the program cut variable ``name`` along
    ``axis`` alone (counted once a run plan)."""
    return ctx.memo(('axis_slices', name, axis), lambda: sum(
        1 for op in ctx.block.ops if op.type == 'slice'
        and op.input('Input') == [name] and list(op.attr('axes')) == [axis]))


@register_op('gather', share_lod=False)
def _gather(ctx, op):
    ctx.out(op, 'Out', gather(ctx.in1(op, 'X'), ctx.in1(op, 'Index')))


@register_op('top_k')
def _top_k(ctx, op):
    vals, idx = torch.topk(ctx.in1(op, 'X'), op.attr('k', 1), dim=-1)
    ctx.out(op, 'Out', vals)
    ctx.out(op, 'Indices', idx)


@register_op('add_position_encoding')
def _add_position_encoding(ctx, op):
    x = ctx.in1(op, 'X')                    # (N, L, D)
    L, D = x.shape[-2], x.shape[-1]
    table = ctx.memo(('position_encoding', L, D), lambda: torch.from_numpy(
        position_encoding_table(L, D)).to(x.device))
    ctx.out(op, 'Out', add_position_encoding(
        x, op.attr('alpha', 1.0), op.attr('beta', 1.0), table=table))


@register_op('get_tensor_from_selected_rows')
def _get_tensor_from_selected_rows(ctx, op):
    """A SelectedRows' values tensor (a dense input passes as it is)."""
    x = ctx.in1(op, 'X')
    ctx.out(op, 'Out', x.values if isinstance(x, SelectedRows) else x)


@register_op('merge_selected_rows')
def _merge_selected_rows(ctx, op):
    """A SelectedRows with its duplicate rows summed
    (`SelectedRows.merged`: the freed slots carry the sentinel row)."""
    x = ctx.in1(op, 'X')
    if isinstance(x, SelectedRows):
        x = SelectedRows(*x.merged(), x.height)
    ctx.out(op, 'Out', x)


@register_op('concat')
def _concat(ctx, op):
    ctx.out(op, 'Out', torch.cat(ctx.in_list(op, 'X'),
                                 dim=op.attr('axis', 0)))


@register_op('split')
def _split(ctx, op):
    """At the running sums of ``sections``, or into ``num`` (else as many
    as there are outputs) equal parts."""
    x = ctx.in1(op, 'X')
    axis = op.attr('axis', 0)
    sections = op.attr('sections', [])
    if sections:
        parts = torch.tensor_split(x, np.cumsum(sections)[:-1].tolist(),
                                   dim=axis)
    else:
        parts = torch.tensor_split(
            x, op.attr('num', 0) or len(op.output('Out')), dim=axis)
    for i, part in enumerate(parts):
        ctx.out(op, 'Out', part, idx=i)


@register_op('stack', share_lod=False)
def _stack(ctx, op):
    ctx.out(op, 'Y', torch.stack(ctx.in_list(op, 'X'),
                                 dim=op.attr('axis', 0)))


@register_op('unstack', share_lod=False)
def _unstack(ctx, op):
    for i, part in enumerate(ctx.in1(op, 'X').unbind(op.attr('axis', 0))):
        ctx.out(op, 'Y', part, idx=i)


def _tile(x, times):
    """``jnp.tile``: ``times`` padded with leading 1s to x's rank (or x's
    shape with leading 1s to ``times``' length)."""
    times = [1] * (x.dim() - len(times)) + list(times)
    return x.repeat(*times)


@register_op('expand')
def _expand(ctx, op):
    """Fluid's expand is a tile: each axis repeated ``expand_times``."""
    ctx.out(op, 'Out', _tile(ctx.in1(op, 'X'), op.attr('expand_times')))


@register_op('tile')
def _tile_op(ctx, op):
    ctx.out(op, 'Out', _tile(ctx.in1(op, 'X'), op.attr('repeat_times')))


def _pad_pairs(pairs):
    """[(before, after)] per axis, first axis first, as F.pad's flat list
    (last axis first)."""
    return [p for pair in reversed(pairs) for p in pair]


@register_op('pad')
def _pad(ctx, op):
    x = ctx.in1(op, 'X')
    p = op.attr('paddings')
    ctx.out(op, 'Out', F.pad(x, _pad_pairs(
        [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]),
        value=op.attr('pad_value', 0.0)))


_PAD2D_MODES = {'reflect': 'reflect', 'edge': 'replicate'}


@register_op('pad2d')
def _pad2d(ctx, op):
    """NCHW, ``paddings`` [top, bottom, left, right]; ``mode`` constant
    (``pad_value``), reflect or edge."""
    x = ctx.in1(op, 'X')
    p = op.attr('paddings')
    mode = op.attr('mode', 'constant')
    pad = (p[2], p[3], p[0], p[1])
    if mode == 'constant':
        out = F.pad(x, pad, value=op.attr('pad_value', 0.0))
    else:
        out = F.pad(x, pad, mode=_PAD2D_MODES[mode])
    ctx.out(op, 'Out', out)


@register_op('pad_constant_like')
def _pad_constant_like(ctx, op):
    """``Y`` padded at the end of each axis to ``X``'s shape."""
    x, y = ctx.in1(op, 'X'), ctx.in1(op, 'Y')
    ctx.out(op, 'Out', F.pad(y, _pad_pairs(
        [(0, a - b) for a, b in zip(x.shape, y.shape)]),
        value=op.attr('pad_value', 0.0)))


@register_op('strided_slice', share_lod=False)
def _strided_slice(ctx, op):
    """``x[start:end:stride]`` on each listed axis, as Python slices it
    (negative strides included)."""
    x = ctx.in1(op, 'Input')
    for a, s, e, st in zip(op.attr('axes'), op.attr('starts'),
                           op.attr('ends'), op.attr('strides')):
        if st > 0:
            idx = [slice(None)] * x.dim()
            idx[a] = slice(s, e, st)
            x = x[tuple(idx)]
        else:
            keep = range(*slice(s, e, st).indices(x.shape[a]))
            x = x.index_select(a, torch.tensor(list(keep), dtype=torch.long,
                                               device=x.device))
    ctx.out(op, 'Out', x)


@register_op('crop', share_lod=False)
def _crop(ctx, op):
    x = ctx.in1(op, 'X')
    ctx.out(op, 'Out', x[tuple(slice(o, o + s) for o, s in zip(
        op.attr('offsets'), op.attr('shape')))])


@register_op('reverse', share_lod=False)
def _reverse(ctx, op):
    axes = op.attr('axis')
    axes = axes if isinstance(axes, (list, tuple)) else [axes]
    ctx.out(op, 'Out', torch.flip(ctx.in1(op, 'X'), dims=list(axes)))


def _ids(t, n):
    """Flattened ids as int64 (cast through int32 as the JAX ops cast
    them), those in [-n, 0) counted from the end."""
    ids = t.reshape(-1).to(torch.int32).to(torch.int64)
    return torch.where(ids < 0, ids + n, ids)


@register_op('scatter', share_lod=False)
def _scatter(ctx, op):
    """Rows ``Ids`` of ``X`` overwritten by ``Updates`` (the last update of
    a repeated id wins), or with ``overwrite=False`` added to (each
    update once); ids outside [-n, n) are dropped."""
    x, upd = ctx.in1(op, 'X'), ctx.in1(op, 'Updates')
    n = x.shape[0]
    ids = _ids(ctx.in1(op, 'Ids'), n)
    inside = (ids >= 0) & (ids < n)
    ids, upd = ids[inside], upd[inside]
    if not op.attr('overwrite', True):
        ctx.out(op, 'Out', x.index_add(0, ids, upd.to(x.dtype)))
        return
    # each id's last position: later positions win
    pos = torch.arange(ids.numel(), device=ids.device)
    last = torch.full((n,), -1, dtype=torch.long, device=ids.device)
    last = last.scatter_reduce(0, ids, pos, reduce='amax')
    win = last[ids] == pos
    ctx.out(op, 'Out', x.index_put((ids[win],), upd[win].to(x.dtype)))


@register_op('gather_nd', share_lod=False)
def _gather_nd(ctx, op):
    """``x[index[..., 0], index[..., 1], ...]``: negative entries count
    from the end and the rest are clamped into range, as JAX's indexing
    clamps them."""
    x, index = ctx.in1(op, 'X'), ctx.in1(op, 'Index')
    index = index.to(torch.int32).to(torch.int64)
    parts = []
    for i in range(index.shape[-1]):
        n = x.shape[i]
        c = index[..., i]
        parts.append(torch.where(c < 0, c + n, c).clamp(0, max(n - 1, 0)))
    ctx.out(op, 'Out', x[tuple(parts)])


@register_op('where', share_lod=False)
def _where(ctx, op):
    ctx.out(op, 'Out', torch.where(ctx.in1(op, 'Condition').bool(),
                                   ctx.in1(op, 'X'), ctx.in1(op, 'Y')))


@register_op('multiplex', share_lod=False)
def _multiplex(ctx, op):
    """Row i of the output is row i of input ``Ids[i]``."""
    xs = torch.stack(ctx.in_list(op, 'X'), dim=0)
    ids = ctx.in1(op, 'Ids').reshape(-1).to(torch.int64)
    ctx.out(op, 'Out', xs[ids, torch.arange(xs.shape[1], device=xs.device)])


@register_op('arg_max')
def _arg_max(ctx, op):
    ctx.out(op, 'Out', torch.argmax(ctx.in1(op, 'X'),
                                    dim=op.attr('axis', -1)))


@register_op('arg_min')
def _arg_min(ctx, op):
    ctx.out(op, 'Out', torch.argmin(ctx.in1(op, 'X'),
                                    dim=op.attr('axis', -1)))


@register_op('argsort', share_lod=False)
def _argsort(ctx, op):
    """Ascending and stable: ties keep their order (``jnp.argsort``)."""
    out, idx = torch.sort(ctx.in1(op, 'X'), dim=op.attr('axis', -1),
                          stable=True)
    ctx.out(op, 'Out', out)
    ctx.out(op, 'Indices', idx)


@register_op('diag', share_lod=False)
def _diag(ctx, op):
    ctx.out(op, 'Out', torch.diag(ctx.in1(op, 'Diagonal')))


@register_op('label_smooth')
def _label_smooth(ctx, op):
    x, dist = ctx.in1(op, 'X'), ctx.in1(op, 'PriorDist')
    eps = op.attr('epsilon', 0.0)
    smooth = eps * dist if dist is not None else eps / x.shape[-1]
    ctx.out(op, 'Out', (1.0 - eps) * x + smooth)


@register_op('space_to_depth')
def _space_to_depth(ctx, op):
    x = ctx.in1(op, 'X')                    # NCHW
    bs = op.attr('blocksize')
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    ctx.out(op, 'Out', out.reshape(n, c * bs * bs, h // bs, w // bs))


@register_op('shuffle_channel')
def _shuffle_channel(ctx, op):
    x = ctx.in1(op, 'X')
    group = op.attr('group')
    n, c, h, w = x.shape
    ctx.out(op, 'Out', x.reshape(n, group, c // group, h, w).transpose(1, 2)
            .reshape(n, c, h, w))


_U32 = 0xFFFFFFFF


@register_op('hash')
def _hash(ctx, op):
    """For each of ``num_hash`` multipliers 2654435761 + 97 i, the uint32
    sum over a row of (x * multiplier), modulo ``mod_by``: [N, num_hash,
    1] int64. The uint32 products are taken on the multiplier's 16-bit
    halves so that no int64 product overflows."""
    x = ctx.in1(op, 'X')
    v = (x.reshape(x.shape[0], -1).to(torch.int64) & _U32)
    outs = []
    for i in range(op.attr('num_hash', 1)):
        m = 2654435761 + i * 97
        lo = v * (m & 0xFFFF)
        hi = ((v * (m >> 16)) & 0xFFFF) << 16
        prod = (lo + hi) & _U32
        h = prod.sum(dim=-1) & _U32
        outs.append(h % op.attr('mod_by', 100000))
    ctx.out(op, 'Out', torch.stack(outs, dim=-1)[:, :, None])


@register_op('sampling_id', needs_rng=True)
def _sampling_id(ctx, op):
    """One id a row drawn from the row's probabilities (clipped to [1e-20,
    1], as the JAX op takes their log), from the run's generator."""
    x = ctx.in1(op, 'X')
    ids = torch.multinomial(x.float().clamp(1e-20, 1.0), 1,
                            generator=ctx.rng())
    ctx.out(op, 'Out', ids.reshape(-1))
