"""Recurrent ops: the lowerings of paddle_tpu/ops/rnn_ops.py's LSTM and GRU
family on torch tensors.

The layouts are the JAX package's (Fluid's lstm_op.cc, lstmp_op.cc,
gru_op.cc, gru_unit_op.cc, lstm_unit_op.cc):

- ``lstm``: Input [T, 4D] already projected, Weight [D, 4D], gate order
  [c, i, f, o]; Bias [1, 4D], or [1, 7D] with the peepholes W_ic, W_fc,
  W_oc after the gate biases: i and f read c_{t-1}, o reads c_t.
  ``lstmp`` adds ProjWeight [D, P]: the recurrent state is the
  projection, its Weight is [P, 4D], so D is Weight.shape[1] // 4.
- ``gru``: Input [T, 3D] ([u, r, c]), Weight [D, 3D] = [W_u W_r | W_c],
  Bias [1, 3D]; h = (1 - u) h_{t-1} + u c, or u h_{t-1} + (1 - u) c with
  ``origin_mode``.
- ``gru_unit`` (one step; activations as the ints 0-3: identity, sigmoid,
  tanh, relu) and ``lstm_unit`` (one step, gate order [i, f, o, j]).

The ragged rows go to a padded [N, maxT] layout and back through the
static maps of `sequence_ops.padded_maps` (the JAX `_padded_maps`), device
tensors built once per run plan. A padded lane gathers row 0 and is never
scattered back, so its cotangent is an exact zero, as in the JAX
lowering; ``is_reverse`` walks each sequence from its end. The JAX
``lax.scan`` is a loop over maxT steps (a host integer from the static
LoD, which keys the plan): each step one ``torch.addmm`` (the gate
inputs plus h_{t-1} @ W, a float32 product under the port's product
convention, ops/math_ops.py) and the gate arithmetic. The input's gate
bias is added for all steps at once before the loop: the same
elementwise sums, rounded the same. The steps' inputs are one
``unbind`` of the padded inputs, whose backward stacks the steps'
gradients once (a slice a step would make autograd add a zero tensor of
the whole padded input for each step). On the card the whole loop, forward
and autograd's backward, replays as one CUDA graph under ``bind`` and
``run_fused``. Outputs nothing reads (``lstm``'s BatchGate and
BatchCellPreAct, ``gru``'s BatchGate, BatchResetHiddenPrev and
BatchHidden) are not built. ``row_conv``, ``attention_lstm`` and
``cudnn_lstm`` wait for a later slice.
"""
import torch

from ..core.registry import register_op
from .sequence_ops import index_map, padded_maps, to_padded

__all__ = []

_ACT = {
    'identity': lambda x: x,
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'relu': torch.relu,
}
_ACT_BY_ID = ['identity', 'sigmoid', 'tanh', 'relu']


def _act(name):
    if isinstance(name, int):
        name = _ACT_BY_ID[name]
    if name not in _ACT:
        raise NotImplementedError("rnn activation %r" % name)
    return _ACT[name]


def _lod_offsets(ctx, op, slot='Input'):
    lod = ctx.in1_lod(op, slot)
    if not lod:
        raise ValueError(
            "op %s requires LoD input (ragged sequences); feed (array, lod)"
            % op.type)
    return lod, lod[-1]


def _maps(ctx, offsets, reverse):
    """(gather [N, maxT], scatter [T]) on the device."""
    return (index_map(ctx, 'rnn.g', lambda: padded_maps(offsets, reverse)[0]),
            index_map(ctx, 'rnn.s', lambda: padded_maps(offsets, reverse)[1]))


def _to_ragged(steps, sidx):
    """The per-step [N, ...] tensors as ragged rows [T, ...]."""
    padded = torch.stack(steps, 1)
    return padded.reshape((-1,) + tuple(padded.shape[2:])).index_select(
        0, sidx)


def _lstm_sequence(xb, w, h, c, peep, acts, proj=None, gates=False):
    """The LSTM over padded inputs ``xb`` [N, maxT, 4D] (gate biases added):
    returns the per-step (h, c) lists and, with ``gates``, the per-step
    [cand, i, f, o]. ``peep`` is (W_ic, W_fc, W_oc) or None; ``acts`` the
    (gate, cell, candidate) activations; ``proj`` (ProjWeight,
    activation) for ``lstmp``."""
    act_gate, act_state, act_cand = acts
    d = xb.shape[2] // 4
    hs, cs, gs = [], [], []
    for xt in xb.unbind(1):
        g = torch.addmm(xt, h, w)
        cand = act_cand(g[:, :d])
        gi, gf, go = g[:, d:2 * d], g[:, 2 * d:3 * d], g[:, 3 * d:]
        if peep is not None:
            gi = gi + c * peep[0]
            gf = gf + c * peep[1]
        i = act_gate(gi)
        f = act_gate(gf)
        c = cand * i + c * f
        o = act_gate(go + c * peep[2] if peep is not None else go)
        h = o * act_state(c)
        if proj is not None:
            h = proj[1](torch.matmul(h, proj[0]))
        hs.append(h)
        cs.append(c)
        if gates:
            gs.append(torch.cat([cand, i, f, o], 1))
    return hs, cs, gs


def _lstm_impl(ctx, op, with_projection):
    x = ctx.in1(op, 'Input')                    # [T, 4D] ragged
    w = ctx.in1(op, 'Weight')                   # [D, 4D]; lstmp: [P, 4D]
    bias = ctx.in1(op, 'Bias')                  # [1, 4D] or [1, 7D]
    lod, offsets = _lod_offsets(ctx, op)
    d = w.shape[1] // 4
    acts = (_act(op.attr('gate_activation', 'sigmoid')),
            _act(op.attr('cell_activation', 'tanh')),
            _act(op.attr('candidate_activation', 'tanh')))
    b = bias.reshape(-1)
    peep = (b[4 * d:5 * d], b[5 * d:6 * d], b[6 * d:7 * d]) \
        if op.attr('use_peepholes', True) else None
    proj = None
    rec = d
    if with_projection:
        proj_w = ctx.in1(op, 'ProjWeight')      # [D, P]
        proj = (proj_w, _act(op.attr('proj_activation', 'tanh')))
        rec = proj_w.shape[1]
    gidx, sidx = _maps(ctx, offsets, bool(op.attr('is_reverse', False)))
    n = gidx.shape[0]
    h0, c0 = ctx.in1(op, 'H0'), ctx.in1(op, 'C0')
    h = h0.to(x.dtype) if h0 is not None else x.new_zeros((n, rec))
    c = c0.to(x.dtype) if c0 is not None else x.new_zeros((n, d))
    out_slot = 'Projection' if with_projection else 'Hidden'
    if offsets[-1] == 0:
        hs = cs = gs = None
        empty = {out_slot: x.new_zeros((0, rec)),
                 'Cell': x.new_zeros((0, d)),
                 'BatchGate': x.new_zeros((0, 4 * d))}
    else:
        xb = to_padded(x, gidx) + b[:4 * d]
        hs, cs, gs = _lstm_sequence(xb, w, h, c, peep, acts, proj,
                                   gates=ctx.needed(op, 'BatchGate'))
        empty = None

    def ragged(slot, steps):
        return empty[slot] if empty is not None else _to_ragged(steps, sidx)

    hidden = ragged(out_slot, hs)
    ctx.out(op, out_slot, hidden)
    if op.output(out_slot):
        ctx.set_lod(op.output(out_slot)[0], lod)
    if ctx.needed(op, 'Cell') or ctx.needed(op, 'BatchCellPreAct'):
        cell = ragged('Cell', cs)
        ctx.out(op, 'Cell', cell)
        if op.output('Cell'):
            ctx.set_lod(op.output('Cell')[0], lod)
        ctx.out(op, 'BatchCellPreAct', cell)
    if ctx.needed(op, 'BatchGate'):
        ctx.out(op, 'BatchGate', ragged('BatchGate', gs))
    if with_projection:
        ctx.out(op, 'Hidden', hidden)


@register_op('lstm')
def _lstm(ctx, op):
    _lstm_impl(ctx, op, with_projection=False)


@register_op('lstmp')
def _lstmp(ctx, op):
    _lstm_impl(ctx, op, with_projection=True)


def _gru_sequence(xb, w, h, acts, origin_mode, keep=False):
    """The GRU over padded inputs ``xb`` [N, maxT, 3D] (biases added):
    returns the per-step h list and, with ``keep``, the per-step gates
    [u, r, c] and r * h_{t-1}."""
    act_gate, act_node = acts
    d = w.shape[0]
    w_ur, w_c = w[:, :2 * d], w[:, 2 * d:]
    hs, gs, rhs = [], [], []
    for xt in xb.unbind(1):
        ur = act_gate(torch.addmm(xt[:, :2 * d], h, w_ur))
        u, r = ur[:, :d], ur[:, d:]
        rh = r * h
        c = act_node(torch.addmm(xt[:, 2 * d:], rh, w_c))
        if origin_mode:
            h = u * h + (1.0 - u) * c
        else:
            h = (1.0 - u) * h + u * c
        hs.append(h)
        if keep:
            gs.append(torch.cat([ur, c], 1))
            rhs.append(rh)
    return hs, gs, rhs


@register_op('gru')
def _gru(ctx, op):
    x = ctx.in1(op, 'Input')                    # [T, 3D] [u, r, c]
    w = ctx.in1(op, 'Weight')                   # [D, 3D]
    lod, offsets = _lod_offsets(ctx, op)
    d = w.shape[0]
    bias = ctx.in1(op, 'Bias')
    acts = (_act(op.attr('gate_activation', 'sigmoid')),
            _act(op.attr('activation', 'tanh')))
    gidx, sidx = _maps(ctx, offsets, bool(op.attr('is_reverse', False)))
    n = gidx.shape[0]
    h0 = ctx.in1(op, 'H0')
    h = h0.to(x.dtype) if h0 is not None else x.new_zeros((n, d))
    keep = ctx.needed(op, 'BatchGate') or \
        ctx.needed(op, 'BatchResetHiddenPrev')
    if offsets[-1] == 0:
        out = {'Hidden': x.new_zeros((0, d)), 'BatchGate':
               x.new_zeros((0, 3 * d)),
               'BatchResetHiddenPrev': x.new_zeros((0, d))}
    else:
        xp = to_padded(x, gidx)
        xb = xp + bias.reshape(-1) if bias is not None else xp
        hs, gs, rhs = _gru_sequence(xb, w, h, acts,
                                   bool(op.attr('origin_mode', False)), keep)
        out = {'Hidden': _to_ragged(hs, sidx)}
        if keep:
            out['BatchGate'] = _to_ragged(gs, sidx)
            out['BatchResetHiddenPrev'] = _to_ragged(rhs, sidx)
    ctx.out(op, 'Hidden', out['Hidden'])
    if op.output('Hidden'):
        ctx.set_lod(op.output('Hidden')[0], lod)
    for slot in ('BatchGate', 'BatchResetHiddenPrev'):
        if ctx.needed(op, slot):
            ctx.out(op, slot, out[slot])
    ctx.out(op, 'BatchHidden', out['Hidden'])


@register_op('gru_unit')
def _gru_unit(ctx, op):
    x = ctx.in1(op, 'Input')                    # [N, 3D]
    h_prev = ctx.in1(op, 'HiddenPrev')          # [N, D]
    w = ctx.in1(op, 'Weight')                   # [D, 3D]
    bias = ctx.in1(op, 'Bias')
    d = h_prev.shape[1]
    xb = x + bias.reshape(-1) if bias is not None else x
    act_gate = _act(op.attr('gate_activation', 1))
    act_node = _act(op.attr('activation', 2))
    ur = act_gate(torch.addmm(xb[:, :2 * d], h_prev, w[:, :2 * d]))
    u, r = ur[:, :d], ur[:, d:]
    reset_h = r * h_prev
    c = act_node(torch.addmm(xb[:, 2 * d:], reset_h, w[:, 2 * d:]))
    if op.attr('origin_mode', False):
        h = u * h_prev + (1.0 - u) * c
    else:
        h = (1.0 - u) * h_prev + u * c
    if ctx.needed(op, 'Gate'):
        ctx.out(op, 'Gate', torch.cat([ur, c], 1))
    ctx.out(op, 'ResetHiddenPrev', reset_h)
    ctx.out(op, 'Hidden', h)


@register_op('lstm_unit')
def _lstm_unit(ctx, op):
    x = ctx.in1(op, 'X')                        # [N, 4D]
    c_prev = ctx.in1(op, 'C_prev')              # [N, D]
    forget_bias = float(op.attr('forget_bias', 0.0))
    d = c_prev.shape[-1]
    i, f, o, j = (x[..., k * d:(k + 1) * d] for k in range(4))
    c = c_prev * torch.sigmoid(f + forget_bias) + \
        torch.sigmoid(i) * torch.tanh(j)
    ctx.out(op, 'C', c)
    ctx.out(op, 'H', torch.tanh(c) * torch.sigmoid(o))
