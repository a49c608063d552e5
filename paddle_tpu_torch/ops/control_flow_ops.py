"""Control-flow ops: the lowerings of paddle_tpu/ops/control_flow_ops.py
on torch tensors: ``while``, ``conditional_block``, ``recurrent``
(StaticRNN and DynamicRNN) with ``drnn_boot_memory``, the tensor-array
ops (core/tensor_array.py), the LoD glue ops of the reference's
DynamicRNN, and the dense beam search.

A sub-block runs through the run plan's own walk (core/lowering.py
`lower_ops`) in a child context (`LowerContext.child`) over a copy of the
environment with the carry bound in it; the names a block writes that
the parent environment holds, and every tensor array its ops touch, are
the carry, as in the JAX lowering. Where the JAX package traces
``lax.while_loop``, ``lax.scan`` and ``lax.cond``, the port runs Python
loops on the device:

- ``while`` without a gradient: ``lax.while_loop``, the loop runs until
  its condition reads false (a ``max_trip_count`` does not cut it, as in
  the JAX package). Eagerly (``Executor.run``, the eager first step of a
  bound plan, every step on the CPU) the condition is read on the host
  before each iteration. Under a CUDA-graph capture (`Executor.bind`,
  ``run_fused``) the loop is one WHILE conditional node of the step's
  graph (core/graphs.py `run_while`, csrc/graph_while.cu): the body is
  captured once over buffers of the carry, writes the arrays' buffers in
  place (`TensorArray.in_place`), copies its other values back into theirs
  and reloads the node's condition, so the device runs it as many times
  as the condition holds, with no host read. The buffers take the layout
  that the plan's eager first step left (its arrays' element shapes, its
  carry's dtypes). A body that draws random numbers draws in each trip of
  the node what ``run()`` draws in that trip: the run's generators' device
  offsets advance by the body's increment at the end of each trip
  (core/graphs.py `run_while`, csrc/philox_offset.cu).
- ``while`` under the ``backward`` meta-op: a bound's iterations,
  ``max_trip_count`` or else the smallest capacity of an array the body
  writes (the JAX package's bounded ``lax.scan``), each iteration's carry
  kept with ``torch.where(cond, new, old)``. An inferred bound is checked,
  as the JAX package checks it on every step: on the host after an eager
  loop; in a capture by a device flag that ``bind`` and ``run_fused`` read
  after their replays (core/graphs.py `watch`). A bound the user passed is
  not checked.
- ``conditional_block``: the scalar form runs its block and keeps the
  written carry with ``torch.where(pred, new, old)`` (``lax.cond`` with an
  identity false branch, no host read); the non-scalar form runs the block
  iff every input has elements, a static rule.
- ``recurrent``: a loop over the static trip count (T, or the longest
  sequence of the static LoD), captured whole by a CUDA graph. A DynamicRNN
  keeps the JAX package's static batch of N sequences: a finished row
  keeps its memory and outputs zeros (``torch.where``), on the padded maps
  of ops/rnn_ops.py.

An array that a loop first writes is sized by that write. A loop whose
condition is false from the start runs its body once under
``torch.no_grad()`` and drops its values (the JAX package's trace of the
body): an array the body would write takes the written element's shape,
and each name the body gives a LoD keeps it, as the trace records it. An
array that is never written becomes a [capacity, 1] float32 array of
zeros, as in the JAX package. ``beam_search`` picks ties in
``lax.top_k``'s order, the lower index first (a stable sort:
``torch.topk`` promises no order on the card); ``beam_search_decode``
backtracks over the arrays' capacity, masked on the device by
``t < length``.
"""
import numpy as np
import torch

from ..core.lod import lengths_from_offsets
from ..core.registry import register_op
from ..core.tensor_array import TensorArray
from ..core.types import torch_dtype
from ..framework import SUB_BLOCK_ATTRS
from .rnn_ops import _maps, _to_ragged
from .sequence_ops import index_map, padded_maps, to_padded

__all__ = ['EmptyTensorArray', 'UnwrittenArrayRead']


class UnwrittenArrayRead(ValueError):
    """A read or stack of an array before its first write."""


class EmptyTensorArray(object):
    """``create_array``'s value before its first write: the element shape
    is unknown until a value is written, and a write records it (on this
    object, so that a probe of a loop body sizes the array)."""

    def __init__(self, capacity):
        self.capacity = int(capacity)
        self.elem_shape = None
        self.dtype = None

    def materialize(self, device):
        if self.elem_shape is None:
            raise UnwrittenArrayRead(
                "TensorArray read/stacked before any write — write to it "
                "first (write_to_array) so its element shape is known")
        return TensorArray.empty(self.capacity, self.elem_shape, self.dtype,
                                 device)

    def record(self, value):
        self.elem_shape = tuple(value.shape)
        self.dtype = value.dtype


def _is_array(v):
    return isinstance(v, (TensorArray, EmptyTensorArray))


def _sub_block(ctx, op, attr='sub_block'):
    return ctx.program.block(int(op.attr(attr)))


def _bind_parent_declared(ctx, written):
    """Vars a block writes that are declared in the parent block but not
    yet in the environment get zeros of their declared shape and dtype, so
    that the write is carried; an unknown shape raises."""
    for n in sorted(written):
        if ctx.has(n):
            continue
        var = ctx.block._find_var_recursive(n)
        if var is None or getattr(var, 'persistable', False):
            continue
        shape = getattr(var, 'shape', None)
        dtype = getattr(var, 'dtype', None)
        if shape is None or dtype is None or any(
                d is None or int(d) < 0 for d in shape):
            raise ValueError(
                "variable %r is declared in the parent block and first "
                "written inside a control-flow block, but its shape/dtype "
                "(%s, %s) is not fully known — assign it an initial value "
                "in the parent block first" % (n, shape, dtype))
        ctx.env[n] = torch.zeros(tuple(int(d) for d in shape),
                                 dtype=torch_dtype(dtype), device=ctx.device)


def _written_names(program, block, acc=None):
    """Every name that an op of ``block`` or of its sub-blocks writes."""
    if acc is None:
        acc = set()
    for op in block.ops:
        acc.update(op.output_arg_names)
        for a in SUB_BLOCK_ATTRS:
            idx = op.attr(a)
            if idx is not None:
                _written_names(program, program.block(int(idx)), acc)
    return acc


def _touched_arrays(ctx, block):
    """The names of the arrays in the environment that an op of ``block``
    reads or writes: they ride in the carry."""
    return set(n for op in block.ops
               for n in op.input_arg_names + op.output_arg_names
               if _is_array(ctx.env.get(n)))


def _carried(ctx, block):
    """(written names, carried names) of a block run from ``ctx``."""
    written = _written_names(ctx.program, block)
    _bind_parent_declared(ctx, written)
    carried = sorted(n for n in written if ctx.has(n))
    carried += sorted(_touched_arrays(ctx, block) - set(carried))
    return written, carried


def _carry_value(v):
    return v.clear_static() if isinstance(v, TensorArray) else v


def _run_block(ctx, block, carry):
    """The environment after one run of ``block`` over ``ctx``'s
    environment with ``carry`` bound in it."""
    from ..core.lowering import lower_ops
    env = dict(ctx.env)
    env.update(carry)
    lower_ops(ctx.child(env, block), block.ops, 0, len(block.ops))
    return env


def _pred(v):
    return v.reshape(()).to(torch.bool)


def _select(ctx, pred, new, old):
    """``new`` where the scalar ``pred`` holds, else ``old``: a tensor, or an
    array (an unwritten ``old`` is the zeros its first write sized)."""
    if new is old or isinstance(new, EmptyTensorArray):
        return old
    if isinstance(new, TensorArray):
        if isinstance(old, EmptyTensorArray):
            old = old.materialize(ctx.device)
        return new.select(pred, old)
    if old.dtype != new.dtype:
        old = old.to(new.dtype)
    return torch.where(pred, new, old)


def _settle_empties(ctx, carry):
    """Size the arrays still unwritten after a block's runs: one whose
    element shape a write recorded (a run of the block, or its probe)
    becomes zeros of that shape, one that nothing writes [capacity, 1]
    float32 zeros."""
    for n, ph in carry.items():
        if isinstance(ph, EmptyTensorArray):
            arr = ph.materialize(ctx.device) if ph.elem_shape is not None \
                else TensorArray.empty(ph.capacity, (1,), torch.float32,
                                       ctx.device)
            carry[n] = arr.clear_static()


def _probe(ctx, block, carry):
    """The JAX package's trace of a loop body that never runs: one run of
    the body under no_grad whose values are dropped. The unwritten arrays
    of ``carry`` record the element shapes it writes, and the run's LoDs
    become the body's (`LowerContext.detached`: it draws nothing from the
    run's generators and leaves the static values as they were). Only a
    read of an array before its first write is let pass: any other fault
    of the body raises, as the trace raises it."""
    with torch.no_grad(), ctx.detached() as probe_ctx:
        try:
            _run_block(probe_ctx, block, carry)
        except UnwrittenArrayRead:
            # a read of an array that no earlier op of the body wrote
            pass
    ctx.lods.clear()
    ctx.lods.update(probe_ctx.lods)


def _carry_spec(carry):
    """{name: (shape, dtype), or ('array', capacity, element shape, dtype)}
    of a loop's carry after its eager run: the buffers its capture loops
    over."""
    spec = {}
    for n, v in carry.items():
        if isinstance(v, TensorArray):
            spec[n] = ('array', v.capacity, v.elem_shape, v.buffer.dtype)
        else:
            spec[n] = (tuple(v.shape), v.dtype)
    return spec


def _capturing(ctx):
    return ctx.device.type == 'cuda' and \
        torch.cuda.is_current_stream_capturing()


# ---------------------------------------------------------------------------
# while
# ---------------------------------------------------------------------------

@register_op('while', stateful=True)
def _while(ctx, op):
    block = _sub_block(ctx, op)
    cond_name = op.input('Condition')[0]
    written, carried = _carried(ctx, block)
    if cond_name not in carried:
        raise ValueError(
            "while: condition %r is never updated inside the loop body — "
            "the loop would not terminate" % cond_name)
    carry = {n: _carry_value(ctx.env[n]) for n in carried}
    if ctx.wrt:
        carry = _bounded_loop(ctx, op, block, written, carry, cond_name)
    elif _capturing(ctx):
        carry = _graph_loop(ctx, block, carry, cond_name)
    else:
        carry = _host_loop(ctx, block, carry, cond_name)
    for n in carried:
        ctx.set(n, carry[n])


def _host_loop(ctx, block, carry, cond_name):
    """``lax.while_loop`` eagerly: the condition read on the host before
    each iteration. A loop that never runs probes its body (`_probe`). On
    the card the carry's layout after the loop is kept for a capture of
    the plan."""
    trips = 0
    while bool(_pred(carry[cond_name])):
        env = _run_block(ctx, block, carry)
        carry = {n: _carry_value(env[n]) for n in carry}
        trips += 1
    if not trips:
        _probe(ctx, block, carry)
    _settle_empties(ctx, carry)
    if ctx.device.type == 'cuda':
        # what a capture of the plan (`_graph_loop`) loops over, its trip
        # counter and the flag of a bounded capture (`_check_cut`), made
        # outside the capture so that no replay zeroes them
        ctx.memo(('while.carry', ctx.op_index), lambda: _carry_spec(carry))
        ctx.memo(('while.trips', ctx.op_index),
                 lambda: torch.zeros((), dtype=torch.int64,
                                     device=ctx.device))
        _cut_flag(ctx)
    return carry


def _graph_loop(ctx, block, carry, cond_name):
    """``lax.while_loop`` under a CUDA-graph capture (`Executor.bind`,
    ``run_fused``): one WHILE node (core/graphs.py `run_while`) whose body
    runs one iteration over buffers of the carry and copies the iteration's
    values back into them, until the condition reads false, with no host
    read. The buffers take the layout the plan's eager first step left
    (`_host_loop`): arrays its run or probe sized, dtypes its body made.
    The body writes the arrays' buffers in place (one slot a write), and
    the loop's values leave it written out of place again."""
    from ..core import graphs
    spec = ctx.memo(('while.carry', ctx.op_index), _not_laid_out)
    trips = ctx.memo(('while.trips', ctx.op_index), _not_laid_out)
    bufs = {}
    for n, v in carry.items():
        want = spec[n]
        if want[0] == 'array':
            _, cap, elem, dtype = want
            buf = torch.zeros((cap,) + tuple(elem), dtype=dtype,
                              device=ctx.device) \
                if isinstance(v, EmptyTensorArray) else \
                v.buffer.to(dtype, copy=True)
            length = torch.zeros((), dtype=torch.int32, device=ctx.device) \
                if isinstance(v, EmptyTensorArray) else v.length.clone()
            bufs[n] = TensorArray(buf, length, in_place=True)
        else:
            if tuple(v.shape) != want[0]:
                raise ValueError('while: %r enters the loop as %s, its eager '
                                 'run left %s' % (n, tuple(v.shape), want[0]))
            bufs[n] = v.to(want[1], copy=True)

    def body():
        env = _run_block(ctx, block, dict(bufs))
        _store(bufs, {n: _carry_value(env[n]) for n in bufs})
        return bufs[cond_name]

    graphs.run_while(bufs[cond_name], body, trips,
                     ctx._rng.generators() if ctx._rng is not None else ())
    return {n: _carry_value(v) for n, v in bufs.items()}


def _not_laid_out():
    raise RuntimeError('while: a loop is captured only after an eager run '
                       'of its plan has laid out its carry')


def _cut_flag(ctx):
    """The device flag of this loop's bounded capture (`_check_cut`),
    made by the plan's eager first step."""
    return ctx.memo(('while.cut', ctx.op_index),
                    lambda: torch.zeros((), dtype=torch.bool,
                                        device=ctx.device))


def _check_cut(ctx, final, message):
    """Raise RuntimeError(``message``) where a bounded loop's condition
    ``final`` still holds after its bound: at once in an eager run; in a
    capture through a device flag that the graph's owner reads after its
    replays (core/graphs.py `watch`, `check_flags`)."""
    if not _capturing(ctx):
        if ctx.device.type == 'cuda':
            _cut_flag(ctx)
        if bool(final.any()):
            raise RuntimeError(message)
        return
    from ..core import graphs
    flag = ctx.memo(('while.cut', ctx.op_index), _not_laid_out)
    flag.logical_or_(final.reshape(-1).any())
    graphs.watch(flag, message)


def _store(bufs, new):
    """Copy one iteration's carry ``new`` into the loop's buffers; a value
    that shares memory with a buffer (an assign of another carried name) is
    copied first."""
    pairs = []
    for n, b in bufs.items():
        v = new[n]
        if isinstance(b, TensorArray):
            pairs += [(b.buffer, v.buffer), (b.length, v.length)]
        else:
            pairs.append((b, v))
    held = set(b.untyped_storage().data_ptr() for b, _ in pairs)
    moves = []
    for b, v in pairs:
        if v is b:
            continue
        if tuple(v.shape) != tuple(b.shape):
            raise ValueError('while: a carried value changes shape from %s '
                             'to %s in the loop body' % (tuple(b.shape),
                                                          tuple(v.shape)))
        if v.untyped_storage().data_ptr() in held:
            v = v.clone()
        moves.append((b, v))
    for b, v in moves:
        b.copy_(v)


def _bounded_loop(ctx, op, block, written, carry, cond_name):
    """Under the ``backward`` meta-op: the bound's iterations (the JAX
    package's bounded ``lax.scan``), each iteration's carry kept with
    ``torch.where(cond, new, old)``. The bound is ``max_trip_count`` or
    else the smallest capacity of an array the body writes. A condition
    that still holds after an inferred bound raises (`_check_cut`)."""
    bound = op.attr('max_trip_count', None)
    inferred = bound is None
    if bound is None:
        # only arrays the body writes bound it: a loop appending one slot
        # an iteration cannot run past the capacity
        caps = [v.capacity for n, v in carry.items()
                if _is_array(v) and n in written]
        bound = min(caps) if caps else None
    if bound is None:
        raise ValueError(
            "while inside a differentiated (training) program needs a "
            "static trip-count bound for reverse-mode AD: pass "
            "layers.While(cond, max_trip_count=N) or carry a "
            "TensorArray whose capacity bounds the loop")
    for _ in range(int(bound)):
        pred = _pred(carry[cond_name])
        env = _run_block(ctx, block, carry)
        carry = {n: _carry_value(_select(ctx, pred, env[n], carry[n]))
                 for n in carry}
    _settle_empties(ctx, carry)
    if inferred:
        _check_cut(ctx, carry[cond_name],
                   "while: inferred trip-count bound %d (from TensorArray "
                   "capacity) was too small — the loop condition is still "
                   "true after %d iterations. Pass layers.While(cond, "
                   "max_trip_count=N) with the real bound."
                   % (bound, bound))
    return carry


# ---------------------------------------------------------------------------
# conditional_block
# ---------------------------------------------------------------------------

@register_op('conditional_block', stateful=True)
def _conditional_block(ctx, op):
    block = _sub_block(ctx, op)
    cond_vals = [ctx.get(n) for n in (op.input('Cond') or
                                      op.input('Condition'))]
    written, carried = _carried(ctx, block)
    if not bool(op.attr('is_scalar_condition', True)):
        # the reference's non-scalar form runs the block iff every input
        # has elements: a static property, so the block runs or not
        if all(c.numel() != 0 for c in cond_vals):
            env = _run_block(ctx, block, {})
            for n in carried:
                if n in env:
                    ctx.set(n, env[n])
        return
    pred = _pred(cond_vals[0])
    carry = {n: _carry_value(ctx.env[n]) for n in carried}
    env = _run_block(ctx, block, carry)
    carry = {n: _carry_value(_select(ctx, pred, env[n], carry[n]))
             for n in carried}
    _settle_empties(ctx, carry)
    for n in carried:
        ctx.set(n, carry[n])


# ---------------------------------------------------------------------------
# recurrent (StaticRNN and DynamicRNN)
# ---------------------------------------------------------------------------

def _step_mask(offsets):
    lens = np.asarray(lengths_from_offsets(offsets))
    maxt = int(lens.max()) if lens.size else 0
    return np.arange(maxt)[:, None] < lens[None, :]


@register_op('recurrent', stateful=True)
def _recurrent(ctx, op):
    block = _sub_block(ctx, op)
    xs_outer = list(op.input('X'))
    xs_inner = list(op.attr('xs_inner'))
    boots = list(op.input('Boot'))
    pre_names = list(op.attr('pre_names'))
    post_names = list(op.attr('post_names'))
    ys_inner = list(op.attr('ys_inner'))
    outs = list(op.output('Out'))
    last_outs = list(op.output('LastMem'))
    is_dynamic = bool(op.attr('is_dynamic', False))
    reverse = bool(op.attr('is_reverse', False))

    if is_dynamic:
        lod = ctx.in1_lod(op, 'X')
        if not lod:
            raise ValueError("DynamicRNN input needs LoD (ragged batch)")
        offsets = lod[-1]
        gidx, sidx = _maps(ctx, offsets, reverse)
        steps = gidx.shape[1]
        seqs = [to_padded(ctx.get(n), gidx).transpose(0, 1)
                for n in xs_outer]                      # [maxT, N, ...]
        masks = index_map(ctx, 'rnn.mask', lambda: _step_mask(offsets),
                          torch.bool).unbind(0)
    else:
        seqs = [ctx.get(n) for n in xs_outer]            # [T, N, ...]
        steps = seqs[0].shape[0] if seqs else int(op.attr('max_steps', 0))
        masks = None
    inputs = [s.unbind(0) for s in seqs]

    mems = {p: ctx.get(b) for p, b in zip(pre_names, boots)}
    ys = [[] for _ in ys_inner]
    for t in range(steps):
        carry = dict(mems)
        carry.update((n, x[t]) for n, x in zip(xs_inner, inputs))
        env = _run_block(ctx, block, carry)
        m = masks[t] if masks is not None else None
        for p, q in zip(pre_names, post_names):
            new = env[q].to(mems[p].dtype)
            if m is not None:
                new = torch.where(
                    m.reshape((-1,) + (1,) * (new.dim() - 1)), new, mems[p])
            mems[p] = new
        for k, y in enumerate(ys_inner):
            v = env[y]
            if m is not None:
                v = torch.where(m.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                                torch.zeros_like(v))
            ys[k].append(v)

    for o, steps_out in zip(outs, ys):
        if is_dynamic:
            ctx.set(o, _to_ragged(steps_out, sidx))
            ctx.set_lod(o, (offsets,))
        else:
            ctx.set(o, torch.stack(steps_out, 0))
    for o, p in zip(last_outs, pre_names):
        ctx.set(o, mems[p])


@register_op('drnn_boot_memory')
def _drnn_boot_memory(ctx, op):
    """DynamicRNN.memory(shape=, value=): a [num_seqs, *shape] constant,
    num_seqs from the static LoD of the RNN's first sequence input."""
    lod = ctx.in1_lod(op, 'X')
    if not lod:
        raise ValueError("drnn_boot_memory: sequence input has no LoD")
    n = len(lod[-1]) - 1
    shape = [n] + [int(s) for s in op.attr('shape')]
    ctx.out(op, 'Out', torch.full(shape, float(op.attr('value', 0.0)),
                                  dtype=torch_dtype(op.attr('dtype',
                                                            'float32')),
                                  device=ctx.device))
    ctx.set_lod(op.output('Out')[0], ())


# ---------------------------------------------------------------------------
# tensor arrays
# ---------------------------------------------------------------------------

@register_op('create_tensor_array', stateful=True)
def _create_tensor_array(ctx, op):
    ctx.out(op, 'Out', EmptyTensorArray(int(op.attr('capacity', 128))))


@register_op('write_to_array', stateful=True)
def _write_to_array(ctx, op):
    """The array is the op's Out (one variable across writes): the current
    value under the output name, written at I and bound again."""
    x = ctx.in1(op, 'X')
    i = ctx.in1(op, 'I')
    out_name = op.output('Out')[0]
    arr = ctx.env.get(out_name)
    if isinstance(arr, TensorArray) and arr.in_place and any(
            n != out_name and isinstance(v, TensorArray) and
            v.buffer is arr.buffer for n, v in ctx.env.items()):
        # another name holds this buffer: it must not see the write
        arr = arr.clear_static()
    if not isinstance(arr, TensorArray):
        if not isinstance(arr, EmptyTensorArray):
            arr = EmptyTensorArray(int(op.attr('capacity', 128)))
        arr.record(x)
        arr = arr.materialize(ctx.device)
    static_i = ctx.statics.get(op.input('I')[0])
    if static_i is not None:
        static_i = int(np.asarray(static_i).reshape(-1)[0])
    ctx.set(out_name, arr.write(i, x, static_i=static_i))


def _array(ctx, op, slot='X'):
    arr = ctx.in1(op, slot)
    return arr.materialize(ctx.device) \
        if isinstance(arr, EmptyTensorArray) else arr


@register_op('read_from_array')
def _read_from_array(ctx, op):
    ctx.out(op, 'Out', _array(ctx, op).read(ctx.in1(op, 'I')))


@register_op('lod_array_length')
def _lod_array_length(ctx, op):
    arr = ctx.in1(op, 'X')
    n = arr.length.reshape(1).to(torch.int64) \
        if isinstance(arr, TensorArray) else \
        torch.zeros((1,), dtype=torch.int64, device=ctx.device)
    ctx.out(op, 'Out', n)


@register_op('tensor_array_to_tensor')
def _tensor_array_to_tensor(ctx, op):
    """Concatenate (or stack) the written elements. With a static length
    the result is exactly the written prefix; an array written in a loop
    gives a capacity-sized result with zeros past the length, and
    OutIndex[0] holds the length (the JAX package's rule: XLA has no
    dynamic output shape)."""
    arr = _array(ctx, op)
    axis = int(op.attr('axis', 0))
    static_len = arr.static_length is not None
    if static_len:
        length = int(arr.static_length)
        buf = arr.stack()[:length]
    else:
        length = arr.capacity
        buf = arr.masked_stack()
    if op.attr('use_stack', False):
        out = buf if axis == 0 else torch.movedim(buf, 0, axis)
    else:
        out = torch.cat(buf.unbind(0), axis) if length else buf
    extent = buf.shape[1 + axis] if buf.dim() > 1 + axis else 1
    if static_len:
        idx = torch.full((max(length, 1),), extent, dtype=torch.int32,
                         device=ctx.device)
    else:
        idx = torch.cat([arr.length.reshape(1).to(torch.int32),
                         torch.full((length - 1,), extent, dtype=torch.int32,
                                    device=ctx.device)])
    ctx.out(op, 'Out', out)
    ctx.out(op, 'OutIndex', idx)


# -- LoD <-> array glue (static LoDs) ----------------------------------------

@register_op('lod_rank_table')
def _lod_rank_table(ctx, op):
    """The sequences by decreasing length, [(index, length)], a constant of
    the static LoD (also recorded as a static value)."""
    lod = ctx.in1_lod(op, 'X')
    if not lod:
        raise ValueError("lod_rank_table: input has no LoD")
    lens = lengths_from_offsets(lod[int(op.attr('level', 0))])
    order = sorted(range(len(lens)), key=lambda i: -lens[i])
    table = np.asarray([(i, lens[i]) for i in order], np.int64).reshape(-1, 2)
    name = op.output('Out')[0]
    ctx.set(name, index_map(ctx, 'table', lambda: table))
    ctx.set_static(name, table)


@register_op('max_sequence_len')
def _max_sequence_len(ctx, op):
    table = ctx.in1_static(op, 'RankTable')
    mx = int(table[0][1]) if len(table) else 0
    ctx.out(op, 'Out', torch.full((1,), mx, dtype=torch.int64,
                                  device=ctx.device))


@register_op('lod_tensor_to_array', stateful=True)
def _lod_tensor_to_array(ctx, op):
    """The ragged rows as an array of per-step batches, the sequences in
    rank-table order (longest first, a stable sort)."""
    x = ctx.in1(op, 'X')
    offsets = ctx.in1_lod(op, 'X')[-1]
    lens = lengths_from_offsets(offsets)
    order = np.argsort(-np.asarray(lens), kind='stable')
    gidx = index_map(ctx, 'gather',
                     lambda: padded_maps(offsets)[0][order])
    tm = to_padded(x, gidx).transpose(0, 1)             # [maxT, N, ...]
    ctx.out(op, 'Out', TensorArray(
        tm, torch.full((), tm.shape[0], dtype=torch.int32,
                       device=ctx.device)))


def _array_rows(table, maxt):
    """The rows of a [N_sorted, maxT] padded layout that hold each
    sequence's steps, sequences in their original order, and its
    offsets."""
    order = table[:, 0].astype(np.int64)
    lens = np.zeros(len(order), np.int64)
    lens[order] = table[:, 1]
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    rows = [inv[s] * maxt + np.arange(lens[s]) for s in range(len(order))]
    rows = np.concatenate(rows) if rows else np.zeros((0,), np.int64)
    return rows, np.concatenate([[0], np.cumsum(lens)])


@register_op('array_to_lod_tensor')
def _array_to_lod_tensor(ctx, op):
    arr = _array(ctx, op)
    table = np.asarray(ctx.static_value(op.input('RankTable')[0]))
    padded = arr.stack().transpose(0, 1)           # [N_sorted, maxT, ...]
    maxt = padded.shape[1]
    rows, off = _array_rows(table, maxt)
    idx = index_map(ctx, 'rows', lambda: rows)
    flat = padded.reshape((-1,) + tuple(padded.shape[2:]))
    ctx.out(op, 'Out', flat.index_select(0, idx))
    ctx.set_lod(op.output('Out')[0], (tuple(int(v) for v in off),))


@register_op('shrink_rnn_memory')
def _shrink_rnn_memory(ctx, op):
    """The reference shrinks the batch as sorted sequences finish; the
    static batch never shrinks (the mask keeps finished rows)."""
    ctx.out(op, 'Out', ctx.in1(op, 'X'))


@register_op('reorder_lod_tensor_by_rank')
def _reorder_lod_tensor_by_rank(ctx, op):
    x = ctx.in1(op, 'X')
    order = np.asarray(ctx.in1_static(op, 'RankTable'))[:, 0].astype(
        np.int64)
    lod = ctx.in1_lod(op, 'X')
    if not lod:
        ctx.out(op, 'Out', x.index_select(
            0, index_map(ctx, 'order', lambda: order)))
        return
    offsets = lod[-1]
    rows = np.concatenate(
        [np.arange(offsets[i], offsets[i + 1]) for i in order]) \
        if len(order) else np.zeros((0,), np.int64)
    ctx.out(op, 'Out', x.index_select(0, index_map(ctx, 'rows',
                                                   lambda: rows)))
    lens = lengths_from_offsets(offsets)
    off = np.concatenate([[0], np.cumsum([lens[i] for i in order])])
    ctx.set_lod(op.output('Out')[0], (tuple(int(v) for v in off),))


@register_op('split_lod_tensor')
def _split_lod_tensor(ctx, op):
    """IfElse's split: both branches take the whole batch (static shapes);
    merge_lod_tensor selects each row by the mask."""
    x = ctx.in1(op, 'X')
    ctx.out(op, 'OutTrue', x)
    ctx.out(op, 'OutFalse', x)


@register_op('merge_lod_tensor')
def _merge_lod_tensor(ctx, op):
    t = ctx.in1(op, 'InTrue')
    f = ctx.in1(op, 'InFalse')
    m = ctx.in1(op, 'Mask').to(torch.bool).reshape(
        (-1,) + (1,) * (t.dim() - 1))
    ctx.out(op, 'Out', torch.where(m, t, f))


# ---------------------------------------------------------------------------
# beam search (dense lanes)
# ---------------------------------------------------------------------------

@register_op('beam_search')
def _beam_search(ctx, op):
    """One dense beam-search step over [batch*beam] lanes: ``ids`` and
    ``scores`` [batch*beam, K] are each lane's candidates and their
    accumulated log-probabilities; a finished lane (pre_id == end_id)
    offers one candidate, (end_id, its pre_score). The best ``beam`` of
    each batch's beam*K candidates, ties to the lower index."""
    pre_ids = ctx.in1(op, 'pre_ids')
    pre_scores = ctx.in1(op, 'pre_scores')
    ids = ctx.in1(op, 'ids')
    scores = ctx.in1(op, 'scores')
    beam = int(op.attr('beam_size'))
    end_id = int(op.attr('end_id'))
    bw, k = scores.shape[0], scores.shape[1]
    batch = bw // beam

    finished = (pre_ids.reshape(bw) == end_id)[:, None]
    first = torch.arange(k, device=scores.device) == 0
    survive = torch.where(first, pre_scores.reshape(bw, 1).to(scores.dtype),
                          torch.full((), -1e9, dtype=scores.dtype,
                                     device=scores.device))
    scores = torch.where(finished, survive, scores)
    ids = torch.where(finished, torch.full((), end_id, dtype=ids.dtype,
                                           device=ids.device), ids)
    flat = scores.reshape(batch, beam * k)
    top_scores, top_idx = torch.sort(flat, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :beam], top_idx[:, :beam]
    base = torch.arange(batch, device=scores.device)[:, None] * beam
    parent = (base + top_idx // k).reshape(bw)
    sel_ids = ids.reshape(batch, beam * k).gather(1, top_idx).reshape(bw, 1)
    ctx.out(op, 'selected_ids', sel_ids.to(torch.int64))
    ctx.out(op, 'selected_scores', top_scores.reshape(bw, 1))
    ctx.out(op, 'parent_idx', parent.to(torch.int32))


@register_op('beam_search_decode')
def _beam_search_decode(ctx, op):
    """Backtrack the per-step (ids, parents) arrays into sentences:
    SentenceIds [batch, beam, T] (end_id past the written steps) and
    SentenceScores [batch, beam] (the last written step's scores)."""
    ids_arr = _array(ctx, op, 'Ids')
    par_arr = _array(ctx, op, 'Parents')
    beam = int(op.attr('beam_size'))
    end_id = int(op.attr('end_id'))
    ids_buf = ids_arr.stack()
    par_buf = par_arr.stack()
    T = ids_buf.shape[0]
    bw = par_buf.shape[1] if par_buf.dim() > 1 else par_buf.shape[0]
    ids_buf = ids_buf.reshape(T, bw)
    par_buf = par_buf.reshape(T, bw).to(torch.int64)
    n_steps = ids_arr.length
    end = torch.full((), end_id, dtype=ids_buf.dtype, device=ids_buf.device)
    row = torch.arange(bw, device=ids_buf.device)
    toks = []
    for t in range(T - 1, -1, -1):
        valid = n_steps > t
        toks.append(torch.where(valid, ids_buf[t].index_select(0, row), end))
        row = torch.where(valid, par_buf[t].index_select(0, row), row)
    sent = torch.stack(toks[::-1], 1)                   # [bw, T]
    batch = bw // beam
    ctx.out(op, 'SentenceIds',
            sent.reshape(batch, beam, T).to(torch.int64))
    if op.input('Scores') and op.output('SentenceScores'):
        sc_buf = _array(ctx, op, 'Scores').stack().reshape(T, bw)
        last = (n_steps - 1).clamp(min=0).to(torch.int64).reshape(1)
        ctx.out(op, 'SentenceScores',
                sc_buf.index_select(0, last).reshape(batch, beam))
