"""Program introspection: a count of each plan's work, and op-level
attribution profiling.

The port's counterpart of paddle_tpu/analysis.py. The JAX package mines
XLA's ``cost_analysis()`` of each compiled program; PyTorch has none, so
the port counts the program's own work from the ops its plan ran.

1. **Where do my step's flops and bytes go?** A plan registers once, at
   its eager first step (``Executor.run``'s first run of a plan: kind
   ``run``; the first step of a plan bound to a scope under ``bind``:
   ``bound``, or under ``run_fused``: ``fused``), keyed like the JAX
   registry by (fingerprint, kind, feed signature). While that step runs,
   an op hook (core/lowering.py `op_hook`) records each op's type, attrs,
   and its inputs' and outputs' shapes, dtypes and whether autograd
   tracks them; the hook runs only on that step, never in a replay. The
   cost is counted lazily, at the first read (the monitor's pre-snapshot
   hook, :func:`lookup`, :func:`records`), from the cost rules below, and
   exported as the gauges ``program_flops`` and ``program_bytes_accessed``
   with the JAX labels. On the card ``peak_bytes`` is the process's peak
   allocation after that first step less what was allocated before it,
   exported as ``program_peak_bytes``, when the step set a new peak
   (``torch.cuda.max_memory_allocated`` rose). When it did not, the step's
   own peak is unknown and ``peak_bytes`` is None: the peak statistics
   are the caller's, and this module never resets them. On the CPU it is
   None. ``PADDLE_PROGRAM_ANALYTICS=0`` disables registration.

   **The cost rules**, keyed by op type (``_PRODUCTS``):

   - Products (``mul``, ``matmul``, ``conv2d``, ``depthwise_conv2d``,
     ``flash_attention``, ``fused_ffn_tail``, the ``kv_*_attention*``
     ops, ``sequence_conv``, the recurrences' per-step products,
     ``bilinear_tensor_product``): 2·M·N·K for each product that the op's
     plain version computes, at the shapes the step ran. Causal attention
     is counted over the full L x L, as the plain version computes it;
     a recurrence over its padded batch at the longest sequence's steps.
   - The ``backward`` meta-op: for a product op, one product for each
     operand the backward differentiates (dX only where autograd tracked
     X, dW only where it tracked W), as autograd computes them; a kernel
     op whose backward is a function of its own counts what its plain
     backward computes (``flash_attention``: the scores and dP recomputed
     by each of its two backward kernels, then dQ, dK and dV, seven
     products; ``fused_ffn_tail``: its four; a table of at most 64 rows
     under ``lookup_table`` takes its gradient as a one-hot product). A
     product under an AMP mark takes each gradient as two bf16 products
     (the hi and lo halves of the gradient, ops/math_ops.py
     `split_product`), and both count. All other ops of the
     differentiated segment are counted once more.
   - Every other op: one flop per output element, and transcendentals
     for exp, log, tanh, sigmoid, erf/gelu and softmax (one per output
     element; the fused kernels: flash's exponentials, the FFN's erf, the
     LN's reciprocal roots, the CE's exponentials), as XLA's
     HloCostAnalysis counts them. Layout ops that move no data (reshape,
     squeeze, unsqueeze, flatten) count nothing, and an op that owns a
     sub-block counts only the ops its block ran (a loop's body once a
     trip of that step).
   - Bytes: each op's input and output bytes (the segment's again under
     the ``backward``).

   The product count of a step equals ``torch.utils.flop_counter.
   FlopCounterMode``'s count of the same step on the plain versions
   (tests/test_torch_goodput.py holds it for the LM with flash off and on,
   BERT and a conv step). goodput.py reads ``flops`` per step.

2. **Which op does the time go to?** ``PADDLE_PROFILE_OPS=1`` (or the
   ``profiler.profile_ops()`` context) makes ``Executor.run`` run a fresh
   plan eagerly, op by op, synchronized after each op (:func:`run_profiled`),
   with per-op wall time (exclusive of the ops nested in it), call count
   and output bytes: the Fluid-style sorted attribution table
   (:func:`format_op_profile`) plus one ``op:<type>`` span per op on the
   monitor ring. A profiled run captures nothing and caches nothing.

3. **Which op made the NaN?** With ``PADDLE_NAN_LOCALIZE=1``, a
   ``FLAGS_check_nan_inf`` trip in ``Executor.run`` (and a TrainingGuard
   rollback, and ``tools/torch_blackbox.py replay``) replays the step
   from its pre-run state with its run seed, op by op under an op hook
   that checks each op's outputs on the host (:func:`localize_nonfinite`):
   pass A runs the ops before the ``backward`` op (a forward culprit), pass
   B the whole step (non-finite gradients name ``backward``; then the
   optimizer). The replay writes into copies of the state, never the
   state it was handed.

``explain_program`` waits for a later slice (``Executor.explain``).

Catalog + examples: docs/observability.md.
"""
import collections
import contextlib
import logging
import os
import threading
import time

import numpy as np
import torch

from . import monitor
from .core import amp, lowering
from .core.selected_rows import SelectedRows

__all__ = ['ProgramAnalytics', 'record_compiled', 'recording',
           'flush_pending', 'lookup', 'records', 'memory_usage_bytes', 'reset',
           'op_profile', 'format_op_profile', 'reset_op_profile',
           'profile_ops_active', 'push_profiling', 'pop_profiling',
           'run_profiled', 'nan_localization_enabled', 'localize_nonfinite',
           'localize_from_scope', 'format_localization']

logger = logging.getLogger(__name__)

# short fingerprint prefix used as the gauge label, as in the JAX package
_FP_LABEL_LEN = 12


def _env_on(name):
    return os.environ.get(name, '') not in ('', '0')


def _analytics_enabled():
    return os.environ.get('PADDLE_PROGRAM_ANALYTICS', '1') != '0'


def _op_counts(program):
    counts = collections.Counter()
    for block in program.blocks:
        for op in block.ops:
            counts[op.type] += 1
    return dict(counts)


# ---------------------------------------------------------------------------
# what the first step ran: one record an op


class _Val(object):
    """A tensor an op read or wrote: shape, bytes, and whether autograd
    tracked it when the op ran."""

    __slots__ = ('shape', 'nbytes', 'grad', 'lod')

    def __init__(self, t, lod=None):
        self.shape = tuple(int(n) for n in t.shape)
        self.nbytes = int(t.numel()) * t.element_size()
        self.grad = bool(t.requires_grad)
        self.lod = lod


def _val(ctx, name):
    v = ctx.env.get(name)
    if isinstance(v, SelectedRows):
        v = v.values
    if isinstance(v, torch.Tensor):
        return _Val(v, ctx.lods.get(name))
    return None


class _OpRec(object):
    """One op as the step ran it: ``ins``/``outs`` {slot: [_Val or None]},
    ``children`` the records of the ops its lowering ran (a sub-block's
    ops, the ``backward``'s forward segment)."""

    __slots__ = ('type', 'op', 'ins', 'outs', 'children')

    def __init__(self, op, ins):
        self.type = op.type
        self.op = op
        self.ins = ins
        self.outs = {}
        self.children = []

    def val(self, slot, i=0, outs=False):
        vals = (self.outs if outs else self.ins).get(slot) or ()
        return vals[i] if i < len(vals) else None

    def shape(self, slot, i=0, outs=False):
        v = self.val(slot, i, outs)
        return v.shape if v is not None else None

    def grad(self, *slots):
        return any(v is not None and v.grad
                   for s in slots for v in self.ins.get(s) or ())

    def io_bytes(self):
        return sum(v.nbytes for d in (self.ins, self.outs)
                   for vals in d.values() for v in vals if v is not None)

    def out_elems(self):
        return sum(int(np.prod(v.shape)) for vals in self.outs.values()
                   for v in vals if v is not None)


class _Recorder(object):
    """The op hook of a plan's first step: a tree of `_OpRec`."""

    def __init__(self):
        self.top = []
        self._stack = [self.top]

    def hook(self, ctx, op, thunk):
        rec = _OpRec(op, {s: [_val(ctx, n) for n in names]
                          for s, names in op.inputs.items()})
        self._stack[-1].append(rec)
        self._stack.append(rec.children)
        try:
            thunk()
        finally:
            self._stack.pop()
        rec.outs = {s: [_val(ctx, n) for n in names]
                    for s, names in op.outputs.items()}


# ---------------------------------------------------------------------------
# the cost rules (module docstring)


def _prod(shape):
    return int(np.prod(shape)) if shape else 1


def _amp_factor(rec):
    """2 where the op's product runs under an AMP mark (each gradient is
    two bf16 products), else 1."""
    return 2 if amp.compute_dtype(amp.op_policy(rec.op)) is not None else 1


def _mul(rec):
    x, y = rec.shape('X'), rec.shape('Y')
    xnc = int(rec.op.attr('x_num_col_dims', 1))
    ynk = int(rec.op.attr('y_num_col_dims', 1))
    p = 2 * _prod(x[:xnc]) * _prod(x[xnc:]) * _prod(y[ynk:])
    bwd = p * _amp_factor(rec) * (rec.grad('X') + rec.grad('Y'))
    return p, bwd


def _matmul(rec):
    x, y = list(rec.shape('X')), list(rec.shape('Y'))
    if len(x) == 1:
        x = [1] + x
    if len(y) == 1:
        y = y + [1]
    if rec.op.attr('transpose_X', False):
        x[-2], x[-1] = x[-1], x[-2]
    if rec.op.attr('transpose_Y', False):
        y[-2], y[-1] = y[-1], y[-2]
    lead = np.broadcast_shapes(tuple(x[:-2]), tuple(y[:-2]))
    p = 2 * _prod(lead) * x[-2] * x[-1] * y[-1]
    bwd = p * _amp_factor(rec) * (rec.grad('X') + rec.grad('Y'))
    return p, bwd


def _conv(rec):
    # torch.utils.flop_counter's conv_flop_count and conv_backward_flop:
    # the filter's gradient counts the input's full channels
    x, w = rec.shape('Input'), rec.shape('Filter')
    out = rec.shape('Output', outs=True)
    fwd = 2 * _prod(out) * _prod(w[1:])
    bwd = 0
    if rec.grad('Input'):
        bwd += fwd
    if rec.grad('Filter'):
        bwd += 2 * _prod(w[2:]) * _prod(out[2:]) * x[1] * x[0] * w[0]
    return fwd, bwd


def _flash(rec):
    q = rec.shape('Q')
    L, dh = q[-2], q[-1]
    p = 2 * _prod(q[:-2]) * L * L * dh
    bwd = 7 * p if rec.grad('Q', 'K', 'V') else 0
    return 2 * p, bwd


def _ffn(rec):
    x, w1, w2 = rec.shape('X'), rec.shape('W1'), rec.shape('W2')
    nfd = int(rec.op.attr('num_flatten_dims', len(x) - 1))
    n = _prod(x[:nfd])
    p = 2 * n * w1[0] * w1[1] + 2 * n * w2[0] * w2[1]
    bwd = 2 * p if rec.grad('X', 'W1', 'B1', 'W2', 'B2') else 0
    return p, bwd


def _lookup(rec):
    # ops/embedding_ops.py `_scatter_grad`: a small table's gradient is the
    # one-hot product [V, n] @ [n, D]
    from .ops.embedding_ops import _ONE_HOT_ROWS
    w = rec.shape('W')
    ids = rec.shape('Ids')
    if not rec.grad('W') or w[0] > _ONE_HOT_ROWS:
        return 0, 0
    n = _prod(ids[:-1]) if ids and ids[-1] == 1 else _prod(ids)
    return 0, 2 * w[0] * n * w[1]


def _kv_cached(rec, rows, m):
    dh = rec.shape('Q')[-1]
    return 2 * 2 * rows * m * dh, 0


def _kv_decode(rec):
    q, k = rec.shape('Q'), rec.shape('KCache')     # k [S, nL, H, M, dh]
    return _kv_cached(rec, q[0] * q[1], k[3])


def _paged_m(rec, table_slot):
    return rec.shape(table_slot)[-1] * rec.shape('KCache')[3]


def _kv_decode_paged(rec):
    q = rec.shape('Q')
    return _kv_cached(rec, q[0] * q[1], _paged_m(rec, 'BlockTables'))


def _kv_verify_paged(rec):
    q = rec.shape('Q')                             # [S, H, W, dh]
    return _kv_cached(rec, q[0] * q[1] * q[2], _paged_m(rec, 'BlockTables'))


def _kv_prefix(rec):
    q = rec.shape('Q')                             # [1, H, T, dh]
    return _kv_cached(rec, q[1] * q[2], _paged_m(rec, 'BlockTable'))


def _sequence_conv(rec):
    x, f = rec.shape('X'), rec.shape('Filter')
    p = 2 * x[0] * f[0] * f[1]
    return p, p * (rec.grad('X', 'PaddingData') + rec.grad('Filter'))


def _steps(rec, slot='Input'):
    """(sequences, longest) of a recurrence's ragged input."""
    lod = rec.val(slot).lod
    lens = np.diff(lod[-1]) if lod else [0]
    return len(lens), int(max(lens)) if len(lens) else 0


def _recurrence(rec, p_step, extra=0):
    """A recurrence's products: ``p_step`` (plus ``extra``, a projection)
    a step over the padded batch, forward; backward the weight's gradient
    every step and the hidden state's wherever autograd tracks it (after
    the first step, when anything upstream is tracked)."""
    n, t = _steps(rec)
    fwd = t * (p_step + extra)
    h_tracked = rec.grad('Input', 'Weight', 'Bias', 'ProjWeight', 'C0')
    h_steps = max(0, t - 1) + rec.grad('H0') if h_tracked else 0
    bwd = t * p_step * rec.grad('Weight') + h_steps * p_step
    if extra:
        bwd += t * extra * (rec.grad('ProjWeight') + h_tracked)
    return fwd, bwd


def _lstm(rec):
    n, _ = _steps(rec)
    w = rec.shape('Weight')                        # [D or P, 4D]
    extra = 0
    if rec.type == 'lstmp':
        pw = rec.shape('ProjWeight')
        extra = 2 * n * pw[0] * pw[1]
    return _recurrence(rec, 2 * n * w[0] * w[1], extra)


def _gru(rec):
    n, _ = _steps(rec)
    w = rec.shape('Weight')                        # [D, 3D]
    return _recurrence(rec, 2 * n * w[0] * w[1])


def _gru_unit(rec):
    h, w = rec.shape('HiddenPrev'), rec.shape('Weight')
    p = 2 * h[0] * w[0] * w[1]
    tracked = rec.grad('Input', 'HiddenPrev', 'Weight', 'Bias')
    return p, p * (rec.grad('Weight') + tracked)


def _bilinear(rec):
    # torch.einsum('nm,kmp,np->nk') contracts x with W, then with y
    x, w = rec.shape('X'), rec.shape('Weight')
    n, k, m, p = x[0], w[0], w[1], w[2]
    fwd = 2 * n * m * k * p + 2 * n * k * p
    return fwd, fwd * rec.grad('X', 'Y', 'Weight')


_PRODUCTS = {
    'mul': _mul, 'matmul': _matmul, 'conv2d': _conv,
    'depthwise_conv2d': _conv, 'flash_attention': _flash,
    'fused_ffn_tail': _ffn, 'lookup_table': _lookup,
    'fused_embedding_gather': _lookup,
    'kv_decode_attention': _kv_decode,
    'kv_decode_attention_paged': _kv_decode_paged,
    'kv_verify_attention_paged': _kv_verify_paged,
    'kv_prefix_attention': _kv_prefix, 'sequence_conv': _sequence_conv,
    'lstm': _lstm, 'lstmp': _lstm, 'gru': _gru, 'gru_unit': _gru_unit,
    'bilinear_tensor_product': _bilinear,
}

# ops whose every output element takes one transcendental
_TRANSCENDENTAL = frozenset((
    'exp', 'log', 'tanh', 'sigmoid', 'gelu', 'erf', 'softmax',
    'sequence_softmax', 'logsigmoid', 'softplus', 'swish', 'elu', 'selu',
    'sqrt', 'rsqrt', 'pow', 'sin', 'cos', 'hard_swish', 'tanh_shrink'))

# layout ops that move no data
_VIEWS = frozenset(('reshape', 'reshape2', 'squeeze', 'squeeze2',
                    'unsqueeze', 'unsqueeze2', 'flatten', 'flatten2'))


def _transcendentals(rec):
    t = rec.type
    if t in _TRANSCENDENTAL:
        return rec.out_elems()
    if t == 'flash_attention':
        q = rec.shape('Q')
        return _prod(q[:-2]) * q[-2] * q[-2]
    if t == 'fused_ffn_tail':
        x, w1 = rec.shape('X'), rec.shape('W1')
        nfd = int(rec.op.attr('num_flatten_dims', len(x) - 1))
        return _prod(x[:nfd]) * w1[1]
    if t in ('layer_norm', 'fused_ln_residual'):
        x = rec.shape('X')
        return _prod(x[:int(rec.op.attr('begin_norm_axis', 1))])
    if t in ('softmax_with_cross_entropy', 'cross_entropy'):
        return _prod(rec.shape('Logits') or rec.shape('X'))
    return 0


class _Cost(object):
    __slots__ = ('flops', 'products', 'transcendentals', 'bytes')

    def __init__(self):
        self.flops = self.products = self.transcendentals = self.bytes = 0

    def add(self, flops=0, products=0, trans=0, nbytes=0):
        self.flops += flops
        self.products += products
        self.transcendentals += trans
        self.bytes += nbytes


def _own(rec):
    """(products, elementwise flops, transcendentals, bytes) of one op's
    forward, without the ops its lowering ran."""
    rule = _PRODUCTS.get(rec.type)
    if rule is not None:
        fwd, _ = rule(rec)
        return fwd, 0, _transcendentals(rec), rec.io_bytes()
    if rec.children or rec.type == 'backward' or rec.type in _VIEWS:
        return 0, 0, 0, 0
    return 0, rec.out_elems(), _transcendentals(rec), rec.io_bytes()


def _forward(rec, cost):
    prods, elem, trans, nbytes = _own(rec)
    cost.add(prods + elem, prods, trans, nbytes)
    if rec.type == 'backward':
        for c in rec.children:
            _forward(c, cost)
            _backward(c, cost)
    else:
        for c in rec.children:
            _forward(c, cost)


def _backward(rec, cost):
    """What the ``backward`` meta-op adds for one op of its segment."""
    rule = _PRODUCTS.get(rec.type)
    if rule is not None:
        _, bwd = rule(rec)
        cost.add(bwd, bwd, _transcendentals(rec), rec.io_bytes())
    else:
        _, elem, trans, nbytes = _own(rec)
        cost.add(elem, 0, trans, nbytes)
    for c in rec.children:
        _backward(c, cost)


def _count(op_records):
    """The cost of one step's op records: a `_Cost` (flops, of which
    products, transcendentals, bytes)."""
    cost = _Cost()
    for rec in op_records:
        _forward(rec, cost)
    return cost


# ---------------------------------------------------------------------------
# the registry


class ProgramAnalytics(object):
    """One plan's analytics record. The cost fields are counted on first
    read from the op records of the plan's first step; ``peak_bytes`` is
    that step's rise of the card's peak allocation over what was allocated
    before it, where the step set a new peak (else None, and None on the
    CPU). The
    JAX record's XLA memory fields (argument/output/temp/alias/generated
    code bytes) have no counterpart beyond ``argument_bytes`` (the feed's
    and state's bytes) and stay None."""

    __slots__ = ('fingerprint', 'kind', 'steps', 'donate', 'feed_batch',
                 'op_count', 'ops', 'flops', 'product_flops',
                 'transcendentals', 'bytes_accessed', 'argument_bytes',
                 'output_bytes', 'temp_bytes', 'alias_bytes', 'peak_bytes',
                 'generated_code_bytes', '_records', 'created_ts')

    def __init__(self, fingerprint, kind, program, op_records, feed,
                 argument_bytes, peak_bytes, steps=1):
        self.fingerprint = fingerprint
        self.kind = kind                # 'run' | 'bound' | 'fused'
        self.steps = steps
        self.donate = False
        self.feed_batch = None
        for v in feed.values():
            if getattr(v, 'dim', lambda: 0)():
                self.feed_batch = int(v.shape[0])
                break
        self.op_count = sum(len(b.ops) for b in program.blocks)
        self.ops = _op_counts(program)
        self.flops = None
        self.product_flops = None
        self.transcendentals = None
        self.bytes_accessed = None
        self.argument_bytes = int(argument_bytes)
        self.output_bytes = None
        self.temp_bytes = None
        self.alias_bytes = None
        self.peak_bytes = peak_bytes
        self.generated_code_bytes = None
        self._records = op_records
        self.created_ts = time.time()

    def materialize_cost(self):
        if self._records is None:
            return self
        try:
            cost = _count(self._records)
            self.flops = float(cost.flops)
            self.product_flops = float(cost.products)
            self.transcendentals = float(cost.transcendentals)
            self.bytes_accessed = float(cost.bytes)
        except Exception as e:          # noqa: BLE001 — advisory data only
            logger.warning("counting the cost of %s failed: %s",
                           self.fingerprint[:16], e)
            self.flops = self.product_flops = 0.0
            self.bytes_accessed = self.transcendentals = 0.0
            monitor.inc('analysis_error_total', labels={'stage': 'cost'})
        self._records = None
        self._export_gauges()
        return self

    def _export_gauges(self):
        labels = {'fingerprint': self.fingerprint[:_FP_LABEL_LEN],
                  'kind': self.kind}
        if self.flops is not None:
            monitor.set_gauge('program_flops', self.flops, labels=labels)
            monitor.set_gauge('program_bytes_accessed', self.bytes_accessed,
                              labels=labels)
        if self.peak_bytes is not None:
            monitor.set_gauge('program_peak_bytes', self.peak_bytes,
                              labels=labels)

    def as_dict(self):
        self.materialize_cost()
        return {
            'fingerprint': self.fingerprint,
            'kind': self.kind,
            'steps': self.steps,
            'donate': self.donate,
            'feed_batch': self.feed_batch,
            'op_count': self.op_count,
            'ops': dict(self.ops),
            'flops': self.flops,
            'product_flops': self.product_flops,
            'transcendentals': self.transcendentals,
            'bytes_accessed': self.bytes_accessed,
            'argument_bytes': self.argument_bytes,
            'output_bytes': self.output_bytes,
            'temp_bytes': self.temp_bytes,
            'alias_bytes': self.alias_bytes,
            'peak_bytes': self.peak_bytes,
            'generated_code_bytes': self.generated_code_bytes,
        }


_reg_lock = threading.RLock()
_registry = collections.OrderedDict()   # (fingerprint, kind, sig) -> rec
_pending = []                           # records whose cost is not counted


def _registry_cap():
    try:
        return max(1, int(os.environ.get('PADDLE_ANALYSIS_CAP', '128')))
    except ValueError:
        return 128


def _sig(feed):
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in feed.items()))


def _bytes(values):
    return sum(int(v.numel()) * v.element_size() for v in values
               if isinstance(v, torch.Tensor))


def record_compiled(program, op_records, feed, state, kind='run',
                    peak_bytes=None, steps=1):
    """Executor hook: register a plan's first step (its op records, from
    :func:`recording`). Cheap: the cost is counted at first read. A plan
    of a key registered before (the same program on another executor or
    scope) replaces its record: its first step measured the peak anew,
    and its gauges export again at the next read. Never raises into the
    run path."""
    if not _analytics_enabled():
        return None
    try:
        fp = program._fingerprint()
        key = (fp, kind, _sig(feed))
        with _reg_lock:
            _registry.pop(key, None)
            rec = ProgramAnalytics(
                fp, kind, program, op_records, feed,
                _bytes(feed.values()) + _bytes(state.values()), peak_bytes,
                steps)
            _registry[key] = rec
            while len(_registry) > _registry_cap():
                _registry.popitem(last=False)
            _pending.append(rec)
        return rec
    except Exception as e:              # noqa: BLE001 — must not break runs
        logger.warning("analytics registration failed: %s", e)
        return None


@contextlib.contextmanager
def recording(program, kind, feed, state, device, steps=1):
    """Around a plan's first step: record its ops (core/lowering.py
    `op_hook`) and, on the card, its peak allocation over the base where
    it set a new peak (module docstring), then register it
    (:func:`record_compiled`). A no-op with analytics off."""
    if not _analytics_enabled():
        yield
        return
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        peak0 = torch.cuda.max_memory_allocated(device)
    rec = _Recorder()
    with lowering.op_hook(rec.hook):
        yield
    peak = None
    if cuda:
        torch.cuda.synchronize(device)
        top = torch.cuda.max_memory_allocated(device)
        if top > peak0:
            peak = top - base
    record_compiled(program, rec.top, feed, state, kind, peak, steps)


def flush_pending():
    """Count the cost of every record registered since the last flush
    (the monitor's snapshot and export call this through the pre-snapshot
    hook, so the gauges exist whenever anyone looks)."""
    with _reg_lock:
        todo, _pending[:] = _pending[:], []
    for rec in todo:
        rec.materialize_cost()


monitor.add_presnapshot_hook(flush_pending)


def records():
    """All registered analytics records (cost counted), newest last."""
    with _reg_lock:
        recs = list(_registry.values())
    return [r.materialize_cost() for r in recs]


def lookup(program_or_fp, kind=None):
    """Newest analytics record for a program (or fingerprint string), or
    None."""
    fp = program_or_fp if isinstance(program_or_fp, str) \
        else program_or_fp._fingerprint()
    with _reg_lock:
        match = [r for (f, k, _), r in _registry.items()
                 if f == fp and (kind is None or k == kind)]
    if not match:
        return None
    return match[-1].materialize_cost()


def memory_usage_bytes(program):
    """The peak-memory rise of ``program``'s first step on the card in
    BYTES, or None (no step registered yet, or the CPU)."""
    rec = lookup(program)
    return None if rec is None else rec.peak_bytes


def reset():
    """Drop every record (test isolation)."""
    with _reg_lock:
        _registry.clear()
        _pending[:] = []


# ---------------------------------------------------------------------------
# op-level attribution profiling

_profile_lock = threading.Lock()
_profile_tls = threading.local()        # profile_ops() nesting, per thread
_op_table = {}                          # op type -> stats dict
_profile_meta = {'runs': 0, 'wall_s': 0.0}


def profile_ops_active():
    """Is op-attribution mode on (PADDLE_PROFILE_OPS=1 or an open
    profiler.profile_ops() context)? Checked once per Executor.run. The
    context is THREAD-local; the env var is the whole-process switch."""
    return getattr(_profile_tls, 'depth', 0) > 0 \
        or _env_on('PADDLE_PROFILE_OPS')


def push_profiling():
    _profile_tls.depth = getattr(_profile_tls, 'depth', 0) + 1


def pop_profiling():
    _profile_tls.depth = max(0, getattr(_profile_tls, 'depth', 0) - 1)


def reset_op_profile():
    with _profile_lock:
        _op_table.clear()
        _profile_meta.update(runs=0, wall_s=0.0)


def _record_op(op_type, dur_s, out_bytes):
    with _profile_lock:
        row = _op_table.get(op_type)
        if row is None:
            row = _op_table[op_type] = {
                'calls': 0, 'total_s': 0.0, 'min_s': float('inf'),
                'max_s': 0.0, 'out_bytes': 0}
        row['calls'] += 1
        row['total_s'] += dur_s
        row['min_s'] = min(row['min_s'], dur_s)
        row['max_s'] = max(row['max_s'], dur_s)
        row['out_bytes'] += out_bytes


def op_profile():
    """Attribution table: {'ops': [rows sorted by total time desc],
    'runs', 'wall_s', 'accounted_s'}. Each row: op type, calls,
    total/min/max/avg seconds, output bytes, ratio of accounted time."""
    with _profile_lock:
        rows = [dict(r, type=t) for t, r in _op_table.items()]
        meta = dict(_profile_meta)
    rows.sort(key=lambda r: -r['total_s'])
    accounted = sum(r['total_s'] for r in rows)
    for r in rows:
        r['avg_s'] = r['total_s'] / r['calls']
        r['ratio'] = r['total_s'] / accounted if accounted else 0.0
    return {'ops': rows, 'runs': meta['runs'], 'wall_s': meta['wall_s'],
            'accounted_s': accounted}


def format_op_profile(profile=None):
    """Fluid-style sorted attribution table (profiler.cc PrintProfiler)."""
    p = profile or op_profile()
    lines = [
        '------------------------->  Op Profiling Report  '
        '<-------------------------',
        'runs: %d   wall: %.3f ms   accounted: %.3f ms (%.0f%%)'
        % (p['runs'], p['wall_s'] * 1e3, p['accounted_s'] * 1e3,
           100.0 * p['accounted_s'] / p['wall_s'] if p['wall_s'] else 0.0),
        '%-24s %8s %12s %12s %12s %12s %7s' % (
            'Event', 'Calls', 'Total(ms)', 'Min(ms)', 'Max(ms)', 'Ave(ms)',
            'Ratio'),
    ]
    for r in p['ops']:
        lines.append('%-24s %8d %12.3f %12.3f %12.3f %12.3f %6.1f%%' % (
            r['type'], r['calls'], r['total_s'] * 1e3, r['min_s'] * 1e3,
            r['max_s'] * 1e3, r['avg_s'] * 1e3, r['ratio'] * 100.0))
    return '\n'.join(lines)


_hook_tls = threading.local()


def _timing_hook(ctx, op, thunk):
    """Per-op timing with EXCLUSIVE (self) time: ops lowered inside
    another hooked op — a sub-block's ops, the forward segment under the
    ``backward`` — subtract from their parent, so the table's total equals
    wall time. On the card each op synchronizes before its clock stops."""
    stack = getattr(_hook_tls, 'stack', None)
    if stack is None:
        stack = _hook_tls.stack = []
    cuda = ctx.device.type == 'cuda'
    with monitor.span('op:%s' % op.type):
        t0 = time.perf_counter()
        stack.append(0.0)               # accumulates child op time
        try:
            thunk()
            if cuda:
                torch.cuda.synchronize(ctx.device)
        finally:
            child_s = stack.pop()
            dur = time.perf_counter() - t0
            if stack:
                stack[-1] += dur
    out_bytes = 0
    for n in op.output_arg_names:
        v = _val(ctx, n)
        if v is not None:
            out_bytes += v.nbytes
    _record_op(op.type, max(0.0, dur - child_s), out_bytes)


def run_profiled(executor, program, feed, fetch_list, scope, return_numpy):
    """``Executor.run`` under op attribution: a fresh plan (nothing is
    cached), run eagerly with the per-op timing hook installed; the run
    counts and seeds as ``run()`` does, and its results are ``run()``'s."""
    monitor.inc('op_profile_run_total')
    t0 = time.perf_counter()
    with monitor.span('profile_ops'):
        out = executor._run_impl(program, feed, fetch_list, scope,
                                 return_numpy, use_program_cache=False,
                                 hook=_timing_hook)
        if executor.device.type == 'cuda':
            torch.cuda.synchronize(executor.device)
    wall = time.perf_counter() - t0
    with _profile_lock:
        _profile_meta['runs'] += 1
        _profile_meta['wall_s'] += wall
    return out


# ---------------------------------------------------------------------------
# NaN provenance


def nan_localization_enabled():
    return _env_on('PADDLE_NAN_LOCALIZE')


class _LocalizedNonFinite(Exception):
    def __init__(self, info):
        Exception.__init__(self, info['op_type'])
        self.info = info


def _host_values(v):
    if isinstance(v, SelectedRows):
        v = v.values
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.detach().to('cpu').numpy()
    return np.asarray(v)


def _value_stats(v):
    try:
        arr = _host_values(v)
    except Exception:                   # noqa: BLE001 — diagnostics only
        return {'repr': type(v).__name__}
    out = {'shape': list(arr.shape), 'dtype': str(arr.dtype)}
    if arr.size and arr.dtype.kind == 'f':
        finite = np.isfinite(arr)
        out['finite_frac'] = round(float(finite.mean()), 6)
        if finite.any():
            fa = arr[finite]
            out['min'] = float(fa.min())
            out['max'] = float(fa.max())
            out['absmean'] = float(np.abs(fa).mean())
    return out


def _nonfinite(v):
    if isinstance(v, SelectedRows):
        v = v.values
    return isinstance(v, torch.Tensor) and v.is_floating_point() and \
        not bool(torch.isfinite(v).all())


def _check_hook(ctx, op, thunk):
    """The localizing op hook: after each op, a host check of its outputs;
    the first op with a non-finite one stops the replay. The ``backward``
    meta-op's thunk runs its forward segment (each op of which calls this
    hook in turn), so its own index is taken before."""
    idx = ctx.op_index
    thunk()
    bad = [n for n in op.output_arg_names if _nonfinite(ctx.env.get(n))]
    if bad:
        inputs = {n: _value_stats(ctx.env[n])
                  for n in op.input_arg_names if ctx.has(n)}
        outputs = {n: _value_stats(ctx.env[n]) for n in bad}
        raise _LocalizedNonFinite({
            'op_type': op.type, 'op_index': idx,
            'bad_outputs': bad, 'output_stats': outputs,
            'input_stats': inputs})


def _localize_core(program, feed, state, run_seed, device, static_lods,
                   static_feed):
    """Replay one step op by op against its pre-run inputs, on copies of
    the state it writes (the optimizers write in place: the state handed
    in, a rolled-back scope's own tensors, stays bitwise as it was); return
    the info dict of the FIRST op producing a non-finite output, or None
    when the replay comes back clean."""
    gb = program.global_block()
    ops = gb.ops
    b = next((i for i, op in enumerate(ops) if op.type == 'backward'), None)
    _, written = lowering.analyze_state(program, [])
    fn, plan = lowering.build_fn(program, [], list(state), written, device,
                                 static_lods=static_lods,
                                 static_feed=static_feed)
    written = set(written)

    def _inputs():
        st = {n: v.clone() if n in written and isinstance(v, torch.Tensor)
              else v for n, v in state.items()}
        rng = lowering.RunRNG(plan, device)
        rng.seed(0 if run_seed is None else int(run_seed))
        return st, rng

    # Pass A, the forward scout: the ops before the first `backward`, run
    # as the step ran them (the same draws, in op order), name a forward
    # culprit before any gradient exists
    scout_hi = b if b is not None else len(ops)
    if scout_hi:
        st, rng = _inputs()
        env = dict(feed)
        env.update(st)
        ctx = lowering.LowerContext(program, gb, env, device, rng=rng,
                                    plan=plan, lods=dict(static_lods or {}),
                                    statics=dict(static_feed or {}))
        try:
            with torch.no_grad(), lowering.op_hook(_check_hook):
                lowering.lower_ops(ctx, ops, 0, scout_hi)
        except _LocalizedNonFinite as e:
            return e.info
    if b is None:
        return None
    # Pass B, the full replay: the forward is finite, so the culprit is
    # the backward (non-finite gradients name `backward`) or an op after
    # it (the optimizer update)
    st, rng = _inputs()
    try:
        with lowering.op_hook(_check_hook):
            fn(feed, st, rng)
    except _LocalizedNonFinite as e:
        return e.info
    return None


def localize_nonfinite(program, feed, state, run_seed, device,
                       static_lods=None, static_feed=None):
    """Opt-in NaN/Inf localization (``PADDLE_NAN_LOCALIZE=1``): replay the
    step of ``program`` on ``feed`` ({name: tensor on ``device``}) from
    its pre-run ``state`` ({name: tensor}: every persistable it reads)
    with the run's seed, op by op, and return the info dict of the first
    op with a non-finite output ({'op_type', 'op_index', 'bad_outputs',
    'output_stats', 'input_stats'}), or None. Never raises: a broken
    replay must not mask the original non-finite error. Counts
    ``nonfinite_localized_total{op_type}``."""
    if not nan_localization_enabled():
        return None
    try:
        with monitor.timed_span('nan_localize', 'nan_localize_seconds'):
            info = _localize_core(program, feed, state, run_seed, device,
                                  static_lods, static_feed)
    except Exception as e:              # noqa: BLE001 — diagnostics only
        logger.warning("NaN localization replay failed: %s", e)
        monitor.inc('analysis_error_total', labels={'stage': 'localize'})
        return None
    if info is not None:
        monitor.inc('nonfinite_localized_total',
                    labels={'op_type': info['op_type']})
        logger.error(
            "non-finite value localized to op #%d (%s): outputs %s; "
            "input stats: %s", info['op_index'], info['op_type'],
            info['bad_outputs'], info['input_stats'])
    return info


def localize_from_scope(executor, program, feed, scope, run_seed):
    """TrainingGuard's (and the replay CLI's) entry point: localize against
    a ROLLED-BACK scope (the pre-step state) with the failed step's run
    seed (``program._last_run_seed``). The scope's values stay as they
    are (a numpy value becomes its tensor on the executor's device, as a
    run reads it). Returns the culprit info dict or None."""
    if not nan_localization_enabled():
        return None
    try:
        tfeed, lods = executor._prepare_feed(program, feed or {})
        read, written = lowering.analyze_state(program, [])
        needed = executor._read_before_write(program, read, written,
                                             set(tfeed), [])
        state = {n: executor._state_value(scope, n, program)
                 for n in needed}
        static_lods = executor._static_lods(scope, lods)
        statics = executor._statics(program, tfeed)
    except Exception as e:              # noqa: BLE001 — diagnostics only
        logger.warning("NaN localization setup failed: %s", e)
        return None
    return localize_nonfinite(program, tfeed, state, run_seed,
                              executor.device, static_lods, statics)


def format_localization(info):
    """One-line human rendering of a localize_nonfinite() result."""
    if not info:
        return 'no op localized (replay was finite)'
    return ('first non-finite output produced by op #%d type=%r '
            'outputs=%s inputs=%s'
            % (info['op_index'], info['op_type'], info['bad_outputs'],
               sorted(info['input_stats'])))
