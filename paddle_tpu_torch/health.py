"""Training-health observatory: in-program gradient/activation telemetry.

The port's own copy of paddle_tpu/health.py, over the port's monitor,
trace and blackbox. The rest of the observability tier watches the
machine; this module watches the model. When enabled (``PADDLE_HEALTH=1``
or ``TrainingGuard(health=...)``), :func:`instrument` appends to an
already-built training program pre-update copies of each parameter
(``assign`` ops right after the ``backward`` op: core/lowering.py makes
an ``assign`` whose output the optimizer would update in place a copy)
and one ``health_stats`` op (ops/health_ops.py) whose float32 vector
``__health_stats__`` carries per-parameter grad L2 norms, update/param
ratios, activation RMS at the tapped sites (``build_lm``'s block
outputs, recorded as ``program._health_act_taps``), the global grad and
param norms, the non-finite and large gradient counts and the loss. It
rides the step's own fetch: no extra dispatch, and under ``bind`` or
``run_fused`` it is part of the one captured graph. The program dict
equals the JAX package's.

Host side, :func:`observe` decodes the vector and runs the detector bank
(a frozen baseline and an EWMA, the goodput.py idiom) that trips
``health_anomaly_total{kind}``:

==================  ====================================================
kind                condition (after the baseline freezes)
==================  ====================================================
grad_explosion      global grad norm > baseline * PADDLE_HEALTH_EXPLODE
grad_vanish         grad-norm EWMA < baseline * PADDLE_HEALTH_VANISH
loss_spike          loss > baseline * PADDLE_HEALTH_LOSS_SPIKE
update_ratio_drift  update/param EWMA outside baseline */÷ RATIO_DRIFT
nonfinite_rate      any non-finite grad entries this step (no baseline)
==================  ====================================================

Each trip publishes an always-kept trace event (``health_anomaly``) and a
``training_anomaly`` flight-recorder bundle with the per-layer stat
table and the last-N-step history ring. ``TrainingGuard(health=
'preempt')`` also rolls the step back on a confirmed ``grad_explosion``
or ``loss_spike`` (resilience.py).

Memory: the update ratios need the pre-update copies, so an instrumented
step holds one more copy of each tracked parameter while it runs.
"""
import collections
import os
import threading
import time

import numpy as np

from . import monitor
from . import trace as trace_mod

__all__ = ['enabled', 'instrument', 'fetch_name', 'observe', 'stats',
           'anomalies', 'reset', 'FETCH_NAME', 'DETECTOR_KINDS']

FETCH_NAME = '__health_stats__'

# detector kinds (the health_anomaly_total{kind} label values)
DETECTOR_KINDS = ('grad_explosion', 'grad_vanish', 'loss_spike',
                  'update_ratio_drift', 'nonfinite_rate')

# kinds a preemptive TrainingGuard rolls back on (confirmed divergence —
# the drift/vanish kinds are advisory, not rollback triggers)
PREEMPT_KINDS = ('grad_explosion', 'loss_spike')

_lock = threading.RLock()
_state = {}           # program uid -> detector/history state
_trip_last = {}       # cooldown bookkeeping, keyed by (kind,)
_sentinel_trace = [None]

# enabled(): one env read per call, cached on the raw string (goodput idiom)
_on_cache = ['\0', False]


def enabled():
    raw = os.environ.get('PADDLE_HEALTH', '')
    if raw != _on_cache[0]:
        _on_cache[0] = raw
        _on_cache[1] = raw not in ('', '0', 'false', 'False')
    return _on_cache[1]


_CFG_KEYS = ('PADDLE_HEALTH_EWMA', 'PADDLE_HEALTH_MIN_SAMPLES',
             'PADDLE_HEALTH_COOLDOWN_S', 'PADDLE_HEALTH_EXPLODE',
             'PADDLE_HEALTH_VANISH', 'PADDLE_HEALTH_LOSS_SPIKE',
             'PADDLE_HEALTH_RATIO_DRIFT', 'PADDLE_HEALTH_HISTORY',
             'PADDLE_HEALTH_MAX_PARAM_GAUGES', 'PADDLE_HEALTH_LARGE')
_cfg_cache = [None, None]


def _cfg():
    raw = tuple(os.environ.get(k) for k in _CFG_KEYS)
    if raw != _cfg_cache[0]:
        def _f(v, d):
            try:
                return float(v)
            except (TypeError, ValueError):
                return d
        _cfg_cache[0] = raw
        _cfg_cache[1] = {
            'ewma': _f(raw[0], 0.2),
            'min_samples': int(_f(raw[1], 8)),
            'cooldown_s': _f(raw[2], 30.0),
            'explode': _f(raw[3], 8.0),
            'vanish': _f(raw[4], 0.05),
            'loss_spike': _f(raw[5], 3.0),
            'ratio_drift': _f(raw[6], 10.0),
            'history': int(_f(raw[7], 64)),
            'max_param_gauges': int(_f(raw[8], 16)),
            'large': _f(raw[9], 1e3),
        }
    return _cfg_cache[1]


# ---------------------------------------------------------------------------
# program instrumentation (build-time surgery)


def note_params_grads(program, params_grads):
    """Optimizer hook (``Optimizer.apply_gradients``): record the FINAL
    (post-clip/regularization) param/grad names so :func:`instrument`
    harvests the gradients the update actually consumes. Unconditional
    and O(n) name copies — the hot path is program BUILD, not dispatch."""
    program._health_params = [(p.name, g.name) for p, g in params_grads]


def fetch_name(program):
    """The extra fetch to ride on the step dispatch, or None when the
    program is not instrumented. This is the per-step hot-path entry:
    one getattr when health is off."""
    sch = getattr(program, '_health_schema', None)
    return sch['fetch'] if sch is not None else None


def instrument(program, loss_name=None):
    """Append the health-stat harvesting to a BUILT training program
    (idempotent). Inserts pre-update parameter copies right after the
    backward op (so update/param ratios are computable for any
    optimizer, fused or per-param) and appends one ``health_stats`` op
    whose single float32 output vector carries every stat; the decode
    schema is stashed on the program. Returns the schema dict."""
    sch = getattr(program, '_health_schema', None)
    if sch is not None:
        return sch
    block = program.global_block()
    bwd_idx = None
    for i, op in enumerate(block.ops):
        if op.type == 'backward':
            bwd_idx = i
    if bwd_idx is None:
        raise ValueError(
            'health.instrument: program has no backward op — build the '
            'training program (optimizer.minimize) before instrumenting')
    pairs = getattr(program, '_health_params', None)
    if pairs is None:
        # program built without the optimizer hook (manual append_backward
        # + hand-rolled update): harvest the backward op's own param/grad
        # names instead
        bwd = block.ops[bwd_idx]
        pairs = list(zip(bwd.attr('wrt_names', []), bwd.output('Grads')))
    if loss_name is None:
        loss_name = block.ops[bwd_idx].input('Loss')[0]
    if loss_name is not None and not block.has_var(loss_name):
        loss_name = None
    taps = tuple(n for n in getattr(program, '_health_act_taps', ())
                 if block.has_var(n))

    pre_names = []
    with program._role_guard('Optimize'):
        # pre-update copies, inserted immediately after the backward op:
        # params are still pre-step there, and the Optimize role keeps
        # clone(for_test)/inference export free of them
        at = bwd_idx + 1
        for pname, _g in pairs:
            pvar = block.var(pname)
            pre = block.create_var(
                name=pname + '@health_pre', shape=pvar.shape,
                dtype=pvar.dtype, persistable=False, stop_gradient=True)
            block._insert_op(at, type='assign', inputs={'X': [pname]},
                             outputs={'Out': [pre.name]})
            at += 1
            pre_names.append(pre.name)

        entries = []
        for pname, _g in pairs:
            entries.append(('grad_norm', pname))
        for pname, _g in pairs:
            entries.append(('upd_ratio', pname))
        for t in taps:
            entries.append(('act_rms', t))
        entries.append(('grad_norm_global', ''))
        entries.append(('param_norm_global', ''))
        entries.append(('nonfinite', ''))
        entries.append(('large', ''))
        if loss_name:
            entries.append(('loss', ''))

        block.create_var(name=FETCH_NAME, shape=(len(entries),),
                         dtype='float32', persistable=False,
                         stop_gradient=True)
        block.append_op(
            type='health_stats',
            inputs={'Grads': [g for _p, g in pairs],
                    'Params': [p for p, _g in pairs],
                    'Pre': pre_names,
                    'Acts': list(taps),
                    'Loss': [loss_name] if loss_name else []},
            outputs={'Out': [FETCH_NAME]},
            attrs={'large': _cfg()['large']})

    sch = {'fetch': FETCH_NAME, 'entries': entries,
           'params': [p for p, _g in pairs], 'acts': list(taps),
           'loss': loss_name}
    program._health_schema = sch
    return sch


# ---------------------------------------------------------------------------
# host-side detector bank


def _st(program, cfg):
    s = _state.get(program._uid)
    if s is None:
        s = _state[program._uid] = {
            'step': 0,
            'streams': {},
            'history': collections.deque(maxlen=max(1, cfg['history'])),
            'last': {},
            'anomalies': collections.deque(maxlen=64),
        }
    return s


def _feed_stream(st, key, x, cfg):
    """Frozen-baseline EWMA stream (the goodput.py idiom): the first
    ``min_samples`` readings freeze the baseline; the EWMA keeps moving."""
    s = st['streams'].get(key)
    if s is None:
        s = st['streams'][key] = {'n': 0, 'bsum': 0.0, 'base': 0.0,
                                  'ewma': float(x)}
    a = cfg['ewma']
    s['ewma'] = a * float(x) + (1.0 - a) * s['ewma']
    s['n'] += 1
    if s['n'] <= cfg['min_samples']:
        s['bsum'] += float(x)
        if s['n'] == cfg['min_samples']:
            s['base'] = s['bsum'] / cfg['min_samples']
    return s


def _cooldown_ok(key, cfg):
    now = time.perf_counter()
    last = _trip_last.get(key)
    if last is not None and now - last < cfg['cooldown_s']:
        return False
    _trip_last[key] = now
    return True


def _trip(kind, st, **fields):
    """One confirmed anomaly: counter + always-kept trace event + the
    ``training_anomaly`` flight-recorder bundle (per-layer table + the
    history ring). Callers hold _lock and have passed the cooldown."""
    monitor.inc('health_anomaly_total', labels={'kind': kind})
    rec = {'kind': kind, 'ts': time.time()}
    rec.update(fields)
    st['anomalies'].append(rec)
    tr = _sentinel_trace[0]
    if tr is None:
        # sampled=False: the trace writes no record of its own; its
        # EVENTS always land in the trace log (keep-errors channel)
        tr = _sentinel_trace[0] = trace_mod.start('health',
                                                  name='healthwatch',
                                                  sampled=False)
    try:
        tr.event('health_anomaly', **fields, anomaly=kind)
    except Exception:           # noqa: BLE001 — telemetry only
        monitor.inc('trace_log_write_errors')
    try:
        from . import blackbox
        blackbox.record('training_anomaly', anomaly=kind,
                        table=dict(st['last']),
                        history=[dict(h) for h in st['history']],
                        **fields)
    except Exception:           # noqa: BLE001 — telemetry only
        monitor.inc('blackbox_write_errors_total')


def observe(program, value, step=None):
    """Decode one fetched ``__health_stats__`` vector, publish gauges,
    update the history ring, and run the detector bank. Returns the
    tuple of kinds DETECTED this step (cooldown-independent — the
    preemptive guard needs every verdict; the counter/trace/bundle side
    effects respect the per-kind cooldown)."""
    sch = getattr(program, '_health_schema', None)
    if sch is None or value is None:
        return ()
    if hasattr(value, 'detach'):        # a fetch left on the device
        value = value.detach().double().cpu().numpy()
    vec = np.asarray(value, dtype=np.float64).reshape(-1)
    entries = sch['entries']
    if vec.size != len(entries):
        return ()
    with _lock:
        cfg = _cfg()
        st = _st(program, cfg)
        st['step'] += 1
        n = st['step'] if step is None else int(step)

        table = {}
        ratios = []
        g = {'grad_norm_global': 0.0, 'param_norm_global': 0.0,
             'nonfinite': 0.0, 'large': 0.0, 'loss': None}
        pg = 0
        ag = 0
        for (kind, label), x in zip(entries, vec):
            x = float(x)
            table[kind + ':' + label if label else kind] = x
            if kind == 'grad_norm':
                if pg < cfg['max_param_gauges']:
                    monitor.set_gauge('health_grad_norm', x,
                                      labels={'param': label})
                    pg += 1
            elif kind == 'upd_ratio':
                if np.isfinite(x):
                    ratios.append(x)
            elif kind == 'act_rms':
                if ag < cfg['max_param_gauges']:
                    monitor.set_gauge('health_act_rms', x,
                                      labels={'site': label})
                    ag += 1
            elif kind in g:
                g[kind] = x
        st['last'] = table
        ratio = float(np.mean(ratios)) if ratios else None

        monitor.set_gauge('health_grad_norm_global', g['grad_norm_global'])
        monitor.set_gauge('health_param_norm_global',
                          g['param_norm_global'])
        if ratio is not None:
            monitor.set_gauge('health_update_ratio', ratio)
        if g['loss'] is not None:
            monitor.set_gauge('health_loss', g['loss'])

        hist = {'step': n, 'grad_norm_global': g['grad_norm_global'],
                'param_norm_global': g['param_norm_global'],
                'nonfinite': g['nonfinite'], 'large': g['large']}
        if ratio is not None:
            hist['update_ratio'] = ratio
        if g['loss'] is not None:
            hist['loss'] = g['loss']
        st['history'].append(hist)

        detected = []

        if g['nonfinite'] > 0 or not np.isfinite(g['grad_norm_global']):
            detected.append('nonfinite_rate')
            if _cooldown_ok(('nonfinite_rate',), cfg):
                _trip('nonfinite_rate', st, step=n,
                      count=g['nonfinite'])

        gn = g['grad_norm_global']
        if np.isfinite(gn):
            s = _feed_stream(st, 'grad', gn, cfg)
            if s['base'] > 0:
                if gn > s['base'] * cfg['explode']:
                    detected.append('grad_explosion')
                    if _cooldown_ok(('grad_explosion',), cfg):
                        _trip('grad_explosion', st, step=n,
                              value=round(gn, 6),
                              baseline=round(s['base'], 6))
                if s['ewma'] < s['base'] * cfg['vanish']:
                    detected.append('grad_vanish')
                    if _cooldown_ok(('grad_vanish',), cfg):
                        _trip('grad_vanish', st, step=n,
                              ewma=round(s['ewma'], 9),
                              baseline=round(s['base'], 6))

        loss = g['loss']
        if loss is not None and np.isfinite(loss):
            s = _feed_stream(st, 'loss', loss, cfg)
            if s['base'] > 0 and loss > s['base'] * cfg['loss_spike']:
                detected.append('loss_spike')
                if _cooldown_ok(('loss_spike',), cfg):
                    _trip('loss_spike', st, step=n,
                          value=round(loss, 6),
                          baseline=round(s['base'], 6))

        if ratio is not None and np.isfinite(ratio):
            s = _feed_stream(st, 'ratio', ratio, cfg)
            k = cfg['ratio_drift']
            if s['base'] > 0 and (s['ewma'] > s['base'] * k
                                  or s['ewma'] < s['base'] / k):
                detected.append('update_ratio_drift')
                if _cooldown_ok(('update_ratio_drift',), cfg):
                    _trip('update_ratio_drift', st, step=n,
                          ewma=round(s['ewma'], 9),
                          baseline=round(s['base'], 9))

        return tuple(detected)


# ---------------------------------------------------------------------------
# stats / reset


def active():
    """True when any program has been observed (state exists) — lets
    ``goodput.stats()`` include the health block only once it has data."""
    return bool(_state)


def stats(program=None):
    """Structured health view (the loop's ``stats()['health']`` block).
    ``program``: restrict to that program's detector state; default
    aggregates every instrumented program observed this process."""
    with _lock:
        if program is not None:
            sts = [s for u, s in _state.items() if u == program._uid]
        else:
            sts = list(_state.values())
        anomalies = []
        steps = 0
        last = {}
        history = []
        for s in sts:
            steps += s['step']
            anomalies.extend(dict(a) for a in s['anomalies'])
            if s['last']:
                last = dict(s['last'])
                history = [dict(h) for h in s['history']]
        anomalies.sort(key=lambda a: a.get('ts', 0.0))
        # "enabled" means harvesting is happening — via the env knob OR a
        # TrainingGuard(health=...) that has observed steps for this view
        return {'enabled': enabled() or bool(sts), 'steps': steps,
                'anomalies': anomalies, 'last': last, 'history': history}


def anomalies():
    """Flat anomaly log across programs (newest last)."""
    return stats()['anomalies']


def reset():
    """Drop every detector stream, baseline, ring and cooldown (tests /
    explicit new-run boundaries). Instrumented programs stay
    instrumented — only the host-side state resets."""
    with _lock:
        _state.clear()
        _trip_last.clear()
        _sentinel_trace[0] = None
        _on_cache[0] = '\0'
        _cfg_cache[0] = None
