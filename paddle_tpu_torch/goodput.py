"""Continuous goodput/MFU accounting + a perf-regression sentinel.

The port's own copy of paddle_tpu/goodput.py, with the device parts
replaced: the peaks name NVIDIA cards, the device kind comes from torch,
and busy time from CUDA events. Every dispatch of a plan — ``Executor.run``
(kind ``run``), a ``bind`` call (``bound``), a ``run_fused`` step
(``fused``) and the decode engine's bound steps — contributes
(device-execute seconds, flops, bytes) keyed by program fingerprint,
yielding LIVE utilization gauges plus a rolling regression sentinel.

**Accounting.** The hot-path hook (``note_dispatch``) appends one record
to a deque: it wakes no thread (a daemon completer drains the records
without events every 0.1 s, and ``stats()``/``flush()`` drain at once).
On the card the caller records a pair of CUDA events on the current
stream around the dispatch (around a replay, never inside a capture) and
passes them as ``events``; a record is taken once its end event has
completed, with ``start.elapsed_time(end)`` as the dispatch's busy
seconds, and its pair of events is reused by a later dispatch. Once
RESOLVE_EACH records wait, a dispatch resolves as many completed ones
after its own end event, while the device runs it. A thread that reads
the accounting (``stats()``, ``flush()``, a monitor snapshot) resolves
them too. No background thread does: not the completer, and not the
monitor's log writer or a /metrics request
(``monitor.on_telemetry_thread``), whose snapshots account only the
records without events. Nor does a thread whose current stream is
capturing. A CUDA call made while another thread captures a CUDA graph
in global mode invalidates that capture. The port captures in
thread-local mode (core/graphs.py), so no other thread's call can
invalidate its captures, and a user's own global-mode capture is safe
from this module's background threads. The window starts at the first
dispatch's ``t0`` (the JAX module starts it when the first record is
noted, after the dispatch returned: with events the device may have been
busy since ``t0``). For a graph replay that is the device's time for the
step. For an eager run it also holds the stream's idle gaps between
launches, while the host is still issuing them: it is the time the
stream was held, an upper bound of the kernels' own time (chip_smoke.py
prints it beside the profiler's busy share). Without events (on the
CPU) busy is ``t1 - t0``, the dispatch call's wall, as the JAX package
accounts a dispatch without a leaf.
Fresh plans are NOT accounted as execute time (their wall lands in the
``compile`` loss bucket instead), so baselines stay clean and "zero
recompiles after warmup" remains observable.

Gauges (exported at every ``monitor.snapshot()`` via a pre-snapshot
hook, so they exist whenever anyone looks — and ride FLAGS_monitor_log
for ``tools/perfwatch.py``):

- ``goodput_frac``          productive device seconds / wall since epoch
- ``step_mfu``              flops per PRODUCTIVE second / peak flops
                            (hardware utilization while executing;
                            ``step_mfu * goodput_frac`` = end-to-end MFU)
- ``model_flops_per_s``     delivered model flops per WALL second
- ``hbm_bw_util_frac``      bytes accessed per productive second / peak
                            HBM bandwidth
- ``goodput_loss_seconds{bucket}``  the non-productive remainder,
  attributed to named loss buckets the monitor already observes:
  ``compile`` (compile_seconds), ``ckpt`` (ckpt_write/restore_seconds),
  ``retry_backoff`` (retry_backoff_seconds), ``elastic_recovery``
  (elastic_recovery_seconds), ``queue`` (serving/generate queue waits).
  Input starvation has no histogram — it is the (unattributed)
  remainder; run_async pipeline stalls (step_wait_seconds) overlap
  device execute and are deliberately not double-booked as a loss.

Per-signature totals export as counters (``goodput_device_seconds_total``
/ ``goodput_flops_total`` / ``goodput_bytes_total`` /
``goodput_dispatch_total`` / ``goodput_steps_total``, labels
{model, kind, fingerprint}) — counters SUM across rank logs, so
``perfwatch --merge`` recovers fleet flops/s and fleet MFU no single
rank could report.

Flops/bytes come from the port's analysis registry (analysis.py: the
product flops of each op's plain version, counted from the shapes its
first step recorded). The registry's ``flops`` is per STEP for every
kind, and a fused dispatch contributes ``flops * n_steps``.

**Sentinel.** Rolling per-signature EWMA baselines (established from the
first ``PADDLE_PERFWATCH_MIN_SAMPLES`` post-warmup dispatches, then
frozen) detect:

- ``step_drift``       per-step execute EWMA > baseline * STEP_DRIFT
- ``recompile_storm``  >= RECOMPILE_N compiles inside RECOMPILE_WINDOW_S
                       AFTER steady state was reached (warmup bursts,
                       which precede any frozen baseline, never trip)
- ``accept_collapse``  speculative accept-rate EWMA < baseline *
                       ACCEPT_DROP (fed by GenerateEngine per round)
- ``queue_burn``       queue-wait EWMA > QUEUE_SLO_MS (0 disables; fed
                       by both engines per request)
- ``bench_row_drift``  a bench-row reading below its committed baseline
                       * ROW_DRIFT (fed by bench tools that registered
                       a baseline, e.g. servebench's serving row)

Each trip increments ``perf_regression_total{kind}`` and writes an
always-kept ``perf_regression`` trace event (the keep-errors channel —
a regression is never invisible), rate-limited by a per-kind cooldown so
one sustained condition trips exactly once per COOLDOWN_S. All sentinel
math runs on the completer thread — the dispatch hot path only appends.

Knobs (all ``PADDLE_PERFWATCH_*``; ``PADDLE_PERFWATCH=0`` is the kill
switch for the whole layer): see ``docs/observability.md`` for the
table. CLI: ``tools/perfwatch.py`` (per-model/per-kind utilization,
loss-bucket breakdown, regression log, ``--merge`` across rank logs).
"""
import collections
import os
import threading
import time

from . import monitor
from . import trace as trace_mod

__all__ = ['note_dispatch', 'timed', 'note_compile', 'note_accept',
           'note_queue_wait', 'note_bench_row', 'name_model',
           'cost_estimate', 'flush', 'stats', 'reset', 'regressions',
           'enabled', 'device_peaks', 'peak_flops_for',
           'peak_hbm_bps_for', 'PEAK_FLOPS', 'PEAK_HBM_BPS']

# peak dense bf16 FLOP/s per card, by the substring of
# torch.cuda.get_device_name() with its spaces removed, lowercased (the
# first match wins: the PCIe card before the SXM one); NVIDIA's figures,
# the ones PERF.md's bounds use for the H100 SXM
PEAK_FLOPS = [
    ('h100pcie', 756e12), ('h100', 989e12),
]

# peak HBM bandwidth, bytes/s per card, matched the same way
PEAK_HBM_BPS = [
    ('h100pcie', 2.0e12), ('h100', 3.35e12),
]


def _table_for(kind, table):
    k = (kind or '').lower().replace(' ', '')
    return next((p for pat, p in table if pat in k), None)


def peak_flops_for(device_kind):
    return _table_for(device_kind, PEAK_FLOPS)


def peak_hbm_bps_for(device_kind):
    return _table_for(device_kind, PEAK_HBM_BPS)


def device_peaks():
    """(peak_flops_per_s, peak_hbm_bytes_per_s) for this process's
    device — env overrides first (``PADDLE_PEAK_FLOPS`` /
    ``PADDLE_PEAK_HBM_BPS``: how CPU boxes get a defined MFU), else the
    per-card tables keyed on torch's device name; (None, None) when
    neither knows the hardware (the MFU gauges are then not set)."""
    def _env(name):
        try:
            v = float(os.environ.get(name, '') or 0)
            return v if v > 0 else None
        except ValueError:
            return None

    flops, bw = _env('PADDLE_PEAK_FLOPS'), _env('PADDLE_PEAK_HBM_BPS')
    if flops is None or bw is None:
        kind = _device_kind()
        if flops is None:
            flops = peak_flops_for(kind)
        if bw is None:
            bw = peak_hbm_bps_for(kind)
    return flops, bw


_dev_kind_cache = [None]


def _device_kind():
    if _dev_kind_cache[0] is None:
        try:
            import torch
            _dev_kind_cache[0] = torch.cuda.get_device_name(0) \
                if torch.cuda.is_available() else ''
        except Exception:               # noqa: BLE001 — advisory only
            _dev_kind_cache[0] = ''
    return _dev_kind_cache[0]


# ---------------------------------------------------------------------------
# knobs

_on_cache = ['\0', True]


def enabled():
    """PADDLE_PERFWATCH=0 is the kill switch; cached on the env string
    so the per-dispatch cost is one env read + one compare."""
    s = os.environ.get('PADDLE_PERFWATCH', '')
    if s != _on_cache[0]:
        _on_cache[0] = s
        _on_cache[1] = s != '0'
    return _on_cache[1]


def _env_float(name, default):
    try:
        return float(os.environ.get(name, '') or default)
    except ValueError:
        return default


_CFG_KEYS = ('PADDLE_PERFWATCH_EWMA', 'PADDLE_PERFWATCH_MIN_SAMPLES',
             'PADDLE_PERFWATCH_STEP_DRIFT', 'PADDLE_PERFWATCH_RECOMPILE_N',
             'PADDLE_PERFWATCH_RECOMPILE_WINDOW_S',
             'PADDLE_PERFWATCH_ACCEPT_DROP',
             'PADDLE_PERFWATCH_QUEUE_SLO_MS',
             'PADDLE_PERFWATCH_COOLDOWN_S',
             'PADDLE_PERFWATCH_ROW_DRIFT')
_cfg_cache = [None, None]       # [raw env tuple, parsed dict]


def _cfg():
    """Sentinel thresholds — env-tunable live, but parsed only when the
    raw env strings change (the per-request feeds and every drain batch
    call this under _lock; float-parsing 8 knobs each time would be the
    lock's hottest line)."""
    raw = tuple(os.environ.get(k) for k in _CFG_KEYS)
    if raw == _cfg_cache[0]:
        return _cfg_cache[1]
    cfg = {
        'ewma': _env_float('PADDLE_PERFWATCH_EWMA', 0.3),
        'min_samples': int(_env_float('PADDLE_PERFWATCH_MIN_SAMPLES', 16)),
        'step_drift': _env_float('PADDLE_PERFWATCH_STEP_DRIFT', 2.0),
        'recompile_n': int(_env_float('PADDLE_PERFWATCH_RECOMPILE_N', 5)),
        'recompile_window_s': _env_float(
            'PADDLE_PERFWATCH_RECOMPILE_WINDOW_S', 30.0),
        'accept_drop': _env_float('PADDLE_PERFWATCH_ACCEPT_DROP', 0.5),
        'queue_slo_s': _env_float('PADDLE_PERFWATCH_QUEUE_SLO_MS', 0.0)
        / 1e3,
        'cooldown_s': _env_float('PADDLE_PERFWATCH_COOLDOWN_S', 60.0),
        'row_drift': _env_float('PADDLE_PERFWATCH_ROW_DRIFT', 0.5),
    }
    _cfg_cache[0], _cfg_cache[1] = raw, cfg
    return cfg


# ---------------------------------------------------------------------------
# state

_lock = threading.RLock()       # accumulators + sentinel state
_drain_lock = threading.Lock()  # exactly one drainer at a time
_q = collections.deque()        # pending dispatch records
_QCAP = 4096                    # past this, records account without events
RESOLVE_EACH = 8                # records waiting when a dispatch resolves
_SPARE_CAP = 64                 # resolved event pairs kept a device
_evt = threading.Event()
_thread = [None]
_epoch = [None, None]           # [perf_counter t0, wall ts] — first note
_base_sums = {}                 # loss-bucket hist sums at epoch
_last_done = [0.0]              # serial-stream attribution cursor
_acct = collections.OrderedDict()   # (fp, kind) -> _Acct
_ACCT_CAP = 256
_names = {}                     # fingerprint -> model name
_exported = {}                  # (fp, kind) -> exported counter totals
_compile_times = collections.deque(maxlen=64)
_warm_t = [None]                # perf time the first baseline froze
_trips = collections.deque(maxlen=100)
_trip_last = {}                 # cooldown: trip key -> perf time
_accept_streams = {}            # model -> ewma state
_queue_stream = {'n': 0, 'ewma': None}
_sentinel_trace = [None]

# goodput kind -> analysis registry kind for flops/bytes lookup (a plan
# bound to a scope serves bind and run_fused alike, and registers under
# the kind of its first use)
_ANALYSIS_KIND = {'run': 'run', 'bound': 'bound', 'fused': 'fused'}

# loss-bucket taxonomy: bucket -> monitor histograms whose SUM is the
# wall attributed to it (docs/observability.md "Goodput & MFU").
# NOTE: 'queue' and 'retry_backoff' sum PER-REQUEST waits — N requests
# queued concurrently contribute N overlapping seconds, so under
# concurrency those buckets are aggregate seconds lost, not disjoint
# wall, and can exceed the window (divide by mean concurrency to
# compare). The serial-loop buckets (compile/ckpt/elastic_recovery)
# are disjoint wall, which is what the >=90% breakdown invariant is
# defined over. step_wait_seconds is deliberately NOT a bucket: a
# run_async submission blocking on the in-flight window waits on the
# DEVICE finishing the oldest step — wall the completer already
# attributes as productive (it is the compute-bound signal, the
# opposite of input wait); true input starvation shows up as the
# (unattributed) remainder with step_wait near zero.
LOSS_BUCKETS = {
    'compile': ('compile_seconds',),
    # 'ckpt' sums only STEP-VISIBLE save wall: under async saves
    # ckpt_write_seconds records just the backpressure wait + host
    # snapshot, while the background publish (ckpt_publish_seconds) is
    # deliberately NOT bucketed — it overlaps training compute, so
    # counting it would double-bill wall the step loop never lost
    'ckpt': ('ckpt_write_seconds', 'ckpt_restore_seconds'),
    'retry_backoff': ('retry_backoff_seconds',),
    'elastic_recovery': ('elastic_recovery_seconds',),
    'queue': ('serving_queue_seconds', 'generate_queue_seconds'),
}


class _Acct(object):
    """Per-(fingerprint, kind) accumulator + step-drift sentinel state."""

    __slots__ = ('n', 'busy_s', 'dispatch_s', 'steps', 'flops', 'bytes',
                 'ewma', 'base', 'bsum', 'bn')

    def __init__(self):
        self.n = 0              # dispatches
        self.busy_s = 0.0       # device-busy seconds (serial-attributed)
        self.dispatch_s = 0.0   # host dispatch-call wall
        self.steps = 0          # scan steps covered (n for unfused)
        self.flops = None       # per-STEP flops (resolved lazily)
        self.bytes = None       # per-STEP bytes accessed
        self.ewma = None        # per-step busy EWMA (post-baseline)
        self.base = None        # frozen baseline per-step busy
        self.bsum = 0.0
        self.bn = 0


def _start_epoch_locked(t0=None):
    now = time.perf_counter()
    _epoch[0] = now if t0 is None else min(now, t0)
    _epoch[1] = time.time() - (now - _epoch[0])
    _last_done[0] = _epoch[0]
    for bucket, hists in LOSS_BUCKETS.items():
        _base_sums[bucket] = sum(monitor.hist_sum(h) for h in hists)


def _ensure_thread():
    t = _thread[0]
    if t is None or not t.is_alive():
        t = threading.Thread(target=_completer_loop,
                             name='paddle-goodput', daemon=True)
        _thread[0] = t
        t.start()


# ---------------------------------------------------------------------------
# hot-path hooks


def note_dispatch(fp, kind, t0, t1, events=None, steps=1):
    """Account one dispatch. ``t0``/``t1``: perf_counter around the
    dispatch call (host window). ``events``: (start, end) CUDA events
    recorded on the dispatch's stream around it, whose elapsed time is
    the dispatch's busy time; None accounts ``t1 - t0`` directly (the
    CPU, overflow fallback). THE hot-path hook — one deque append (and,
    once RESOLVE_EACH records wait, a read of at most as many completed
    ones)."""
    if enabled():
        _note(fp, kind, t0, t1, events, steps)


def _note(fp, kind, t0, t1, events, steps):
    if _epoch[0] is None:
        with _lock:
            if _epoch[0] is None:
                _start_epoch_locked(t0)
        _ensure_thread()
    if len(_q) > _QCAP:
        events = None           # degrade to dispatch-window accounting
    _q.append((fp, kind, steps, t0, t1, events))
    if len(_q) >= RESOLVE_EACH:
        # the oldest completed records, on this thread while the device
        # runs this dispatch (a dispatch never runs inside a capture)
        _drain(block=False, limit=RESOLVE_EACH)


_torch = [None]
_spare = {}         # device index -> resolved CUDA event pairs, reused
_streams = {}       # raw CUDA stream handle -> its torch.cuda.Stream


def _event_pair(device):
    """(start, end, device index): a pair of timing events for ``device``,
    a resolved pair reused where there is one (creating and destroying two
    CUDA events a dispatch costs more than the rest of the hook)."""
    idx = device.index or 0
    try:
        return _spare[idx].pop()
    except (KeyError, IndexError):
        import torch
        _torch[0] = torch
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True), idx)


def _reuse(events):
    spare = _spare.setdefault(events[2], [])
    if len(spare) < _SPARE_CAP:
        spare.append(events)


def _record(event, idx):
    """Record ``event`` on device ``idx``'s current stream. The stream's
    Python object is kept by its raw handle: building one a call
    (``torch.cuda.current_stream``) costs more than the record."""
    torch = _torch[0]
    raw = torch._C._cuda_getCurrentRawStream(idx)
    stream = _streams.get(raw)
    if stream is None:
        if len(_streams) >= 64:
            _streams.clear()
        stream = _streams[raw] = torch.cuda.current_stream(idx)
    torch._C._CudaEventBase.record(event, stream)


class _Timed(object):
    """`timed`'s context manager."""

    __slots__ = ('fp', 'kind', 'steps', 'events', 't0', 'on')

    def __init__(self, fp, kind, device, steps):
        self.fp, self.kind, self.steps = fp, kind, steps
        self.on = enabled()
        self.events = _event_pair(device) \
            if self.on and device.type == 'cuda' else None

    def __enter__(self):
        self.t0 = time.perf_counter()
        if self.events is not None:
            _record(self.events[0], self.events[2])
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None and self.on:
            if self.events is not None:
                _record(self.events[1], self.events[2])
            _note(self.fp, self.kind, self.t0, time.perf_counter(),
                  self.events, self.steps)
        return False


def timed(fp, kind, device, steps=1):
    """A context manager around one dispatch on ``device`` (a
    torch.device) that notes it (`note_dispatch`) when it ends without
    raising: on the card with CUDA events recorded on the current stream
    before and after it (none with the layer off), elsewhere with the host
    window alone."""
    return _Timed(fp, kind, device, steps)


def note_compile(fp, seconds):
    """Record one real (run-path) compile for recompile-storm detection.
    The compile's WALL already lands in the ``compile`` loss bucket via
    the compile_seconds histogram; this hook only feeds the sentinel.
    Warmup compiles never trip: the storm detector arms only once some
    signature's baseline froze (steady state was reached)."""
    if not enabled():
        return
    now = time.perf_counter()
    with _lock:
        _compile_times.append(now)
        cfg = _cfg()
        warm = _warm_t[0]
        if warm is None:
            return
        lo = max(now - cfg['recompile_window_s'], warm)
        n = sum(1 for t in _compile_times if t >= lo)
        if n >= cfg['recompile_n'] and _cooldown_ok('recompile_storm',
                                                    cfg):
            _trip('recompile_storm', compiles_in_window=n,
                  window_s=cfg['recompile_window_s'],
                  fingerprint=fp[:12])


def note_accept(rate, model='default'):
    """Feed one speculative-decode round's accept rate (accepted /
    proposed in [0, 1]). Baseline = mean of the first MIN_SAMPLES
    rounds; an EWMA collapsing below baseline * ACCEPT_DROP trips
    ``perf_regression_total{kind=accept_collapse}``."""
    if not enabled():
        return
    with _lock:
        cfg = _cfg()
        st = _accept_streams.get(model)
        if st is None:
            st = _accept_streams[model] = {'n': 0, 'bsum': 0.0,
                                           'base': None, 'ewma': None}
        st['n'] += 1
        if st['base'] is None:
            st['bsum'] += rate
            if st['n'] >= cfg['min_samples']:
                st['base'] = st['bsum'] / st['n']
                st['ewma'] = st['base']
            return
        a = cfg['ewma']
        st['ewma'] = a * rate + (1.0 - a) * st['ewma']
        if st['base'] > 0 and \
                st['ewma'] < st['base'] * cfg['accept_drop'] and \
                _cooldown_ok(('accept_collapse', model), cfg):
            _trip('accept_collapse', model=model,
                  baseline=round(st['base'], 4),
                  ewma=round(st['ewma'], 4))


def note_bench_row(row, value, baseline, floor_frac=None):
    """Compare a bench-row reading against its REGISTERED baseline (a
    committed number from a past round, e.g. servebench's serving-row
    speedup from BENCH_r08): measuring below ``baseline * floor_frac``
    (default PADDLE_PERFWATCH_ROW_DRIFT = 0.5 — bench rows on a shared
    CPU box are noisy, so the floor is generous) trips
    ``perf_regression_total{kind=bench_row_drift}`` with the row name
    and both numbers in the trace event. Higher-is-better rows only.
    Returns True if the reading is within the floor."""
    if not enabled():
        return True
    with _lock:
        cfg = _cfg()
        frac = cfg['row_drift'] if floor_frac is None else float(floor_frac)
        ok = float(value) >= float(baseline) * frac
        if not ok and _cooldown_ok(('bench_row_drift', row), cfg):
            _trip('bench_row_drift', row=row, value=round(float(value), 4),
                  baseline=round(float(baseline), 4), floor_frac=frac)
        return ok


def note_queue_wait(seconds):
    """Feed one request's queue wait. With PADDLE_PERFWATCH_QUEUE_SLO_MS
    set (> 0), a queue-wait EWMA burning past the SLO for at least
    MIN_SAMPLES requests trips
    ``perf_regression_total{kind=queue_burn}``."""
    if not enabled():
        return
    with _lock:
        cfg = _cfg()
        st = _queue_stream
        st['n'] += 1
        a = cfg['ewma']
        st['ewma'] = seconds if st['ewma'] is None else \
            a * seconds + (1.0 - a) * st['ewma']
        slo = cfg['queue_slo_s']
        if slo > 0 and st['n'] >= cfg['min_samples'] and \
                st['ewma'] > slo and _cooldown_ok('queue_burn', cfg):
            _trip('queue_burn', slo_ms=round(slo * 1e3, 3),
                  ewma_ms=round(st['ewma'] * 1e3, 3))


def name_model(program_or_fp, name):
    """Attach a human model name to a program's goodput series (engines
    and bench rows call this; unnamed series label as the fingerprint
    prefix)."""
    fp = program_or_fp if isinstance(program_or_fp, str) \
        else program_or_fp._fingerprint()
    with _lock:
        _names[fp] = str(name)


# ---------------------------------------------------------------------------
# completer


def _completer_loop():
    while True:
        _evt.wait(0.1)
        _evt.clear()
        try:
            # the records without CUDA events (module docstring)
            _drain(block=False, cuda=False)
        except Exception:       # noqa: BLE001 — accounting must not die
            monitor.inc('goodput_drain_errors_total')


def _drain(block=True, cuda=True, limit=None):
    """block=False (the presnapshot-hook path) processes only the
    completed prefix of the queue: a telemetry thread (periodic
    FLAGS_monitor_log writer, /metrics scrape) must never stall behind
    a multi-second in-flight step — a later read picks up the remainder.
    ``cuda=False`` (the background threads) stops at the first record
    with CUDA events, and so does a thread whose current stream is
    capturing (module docstring). ``limit`` (the dispatch path, never
    inside a capture) takes at most that many records. Records are in
    dispatch order and one stream executes them in order, so stopping at
    the first unfinished dispatch keeps the serial attribution exact."""
    checked, cfg, n = limit is not None, None, 0
    # a dispatch does not wait for another thread's drain
    if not _drain_lock.acquire(blocking=limit is None):
        return
    try:
        while limit is None or n < limit:
            n += 1
            try:
                rec = _q.popleft()
            except IndexError:
                return
            if rec[5] is not None and cuda and not checked:
                import torch
                cuda = not (torch.cuda.is_available() and
                            torch.cuda.is_current_stream_capturing())
                checked = True
            if not cuda and rec[5] is not None:
                _q.appendleft(rec)
                return
            ready = False
            if not block and rec[5] is not None:
                try:
                    ready = rec[5][1].query()
                except Exception:   # noqa: BLE001 — a failed stream:
                    ready = True    # _process handles it either way
                if not ready:
                    # a later dispatch or read takes it
                    _q.appendleft(rec)
                    return
            if cfg is None:
                cfg = _cfg()    # once a drain: it reads nine env knobs
            _process(rec, cfg, ready)
    finally:
        _drain_lock.release()


def _process(rec, cfg, ready=False):
    fp, kind, steps, t0, t1, events = rec
    busy = None
    if events is not None:
        try:
            if not ready:
                events[1].synchronize()
            busy = max(0.0, events[0].elapsed_time(events[1]) / 1e3)
            if len(events) == 3:
                _reuse(events)
        except Exception:       # noqa: BLE001 — a failed stream: the
            pass                # dispatch window accounts it instead
        _last_done[0] = max(_last_done[0], time.perf_counter())
    if busy is None:
        busy = max(0.0, t1 - t0)
        _last_done[0] = max(_last_done[0], t1)
    with _lock:
        a = _acct.get((fp, kind))
        if a is None:
            a = _acct[(fp, kind)] = _Acct()
            while len(_acct) > _ACCT_CAP:
                old_key, _ = _acct.popitem(last=False)
                # drop the exported cursor with the accumulator: if the
                # signature comes back, its fresh totals re-export from
                # zero deltas instead of hiding behind the stale cursor
                # (monitor counters stay cumulative either way)
                _exported.pop(old_key, None)
        a.n += 1
        a.busy_s += busy
        a.dispatch_s += max(0.0, t1 - t0)
        a.steps += max(1, int(steps))
        per_step = busy / max(1, int(steps))
        if a.base is None:
            a.bsum += per_step
            a.bn += 1
            if a.bn >= cfg['min_samples']:
                a.base = a.bsum / a.bn
                a.ewma = a.base
                if _warm_t[0] is None:
                    _warm_t[0] = time.perf_counter()
        else:
            al = cfg['ewma']
            a.ewma = al * per_step + (1.0 - al) * a.ewma
            if a.base > 0 and a.ewma > a.base * cfg['step_drift'] and \
                    _cooldown_ok(('step_drift', fp, kind), cfg):
                _trip('step_drift', fingerprint=fp[:12], kind_=kind,
                      baseline_ms=round(a.base * 1e3, 4),
                      ewma_ms=round(a.ewma * 1e3, 4))


def _cooldown_ok(key, cfg):
    now = time.perf_counter()
    last = _trip_last.get(key)
    if last is not None and now - last < cfg['cooldown_s']:
        return False
    _trip_last[key] = now
    return True


def _trip(kind, **fields):
    """One sentinel firing: counter + always-kept trace event + the
    in-memory regression log perfwatch/stats expose. Callers hold
    _lock and have already passed the cooldown."""
    monitor.inc('perf_regression_total', labels={'kind': kind})
    rec = {'kind': kind, 'ts': time.time()}
    rec.update(fields)
    _trips.append(rec)
    tr = _sentinel_trace[0]
    if tr is None:
        # sampled=False: the trace never writes its own record; its
        # EVENTS always land in the trace log (the keep-errors channel)
        tr = _sentinel_trace[0] = trace_mod.start('perf',
                                                  name='perfwatch',
                                                  sampled=False)
    try:
        tr.event('perf_regression', **fields, regression=kind)
    except Exception:           # noqa: BLE001 — telemetry only
        monitor.inc('trace_log_write_errors')
    try:
        # flight recorder: every sentinel trip publishes a post-mortem
        # bundle (rate-limit + heavy capture live in blackbox — this is
        # an enqueue, safe under _lock)
        from . import blackbox
        blackbox.record(kind, **fields)
    except Exception:           # noqa: BLE001 — telemetry only
        monitor.inc('blackbox_write_errors_total')


# ---------------------------------------------------------------------------
# flush / stats


def _resolve_costs_locked():
    """Fill in per-step flops/bytes from the analysis registry for any
    signature still missing them (cheap lookups; the registry counts a
    record's cost at its first read)."""
    from . import analysis
    for (fp, kind), a in _acct.items():
        if a.flops is not None:
            continue
        akind = _ANALYSIS_KIND.get(kind)
        if akind is None:
            # busy-only kinds (segmented): the per-segment clones never
            # register analytics, and a kind=None lookup would match the
            # WHOLE program's record and credit its flops to every
            # segment dispatch
            a.flops = 0.0
            a.bytes = 0.0
            continue
        rec = analysis.lookup(fp, kind=akind)
        if rec is None:
            rec = analysis.lookup(fp)   # the plan's record of any kind
        if rec is not None and rec.flops is not None:
            a.flops = rec.flops
            a.bytes = rec.bytes_accessed


def _loss_buckets_now():
    out = {}
    for bucket, hists in LOSS_BUCKETS.items():
        total = sum(monitor.hist_sum(h) for h in hists)
        out[bucket] = max(0.0, total - _base_sums.get(bucket, 0.0))
    return out


def flush():
    """Drain pending records, resolve flops, export gauges + counters.
    Runs on every monitor snapshot/export via the pre-snapshot hook —
    the goodput view exists whenever anyone looks. Non-blocking drain:
    a snapshot mid-step accounts the completed prefix and never waits
    on the device (stats() waits — it is the synchronous view)."""
    if _epoch[0] is None:
        return
    _drain(block=False, cuda=not monitor.on_telemetry_thread())
    with _lock:
        _resolve_costs_locked()
        wall = max(1e-9, time.perf_counter() - _epoch[0])
        busy = flops = bytes_ = 0.0
        for (fp, kind), a in _acct.items():
            busy += a.busy_s
            if a.flops is not None:
                flops += a.flops * a.steps
                bytes_ += (a.bytes or 0.0) * a.steps
            model = _names.get(fp, fp[:12])
            labels = {'model': model, 'kind': kind,
                      'fingerprint': fp[:12]}
            prev = _exported.get((fp, kind), (0.0, 0, 0, 0.0, 0.0))
            cur = (a.busy_s, a.n, a.steps,
                   (a.flops or 0.0) * a.steps,
                   (a.bytes or 0.0) * a.steps)
            for name, i in (('goodput_device_seconds_total', 0),
                            ('goodput_dispatch_total', 1),
                            ('goodput_steps_total', 2),
                            ('goodput_flops_total', 3),
                            ('goodput_bytes_total', 4)):
                d = cur[i] - prev[i]
                if d > 0:
                    monitor.inc(name, d, labels=labels)
            _exported[(fp, kind)] = cur
        buckets = _loss_buckets_now()
        busy = min(busy, wall)
        monitor.set_gauge('goodput_wall_seconds', wall)
        monitor.set_gauge('goodput_productive_seconds', busy)
        monitor.set_gauge('goodput_frac', busy / wall)
        monitor.set_gauge('model_flops_per_s', flops / wall)
        peak, peak_bw = device_peaks()
        if peak:
            # perfwatch reads the peak from here directly — a cumulative
            # counters / epoch-scoped gauges back-inference would break
            # the first time reset() restarts the window mid-log
            monitor.set_gauge('goodput_peak_flops', peak)
            if busy > 0:
                monitor.set_gauge('step_mfu', flops / busy / peak)
        if peak_bw and busy > 0:
            monitor.set_gauge('hbm_bw_util_frac',
                              bytes_ / busy / peak_bw)
        for bucket, s in buckets.items():
            monitor.set_gauge('goodput_loss_seconds', s,
                              labels={'bucket': bucket})


monitor.add_presnapshot_hook(flush)


def stats(fps=None):
    """Structured goodput view (the engines' ``stats()['goodput']``
    block). ``fps``: restrict execute accounting to these program
    fingerprints (an engine's own signature set); loss buckets and the
    regression log stay process-wide — they are wall attribution, not
    per-program."""
    if _epoch[0] is None:
        return {'window_s': 0.0, 'productive_s': 0.0,
                'goodput_frac': 0.0, 'dispatches': 0, 'flops': 0.0,
                'model_flops_per_s': 0.0, 'step_mfu': None,
                'hbm_bw_util_frac': None, 'by_kind': {},
                'loss_buckets': {k: 0.0 for k in LOSS_BUCKETS},
                'regressions': [], 'health': _health_block()}
    _drain()
    keep = None if fps is None else set(fps)
    with _lock:
        _resolve_costs_locked()
        wall = max(1e-9, time.perf_counter() - _epoch[0])
        busy = flops = bytes_ = 0.0
        n = 0
        by_kind = {}
        for (fp, kind), a in _acct.items():
            if keep is not None and fp not in keep:
                continue
            busy += a.busy_s
            n += a.n
            f = (a.flops or 0.0) * a.steps
            b = (a.bytes or 0.0) * a.steps
            flops += f
            bytes_ += b
            k = by_kind.setdefault(kind, {'dispatches': 0, 'steps': 0,
                                          'device_s': 0.0, 'flops': 0.0})
            k['dispatches'] += a.n
            k['steps'] += a.steps
            k['device_s'] += a.busy_s
            k['flops'] += f
        busy = min(busy, wall)
        peak, peak_bw = device_peaks()
        buckets = _loss_buckets_now()
        for k in by_kind.values():
            k['device_s'] = round(k['device_s'], 6)
        return {
            'window_s': round(wall, 6),
            'productive_s': round(busy, 6),
            'goodput_frac': round(busy / wall, 6),
            'dispatches': n,
            'flops': flops,
            'model_flops_per_s': flops / wall,
            'step_mfu': (flops / busy / peak)
            if (peak and busy > 0) else None,
            'hbm_bw_util_frac': (bytes_ / busy / peak_bw)
            if (peak_bw and busy > 0) else None,
            'by_kind': by_kind,
            'loss_buckets': {k: round(v, 6) for k, v in buckets.items()},
            'regressions': list(_trips),
            'health': _health_block(),
        }


def _health_block():
    """The training-health view nested into every stats() reading (and so
    into every flight-recorder bundle's goodput.json): None until the
    health observatory has observed a step."""
    try:
        from . import health
        if health.active():
            return health.stats()
    except Exception:           # noqa: BLE001 — telemetry only
        pass
    return None


def cost_estimate(model, kind=None):
    """Live per-model cost model for admission control: device-seconds
    per dispatch/step for every signature whose goodput series is named
    `model` (``name_model`` — engines name their programs at
    construction). This is the stable API a fleet router prices
    admissions with: estimates come from the SAME serially-attributed
    device-busy accounting as ``stats()``, so they track the hardware
    live instead of a hardcoded cost table. ``kind`` restricts to one
    dispatch kind ('run' | 'fused' | 'mesh' | ...).

    Returns ``{'model', 'dispatches', 'steps', 'device_s',
    'device_s_per_dispatch', 'device_s_per_step', 'by_kind'}``, or None
    before any accounted dispatch for the model — a router must treat
    None as "no data yet" (admit and learn), never as free."""
    if _epoch[0] is None:
        return None
    _drain()
    name = str(model)
    with _lock:
        fps = {fp for fp, n in _names.items() if n == name}
        if not fps:
            return None
        n = steps = 0
        busy = 0.0
        by_kind = {}
        for (fp, k), a in _acct.items():
            if fp not in fps or (kind is not None and k != kind):
                continue
            n += a.n
            steps += a.steps
            busy += a.busy_s
            bk = by_kind.setdefault(k, {'dispatches': 0, 'steps': 0,
                                        'device_s': 0.0})
            bk['dispatches'] += a.n
            bk['steps'] += a.steps
            bk['device_s'] += a.busy_s
        if n == 0:
            return None
        for bk in by_kind.values():
            bk['device_s'] = round(bk['device_s'], 9)
        return {
            'model': name,
            'dispatches': n,
            'steps': steps,
            'device_s': round(busy, 9),
            'device_s_per_dispatch': busy / n,
            'device_s_per_step': busy / max(1, steps),
            'by_kind': by_kind,
        }


def regressions():
    """Sentinel trips so far (bounded ring, oldest first)."""
    with _lock:
        return list(_trips)


def reset():
    """Restart the accounting window: accumulators, sentinel baselines,
    regression log and the loss-bucket epoch all clear; the next
    dispatch starts a fresh epoch. (Monitor counters already exported
    keep their values — counters are cumulative by contract.)"""
    _drain()
    with _lock:
        _epoch[0] = _epoch[1] = None
        _acct.clear()
        _exported.clear()
        _base_sums.clear()
        _compile_times.clear()
        _warm_t[0] = None
        _trips.clear()
        _trip_last.clear()
        _accept_streams.clear()
        _queue_stream.update(n=0, ewma=None)
        _q.clear()
