"""Runtime observability: thread-safe metrics registry + always-on span ring.

The port's own copy of paddle_tpu/monitor.py: the same public names, the
same series, the same knobs, and a registry of its own (a process that
imports both packages holds two). The reference framework ships a
first-class observability tier — RAII ``RecordEvent`` spans
(platform/profiler.h:82), the chrome-trace timeline (tools/timeline.py),
per-op stats. This module is its serving-era analog: the Prometheus-style
counter/gauge/histogram surface a production deployment scrapes, plus the
lightweight span recorder the profiler drains.

Three export surfaces:

- ``monitor.snapshot()``          -> plain dict (tests, bench rows, debuggers)
- ``monitor.export_prometheus()`` -> text exposition format (scrape endpoint)
- ``FLAGS_monitor_log=<path>``    -> periodic JSON-lines snapshots appended to
                                     the file (read when flags.py is
                                     imported, with the package; interval via
                                     ``PADDLE_MONITOR_LOG_INTERVAL_S``,
                                     default 60 s, plus one immediate line and
                                     a final line at interpreter exit)

Spans: ``monitor.span(name)`` records into a bounded ring buffer
(``PADDLE_MONITOR_SPAN_CAP``, default 4096 spans) with real pid/tid, ALWAYS
— no session to start — so ``profiler.export_chrome_tracing`` can emit the
executor's compile/run spans even when no explicit profiler session is
active. The ring bound makes always-on safe for long-lived processes.

Label cardinality is capped per metric name (``PADDLE_MONITOR_MAX_SERIES``,
default 64): overflowing label sets collapse into the reserved series
``{other="true"}`` and bump the ``monitor_series_dropped`` counter, so an
unbounded label (a per-request id, say) degrades into one aggregate series
instead of leaking memory.

Metric catalog (what the executor, predictor and decode engine emit)
lives in docs/observability.md; the port emits no series outside it.

The two threads of this module (the periodic log writer and a /metrics
request's handler) mark themselves (:func:`on_telemetry_thread`): the
pre-snapshot hooks they run make no CUDA call there (goodput.py), so a
scrape or a log line never touches the card while another thread
captures a CUDA graph.
"""
import bisect
import collections
import itertools
import json
import math
import os
import threading
import time

__all__ = ['inc', 'set_gauge', 'observe', 'span', 'spans', 'clear_spans',
           'snapshot', 'export_prometheus', 'counters', 'counter_delta',
           'hist_sum',
           'configure_logging', 'log_snapshot', 'reset',
           'serve_metrics', 'MetricsServer']

_lock = threading.RLock()
_counters = {}          # name -> {label_key: float}
_gauges = {}            # name -> {label_key: float}
_hists = {}             # name -> {label_key: _Hist}

# Causal-trace context (trace.py binds/unbinds it): when a trace is
# active on a thread, _trace_ctx[tid] = (Trace, parent_span_id) and — if
# the trace is sampled — every span recorded there annotates with
# trace_id/span_id/parent_id. Lives here, not in trace.py, so the span
# hot path needs no cross-module import. A plain dict keyed by thread
# id, NOT threading.local: local's getattr costs ~0.7 us in sandboxed
# containers vs ~0.15 us for dict.get(get_ident()), and this read is on
# every span and every run (get/set of one key are GIL-atomic; entries
# are popped when a context deactivates, so dead threads don't leak).
_trace_ctx = {}
_span_ids = itertools.count(1)


def _new_span_id():
    return next(_span_ids)

# reserved series absorbing label sets beyond the cardinality cap
_OVERFLOW_KEY = (('other', 'true'),)
_DROPPED = 'monitor_series_dropped'

# 1-2-5 log-scale latency bounds, 1 us .. 500 s (seconds). Generic enough
# for any nonnegative observation; latency is the designed-for case.
_BOUNDS = tuple(m * (10.0 ** e) for e in range(-6, 3) for m in (1, 2, 5))


def _env_int(name, default):
    try:
        return max(1, int(os.environ.get(name, '') or default))
    except ValueError:
        return default


def _max_series():
    return _env_int('PADDLE_MONITOR_MAX_SERIES', 64)


# exact-quantile sample ring per histogram series: while a series has
# seen <= this many observations, p50/p90/p99 are computed exactly from
# the retained samples instead of bucket interpolation (short-lived test
# runs and per-request latencies get exact numbers); past it the fixed
# buckets take over and the ring only bounds memory
_HIST_RING = 512


def _rank_idx(q, n):
    """Nearest-rank quantile index: the smallest i with (i+1)/n >= q."""
    return min(n - 1, max(0, int(math.ceil(q * n)) - 1))


class _Hist(object):
    """Fixed log-spaced-bucket latency histogram: O(1) observe. The
    bucket counts COMPOSE across processes (obsreport --merge sums them
    and recovers true fleet percentiles); quantiles are exact from the
    sample ring while it still holds every observation, else by linear
    interpolation inside the owning bucket (the estimator Prometheus'
    histogram_quantile uses)."""

    __slots__ = ('counts', 'n', 'total', 'vmin', 'vmax', 'ring')

    def __init__(self):
        self.counts = [0] * (len(_BOUNDS) + 1)   # +1: > last bound
        self.n = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self.ring = []

    def add(self, v):
        if not math.isfinite(v):
            # a NaN observation would poison sum/min/max (and bisect
            # against NaN lands in an arbitrary bucket), making every
            # later export emit NaN — drop it loudly instead
            d = _counters.setdefault('monitor_nonfinite_observations', {})
            d[()] = d.get((), 0.0) + 1
            return
        self.counts[bisect.bisect_left(_BOUNDS, v)] += 1
        if len(self.ring) < _HIST_RING:
            self.ring.append(v)
        else:
            self.ring[self.n % _HIST_RING] = v
        self.n += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def quantile(self, q):
        if not self.n:
            return None
        if self.n <= len(self.ring):
            srt = sorted(self.ring[:self.n])
            return srt[_rank_idx(q, self.n)]
        target = q * self.n
        cum = 0.0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= target:
                lo = _BOUNDS[i - 1] if i > 0 else 0.0
                hi = _BOUNDS[i] if i < len(_BOUNDS) else self.vmax
                est = lo + (hi - lo) * (target - cum) / c
                return min(max(est, self.vmin), self.vmax)
            cum += c
        return self.vmax

    def bucket_pairs(self):
        """Nonzero buckets as [upper_bound, count] pairs; the overflow
        bucket's bound is None (JSON has no +Inf). This is the composable
        representation snapshot logs carry for cross-rank percentiles."""
        out = [[_BOUNDS[i], c] for i, c in
               enumerate(self.counts[:-1]) if c]
        if self.counts[-1]:
            out.append([None, self.counts[-1]])
        return out

    def stats(self):
        if not self.n:
            return {'count': 0, 'sum': 0.0}
        if self.n <= len(self.ring):
            srt = sorted(self.ring[:self.n])

            def q(p):
                return srt[_rank_idx(p, self.n)]
            p50, p90, p99 = q(0.5), q(0.9), q(0.99)
        else:
            p50, p90, p99 = (self.quantile(0.5), self.quantile(0.9),
                             self.quantile(0.99))
        return {'count': self.n, 'sum': self.total,
                'min': self.vmin, 'max': self.vmax,
                'avg': self.total / self.n,
                'p50': p50, 'p90': p90, 'p99': p99,
                'buckets': self.bucket_pairs()}


def _labels_key(labels):
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _capped_key(series, key):
    """Resolve `key` inside one metric's series dict, honoring the
    cardinality cap. Callers hold _lock."""
    if key in series or len(series) < _max_series():
        return key
    d = _counters.setdefault(_DROPPED, {})
    d[()] = d.get((), 0.0) + 1
    return _OVERFLOW_KEY


def inc(name, value=1.0, labels=None):
    """Add `value` (default 1) to counter `name`; labels: optional dict."""
    key = _labels_key(labels)
    value = float(value)    # numpy scalars must not poison JSON export
    with _lock:
        series = _counters.setdefault(name, {})
        key = _capped_key(series, key)
        series[key] = series.get(key, 0.0) + value


# Gauges whose value changes are ALSO recorded into the span ring as
# chrome-trace counter samples ('ph': 'C'), so exported traces show
# memory/load curves alongside spans. Matched by exact name or suffix.
# Queue-depth gauges move PER REQUEST at serving throughput (thousands/s)
# — unthrottled they would churn the whole 4096-entry ring in under a
# second and evict every duration span — so each track is sampled at most
# once per _COUNTER_TRACK_MIN_S.
_COUNTER_TRACK_NAMES = ('program_peak_bytes', 'program_flops',
                        'executor_inflight', 'elastic_world_size',
                        'step_mfu', 'goodput_frac',
                        'health_grad_norm_global', 'health_loss')
_COUNTER_TRACK_SUFFIXES = ('queue_depth', 'inflight_batches')
_COUNTER_TRACK_MIN_S = 0.005            # <= 200 samples/s per track
_track_last_ts = {}                     # track name -> last sample time


def _counter_tracked(name):
    return name in _COUNTER_TRACK_NAMES or \
        name.endswith(_COUNTER_TRACK_SUFFIXES)


def set_gauge(name, value, labels=None):
    """Set gauge `name` to `value` (last write wins). Gauges on the
    counter-track list additionally drop a 'C' sample into the span ring
    for profiler.export_chrome_tracing's counter tracks."""
    key = _labels_key(labels)
    value = float(value)
    with _lock:
        series = _gauges.setdefault(name, {})
        key = _capped_key(series, key)
        series[key] = value
        if _counter_tracked(name):
            # label values ride in the event name so two programs'
            # program_peak_bytes samples land on SEPARATE chrome counter
            # tracks instead of sawtoothing on one
            track = '%s:%s' % (name, ','.join(v for _, v in key)) \
                if key else name
            now = time.time()
            if now - _track_last_ts.get(track, 0.0) >= _COUNTER_TRACK_MIN_S:
                _track_last_ts[track] = now
                _spans.append({'name': track, 'ph': 'C', 'ts': now * 1e6,
                               'value': value, 'pid': _PID,
                               'tid': threading.get_ident()})
                _n_spans[0] += 1


def observe(name, value, labels=None):
    """Record one observation (seconds, for latencies) into histogram
    `name`."""
    key = _labels_key(labels)
    with _lock:
        series = _hists.setdefault(name, {})
        key = _capped_key(series, key)
        h = series.get(key)
        if h is None:
            h = series[key] = _Hist()
        h.add(float(value))


# ---------------------------------------------------------------------------
# span ring buffer


def _new_ring():
    return collections.deque(maxlen=_env_int('PADDLE_MONITOR_SPAN_CAP', 4096))


_spans = _new_ring()
# monotonic count of spans ever appended — lets the profiler detect that a
# session outgrew the ring (eviction = silently truncated session trace)
_n_spans = [0]

# getpid() is a cached libc call on bare metal but a full (seccomp-filtered)
# syscall in sandboxed containers — measured ~30 us/call on the CI box, which
# would dominate the whole span. Cache it; refresh in forked children.
_PID = os.getpid()


def _refresh_pid():
    global _PID
    _PID = os.getpid()


if hasattr(os, 'register_at_fork'):
    os.register_at_fork(after_in_child=_refresh_pid)


class _Span(object):
    """Plain __enter__/__exit__ object, not @contextmanager: the generator
    protocol costs ~2-3 us per span on the hot path for nothing. Each
    span(name) call returns a fresh single-use instance; calling it on a
    function uses it as a decorator (a fresh span per invocation), matching
    the old contextlib-based record_event.

    When a SAMPLED trace is bound to this thread (trace.activate), the
    span records trace_id/span_id/parent_id and becomes the parent of
    spans nested inside it — the causality export_chrome_tracing turns
    into flow events. The no-trace fast path pays one thread-local read."""

    __slots__ = ('name', 'ts', 't0', '_tctx', '_sid')

    def __init__(self, name):
        self.name = name

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _Span(self.name):
                return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        tid = threading.get_ident()
        ctx = _trace_ctx.get(tid)
        if ctx is not None and ctx[0].sampled:
            self._tctx = ctx
            self._sid = _new_span_id()
            _trace_ctx[tid] = (ctx[0], self._sid)   # nested spans chain
        else:
            self._tctx = None
        self.ts = time.time() * 1e6
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        tid = threading.get_ident()
        rec = {'name': self.name, 'ts': self.ts,
               'dur': (time.perf_counter() - self.t0) * 1e6,
               'pid': _PID, 'tid': tid}
        ctx = self._tctx
        if ctx is not None:
            _trace_ctx[tid] = ctx                   # pop this span
            rec['trace_id'] = ctx[0].trace_id
            rec['span_id'] = self._sid
            if ctx[1] is not None:
                rec['parent_id'] = ctx[1]
        # appended under the registry lock so spans() can iterate the deque
        # without racing a concurrent append (deque iteration raises on
        # mutation); deque.append alone is atomic but iteration is not
        with _lock:
            _spans.append(rec)
            _n_spans[0] += 1
        return False


def span(name):
    """RAII span: wall-clock start (us) + duration (us) + REAL pid/tid, so
    multi-threaded serving traces keep one row per thread. Always recorded;
    the bounded ring makes that safe."""
    return _Span(name)


def record_span(name, ts_us, dur_us, tid=None, trace=None, parent_id=None,
                span_id=None):
    """Retrospective span: append a ready-made record to the ring. The
    serving engines use this to stamp per-request stage spans (queue wait,
    batch formation, execute, sync) AFTER the fact, on whatever thread
    processed the stage — with `tid` naming the thread the stage
    conceptually belongs to (the submitter's tid for queue wait). With
    `trace` (a sampled trace.Trace), the record carries causality:
    span_id fresh unless given, parent defaulting to the trace's root."""
    if trace is not None and not trace.sampled:
        # an unsampled unit must cost NOTHING on the ring — at serving
        # throughput, per-request stage spans would churn the whole
        # 4096-entry ring in seconds (checked before any allocation:
        # this is the dominant path at 1% sampling)
        return
    rec = {'name': name, 'ts': float(ts_us), 'dur': float(dur_us),
           'pid': _PID,
           'tid': tid if tid is not None else threading.get_ident()}
    if trace is not None:
        sid = span_id if span_id is not None else _new_span_id()
        rec['trace_id'] = trace.trace_id
        rec['span_id'] = sid
        if sid != trace.root_id:
            rec['parent_id'] = parent_id if parent_id is not None \
                else trace.root_id
    with _lock:
        _spans.append(rec)
        _n_spans[0] += 1


class _TimedSpan(_Span):
    """Span that also feeds its duration into a latency histogram — the
    one-liner behind every instrumented run path (span + histogram from a
    single perf_counter pair, recorded even when the body raises, so
    failing runs stay visible in the latency data)."""

    __slots__ = ('hist',)

    def __init__(self, name, hist):
        _Span.__init__(self, name)
        self.hist = hist

    def __exit__(self, *exc):
        dur_s = time.perf_counter() - self.t0
        _Span.__exit__(self, *exc)
        observe(self.hist, dur_s)
        return False


def timed_span(name, histogram):
    """span(name) that also observes its duration (seconds) into
    `histogram`. Not exported via __all__ — an instrumentation-internal
    helper, not a stable public surface."""
    return _TimedSpan(name, histogram)


def spans():
    """Snapshot of the span ring (oldest first)."""
    with _lock:
        return list(_spans)


def clear_spans():
    with _lock:
        _spans.clear()


def span_seq():
    """Monotonic count of spans ever recorded — lets a session-scoped
    consumer (the profiler) detect that the bounded ring evicted spans
    from its window."""
    return _n_spans[0]


def span_cap():
    """Current capacity of the span ring."""
    return _spans.maxlen


# ---------------------------------------------------------------------------
# export surfaces


def _fmt(name, key):
    if not key:
        return name
    return '%s{%s}' % (name, ','.join('%s=%s' % kv for kv in key))


def _num(v):
    return int(v) if float(v).is_integer() else v


def counters():
    """Flat {'name' or 'name{k=v}': value} dict of all counters."""
    with _lock:
        return {_fmt(n, k): _num(v)
                for n, series in _counters.items()
                for k, v in series.items()}


def hist_sum(name):
    """Sum of every observation in histogram `name` across all label
    series (0.0 when nothing observed). Unlike snapshot(), this runs NO
    pre-snapshot hooks — safe to call from inside one (the goodput
    layer's loss-bucket accounting reads wall attribution this way)."""
    with _lock:
        return sum(h.total for h in _hists.get(name, {}).values())


def counter_delta(before, after=None):
    """Counter movement since `before` (a counters() snapshot): only keys
    that changed, as after - before."""
    if after is None:
        after = counters()
    return {k: _num(v - before.get(k, 0))
            for k, v in after.items() if v != before.get(k, 0)}


# Hooks run (outside the lock) before snapshot()/export_prometheus()
# assemble their view — analysis.py registers its lazy-analytics flush
# here, so program_flops/peak_bytes gauges exist whenever anyone looks.
_presnapshot_hooks = []


def add_presnapshot_hook(fn):
    _presnapshot_hooks.append(fn)


def _run_presnapshot_hooks():
    for fn in list(_presnapshot_hooks):
        try:
            fn()
        except Exception:
            # an analytics hiccup must never break metrics export; inc()
            # takes _lock — a raw dict write here could resize _counters
            # under a concurrent scrape's iteration
            inc('monitor_presnapshot_errors')


def snapshot():
    """Plain-dict view of every metric (the tests/bench surface). Tagged
    with the worker rank when launched under distributed.launch (the
    PADDLE_TRAINER_ID env contract) so merged fleet logs stay
    attributable — tools/obsreport.py --merge keys on it."""
    _run_presnapshot_hooks()
    try:
        rank = int(os.environ.get('PADDLE_TRAINER_ID', ''))
    except ValueError:
        # a non-numeric rank ('chief', garbage) must not turn every
        # snapshot/log write into a crash — telemetry never kills the job
        rank = None
    with _lock:
        return {
            'ts': time.time(),
            'rank': rank,
            'counters': {_fmt(n, k): _num(v)
                         for n, s in _counters.items()
                         for k, v in s.items()},
            'gauges': {_fmt(n, k): v
                       for n, s in _gauges.items() for k, v in s.items()},
            'histograms': {_fmt(n, k): h.stats()
                           for n, s in _hists.items()
                           for k, h in s.items()},
            'spans_recorded': len(_spans),
        }


def _prom_labels(key, extra=()):
    items = tuple(key) + tuple(extra)
    if not items:
        return ''
    def esc(v):
        return str(v).replace('\\', '\\\\').replace('"', '\\"') \
            .replace('\n', '\\n')
    return '{%s}' % ','.join('%s="%s"' % (k, esc(v)) for k, v in items)


def export_prometheus():
    """Text exposition format (the /metrics scrape body)."""
    _run_presnapshot_hooks()
    lines = []
    with _lock:
        for name in sorted(_counters):
            lines.append('# TYPE %s counter' % name)
            for key, v in sorted(_counters[name].items()):
                lines.append('%s%s %s' % (name, _prom_labels(key), _num(v)))
        for name in sorted(_gauges):
            lines.append('# TYPE %s gauge' % name)
            for key, v in sorted(_gauges[name].items()):
                lines.append('%s%s %s' % (name, _prom_labels(key), v))
        for name in sorted(_hists):
            # a series whose every observation was dropped (non-finite
            # guard) has n == 0: emitting its sum/buckets would be noise
            # at best and NaN at worst — skip empties entirely
            live = [(k, h) for k, h in sorted(_hists[name].items()) if h.n]
            if not live:
                continue
            lines.append('# TYPE %s histogram' % name)
            for key, h in live:
                cum = 0
                for bound, c in zip(_BOUNDS, h.counts):
                    cum += c
                    lines.append('%s_bucket%s %d' % (
                        name, _prom_labels(key, (('le', '%g' % bound),)),
                        cum))
                lines.append('%s_bucket%s %d' % (
                    name, _prom_labels(key, (('le', '+Inf'),)), h.n))
                lines.append('%s_sum%s %s' % (name, _prom_labels(key),
                                              h.total))
                lines.append('%s_count%s %d' % (name, _prom_labels(key),
                                                h.n))
    return '\n'.join(lines) + '\n'


def reset():
    """Clear every metric and the span ring (test isolation; the logging
    thread, if any, keeps running)."""
    global _spans
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _track_last_ts.clear()
        _spans = _new_ring()


# ---------------------------------------------------------------------------
# FLAGS_monitor_log JSON-lines writer


_log = {'path': None, 'stop': None, 'thread': None, 'interval': None}
_atexit_hooked = [False]


def log_snapshot(path=None):
    """Append one snapshot as a JSON line to `path` (default: the
    configured FLAGS_monitor_log file). No-op when neither is set."""
    path = path or _log['path']
    if not path:
        return
    line = json.dumps(snapshot(), sort_keys=True)
    with open(path, 'a') as f:
        f.write(line + '\n')


_telemetry = threading.local()


def on_telemetry_thread():
    """Whether this thread is one of this module's own (the log writer, a
    /metrics request's handler): a pre-snapshot hook makes no CUDA call
    there (module docstring)."""
    return getattr(_telemetry, 'on', False)


def _log_loop(path, interval_s, stop):
    _telemetry.on = True
    while not stop.wait(interval_s):
        try:
            log_snapshot(path)
        except Exception:
            # a transient failure (full disk, rotated-away directory, an
            # unserializable value) must not kill periodic logging
            # permanently — count it and retry next interval;
            # configure-time validation already proved the path writable
            inc('monitor_log_write_errors')


def _final_flush():
    if _log['path']:
        try:
            log_snapshot()
        except OSError:
            pass            # interpreter teardown: nothing to raise into


def configure_logging(path, interval_s=None):
    """(Re)start or stop the periodic JSON-lines writer. `path` falsy stops
    it. Writes one line immediately — which also validates the path LOUDLY
    (an unwritable FLAGS_monitor_log raises here, at configure time, not
    silently in a background thread). A failed configure leaves the
    previous logging state untouched."""
    path = path or None
    if path is not None:
        if interval_s is None:
            try:
                interval_s = float(os.environ.get(
                    'PADDLE_MONITOR_LOG_INTERVAL_S', '') or 60.0)
            except ValueError:
                interval_s = 60.0
        # a zero/negative interval would busy-loop the writer thread
        interval_s = max(1.0, interval_s)
    with _lock:
        unchanged = path == _log['path'] and (
            path is None
            or (_log['thread'] is not None
                and _log['thread'].is_alive()
                and interval_s == _log['interval']))
    if unchanged:
        return              # no-op only when NOTHING changed
    if path is not None:
        # immediate line + path validation, BEFORE any state commits: a bad
        # path must not stick around to poison later reconfigures. Written
        # OUTSIDE the registry lock — a hung filesystem here must not
        # freeze every inc/observe/span in the process
        log_snapshot(path)
    with _lock:
        if _log['stop'] is not None:
            _log['stop'].set()
        _log['path'] = path
        _log['stop'] = None
        _log['thread'] = None
        _log['interval'] = None
        if path is None:
            return
        stop = threading.Event()
        t = threading.Thread(target=_log_loop, args=(path, interval_s, stop),
                             name='paddle-monitor-log', daemon=True)
        _log['stop'] = stop
        _log['thread'] = t
        _log['interval'] = interval_s
        if not _atexit_hooked[0]:
            import atexit
            atexit.register(_final_flush)
            _atexit_hooked[0] = True
        t.start()


# ---------------------------------------------------------------------------
# fleet telemetry: the /metrics scrape endpoint


class MetricsServer(object):
    """Stdlib-HTTP Prometheus endpoint serving this process's registry.

    ``GET /metrics`` returns ``export_prometheus()`` (content type
    ``text/plain; version=0.0.4``), ``GET /healthz`` returns ``ok`` —
    enough for a Prometheus scrape config plus a liveness probe, with
    zero dependencies. The server runs on a daemon thread; ``close()``
    shuts it down and releases the port. Use via ``serve_metrics()``."""

    def __init__(self, port=0, host='127.0.0.1'):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 — stdlib contract
                _telemetry.on = True
                if self.path.split('?')[0] in ('/metrics', '/'):
                    body = export_prometheus().encode()
                    ctype = 'text/plain; version=0.0.4; charset=utf-8'
                elif self.path == '/healthz':
                    body, ctype = b'ok\n', 'text/plain'
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass                    # scrapes must not spam stderr

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={'poll_interval': 0.2},
            name='paddle-metrics-%d' % self.port, daemon=True)
        self._thread.start()
        set_gauge('metrics_server_port', float(self.port))

    @property
    def url(self):
        return 'http://%s:%d/metrics' % (self.host, self.port)

    def close(self, timeout_s=5.0):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout_s)

    stop = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def serve_metrics(port=None, host='127.0.0.1'):
    """Start the Prometheus scrape endpoint; returns a `MetricsServer`
    (``.port`` holds the bound port). ``port=None`` reads
    ``PADDLE_METRICS_PORT``; 0 (the default) binds an ephemeral port.
    Callers own the returned server's lifetime (``close()``); the serving
    engine and distributed launch wire it automatically — see
    docs/observability.md."""
    if port is None:
        try:
            port = int(os.environ.get('PADDLE_METRICS_PORT', '') or 0)
        except ValueError:
            port = 0
    return MetricsServer(port=port, host=host)
