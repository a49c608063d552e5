"""Request/step-scoped causal tracing: trace IDs, parent/child spans, and
a per-trace latency-budget breakdown.

The port's own copy of paddle_tpu/trace.py, over the port's monitor: the
same names, knobs and JSON lines, so ``tools/tracereport.py`` and
``tools/perfwatch.py`` read the port's logs unchanged. The metrics
registry (monitor.py) answers "how is the fleet doing"; this module
answers the question operators actually ask under load: "why was THIS
request slow / what happened to THIS step". Every external unit of work
gets a `Trace`:

- a ``GenerateRequest`` (kind ``generate``, created at ``submit()``),
- a bare ``Executor.run`` step with no ambient trace (kind ``step``,
  head-sampled).

A `Trace` carries a process-unique ``trace_id``, accumulates named
**stages** (``queue`` -> ``prefill`` -> ``decode_step``: the request's
latency budget; stage sums compose to the end-to-end latency within the
gaps the runtime cannot see), and appends structured **events**. While a
SAMPLED trace is activated on a thread, every ``monitor.span`` records
``trace_id``/``span_id``/``parent_id`` causality —
``profiler.export_chrome_tracing`` then emits flow events linking one
trace's spans across threads.

Head-based sampling keeps the always-on cost inside the executor's
<= 5 us/run overhead contract: ``PADDLE_TRACE_SAMPLE`` (default 0.01 =
keep 1%) decides at trace START whether span-level recording and the
trace-log line happen; traces that finish with a non-``ok`` outcome are
written regardless (keep-errors — a failed request is never invisible),
and lifecycle events always land in the log. ``PADDLE_TRACE=0`` disables
the layer entirely (the overhead-guard baseline).

Finished traces are JSON lines on the same channel as the monitor log
(``PADDLE_TRACE_LOG``, falling back to ``FLAGS_monitor_log``),
distinguished from snapshot lines by their ``trace_id`` field.
``tools/tracereport.py`` turns them into per-stage p50/p95/p99
breakdowns, slowest-trace exemplars, and SLO summaries. Full guide:
docs/observability.md.
"""
import itertools
import json
import os
import random
import threading
import time

from . import monitor

__all__ = ['Trace', 'start', 'maybe_trace', 'current', 'activate',
           'step_scope', 'note', 'flat_timing', 'recent', 'reset',
           'new_trace_id', 'sample_rate', 'log_line']

_ids = itertools.count(1)
_rng = random.Random()

_DEFAULT_SAMPLE = 0.01
_rate_cache = [None, _DEFAULT_SAMPLE]   # [env string it was parsed from, rate]


def new_trace_id():
    """Process-unique trace id: wall-second low bits + pid + counter, so
    ids from different ranks of one job never collide in a merged log."""
    return '%08x%04x%06x' % (int(time.time()) & 0xFFFFFFFF,
                             monitor._PID & 0xFFFF,
                             next(_ids) & 0xFFFFFF)


def sample_rate():
    """Parsed PADDLE_TRACE_SAMPLE: '' -> 0.01 (keep-errors-plus-1%),
    'off'/'0' -> 0.0 (errors still kept), 'all'/'1' -> 1.0, else a float
    probability. Cached on the env string so the per-call cost is one env
    read + one comparison."""
    s = os.environ.get('PADDLE_TRACE_SAMPLE', '')
    if _rate_cache[0] == s:
        return _rate_cache[1]
    if s == '':
        r = _DEFAULT_SAMPLE
    elif s.strip().lower() in ('off', 'errors'):
        r = 0.0
    elif s.strip().lower() == 'all':
        r = 1.0
    else:
        try:
            r = min(1.0, max(0.0, float(s)))
        except ValueError:
            r = _DEFAULT_SAMPLE
    _rate_cache[0], _rate_cache[1] = s, r
    return r


def _enabled():
    return os.environ.get('PADDLE_TRACE', '') != '0'


# in-memory ring of finished trace records (tests / debuggers; the log
# file is the durable surface)
def _new_ring():
    import collections
    try:
        cap = max(1, int(os.environ.get('PADDLE_TRACE_RING', '') or 256))
    except ValueError:
        cap = 256
    return collections.deque(maxlen=cap)


_recent = _new_ring()
_log_lock = threading.Lock()

# Rate cap on UNSAMPLED keep-errors trace lines (sampled traces and
# lifecycle events are never throttled): under a load-shed storm every
# rejected submit finishes an error trace, and an uncapped synchronous
# open/append per rejection would serialize all client threads on log
# I/O — deepening exactly the overload the shed exists to relieve. 50
# failure exemplars/s is post-mortem plenty; the rest are counted.
_ERROR_LINES_PER_S = 50
_err_window = [0.0, 0]          # [window start, lines written in window]


def _error_line_allowed():
    now = time.time()
    if now - _err_window[0] >= 1.0:
        _err_window[0], _err_window[1] = now, 0
    if _err_window[1] >= _ERROR_LINES_PER_S:
        monitor.inc('trace_log_throttled_total')
        return False
    _err_window[1] += 1
    return True


def _log_path():
    p = os.environ.get('PADDLE_TRACE_LOG', '')
    if p:
        return p
    return monitor._log['path']


def _write_line(rec):
    """Append one JSON line to the trace channel; a telemetry write must
    never raise into the request/step it describes. PADDLE_TRACE=0
    silences the channel entirely — keep-errors and lifecycle events
    included (the kill switch means OFF, not quieter)."""
    if not _enabled():
        return
    path = _log_path()
    if not path:
        return
    try:
        line = json.dumps(rec, sort_keys=True)
        with _log_lock:
            with open(path, 'a') as f:
                f.write(line + '\n')
    except Exception:       # noqa: BLE001 — telemetry only
        monitor.inc('trace_log_write_errors')


def log_line(rec):
    """Write one raw JSON record to the trace channel (the blackbox
    recorder's bundle-pointer lines ride here so a merged rank log names
    every bundle it references). Same contract as trace records: never
    raises, silenced by PADDLE_TRACE=0, no-op without a log path."""
    _write_line(dict(rec))


def _rank():
    try:
        return int(os.environ.get('PADDLE_TRAINER_ID', ''))
    except ValueError:
        return None


class Trace(object):
    """One unit of work: trace id + stage accumulation + lifecycle events.

    ``add_stage(name, seconds)`` accumulates the latency budget (same
    stage name adds up — per-token decode steps land in one
    ``decode_step`` stage with a count). ``event(name, **fields)``
    appends a structured lifecycle event AND writes it to the trace log
    immediately (crash-safe: an elastic restart is logged before the
    respawn that may die). ``finish(outcome)`` stamps the duration,
    writes the trace record when sampled or non-ok (keep-errors), emits
    the root span onto the monitor ring for sampled traces, and returns
    the record (idempotent — the first finish wins)."""

    __slots__ = ('trace_id', 'kind', 'name', 'sampled', 'ts', 't0',
                 'stages', 'events', 'outcome', 'parent', 'root_id',
                 'root_tid', 'record')

    def __init__(self, kind, name=None, sampled=None):
        self.trace_id = new_trace_id()
        self.kind = kind
        self.name = name
        if sampled is None:
            r = sample_rate()
            sampled = r >= 1.0 or (r > 0.0 and _rng.random() < r)
        self.sampled = bool(sampled)
        self.ts = time.time()
        self.t0 = time.perf_counter()
        self.stages = {}                # name -> [sum_seconds, count]
        self.events = []
        self.outcome = None
        self.parent = os.environ.get('PADDLE_TRACE_PARENT') or None
        self.root_id = monitor._new_span_id()
        self.root_tid = threading.get_ident()
        self.record = None

    def add_stage(self, name, seconds, n=1):
        st = self.stages.get(name)
        if st is None:
            self.stages[name] = [float(seconds), n]
        else:
            st[0] += float(seconds)
            st[1] += n

    def stage_sum(self):
        return sum(v[0] for v in self.stages.values())

    def event(self, name, **fields):
        rec = {'trace_id': self.trace_id, 'kind': self.kind,
               'event': name, 'ts': time.time()}
        rank = _rank()
        if rank is not None:
            rec['rank'] = rank
        if self.parent:
            rec['parent'] = self.parent
        rec.update(fields)
        self.events.append(rec)
        _write_line(rec)
        return rec

    def finish(self, outcome='ok', error=None, **extra):
        if self.record is not None:
            return self.record
        dur_s = time.perf_counter() - self.t0
        self.outcome = outcome
        rec = {'trace_id': self.trace_id, 'kind': self.kind,
               'ts': self.ts, 'dur_s': dur_s, 'outcome': outcome,
               'sampled': self.sampled,
               'stages': {k: {'s': v[0], 'n': v[1]}
                          for k, v in self.stages.items()}}
        if self.name is not None:
            rec['name'] = self.name
        rank = _rank()
        if rank is not None:
            rec['rank'] = rank
        if self.parent:
            rec['parent'] = self.parent
        if error is not None:
            rec['error'] = '%s: %s' % (type(error).__name__, error)
        if self.events:
            rec['events'] = len(self.events)
        rec.update(extra)
        self.record = rec
        if self.sampled or outcome != 'ok':
            # the ring mirrors the log's keep-errors policy: at 1%
            # sampling, unsampled-ok churn would evict every sampled and
            # error record within seconds of serving load
            _recent.append(rec)
        if self.sampled:
            # the root span makes the whole unit visible on the timeline;
            # stage/child spans recorded earlier already point at root_id
            monitor.record_span(self.kind, self.ts * 1e6, dur_s * 1e6,
                                tid=self.root_tid, trace=self,
                                span_id=self.root_id)
        if self.sampled or (outcome != 'ok' and _error_line_allowed()):
            # keep-errors: a failed/shed/expired unit is written even when
            # head sampling said no — post-mortems start from failures
            # (rate-capped so a shed storm can't serialize submitters on
            # log I/O; dropped lines count trace_log_throttled_total)
            _write_line(rec)
        return rec


def flat_timing(record):
    """Flatten a finished trace record into the structured timing
    breakdown requests carry: {'trace_id', 'total_s', '<stage>_s': ...}."""
    out = {'trace_id': record['trace_id'],
           'total_s': record['dur_s'],
           'outcome': record['outcome']}
    for name, st in record.get('stages', {}).items():
        out['%s_s' % name] = st['s']
    return out


# ---------------------------------------------------------------------------
# thread-local context (lives in monitor so span recording needs no import)


def start(kind, name=None, sampled=None):
    """New Trace for one unit of work. `sampled=None` head-samples via
    PADDLE_TRACE_SAMPLE; pass True for units that must always be kept
    (elastic incarnations)."""
    if not _enabled():
        return Trace(kind, name=name, sampled=False)
    return Trace(kind, name=name, sampled=sampled)


def current():
    """The trace active on this thread, or None."""
    ctx = monitor._trace_ctx.get(threading.get_ident())
    return ctx[0] if ctx is not None else None


def maybe_trace(kind):
    """Head-sampled trace for a bare step: None when an ambient trace
    already owns this thread, the sample said no, or the layer is off.
    This is the whole per-run cost of the sampled-out path — one
    thread-local read, one env read, one random() (env reads are ~1.4 us
    syscall-filtered in sandboxes, so the kill switch is only consulted
    on the rare sampled-IN path; see the overhead guard in
    tests/test_trace.py)."""
    if monitor._trace_ctx.get(threading.get_ident()) is not None:
        return None
    r = sample_rate()
    if r <= 0.0 or (r < 1.0 and _rng.random() >= r):
        return None
    if not _enabled():
        return None
    return Trace(kind, sampled=True)


class _Active(object):
    """Context manager binding a trace to the current thread; spans
    recorded inside annotate with causality when the trace is sampled.
    activate(None) is a no-op (keeps call sites branch-free)."""

    __slots__ = ('tr', 'prev')

    def __init__(self, tr):
        self.tr = tr

    def __enter__(self):
        if self.tr is not None:
            tid = threading.get_ident()
            self.prev = monitor._trace_ctx.get(tid)
            monitor._trace_ctx[tid] = (self.tr, self.tr.root_id)
        return self.tr

    def __exit__(self, *exc):
        if self.tr is not None:
            tid = threading.get_ident()
            if self.prev is None:
                monitor._trace_ctx.pop(tid, None)
            else:
                monitor._trace_ctx[tid] = self.prev
        return False


def activate(tr):
    return _Active(tr)


class _StepScope(object):
    """The executor's run()-path hook: when no ambient trace owns the
    thread and head sampling keeps this step, a 'step' trace wraps the
    run (spans annotate, an 'execute' stage records the wall time, and
    an escaping exception finishes the trace as an error). The
    sampled-out path allocates this object and nothing else."""

    __slots__ = ('kind', 'tr')

    def __init__(self, kind):
        self.kind = kind

    def __enter__(self):
        self.tr = maybe_trace(self.kind)
        if self.tr is not None:
            monitor._trace_ctx[threading.get_ident()] = \
                (self.tr, self.tr.root_id)
        return self.tr

    def __exit__(self, exc_type, exc, tb):
        tr = self.tr
        if tr is not None:
            monitor._trace_ctx.pop(threading.get_ident(), None)
            tr.add_stage('execute', time.perf_counter() - tr.t0)
            tr.finish('error' if exc_type is not None else 'ok', error=exc)
        return False


def step_scope(kind='step'):
    return _StepScope(kind)


def note(event, **fields):
    """Attach a lifecycle event to the current trace, if any — the hook
    resilience uses for retry give-ups. No-op without an active trace."""
    tr = current()
    if tr is not None:
        tr.event(event, **fields)


def recent():
    """Finished trace records, oldest first (bounded in-memory ring)."""
    return list(_recent)


def reset():
    """Clear the in-memory ring and rate-limiter state (test isolation)."""
    global _recent
    _recent = _new_ring()
    _rate_cache[0] = None
    _err_window[0], _err_window[1] = 0.0, 0
