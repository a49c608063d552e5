"""Profiler (reference python/paddle/fluid/profiler.py + platform/profiler.*).

The port's counterpart of paddle_tpu/profiler.py: ``start_profiler``,
``stop_profiler`` and ``profiler`` wrap ``torch.profiler`` (CPU and, where
a card is present, CUDA activities) in place of ``jax.profiler``; a
``trace_dir`` receives torch's chrome trace of the session
(``torch.profiler.tensorboard_trace_handler``), and :func:`last_session`
hands out the finished ``torch.profiler.profile`` (its ``key_averages()``
and device events). A lightweight host-side span recorder mirrors
RecordEvent RAII spans (platform/profiler.h:82): host spans live in
monitor.py's always-on bounded ring — the executor's compile/run spans
and user record_event spans share one timeline, with real pid/tid, so
export_chrome_tracing works even when no profiler session was ever
started. ``record_event`` also opens a ``torch.profiler.record_function``,
so a span shows on torch's timeline too.
"""
import contextlib
import json

from . import monitor

__all__ = ['cuda_profiler', 'reset_profiler', 'profiler', 'start_profiler',
           'stop_profiler', 'record_event', 'export_chrome_tracing',
           'profile_ops', 'last_session']

_active = False
_trace_dir = None
_torch_prof = [None, None]      # [the running session, the last finished]
_depth = 0
_session_ts = None      # wall-clock us of the outermost start_profiler
_session_seq = 0        # monitor._n_spans at session start (overflow check)


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    # name kept for API parity: a session whose host spans export to
    # output_file
    with profiler('All', 'total', output_file):
        yield


def reset_profiler():
    monitor.clear_spans()


def start_profiler(state='All', tracer_option=None, trace_dir=None):
    """Errors from the device tracer propagate — a typo'd trace dir must
    fail loudly, not produce a silently empty profile."""
    global _active, _trace_dir, _depth, _session_ts, _session_seq
    if _active:
        # already profiling (reference start_profiler returns early when
        # enabled) — don't clobber a running device trace; the matching
        # stop becomes a no-op via the depth counter
        _depth += 1
        return
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir)
        if trace_dir else None)
    prof.__enter__()
    # recorded only after a successful start, so that a failed start does
    # not make stop_profiler stop a session that never began
    _torch_prof[0] = prof
    _trace_dir = trace_dir
    _active = True
    _depth = 1
    import time
    _session_ts = time.time() * 1e6
    _session_seq = monitor.span_seq()


def stop_profiler(sorted_key=None, profile_path='/tmp/profile'):
    global _active, _trace_dir, _depth
    if not _active:
        return
    _depth -= 1
    if _depth > 0:
        return          # inner stop of a nested start pair: keep tracing
    _active = False
    _trace_dir = None
    prof, _torch_prof[0] = _torch_prof[0], None
    if prof is not None:
        prof.__exit__(None, None, None)
        _torch_prof[1] = prof
    # session exports cover the profiled WINDOW, not the whole always-on
    # ring (a process may hold hours of pre-session spans)
    appended = monitor.span_seq() - _session_seq
    cap = monitor.span_cap()
    if cap and appended > cap:
        import warnings
        warnings.warn(
            "profiler session recorded %d host spans but the ring keeps "
            "only %d — the exported trace is truncated to the newest %d; "
            "raise PADDLE_MONITOR_SPAN_CAP (before import) to cover the "
            "whole session" % (appended, cap, cap), stacklevel=2)
    export_chrome_tracing(profile_path, since_ts=_session_ts)


@contextlib.contextmanager
def profiler(state='All', sorted_key=None, profile_path='/tmp/profile',
             tracer_option=None):
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def last_session():
    """The ``torch.profiler.profile`` of the last finished session (None
    before one): ``key_averages()``, ``events()``, device times."""
    return _torch_prof[1]


class _Event(monitor._Span):
    """A monitor span that also opens a ``torch.profiler.record_function``
    of the same name (which costs next to nothing outside a session)."""

    __slots__ = ('_rf',)

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _Event(self.name):
                return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        import torch
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return monitor._Span.__enter__(self)

    def __exit__(self, *exc):
        monitor._Span.__exit__(self, *exc)
        self._rf.__exit__(*exc)
        return False


def record_event(name):
    """RAII span (reference platform/profiler.h:82 RecordEvent). Recorded
    unconditionally into monitor's bounded span ring — with the real
    process id and thread id — so multi-threaded serving traces keep one
    row per thread and no session needs to be active — and as a
    ``torch.profiler.record_function`` on torch's timeline."""
    return _Event(name)


@contextlib.contextmanager
def profile_ops():
    """Op-level attribution mode (the context-manager twin of
    ``PADDLE_PROFILE_OPS=1``): every ``Executor.run`` inside the block
    executes op by op, each op synchronized, with per-op wall time, call
    count, and output-bytes accounting. Yields the ``analysis`` module —
    read ``analysis.op_profile()`` for the structured table or
    ``analysis.format_op_profile()`` for the Fluid-style sorted report.
    The accumulated table is reset on entry and KEPT on exit (so it can
    be read after the block). ~10-100x slower than compiled execution —
    a debugging mode, not a serving mode."""
    from . import analysis
    analysis.reset_op_profile()
    analysis.push_profiling()
    try:
        yield analysis
    finally:
        analysis.pop_profiling()


def export_chrome_tracing(path, since_ts=None):
    """chrome://tracing JSON of host spans (reference tools/timeline.py:115).

    Exports the whole always-on ring by default (works with no session);
    `since_ts` (wall-clock us) keeps only spans that END at or after it —
    how stop_profiler scopes a session export to the profiled window.
    Gauge samples the monitor's counter-track list recorded (memory /
    queue depth) are emitted as chrome counter events (``"ph": "C"``), so
    the trace shows load curves alongside spans.

    Spans recorded under a sampled trace (docs/observability.md
    "Request & step tracing") carry ``args: {trace_id, span_id,
    parent_id}``, and each trace's thread hops become chrome FLOW events
    (``"ph": "s"``/``"f"``): consecutive spans of one trace on different
    tids are linked by an arrow, so a request's path through the submit
    thread, the batcher pool, and the completion thread reads as one
    causal chain on the timeline.

    A bad path raises (fail-loudly doctrine — same contract as the
    device tracer in start_profiler); it must not produce a silently
    missing trace."""
    events = monitor.spans()
    if since_ts is not None:
        events = [e for e in events
                  if e['ts'] + e.get('dur', 0.0) >= since_ts]
    out = []
    traced = {}                 # trace_id -> [(ts, dur, tid)]
    for e in events:
        if e.get('ph') == 'C':
            out.append({'name': e['name'], 'ph': 'C', 'ts': e['ts'],
                        'pid': e['pid'],
                        'args': {e['name']: e['value']}})
        else:
            ev = {'name': e['name'], 'ph': 'X', 'ts': e['ts'],
                  'dur': e['dur'], 'pid': e['pid'], 'tid': e['tid']}
            if 'trace_id' in e:
                args = {'trace_id': e['trace_id'],
                        'span_id': e['span_id']}
                if 'parent_id' in e:
                    args['parent_id'] = e['parent_id']
                ev['args'] = args
                traced.setdefault(e['trace_id'], []).append(
                    (e['ts'], e.get('dur', 0.0), e['tid'], e['pid']))
            out.append(ev)
    # flow events: link one trace's spans across thread hops so the
    # request reads as a causal chain, not disconnected slices
    for trace_id, spans_ in traced.items():
        spans_.sort()
        k = 0
        for (ts0, d0, tid0, pid0), (ts1, d1, tid1, pid1) in \
                zip(spans_, spans_[1:]):
            if tid0 == tid1:
                continue
            k += 1
            fid = '%s.%d' % (trace_id, k)
            s_ts = min(ts0 + d0, ts1)   # arrow start inside the source
            out.append({'name': 'trace', 'cat': 'trace', 'ph': 's',
                        'id': fid, 'ts': s_ts, 'pid': pid0, 'tid': tid0})
            out.append({'name': 'trace', 'cat': 'trace', 'ph': 'f',
                        'bp': 'e', 'id': fid, 'ts': ts1, 'pid': pid1,
                        'tid': tid1})
    with open(path, 'w') as f:
        json.dump({'traceEvents': out}, f)
