"""Request futures and the bounded request queue.

The port's own copy of paddle_tpu/serving/batcher.py (`Request`,
`RequestQueue` and the error classes, the request's trace hooks, and the
metrics endpoint's port resolution and start). A full queue sheds new
load at once with a structured `LoadShedError`; expired requests are
dropped at collection so a dead request never occupies the card.
"""
import threading
import time

from .. import trace as trace_mod

__all__ = ['ServingError', 'LoadShedError', 'DeadlineExceededError',
           'EngineStoppedError', 'Request', 'RequestQueue',
           'resolve_metrics_port', 'start_metrics_server']


def resolve_metrics_port(configured):
    """A config's ``metrics_port``: an explicit value wins; else
    PADDLE_METRICS_PORT (unset or unparsable: None, no endpoint)."""
    if configured is not None:
        return int(configured)
    import os
    env = os.environ.get('PADDLE_METRICS_PORT', '')
    if env == '':
        return None
    try:
        return int(env)
    except ValueError:
        return None


def start_metrics_server(port, owner):
    """Start the scrape endpoint that rides an engine's lifecycle: up
    before the first request is served, down with stop(). A bind failure
    must not leave the engine half-started: warn and serve without the
    endpoint. Returns the server or None."""
    if port is None:
        return None
    from .. import monitor
    try:
        return monitor.serve_metrics(port)
    except Exception as e:          # noqa: BLE001 — telemetry only
        import warnings
        warnings.warn(
            "%s: could not serve /metrics on port %s (%s); continuing "
            "without the endpoint" % (owner, port, e), stacklevel=3)
        return None


class ServingError(RuntimeError):
    """Base class of serving-engine request failures."""


class LoadShedError(ServingError):
    """The bounded queue rejected this request. Fields carry the
    structured reason a client or load balancer routes on."""

    def __init__(self, reason, queue_depth, queue_cap):
        ServingError.__init__(
            self, "request shed (%s): queue depth %d at cap %d — retry "
            "against another replica or back off" %
            (reason, queue_depth, queue_cap))
        self.reason = reason
        self.queue_depth = queue_depth
        self.queue_cap = queue_cap


class DeadlineExceededError(ServingError):
    """The request's deadline passed before (or while) it was served."""


class EngineStoppedError(ServingError):
    """The engine was stopped while the request was queued."""


def _trace_outcome(error):
    """A request failure's trace and metric outcome label."""
    if isinstance(error, DeadlineExceededError):
        return 'deadline'
    if isinstance(error, LoadShedError):
        return 'shed'
    if isinstance(error, EngineStoppedError):
        return 'stopped'
    return 'error'


class Request(object):
    """One in-flight request with a one-shot future: the engine calls
    done()/fail(), the submitting thread blocks in result().

    ``trace`` (set by the engine at submit) is the request's causal trace
    (trace.py): the engine accumulates the latency-budget stages on it,
    and done()/fail() finish it with the outcome; the flattened breakdown
    lands on ``timing`` (``{'trace_id', 'total_s', 'queue_s', ...}``)."""

    __slots__ = ('deadline', 'enqueue_t', 'enqueue_wall', 'trace', 'timing',
                 '_tid', '_event', '_result', '_error')

    def __init__(self, deadline):
        self.deadline = deadline
        self.enqueue_t = time.monotonic()
        self.enqueue_wall = time.time() * 1e6
        self.trace = None
        self.timing = None
        self._tid = threading.get_ident()   # submitter (queue-span owner)
        self._event = threading.Event()
        self._result = None
        self._error = None

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline

    def _finish_trace(self, outcome, error=None):
        tr = self.trace
        if tr is None or self.timing is not None:
            return
        if 'queue' not in tr.stages:
            # never admitted (expired, shed, stopped in the queue): its
            # whole life was queue wait, so the breakdown composes
            tr.add_stage('queue', max(0.0,
                                      time.monotonic() - self.enqueue_t))
        self.timing = trace_mod.flat_timing(tr.finish(outcome, error=error))

    def done(self, result):
        self._result = result
        self._finish_trace('ok')
        self._event.set()

    def fail(self, error):
        self._error = error
        self._finish_trace(_trace_outcome(error), error)
        self._event.set()

    def result(self, timeout=None):
        """Block until served; raises the request's error on failure. The
        default timeout is the request's own deadline plus a grace second
        (a caller must never hang past its deadline)."""
        if timeout is None and self.deadline is not None:
            timeout = max(0.0, self.deadline - time.monotonic()) + 1.0
        if not self._event.wait(timeout):
            raise DeadlineExceededError(
                "request not served within %.3fs" % (timeout or 0.0))
        if self._error is not None:
            raise self._error
        return self._result


class RequestQueue(object):
    """Bounded FIFO of Requests with condition-variable hand-off to the
    engine loop."""

    def __init__(self, cap):
        self._cap = max(1, int(cap))
        self._q = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False

    @property
    def cap(self):
        return self._cap

    @property
    def closed(self):
        return self._closed

    def depth(self):
        with self._lock:
            return len(self._q)

    def put(self, req):
        """Enqueue, or raise LoadShedError when full and
        EngineStoppedError after close()."""
        with self._lock:
            if self._closed:
                raise EngineStoppedError("serving engine is stopped")
            if len(self._q) >= self._cap:
                raise LoadShedError('queue_full', len(self._q), self._cap)
            self._q.append(req)
            self._cond.notify()

    def close(self):
        """Stop accepting requests and fail everything still queued.
        Returns how many were failed."""
        with self._lock:
            self._closed = True
            drained, self._q = self._q, []
            self._cond.notify_all()
        for r in drained:
            r.fail(EngineStoppedError("serving engine stopped while the "
                                      "request was queued"))
        return len(drained)

    def take(self, poll_s=0.0):
        """Pop the oldest live request, waiting up to ``poll_s`` for one.
        Returns (request or None, expired): ``expired`` requests were
        dropped on the way and must be failed by the caller, outside the
        queue lock."""
        with self._lock:
            if not self._q and not self._closed and poll_s > 0:
                self._cond.wait(poll_s)
            now = time.monotonic()
            expired = [r for r in self._q if r.expired(now)]
            live = [r for r in self._q if not r.expired(now)]
            first = live.pop(0) if live else None
            self._q = live
        return first, expired
