"""CUDA-graph capture shared by the port's bound steps.

Two owners capture a step once and replay it: the decode engine's fixed
signatures (serving/graphs.py `BoundStep`) and a program's cached run plan
(executor.py: `Executor.bind` and `Executor.run_fused`). What they share
lives here.

- :class:`FeedBuffer` holds every feed of a fixed signature in one device
  buffer, with one host staging buffer of the same bytes (pinned on the
  card): numpy feeds cost one host-to-device copy, device tensors a
  device-to-device copy into their view. An event guards the staging
  buffer: the previous call's copy must have read it before it is
  overwritten.
- :func:`capture` captures one call of a function as a CUDA graph, with the
  cyclic garbage collector off (freeing another graph or pinned memory
  inside a capture is an operation the capture does not permit) and the
  caller's generators registered with the graph. It captures in
  thread-local mode: a CUDA call that a capture does not permit fails it
  only when the capturing thread makes it, so another engine's decode
  loop, a /metrics scrape or a goodput read on another thread leaves it
  whole. A capture that fails raises: nothing runs eagerly on the card in
  place of a replay.
- Launch counts (`ops.kernel_tier`) are counted in Python where a wrapper
  launches, so a capture counts launches that never ran. :func:`capture`
  takes them back and returns them; the owner adds them again on every
  replay (:func:`replay`), so the counts stay what the device ran.

- :func:`run_while` captures a data-dependent loop (a ``while`` op of a
  bound plan, ops/control_flow_ops.py) as one WHILE conditional node of the
  graph being captured (CUDA 12.4 or later; csrc/graph_while.cu): a
  one-thread kernel loads the node's condition from a device tensor before
  the node and again at the end of each run of its body, so the loop runs
  until its condition reads false with no host read. The body is captured
  on a stream of its own into the node's body graph, and what it allocates
  comes from a memory pool that the graph keeps (`torch.cuda.MemPool`,
  routed by thread while the body is captured: the capture's own pool takes
  only the allocations of the capturing stream). A loop's body launches
  run once for each trip, which the capture cannot know: each loop counts
  its trips in a device tensor, :func:`capture` leaves the bodies' launches
  out of what a replay adds, and :func:`loop_launches` reads the trip
  counts (a host read, for a caller that wants exact launch counts) and
  adds body launches times trips. A body that draws random numbers draws
  what an eager run draws in each trip: a captured random kernel draws at
  its generator's device offset plus an offset fixed at capture, so the
  body's capture-time increment of each of the run's generators (read
  before and after the body's capture, csrc/philox_offset.cu) is added to
  that generator's device offset at the end of each trip and taken off
  once after the node (csrc/graph_while.cu `add_offset`).
- :func:`watch` and :func:`check_flags`: a bounded loop that its bound may
  cut in a capture (a differentiated ``while`` whose bound is inferred
  from an array's capacity) ORs its final condition into a device flag;
  the owner reads the graph's flags after its replays and raises when one
  is set.

The two owners warm up differently before their capture. A decode
signature is idempotent in the state it writes, so `BoundStep` calls it
twice on a side stream. A training step is not: its warm-up is the one
real step that `Executor.bind` takes anyway, run on the stream that then
captures the next one.
"""
import ctypes
import gc
import threading

import numpy as np
import torch

from ..ops import kernel_tier

__all__ = ['FeedBuffer', 'capture', 'replay', 'run_while', 'loop_launches',
           'watch', 'check_flags']

_ALIGN = 16     # bytes between feeds in the staging buffers


class FeedBuffer(object):
    """The static feeds of a fixed signature: ``specs`` is a sequence of
    (shape, numpy dtype) pairs; ``inputs`` the device views, one a feed,
    that the bound function reads."""

    def __init__(self, specs, device):
        self.device = torch.device(device)
        self.specs = [(tuple(int(n) for n in shape), np.dtype(dtype))
                      for shape, dtype in specs]
        offsets, at = [], 0
        for shape, dtype in self.specs:
            offsets.append(at)
            at += -(-int(np.prod(shape)) * dtype.itemsize // _ALIGN) * _ALIGN
        cuda = self.device.type == 'cuda'
        self._host = torch.zeros(max(at, _ALIGN), dtype=torch.uint8,
                                 pin_memory=cuda)
        self._dev = torch.zeros(max(at, _ALIGN), dtype=torch.uint8,
                                device=self.device)
        host = self._host.numpy()
        self._staged, inputs = [], []
        for (shape, dtype), off in zip(self.specs, offsets):
            nbytes = int(np.prod(shape)) * dtype.itemsize
            self._staged.append(host[off:off + nbytes].view(dtype)
                                .reshape(shape))
            tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
            inputs.append(self._dev[off:off + nbytes].view(tdtype)
                          .view(shape))
        self.inputs = tuple(inputs)
        self.tdtypes = [t.dtype for t in self.inputs]
        self._copied = torch.cuda.Event() if cuda else None

    def check(self, name, values):
        """Raise ValueError unless ``values`` (numpy arrays or tensors) have
        exactly the bound shapes and dtypes."""
        if len(values) != len(self.specs):
            raise ValueError('%s takes %d feeds, got %d'
                             % (name, len(self.specs), len(values)))
        for i, (v, (shape, dtype), tdtype) in enumerate(
                zip(values, self.specs, self.tdtypes)):
            got = v.dtype
            want = tdtype if isinstance(v, torch.Tensor) else dtype
            if tuple(v.shape) != shape or got != want:
                raise ValueError(
                    '%s: feed %d must be %s %s, got %s %s — a bound '
                    'signature takes exactly the shapes and dtypes it was '
                    'bound at' % (name, i, dtype, shape, got,
                                  tuple(v.shape)))

    def stage(self, values):
        """Copy checked ``values`` into the device views: the numpy arrays
        (and CPU tensors) through the staging buffer in one host-to-device
        copy, tensors on the device each by a device-to-device copy."""
        on_dev = [isinstance(v, torch.Tensor) and v.device == self.device
                  for v in values]
        if not all(on_dev):
            if self._copied is not None:
                # the previous call's copy must have read the staging
                # buffer before it is overwritten
                self._copied.synchronize()
            for staged, v, dev in zip(self._staged, values, on_dev):
                if not dev:
                    staged[...] = v.numpy() if isinstance(v, torch.Tensor) \
                        else v
            self._dev.copy_(self._host, non_blocking=True)
            if self._copied is not None:
                self._copied.record()
        for dst, v, dev in zip(self.inputs, values, on_dev):
            if dev:
                dst.copy_(v)


def capture(fn, stream=None, pool=None, name='bound step', generators=()):
    """Capture one call of ``fn()`` as a CUDA graph on ``stream`` (None:
    PyTorch's capture stream) into ``pool`` (None: a pool of its own),
    with ``generators`` registered so that each replay draws from their
    state at that replay. Returns (graph, {kernel: launches a replay
    runs})."""
    graph = torch.cuda.CUDAGraph()
    if generators:
        if not hasattr(graph, 'register_generator_state'):
            raise RuntimeError(
                'capturing %s: this PyTorch cannot register a generator '
                'with a CUDA graph (CUDAGraph.register_generator_state)'
                % name)
        for g in generators:
            graph.register_generator_state(g)
    before = kernel_tier.launch_counts()
    # no cyclic collection inside the capture: freeing another graph or
    # pinned memory there is an operation the capture does not permit
    gc_on = gc.isenabled()
    gc.disable()
    _loops.records, _loops.pool, _loops.depth = [], None, 0
    _loops.flags = []
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode='thread_local'):
            fn()
    except Exception as e:
        raise RuntimeError('capturing %s as a CUDA graph failed: %s'
                           % (name, e)) from e
    finally:
        if gc_on:
            gc.enable()
        after = kernel_tier.launch_counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        # the capture recorded these launches; the device ran none of them
        kernel_tier.add_counts({k: -n for k, n in launches.items()})
        graph.loops, graph.loop_pool = _loops.records, _loops.pool
        graph.flags = _loops.flags
        _loops.records = _loops.pool = _loops.flags = None
    # a loop body's launches run once a trip: `loop_launches` counts them
    for body, _ in graph.loops:
        for k, n in body.items():
            launches[k] -= n
    return graph, {k: n for k, n in launches.items() if n}


def replay(graph, launches):
    """Replay ``graph`` and count the launches it runs (a loop body's
    launches: :func:`loop_launches`)."""
    graph.replay()
    kernel_tier.add_counts(launches)


# ---------------------------------------------------------------------------
# loops: WHILE conditional nodes
# ---------------------------------------------------------------------------

# the capture in progress on this thread: ``records`` [(body launches,
# trip counter)] of its loops (None outside `capture`), ``pool`` the memory
# pool of their bodies, ``depth`` the loops being captured and ``flags``
# [(flag, message)] of `watch`
_loops = threading.local()
_fns = None
_philox = None
_body_streams = {}


def _while_fns():
    global _fns
    if _fns is None:
        from .. import native
        P = ctypes.c_void_p
        _fns = (native.function('graph_while', 'graph_while_begin',
                                [P, P, P, ctypes.POINTER(ctypes.c_ulonglong)]),
                native.function('graph_while', 'graph_while_end',
                                [P, P, ctypes.c_ulonglong]),
                native.function('graph_while', 'graph_stream_create',
                                [ctypes.POINTER(P)]),
                native.function('graph_while', 'graph_offset_add',
                                [P, P, ctypes.c_longlong]))
    return _fns


def _philox_state(gen):
    """(address of the device offset, intragraph offset) of the CUDA
    generator ``gen`` in the capture in progress on the current stream
    (csrc/philox_offset.cu). Raises when the generator's graph state cannot
    be read: a loop that draws is not captured without it."""
    global _philox
    from .. import native
    if _philox is None:
        # the C side reads the at::Generator after the CPython object
        # header: a torch.Generator of any other layout is not read
        if torch._C.Generator.__basicsize__ != 24:
            raise RuntimeError(
                'a torch.Generator is %d bytes here, not the 24 (object '
                'header and at::Generator) whose graph state '
                'csrc/philox_offset.cu reads: a while loop that draws '
                'cannot be captured with this PyTorch'
                % torch._C.Generator.__basicsize__)
        _philox = native.function(
            'philox_offset', 'philox_graph_state',
            [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_ulonglong)])
    ptr, intra = ctypes.c_void_p(), ctypes.c_ulonglong()
    rc = _philox(id(gen), ctypes.byref(ptr), ctypes.byref(intra))
    if rc:
        raise RuntimeError(
            'reading the graph state of a CUDA generator failed (%s)'
            % ('no capture in progress on the current stream' if rc == 1
               else 'PyTorch raised: not a CUDA generator?'))
    return ptr.value, intra.value


def _body_stream(device, depth):
    """The stream that captures the body of a loop at ``depth`` (one a
    device and depth, made once: a body's capture ends before the next
    one at its depth begins)."""
    from .. import native
    key = (device.index, depth)
    s = _body_streams.get(key)
    if s is None:
        raw = ctypes.c_void_p()
        with torch.cuda.device(device):
            native.check(_while_fns()[2](ctypes.byref(raw)),
                         'graph_stream_create')
        s = _body_streams[key] = torch.cuda.ExternalStream(raw.value,
                                                           device=device)
    return s


def _flag(cond):
    """``cond`` (one element of any dtype) as a bool tensor of one byte."""
    return cond.reshape(()).to(torch.bool).contiguous()


def run_while(cond, body, trips, generators=()):
    """Capture ``while cond: cond = body()`` as one WHILE node of the graph
    that :func:`capture` is capturing on the current stream. ``cond`` is a
    device tensor of one element, read when the node starts; ``body()``
    captures one iteration on the body's stream (the current stream while
    it runs) and returns the condition after it, read at the end of each
    run of the body; ``trips`` is an int64 device tensor of one element
    that each run of the body adds one to (made before the capture, so that
    the graph does not zero it: :func:`loop_launches` reads it).
    ``generators`` are the CUDA generators the body may draw from (those
    registered with the graph): each trip draws past the last, as an eager
    loop draws (module docstring). Raises when no capture is in progress,
    a generator's graph state cannot be read or a CUDA call fails: nothing
    falls back to an eager loop."""
    from .. import native
    records = getattr(_loops, 'records', None)
    if records is None:
        raise RuntimeError('run_while captures a loop only inside '
                           'core.graphs.capture')
    begin, end, _, offset_add = _while_fns()
    stream = torch.cuda.current_stream()
    before_draws = [_philox_state(g) for g in generators]
    body_stream = _body_stream(stream.device, _loops.depth)
    flag = _flag(cond)
    handle = ctypes.c_ulonglong()
    native.check(begin(stream.cuda_stream, body_stream.cuda_stream,
                       flag.data_ptr(), ctypes.byref(handle)),
                 'graph_while_begin')
    if _loops.pool is None:
        _loops.pool = torch.cuda.MemPool()
    routed = _loops.depth == 0
    if routed:
        # the capture's pool takes only the capturing stream's allocations
        torch._C._cuda_beginAllocateCurrentThreadToPool(
            stream.device.index, _loops.pool.id)
    _loops.depth += 1
    nested = len(records)
    before = kernel_tier.launch_counts()
    new = None
    drawn = []
    try:
        with torch.cuda.stream(body_stream):
            new = _flag(body())
            trips.add_(1)
            # each trip draws one body's increment further on
            for g, (ptr, at) in zip(generators, before_draws):
                p = _philox_state(g)[1] - at
                if p:
                    native.check(offset_add(body_stream.cuda_stream, ptr, p),
                                 'graph_offset_add')
                    drawn.append((ptr, p))
    finally:
        after = kernel_tier.launch_counts()
        _loops.depth -= 1
        if routed:
            torch._C._cuda_endAllocateToPool(stream.device.index,
                                             _loops.pool.id)
            torch._C._cuda_releasePool(stream.device.index, _loops.pool.id)
        rc = end(body_stream.cuda_stream,
                 new.data_ptr() if new is not None else None, handle)
    native.check(rc, 'graph_while_end')
    # the ops after the loop were captured one body's increment on
    for ptr, p in drawn:
        native.check(offset_add(stream.cuda_stream, ptr, -p),
                     'graph_offset_add')
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    for inner, _ in records[nested:]:
        for k, n in inner.items():
            launches[k] -= n
    records.append(({k: n for k, n in launches.items() if n}, trips))


def loop_launches(graph):
    """The launches that the loops of ``graph`` ran in its replays since
    the last call, each body's launches times its trips: read from the
    trip counters (one host read each), added to the launch counts and
    returned with the trips of each loop, ({kernel: launches}, [trips]).
    The counters restart at 0."""
    total, trips = {}, []
    for body, counter in getattr(graph, 'loops', ()):
        n = int(counter)
        counter.zero_()
        trips.append(n)
        for k, m in body.items():
            total[k] = total.get(k, 0) + m * n
    kernel_tier.add_counts(total)
    return total, trips


def watch(flag, message):
    """Have the graph that :func:`capture` is capturing raise
    RuntimeError(``message``) once a replay has set ``flag``, a bool device
    tensor of one element that the captured step ORs into (made before the
    capture, so that no replay clears it): :func:`check_flags`."""
    flags = getattr(_loops, 'flags', None)
    if flags is None:
        raise RuntimeError('watch registers a flag only inside '
                           'core.graphs.capture')
    if not any(f is flag for f, _ in flags):
        flags.append((flag, message))


def check_flags(graph):
    """Raise RuntimeError with the message of the first flag of ``graph``
    (None: no graph) that a replay since the last check set, after clearing
    them all; one host read a flag, none for a graph without flags."""
    flags = getattr(graph, 'flags', None) or ()
    for flag, message in flags:
        if bool(flag):
            for f, _ in flags:
                f.zero_()
            raise RuntimeError(message)
