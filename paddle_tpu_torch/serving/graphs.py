"""Bound signatures: the port's counterpart of `Executor.bind`.

The JAX engine compiles each program it dispatches once, at a fixed feed
signature, and then pays "state staging + one compiled call" a token
(paddle_tpu/serving/generate.py, `Executor.bind` in paddle_tpu/executor.py).
PyTorch runs eagerly, one Python-launched op at a time, so on the card the
counterpart is a CUDA graph: the whole step captured once and replayed.

A `BoundStep` wraps a function of device tensors and the shapes and dtypes
of its feeds. It owns one device buffer that holds every feed and one host
staging buffer of the same bytes (pinned on the card), so a call costs one
host-to-device copy. Its outputs are static tensors too, written by every
call and read by the caller before the step's next call.

- **On a CUDA device** the first call runs the function eagerly on a side
  stream (twice: the kernels build, the FFN's and flash's route plans
  settle), captures it with ``torch.cuda.graph`` into the engine's shared
  memory ``pool`` and replays; every later call stages the feeds and
  replays. A capture that fails raises, and so does a feed of another
  shape or dtype: nothing runs eagerly on the card after the capture.
- **On the CPU** every call runs the function on the same static buffers,
  so the CPU tests drive the same feed plumbing the card does.

The function must be idempotent in the state it writes (the KV cache): the
warm-up calls and the first replay run it on the same feeds. Every decode
signature is: it writes rows whose values depend only on the feeds and on
rows it does not write.

Feed staging, capture and the launch counts of a replay are the shared
machinery of core/graphs.py.

Outputs live outside the graphs' pool (each call copies its results into
them), because graphs that share a pool reuse each other's scratch: an
output in the pool would be overwritten by the next replay of another
graph, which the engine's admissions run while a speculative round's
results wait to be read.
"""
import numpy as np
import torch

from ..core import graphs

__all__ = ['BoundStep']

_WARMUP_CALLS = 2


class BoundStep(object):
    """``fn(*feed_tensors)`` -> tuple of tensors, bound to fixed feeds.

    ``feeds`` is a sequence of (shape, numpy dtype) pairs; ``device`` the
    torch device; ``pool`` a ``torch.cuda.graph_pool_handle()`` that the
    engine's other bound steps share (None: a pool of its own). A call
    takes numpy arrays of exactly those shapes and dtypes and returns the
    static output tensors, valid until this step's next call.

    Counters: ``captured`` (a graph exists), ``replays``, and
    ``launches`` (kernel launches a replay runs, by kernel name)."""

    def __init__(self, fn, feeds, device, pool=None, name='bound step'):
        self.fn = fn
        self.name = name
        self.device = torch.device(device)
        self.pool = pool
        self._feeds = graphs.FeedBuffer(feeds, self.device)
        self.specs = self._feeds.specs
        self.inputs = self._feeds.inputs
        self.outputs = None
        self._graph = None
        self.captured = False
        self.replays = 0
        self.launches = {}

    def __call__(self, *arrays):
        arrays = [np.asarray(a) for a in arrays]
        self._feeds.check(self.name, arrays)
        self._feeds.stage(arrays)
        if self.device.type != 'cuda':
            self._write(self.fn(*self.inputs))
            return self.outputs
        if self._graph is None:
            self._capture()
        graphs.replay(self._graph, self.launches)
        self.replays += 1
        return self.outputs

    def _write(self, results):
        if self.outputs is None:
            self.outputs = tuple(torch.empty_like(r) for r in results)
        for out, r in zip(self.outputs, results):
            out.copy_(r)

    def _capture(self):
        """Warm up eagerly on a side stream, then capture one call of the
        function (and the copies into the static outputs)."""
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_CALLS):
                results = self.fn(*self.inputs)
        stream.wait_stream(side)
        # outside the pool (see the module docstring), on the replay stream
        self.outputs = tuple(torch.empty_like(r) for r in results)
        del results
        self._graph, self.launches = graphs.capture(
            lambda: self._write(self.fn(*self.inputs)), pool=self.pool,
            name=self.name)
        self.captured = True
