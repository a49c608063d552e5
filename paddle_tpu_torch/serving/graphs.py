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

Launch counts (`ops.kernel_tier`) are counted where a wrapper launches, in
Python, so a replay would count nothing and a capture would count launches
that never ran. A `BoundStep` therefore takes back the counts its capture
made and adds them again on every replay: the counts stay what the device
ran.

Outputs live outside the graphs' pool (each call copies its results into
them), because graphs that share a pool reuse each other's scratch: an
output in the pool would be overwritten by the next replay of another
graph, which the engine's admissions run while a speculative round's
results wait to be read.
"""
import gc

import numpy as np
import torch

from ..ops import kernel_tier

__all__ = ['BoundStep']

_ALIGN = 16     # bytes between feeds in the staging buffers
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
        self.specs = [(tuple(int(n) for n in shape), np.dtype(dtype))
                      for shape, dtype in feeds]
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
        self._staged, self.inputs = [], []
        for (shape, dtype), off in zip(self.specs, offsets):
            nbytes = int(np.prod(shape)) * dtype.itemsize
            self._staged.append(host[off:off + nbytes].view(dtype)
                                .reshape(shape))
            tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
            self.inputs.append(self._dev[off:off + nbytes].view(tdtype)
                               .view(shape))
        self.inputs = tuple(self.inputs)
        self.outputs = None
        self._graph = None
        self._copied = torch.cuda.Event() if cuda else None
        self.captured = False
        self.replays = 0
        self.launches = {}

    def __call__(self, *arrays):
        if len(arrays) != len(self.specs):
            raise ValueError('%s takes %d feeds, got %d'
                             % (self.name, len(self.specs), len(arrays)))
        arrays = [np.asarray(a) for a in arrays]
        for i, (a, (shape, dtype)) in enumerate(zip(arrays, self.specs)):
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(
                    '%s: feed %d must be %s %s, got %s %s — a bound '
                    'signature takes exactly the shapes and dtypes it was '
                    'bound at' % (self.name, i, dtype, shape, a.dtype,
                                  a.shape))
        if self._copied is not None:
            # the previous call's copy must have read the staging buffer
            # before it is overwritten
            self._copied.synchronize()
        for staged, a in zip(self._staged, arrays):
            staged[...] = a
        self._dev.copy_(self._host, non_blocking=True)
        if self._copied is None:
            self._write(self.fn(*self.inputs))
            return self.outputs
        self._copied.record()
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.replays += 1
        kernel_tier.add_counts(self.launches)
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
        graph = torch.cuda.CUDAGraph()
        before = kernel_tier.launch_counts()
        # no cyclic collection inside the capture: freeing another graph or
        # pinned memory there is an operation the capture does not permit
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self._write(self.fn(*self.inputs))
        except Exception as e:
            raise RuntimeError('capturing %s as a CUDA graph failed: %s'
                               % (self.name, e)) from e
        finally:
            if gc_on:
                gc.enable()
        after = kernel_tier.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        # the capture recorded these launches; the device ran none of them
        kernel_tier.add_counts({k: -n for k, n in self.launches.items()})
        self._graph = graph
        self.captured = True
