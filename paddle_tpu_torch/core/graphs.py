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
  caller's generators registered with the graph. A capture that fails
  raises: nothing runs eagerly on the card in place of a replay.
- Launch counts (`ops.kernel_tier`) are counted in Python where a wrapper
  launches, so a capture counts launches that never ran. :func:`capture`
  takes them back and returns them; the owner adds them again on every
  replay (:func:`replay`), so the counts stay what the device ran.

The two owners warm up differently before their capture. A decode
signature is idempotent in the state it writes, so `BoundStep` calls it
twice on a side stream. A training step is not: its warm-up is the one
real step that `Executor.bind` takes anyway, run on the stream that then
captures the next one.
"""
import gc

import numpy as np
import torch

from ..ops import kernel_tier

__all__ = ['FeedBuffer', 'capture', 'replay']

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
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
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
    return graph, launches


def replay(graph, launches):
    """Replay ``graph`` and count the launches it runs."""
    graph.replay()
    kernel_tier.add_counts(launches)
