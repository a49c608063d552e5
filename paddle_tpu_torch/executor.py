"""Executor and Scope: run a Program on the card.

The port's own copy of paddle_tpu/executor.py's `Scope`, `global_scope`,
`scope_guard`, `Executor.run`, `Executor.bind` (with `BoundProgram`) and
`Executor.run_fused`. ``Executor(place=None)`` runs on ``cuda:0``
(framework.resolve_device); ``Executor(CPUPlace())`` on the CPU, where
every kernel wrapper takes its plain version.

- ``run(program, feed, fetch_list, scope, return_numpy)`` prepares the feed
  (a float64 array becomes float32 when the variable is float32, ints take
  the variable's int type), reads the persistable state the program needs
  from the scope (a variable the startup program has not written raises
  RuntimeError naming it), runs the program's run plan
  (core/lowering.py), writes the state it wrote back into the scope, and
  returns the fetches as numpy arrays (or, with ``return_numpy=False``, as
  tensors on the device; a fetched state variable is then a copy, since the
  optimizers update state in place). A bf16 fetch (an activation kept
  bf16 by the AMP pass) comes back as a float32 array.
- Ragged feeds: a feed may be an ``(array, lod)`` pair (offsets, or
  lengths as ``create_lod_tensor`` takes them) or a `LoDTensor`; its LoD
  must end at the array's leading dimension (else ValueError). The LoDs
  of the feeds, and those the scope keeps for state a run wrote
  (``scope._lods``), are static in the plan (core/lowering.py); a fetch
  that carries a LoD comes back as a `FetchedTensor`, a numpy array with
  ``.lod()`` and ``.recursive_sequence_lengths()`` (with
  ``return_numpy=False`` too: the LoD is the point of fetching it, as in
  the JAX executor).
- Run plans are cached per executor by (program, version, feed signature,
  fetch list, LoDs, values of the shape-bearing feeds), the key the JAX
  executor's `_feed_signature` builds, in a least-recently-used cache of
  ``PADDLE_EXECUTOR_CACHE_SIZE`` entries (default 64, read at each
  insert; the JAX executor's `_LRUCache`): the op list, the lowerings and
  the state names are resolved once per key, and constants are built
  once per plan.
- The RNG stream is counted as the JAX executor counts it (`_run_seed`,
  `_next_program_run`, core/lowering.py `_needs_rng`): a seeded program
  draws from (random_seed, its own run index), so it replays its
  trajectory from a fresh build; an unseeded one from the executor's run
  counter.
- ``bind(program, feed, fetch_list, scope)`` takes one step and returns a
  `BoundProgram` of that feed signature; ``run_fused(program, feed_list,
  fetch_list, scope, steps=)`` runs K steps over K staged batches. Both
  run a plan bound to one scope (`_BoundPlan`). On the card its first
  step is eager, on a side stream, and the step after it is captured as
  one CUDA graph (core/graphs.py): the forward, the ``backward`` meta-op's
  autograd and the optimizer; every later step stages the feeds (one copy),
  re-seeds the run's generators, replays and reads the fetches once. On
  the CPU the same object runs the plan eagerly through the same staging.
  A bound plan holds one LoD: `bind` takes the LoD of its feed, and
  ``run_fused`` splits a list of feeds whose LoDs differ into runs of
  consecutive feeds of one LoD, in order, each on its own bound plan.
- Control flow under ``bind`` and ``run_fused``: a StaticRNN or DynamicRNN
  (``recurrent``) has a trip count fixed by the plan's key, and is
  captured whole. A ``while`` without a gradient runs until its condition
  reads false, as ``run()`` runs it (``lax.while_loop``: a
  ``max_trip_count`` does not cut it): in the capture it is one WHILE
  node of the step's graph, whose body the device runs while the
  condition holds, with no host read (core/graphs.py `run_while`); a body
  that draws random numbers draws in each trip what ``run()`` draws in
  it. Under the ``backward`` meta-op a ``while`` runs its bound's
  iterations, finished ones masked, in ``run()`` as in the capture. Where
  a bound inferred from an array's capacity may cut the loop, the capture
  ORs the final condition into a device flag, read after each ``bind``
  call and each ``run_fused`` run, which raises RuntimeError when it is
  set (core/graphs.py `check_flags`).

The scope holds torch tensors on the run's device. State given as numpy
arrays (or tensors elsewhere) is copied there on first read and cached
back into the scope; the optimizer ops then update those tensors in
place (core/lowering.py copies an output that would share storage with
state a later op updates in place, where it is read after the update).
`run_async`, `precompile`, `explain`, donation and segmented host ops
wait for later slices.

Observability, on the JAX executor's series (docs/observability.md):
``run`` opens a head-sampled step trace (trace.py `step_scope`) and the
``run`` span, counts ``executor_run_total`` and observes
``executor_run_seconds``; a plan-cache hit counts ``compile_cache_hit``
and is a goodput dispatch of kind ``run`` (goodput.py: CUDA events around
it on the card), a miss counts ``compile_cache_miss`` (``_bypass`` without
the cache), and the plan's build with its first run (the ``compile``
span) goes into ``compile_seconds`` and ``goodput.note_compile``; that
first run registers the plan's cost (analysis.py `recording`). Numpy
feeds count ``feed_host_bytes``, numpy fetches ``fetch_host_bytes``, and
every run, bind and fused call notes its program to the flight recorder
(``blackbox.note_step``). ``bind`` takes its step as ``run`` counts one; a
``BoundProgram`` call counts ``executor_bound_run_total`` and is a
dispatch of kind ``bound``. ``run_fused`` counts
``executor_run_fused_total`` in the ``run_fused`` span
(``executor_run_fused_seconds``); a call whose bound plan is new is a
miss, and its first step (eager, with the capture on the card) a compile;
any other call is a hit. The steps after a new plan's first, and every
step of a hit, are one dispatch of kind ``fused``. Counts that differ
from the JAX executor's by design:

- ``compile_cache_hit``/``_miss`` of ``run_fused``: the JAX executor
  compiles a scan of its own per (K, steps) signature, so its first
  ``run_fused`` of a signature is a miss even after ``bind`` compiled
  the step; here ``bind`` and ``run_fused`` share one bound plan a
  (signature, scope), so a ``run_fused`` after a ``bind`` of its
  signature is a hit.
- ``bind`` of a signature that ``run`` already cached: the JAX bind's
  ``run`` dispatches the cached executable (a goodput dispatch of kind
  ``run``); here the plan is new to the scope, so the step is its eager
  first step and its capture, counted in ``compile_seconds`` with no
  dispatch.
- goodput of a ``run_fused`` call on a new plan: the JAX executor
  compiles its scan and runs every step in one call, all of it compile
  time; here only the first step is, and the rest are a ``fused``
  dispatch of one step fewer.
- ``compile_cache_eviction``: the JAX executor also keeps a process-wide
  cache of 64 compiled entries beside each executor's, whose evictions
  count too; the port's plan cache is the executor's alone.
- the donation and segmented-execution series are not emitted: their
  features wait for later slices.

Health and faults (flags.py, resilience.py, health.py; the JAX
executor's hooks): with ``FLAGS_check_nan_inf`` every ``run`` checks the
state it wrote and its fetches for NaN or Inf after the scope takes them
(`check_nan_inf`), and raises naming them (``nan_check_trigger_total``);
with ``PADDLE_NAN_LOCALIZE=1`` too, the run keeps a copy of the state it
writes and replays the step from it to name the first op that made one
(analysis.py; the error carries ``nonfinite_localization``). A plan bound
with the flag on computes the check inside its step (in the CUDA graph on
the card): a flag a variable, summed over a call's steps and read after
the call, so ``bind`` calls and ``run_fused`` windows name what ``run()``
names. ``FLAGS_debug_nans`` runs ``run`` under anomaly mode and refuses a
CUDA graph; ``FLAGS_benchmark`` synchronizes after each ``run`` on the
card (``executor_sync_seconds``). A plan's build is the ``compile`` fault
site and each dispatch the ``run`` site (a bound call's or a fused
window's before its first step), retried under `resilience.RetryPolicy`;
a run that failed after writing state in place is not re-run (a retry
re-seeds the run's generators, so it draws what the failed try drew).
Each run's seed stays on ``program._last_run_seed``.
"""
import collections
import math
import os
import threading
import time
import weakref

import numpy as np
import torch

from . import analysis, blackbox, flags, goodput, monitor, resilience, trace
from . import ops  # noqa: F401  (registers every op's lowering)
from .core import graphs, lowering
from .core.lod import lengths_from_offsets, normalize_lod
from .core.registry import get_op, has_op
from .core.selected_rows import SelectedRows
from .core.types import torch_dtype
from .framework import Program, Variable, default_main_program, resolve_device

__all__ = ['Executor', 'BoundProgram', 'FetchedTensor', 'Scope',
           'global_scope', 'scope_guard']


class _TensorShim(object):
    """A LoDTensor-like view of a scope entry: numpy conversion and set()."""

    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def __array__(self, dtype=None, copy=None):
        arr = _to_numpy(self._scope._vars[self._name])
        return arr.astype(dtype) if dtype is not None else arr

    def shape(self):
        return list(self._scope._vars[self._name].shape)

    def set(self, value, place=None):
        self._scope._vars[self._name] = np.array(value)

    def set_lod(self, lod):
        self._scope._lods[self._name] = normalize_lod(lod)

    def lod(self):
        return [list(l) for l in self._scope._lods.get(self._name, ())]


class _VarShim(object):
    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return _TensorShim(self._scope, self._name)


class Scope(object):
    """A flat name -> value store of persistable state (torch tensors, or
    numpy arrays not yet read by a run); ``_lods`` keeps the LoD of state
    a run wrote with one."""

    def __init__(self):
        self._vars = {}
        self._lods = {}

    def get(self, name, default=None):
        return self._vars.get(name, default)

    def set(self, name, value):
        self._vars[name] = value

    def update(self, d):
        self._vars.update(d)

    def has(self, name):
        return name in self._vars

    def names(self):
        return sorted(self._vars)

    def drop(self, name):
        self._vars.pop(name, None)

    def find_var(self, name):
        if name not in self._vars:
            return None
        return _VarShim(self, name)

    def var(self, name):
        self._vars.setdefault(name, None)
        return _VarShim(self, name)

    def new_scope(self):
        return Scope()


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope():
    return _scope_stack[-1]


class scope_guard(object):
    def __init__(self, scope):
        self._scope = scope

    def __enter__(self):
        _scope_stack.append(self._scope)

    def __exit__(self, *a):
        _scope_stack.pop()


def _to_numpy(v):
    """A numpy copy of a scope or fetched value; a bf16 tensor (a kept AMP
    activation) comes back as float32, exactly: numpy has no bf16."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.detach().to('cpu', copy=True).numpy()
    return np.asarray(v)


class FetchedTensor(np.ndarray):
    """A fetched numpy array with its LoD (the JAX executor's
    `FetchedTensor`)."""

    def lod(self):
        return [list(l) for l in getattr(self, '_lod', ())]

    def recursive_sequence_lengths(self):
        return [list(lengths_from_offsets(l))
                for l in getattr(self, '_lod', ())]


def _fetched(arr, lod):
    out = np.asarray(arr).view(FetchedTensor)
    out._lod = normalize_lod(lod)
    return out


def _split_lod_feed(value):
    """(value, LoD) of a feed: an ``(array, lod)`` pair, a `LoDTensor` (or
    anything with a ``lod()`` method that is not an array), a
    `FetchedTensor`, or a dense value with LoD ()."""
    if isinstance(value, tuple) and len(value) == 2 and \
            isinstance(value[1], (list, tuple)):
        return value[0], normalize_lod(value[1])
    if isinstance(value, FetchedTensor):
        return np.asarray(value), normalize_lod(value.lod())
    lod_m = getattr(value, 'lod', None)
    if callable(lod_m) and not isinstance(value, (np.ndarray, torch.Tensor)):
        return np.asarray(value), normalize_lod(lod_m())
    return value, ()


def _run_seed(random_seed, program_runs, global_counter):
    """The seed of one run's generator: (random_seed, the program's run
    index) for a seeded program, so masks vary from step to step yet a
    fresh build of it replays them; the executor's run counter for an
    unseeded one."""
    if random_seed:
        return (int(random_seed) * 1000003 + int(program_runs)) % (2 ** 63)
    return global_counter % (2 ** 31)


def _next_program_run(program):
    n = getattr(program, '_rng_run_counter', 0) + 1
    program._rng_run_counter = n
    return n


class _LRUCache(object):
    """The bounded plan cache (the JAX executor's `_LRUCache`): a hit moves
    its key to the back, an insert past the cap evicts from the front. The
    cap is ``PADDLE_EXECUTOR_CACHE_SIZE`` (default 64), read at each
    insert. The small dict surface: ``get``, ``[k] = v``, ``in``, ``len``,
    ``iter``, ``items``, ``clear``. An evicted plan that holds a CUDA
    graph lets go of it; a `BoundProgram` holding the plan keeps
    working. Each eviction counts ``compile_cache_eviction``."""

    def __init__(self):
        self._d = collections.OrderedDict()
        self._lock = threading.RLock()

    @property
    def cap(self):
        try:
            return max(1, int(os.environ.get('PADDLE_EXECUTOR_CACHE_SIZE',
                                             '64')))
        except ValueError:
            return 64

    def get(self, key, default=None):
        with self._lock:
            try:
                self._d.move_to_end(key)
            except KeyError:
                return default
            return self._d[key]

    def __setitem__(self, key, value):
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.cap:
                self._d.popitem(last=False)
                monitor.inc('compile_cache_eviction')

    def __contains__(self, key):
        with self._lock:
            return key in self._d

    def __len__(self):
        with self._lock:
            return len(self._d)

    def __iter__(self):
        with self._lock:
            return iter(list(self._d))

    def items(self):
        with self._lock:
            return list(self._d.items())

    def clear(self):
        with self._lock:
            self._d.clear()


class _Entry(object):
    """A cached run plan: its function and plan, the state it reads and
    writes, whether it draws random numbers, which fetches are state
    variables, and its plans bound to a scope (`_BoundPlan`, by scope)."""

    def __init__(self, fn, plan, read_names, written_names, needs_rng,
                 fetch_names, state_fetches, device):
        self.fn = fn
        self.fp = None          # the program's fingerprint (goodput's key)
        self.plan = plan
        self.read_names = read_names
        self.written_names = written_names
        self.needs_rng = needs_rng
        self.fetch_names = tuple(fetch_names)
        self.state_fetches = state_fetches
        self.device = device
        self.bound = weakref.WeakKeyDictionary()


def _numpy_dtype(tdtype):
    try:
        return torch.empty(0, dtype=tdtype).numpy().dtype
    except TypeError:
        raise ValueError('a bound feed of dtype %s has no numpy form'
                         % tdtype) from None


def _widens(program, name, dtype):
    """Whether a state value of ``dtype`` is an int32 copy of a variable
    that ``program`` declares int64."""
    if dtype != torch.int32:
        return False
    var = program.global_block().vars.get(name)
    return var is not None and var.dtype == np.dtype('int64')


class _BoundPlan(object):
    """A run plan bound to one scope at one feed signature: the static
    feeds (core/graphs.py `FeedBuffer`), the state tensors the plan reads
    and writes (the scope's own, whose addresses a graph holds: the
    optimizers update them in place, and state written as a new tensor is
    copied into its tensor at the end of the step), the fetches' static
    copies, its generators and, on the card, its CUDA graph.

    ``step(scope)`` runs one program run on the staged feeds: the state
    stages (a read name whose scope value is no longer its tensor, after a
    ``load_params`` or a user's ``scope.set``, is copied into that tensor
    and the scope bound back to it), the run is counted and the generators
    seeded as ``run()`` counts and seeds them, and the plan runs: on the
    CPU eagerly; on the card the first step eagerly on a side stream, the
    next one captured on that stream and every step a replay."""

    def __init__(self, exe, entry, program, feed, lods, kind):
        self.exe = exe
        self.entry = entry
        self.program = program
        self.kind = kind        # analysis kind of its first step
        self.lods = dict(lods)          # the LoD of each ragged feed
        self.names = sorted(feed)
        self.feeds = graphs.FeedBuffer(
            [(tuple(feed[n].shape), _numpy_dtype(feed[n].dtype))
             for n in self.names], exe.device)
        self.feed = dict(zip(self.names, self.feeds.inputs))
        self.state = None       # {name: tensor} the plan reads
        self.written = None     # {name: tensor} the state the plan writes
        self.outputs = None     # the fetches' static copies
        self.rng = lowering.RunRNG(entry.plan, exe.device) \
            if entry.needs_rng else None
        self.cuda = exe.device.type == 'cuda'
        self.graph = None
        self.launches = {}
        self.captures = 0
        self.replays = 0
        # FLAGS_check_nan_inf on at the first step: the names checked and
        # a device vector each step adds its `_finite_flags` to (in the
        # graph on the card), zeroed before each call
        self.nan_names = None
        self.nan_acc = None

    def stage(self, feed):
        """Copy ``feed`` ({name: numpy array or tensor}, exactly the bound
        names, shapes and dtypes, else ValueError) into the static feeds. A
        ragged feed may come with its LoD (an ``(array, lod)`` pair or a
        `LoDTensor`), which must be the bound one, or bare."""
        if sorted(feed) != self.names:
            raise ValueError('a bound program takes the feeds %s, got %s'
                             % (self.names, sorted(feed)))
        values = []
        for n in self.names:
            v, lod = _split_lod_feed(feed[n])
            if lod and lod != self.lods.get(n, ()):
                raise ValueError(
                    'a bound program holds feed %r at the LoD %s, got %s'
                    % (n, [list(l) for l in self.lods.get(n, ())],
                       [list(l) for l in lod]))
            values.append(v if isinstance(v, torch.Tensor) else
                          np.asarray(v))
        self.feeds.check('bound program', values)
        self.feeds.stage(values)

    def step(self, scope):
        debug = flags.get_flags('debug_nans')
        if debug and self.cuda:
            raise RuntimeError(
                'FLAGS_debug_nans cannot hold under a CUDA graph: anomaly '
                'mode reads each gradient on the host, which a capture or a '
                'replay cannot do. Use Executor.run, or FLAGS_check_nan_inf, '
                'which bind and run_fused check inside the graph')
        self._stage_state(scope)
        rng = self.exe._seed_run(self.program, self.entry, self.rng)
        if debug:
            with torch.autograd.detect_anomaly(check_nan=True):
                self._run(rng)
        else:
            self._run(rng)
        scope.update(self.written)
        _keep_lods(scope, self.entry)

    def _run(self, rng):
        if not self.cuda:
            if self.outputs is None:
                self._first(rng)
            else:
                self._body(rng)
        elif self.graph is None:
            if self.captures:
                raise RuntimeError('the capture of this bound plan failed '
                                   'at an earlier call; it does not run '
                                   'eagerly in place of a replay')
            self._capture(rng)
        else:
            graphs.replay(self.graph, self.launches)
            self.replays += 1

    def begin_check(self):
        """Zero the check's vector before a call's steps."""
        if self.nan_acc is not None:
            self.nan_acc.zero_()

    def check(self):
        """``FLAGS_check_nan_inf`` after a call: raise naming every state
        variable or fetch that was non-finite after any of its steps (the
        vector the steps added to; for a plan built with the flag off, the
        values after the last step, checked now)."""
        if not flags.get_flags('check_nan_inf') or self.outputs is None:
            return
        if self.nan_acc is not None:
            _raise_nonfinite(self.nan_names, self.nan_acc)
            return
        check_nan_inf(self.written, dict(zip(self.entry.fetch_names,
                                             self.outputs)),
                      self.exe.device)

    def fetches(self, return_numpy):
        """The last step's fetches: numpy arrays, or copies on the device
        (the static copies are overwritten by the next step); a fetch with
        a LoD is a `FetchedTensor`."""
        return _fetch_values(self.entry, self.outputs, return_numpy,
                             [True] * len(self.outputs))

    def _stage_state(self, scope):
        if self.state is None:
            self.state = {n: self.exe._state_value(scope, n, self.program)
                          for n in self.entry.read_names}
            return
        for n, t in self.state.items():
            v = scope.get(n)
            if v is t:
                continue
            if v is None:
                raise RuntimeError('persistable variable %r left the scope '
                                   'of a bound program' % n)
            src = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.asarray(v))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError('%r is %s in the scope, the bound program '
                                 'holds %s' % (n, tuple(src.shape),
                                               tuple(t.shape)))
            t.copy_(src)
            scope.set(n, t)

    @property
    def fresh(self):
        """Whether no step has run yet (the next one is the first: eager,
        then on the card the capture)."""
        return self.outputs is None and not self.captures

    def _first(self, rng):
        """The first step, eagerly: it sizes the fetches' static copies and
        the tensors of state the plan writes without reading, and
        registers the plan's cost (analysis.py)."""
        with analysis.recording(self.program, self.kind, self.feed,
                                self.state, self.exe.device):
            fetches, new_state = self.entry.fn(self.feed, self.state, rng)
        self.outputs = tuple(torch.empty(f.shape, dtype=f.dtype,
                                         device=f.device) for f in fetches)
        self.written = {}
        for n, v in new_state.items():
            t = self.state.get(n)
            if t is None:
                t = torch.empty(v.shape, dtype=v.dtype, device=v.device)
            elif (tuple(v.shape), v.dtype) != (tuple(t.shape), t.dtype):
                raise ValueError('%r is written as %s %s but read as %s %s'
                                 % (n, v.dtype, tuple(v.shape), t.dtype,
                                    tuple(t.shape)))
            self.written[n] = t
        if flags.get_flags('check_nan_inf'):
            self.nan_names = list(self.written) + list(self.entry.fetch_names)
            self.nan_acc = torch.zeros(len(self.nan_names),
                                       dtype=torch.float32,
                                       device=self.exe.device)
        self._write(fetches, new_state)

    def _body(self, rng):
        self._write(*self.entry.fn(self.feed, self.state, rng))

    def _write(self, fetches, new_state):
        # the fetches first: a fetch may alias state written below
        for out, f in zip(self.outputs, fetches):
            out.copy_(f)
        for n, v in new_state.items():
            t = self.written[n]
            if v is not t:
                t.copy_(v)
        if self.nan_acc is not None:
            self.nan_acc.add_(_finite_flags(
                list(self.written.values()) + list(self.outputs),
                self.exe.device))

    def _capture(self, rng):
        """The first step eagerly on a side stream, then the next one
        captured on it: the stream whose cuBLAS workspace and autograd
        streams the warm-up set up."""
        dev = self.exe.device
        self.captures += 1
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._first(rng)
        self.graph, self.launches = graphs.capture(
            lambda: self._body(self.rng), stream=side,
            name='the run plan of program %d' % self.program._uid,
            generators=self.rng.generators() if self.rng else ())
        stream.wait_stream(side)


class BoundProgram(object):
    """A fixed-signature handle from `Executor.bind`: each call takes a
    feed of exactly the bound names, shapes and dtypes (else ValueError)
    and runs one step of the program, one program run of the counted RNG
    stream. On the card a call stages the feed (one host-to-device copy,
    or a device-to-device copy of device tensors), stages the state,
    re-seeds the generators, replays the captured graph and reads the
    fetches once; ``return_numpy=False`` hands out copies. ``first_out``
    holds the fetches of the step that ``bind`` took, ``example_feed`` the
    prepared feed it took (device tensors, which a call copies on the
    device), ``fetch_names`` the fetch list. ``replays``, ``captures`` and
    ``launches`` (kernel launches a replay runs) count the graph's use.
    Calls are not thread-safe against each other."""

    __slots__ = ('_plan', '_scope', 'first_out', 'fetch_names',
                 'example_feed')

    def __init__(self, plan, scope, first_out, example_feed):
        self._plan = plan
        self._scope = scope
        self.first_out = first_out
        self.fetch_names = plan.entry.fetch_names
        self.example_feed = example_feed

    def __call__(self, feed, return_numpy=True):
        plan = self._plan
        monitor.inc('executor_bound_run_total')
        plan.stage(feed)
        blackbox.note_step(plan.program)
        _run_site()
        plan.begin_check()
        with goodput.timed(plan.entry.fp, 'bound', plan.exe.device):
            plan.step(self._scope)
        graphs.check_flags(plan.graph)
        plan.check()
        return plan.fetches(return_numpy)

    def loop_launches(self):
        """({kernel: launches}, [trips]) that the ``while`` loops of the
        replays since the last call ran (core/graphs.py `loop_launches`: a
        replay counts a loop body's launches not at all, this adds them
        times the trips; one host read a loop). On the CPU, where the
        loops run eagerly and count as they launch, ({}, [])."""
        if self._plan.graph is None:
            return {}, []
        return graphs.loop_launches(self._plan.graph)

    @property
    def graph(self):
        return self._plan.graph

    @property
    def replays(self):
        return self._plan.replays

    @property
    def captures(self):
        return self._plan.captures

    @property
    def launches(self):
        return dict(self._plan.launches)


class Executor(object):
    """``Executor(place=None)``: None or a ``CUDAPlace`` runs on the card,
    ``CPUPlace()`` on the CPU."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._cache = _LRUCache()
        self._run_counter = 0

    def close(self):
        self._cache.clear()

    # ------------------------------------------------------------------
    @staticmethod
    def _feed_signature(feed):
        return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in feed.items()))

    def _prepare_feed(self, program, feed):
        """({name: tensor on the device}, {name: LoD}): numpy, lists,
        tensors and ragged feeds (`_split_lod_feed`) in; a value whose dtype
        differs from its variable's is converted as the JAX executor
        converts it (ints to the variable's int type, floats to its float
        type, float64 always). A LoD must end at its array's leading
        dimension. The bytes of feeds given on the host (not as tensors on
        the device) count ``feed_host_bytes``."""
        out, lods = {}, {}
        host_bytes = 0
        gb = program.global_block()
        for name, value in feed.items():
            value, lod = _split_lod_feed(value)
            var = gb._find_var_recursive(name)
            t = value if isinstance(value, torch.Tensor) else \
                torch.from_numpy(np.asarray(value))
            if var is not None and var.dtype is not None:
                tgt = torch_dtype(var.dtype)
                src_f, tgt_f = t.dtype.is_floating_point, \
                    tgt.is_floating_point
                if t.dtype != tgt and (src_f == tgt_f or
                                       t.dtype == torch.float64):
                    t = t.to(tgt)
            if lod:
                if t.dim() == 0 or lod[-1][-1] != t.shape[0]:
                    raise ValueError(
                        "feed %r: LoD %s does not cover the array's leading "
                        "dimension %s: the offsets' last entry must equal "
                        "it (pass lengths through create_lod_tensor or "
                        "recursive_sequence_lengths)"
                        % (name, [list(l) for l in lod],
                           t.shape[0] if t.dim() else None))
                lods[name] = lod
            if not isinstance(value, torch.Tensor) or \
                    value.device != self.device:
                host_bytes += int(t.numel()) * t.element_size()
            out[name] = t.to(self.device)
        if host_bytes:
            monitor.inc('feed_host_bytes', host_bytes)
        return out, lods

    @staticmethod
    def _static_feed_names(program):
        """The feeds read through an op's ``static_inputs`` slot, whose
        values set a layout (cached per program version)."""
        cached = getattr(program, '_static_names_cache', None)
        if cached is not None and cached[0] == program._version:
            return cached[1]
        names = set()
        for block in program.blocks:
            for op in block.ops:
                if has_op(op.type):
                    for slot in get_op(op.type).static_inputs:
                        names.update(op.input(slot))
        program._static_names_cache = (program._version, names)
        return names

    def _statics(self, program, feed):
        """{name: numpy} of the shape-bearing feeds among ``feed``."""
        return {n: _to_numpy(feed[n])
                for n in self._static_feed_names(program) if n in feed}

    @staticmethod
    def _static_lods(scope, lods):
        """The plan's static LoDs: those the scope keeps for state, then the
        feeds'."""
        out = {n: l for n, l in scope._lods.items() if l}
        out.update(lods)
        return out

    def _state_value(self, scope, name, program):
        """The scope's value of ``name`` as a tensor on the device, cached
        back into the scope (a copy: the optimizers update state in place,
        so the scope never shares memory with the caller's array). An
        int32 value of a variable ``program`` declares int64 is widened:
        the JAX package runs with x64 off and holds such state (the
        schedules' step counter) as int32."""
        v = scope.get(name)
        if v is None:
            raise RuntimeError(
                "persistable variable %r is not initialized in the scope — "
                "run the startup program first" % name)
        if isinstance(v, torch.Tensor) and v.device == self.device and \
                not _widens(program, name, v.dtype):
            return v
        if isinstance(v, torch.Tensor):
            t = v.detach().to(self.device, copy=True)
        else:
            t = torch.from_numpy(np.array(v)).to(self.device)
        if _widens(program, name, t.dtype):
            t = t.to(torch.int64)
        scope.set(name, t)
        return t

    @staticmethod
    def _read_before_write(program, read, written, feed_names, fetch_names):
        """A persistable var written earlier in the program than any read
        (a startup program's init ops) need not come from the scope."""
        first_write, first_read = {}, {}
        for idx, op in enumerate(program.global_block().ops):
            for n in lowering._reads(op):
                first_read.setdefault(n, idx)
            for n in op.output_arg_names:
                first_write.setdefault(n, idx)
        end = len(program.global_block().ops)
        for n in fetch_names:
            first_read.setdefault(n, end)
        return [n for n in read if n not in feed_names and not (
            n in first_write and first_write[n] < first_read.get(n, end + 1))]

    def _build(self, program, feed_names, fetch_names, lods, statics):
        read, written = lowering.analyze_state(program, fetch_names)
        needed = self._read_before_write(program, read, written, feed_names,
                                         fetch_names)
        fn, plan = lowering.build_fn(program, fetch_names, needed, written,
                                     self.device, static_lods=lods,
                                     static_feed=statics)
        needs_rng = any(lowering._needs_rng(d, op)
                        for d, op in plan.all_ops())
        state = set(read) | set(written)
        return _Entry(fn, plan, needed, written, needs_rng, fetch_names,
                      [n in state for n in fetch_names], self.device)

    def _entry(self, program, feed, fetch_names, lods=None, statics=None,
               use_program_cache=True):
        """(the cached run plan of (program, its version, the feed
        signature, the fetch list, the static LoDs, the values of the
        shape-bearing feeds), whether it was built now)."""
        lods, statics = lods or {}, statics or {}
        key = (program._uid, program._version, self._feed_signature(feed),
               tuple(fetch_names), tuple(sorted(lods.items())),
               tuple(sorted((k, v.dtype.str, v.shape, v.tobytes())
                            for k, v in statics.items())))
        entry = self._cache.get(key) if use_program_cache else None
        fresh = entry is None
        if fresh:
            def _build():
                resilience.maybe_fault('compile')
                return self._build(program, set(feed), fetch_names, lods,
                                   statics)
            try:
                entry = _build()
            except Exception as e:      # noqa: BLE001 — classified inside
                entry = resilience.retry_after(e, _build, site='compile')
            entry.fp = program._fingerprint()
            if use_program_cache:
                self._cache[key] = entry
        return entry, fresh

    def _seed_run(self, program, entry, rng):
        """Count one run of ``program`` as the JAX executor counts it;
        returns ``rng`` seeded for it, or None for a plan that draws
        nothing. The run's seed stays on ``program._last_run_seed`` (the
        JAX executor's ``_last_run_key``): NaN localization and a
        flight-recorder bundle replay the step with it."""
        self._run_counter += 1
        runs = _next_program_run(program)
        seed = _run_seed(program.random_seed, runs, self._run_counter)
        program._last_run_seed = seed
        if not entry.needs_rng:
            return None
        rng.seed(seed)
        return rng

    @staticmethod
    def _check_program(program, what):
        if program is None:
            program = default_main_program()
        if not isinstance(program, Program):
            raise TypeError('Executor.%s takes a Program, got %r'
                            % (what, type(program).__name__))
        return program

    @staticmethod
    def _fetch_names(fetch_list):
        return [v.name if isinstance(v, Variable) else v
                for v in (fetch_list or [])]

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True, use_program_cache=True):
        program = self._check_program(program, 'run')
        # the JAX executor's instrumentation: a head-sampled step trace,
        # the 'run' span and its histogram, and the run counted even when
        # it raises
        with trace.step_scope('step'):
            with monitor.timed_span('run', 'executor_run_seconds'):
                monitor.inc('executor_run_total')
                if analysis.profile_ops_active():
                    # op attribution: a fresh plan, op by op, each op synced
                    return analysis.run_profiled(self, program, feed,
                                                 fetch_list, scope,
                                                 return_numpy)
                return self._run_impl(program, feed, fetch_list, scope,
                                      return_numpy, use_program_cache)

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy,
                  use_program_cache=True, hook=None):
        """One run (module docstring); ``hook`` (an op profile's, from
        analysis.py) runs a fresh plan under it, counted in no cache
        series."""
        if scope is None:
            scope = global_scope()
        t_build = time.perf_counter()
        feed, lods = self._prepare_feed(program, feed or {})
        fetch_names = self._fetch_names(fetch_list)
        static_lods = self._static_lods(scope, lods)
        statics = self._statics(program, feed)
        entry, fresh = self._entry(program, feed, fetch_names, static_lods,
                                   statics, use_program_cache and hook is None)
        if hook is None:
            monitor.inc('compile_cache_hit' if not fresh else
                        'compile_cache_miss' if use_program_cache else
                        'compile_cache_bypass')
        state = {n: self._state_value(scope, n, program)
                 for n in entry.read_names}
        # generators of this run's own: a cached plan may run on two
        # threads at once
        rng = self._seed_run(program, entry, lowering.RunRNG(
            entry.plan, self.device) if entry.needs_rng else None)
        seed = program._last_run_seed
        blackbox.note_step(program)
        check = flags.get_flags('check_nan_inf')
        # PADDLE_NAN_LOCALIZE=1 with the check on: a copy of the state the
        # run writes, so that a trip replays the step from its pre-run
        # state (the run updates the scope's tensors in place)
        pre = _copies(state, entry.written_names) \
            if check and hook is None and \
            analysis.nan_localization_enabled() else None
        # a run that fails after an in-place write is not re-run
        writes = resilience.StateWrites(
            state[n] for n in entry.plan.inplace_names if n in state)
        attempts = [0]

        def _call():
            if attempts[0] and rng is not None:
                rng.seed(seed)          # a retry draws what the try drew
            attempts[0] += 1
            if flags.get_flags('debug_nans'):
                with torch.autograd.detect_anomaly(check_nan=True):
                    return entry.fn(feed, state, rng)
            return entry.fn(feed, state, rng)

        def _dispatch():
            resilience.maybe_fault('run')
            with goodput.timed(entry.fp, 'run', self.device):
                return _call()

        if hook is not None:
            with lowering.op_hook(hook):
                fetches, new_state = _call()
        elif fresh:
            # the plan's first run: with its build, the compile of the JAX
            # executor's first call, and where its cost registers
            with monitor.span('compile'), analysis.recording(
                    program, 'run', feed, state, self.device):
                try:
                    fetches, new_state = _call()
                except Exception as e:  # noqa: BLE001 — classified inside
                    fetches, new_state = resilience.retry_after(
                        e, _call, site='compile', state=writes)
            seconds = time.perf_counter() - t_build
            monitor.observe('compile_seconds', seconds)
            goodput.note_compile(entry.fp, seconds)
        else:
            try:
                fetches, new_state = _dispatch()
            except Exception as e:      # noqa: BLE001 — classified inside
                fetches, new_state = resilience.retry_after(
                    e, _dispatch, site='run', state=writes)
        # the scope takes the new state before the check can raise: a NaN
        # state stays readable (and a TrainingGuard restores it)
        scope.update(new_state)
        _keep_lods(scope, entry)
        if check:
            try:
                check_nan_inf(new_state, dict(zip(entry.fetch_names,
                                                  fetches)), self.device)
            except RuntimeError as e:
                info = None
                if pre is not None:
                    loc_state = dict(state)
                    loc_state.update(pre)
                    info = analysis.localize_nonfinite(
                        program, feed, loc_state, seed, self.device,
                        static_lods, statics)
                if info is None:
                    raise
                err = RuntimeError('%s; %s' % (
                    e, analysis.format_localization(info)))
                # carried for TrainingGuard, which reuses it
                err.nonfinite_localization = info
                raise err from None
        if flags.get_flags('benchmark') and self.device.type == 'cuda':
            t_sync = time.perf_counter()
            torch.cuda.synchronize(self.device)
            monitor.observe('executor_sync_seconds',
                            time.perf_counter() - t_sync)
        # state is updated in place by later runs: a fetched state variable
        # is handed out as a copy
        out = _fetch_values(entry, fetches, return_numpy,
                            entry.state_fetches)
        _count_fetch_bytes(out, return_numpy)
        return out

    # ------------------------------------------------------------------
    def _bound_plan(self, program, scope, feed, lods, fetch_names, what):
        """(the cached plan of (program, ``feed``'s signature at ``lods``,
        the fetch list) bound to ``scope`` (one for each pair, shared by
        `bind` and `run_fused`), whether the run plan was built now). A
        shape-bearing feed raises ValueError: a bound plan stages new
        values into the layout it was built for."""
        static = sorted(self._static_feed_names(program) & set(feed))
        if static:
            raise ValueError('%s cannot bind the shape-bearing static feeds '
                             '%s' % (what, static))
        entry, fresh = self._entry(program, feed, fetch_names,
                                   self._static_lods(scope, lods))
        plan = entry.bound.get(scope)
        if plan is None:
            plan = entry.bound[scope] = _BoundPlan(
                self, entry, program, feed, lods,
                'bound' if what == 'bind' else 'fused')
        return plan, fresh

    def bind(self, program, feed, fetch_list=None, scope=None, donate=None):
        """Take one step of ``program`` on ``feed`` (one program run, as
        ``run()`` takes it) and return a `BoundProgram` whose calls run the
        same plan at the same feed signature: on the card each call is a
        feed copy, a state check, a re-seed, one replay of the plan's CUDA
        graph (captured at this call, after its eager first step) and one
        read of the fetches. ``donate`` is taken for parity with the JAX
        executor and changes nothing: the port's optimizers update their
        state in place, so there is no second copy of it to donate."""
        program = self._check_program(program, 'bind')
        if scope is None:
            scope = global_scope()
        # counted as the JAX bind's run() counts its step
        with trace.step_scope('step'):
            with monitor.timed_span('run', 'executor_run_seconds'):
                monitor.inc('executor_run_total')
                t0 = time.perf_counter()
                feed, lods = self._prepare_feed(program, feed)
                plan, built = self._bound_plan(
                    program, scope, feed, lods,
                    self._fetch_names(fetch_list), 'bind')
                monitor.inc('compile_cache_miss' if built else
                            'compile_cache_hit')
                blackbox.note_step(program)
                if plan.fresh:
                    with monitor.span('compile'):
                        plan.stage(feed)
                        plan.step(scope)
                    seconds = time.perf_counter() - t0
                    monitor.observe('compile_seconds', seconds)
                    goodput.note_compile(plan.entry.fp, seconds)
                else:
                    plan.stage(feed)
                    _run_site()
                    plan.begin_check()
                    with goodput.timed(plan.entry.fp, 'run', self.device):
                        plan.step(scope)
                plan.check()
                first = plan.fetches(True)
                _count_fetch_bytes(first, True)
                return BoundProgram(plan, scope, first, feed)

    def _stack(self, program, stacked, lods):
        """({name: tensor [K, ...] on the device}, K) of a stacked feed,
        each LoD in ``lods`` covering every one of the K batches."""
        stacked, _ = self._prepare_feed(program, stacked)
        ks = set(int(t.shape[0]) for t in stacked.values())
        if len(ks) != 1:
            raise ValueError('run_fused: the stacked feeds hold %s batches'
                             % sorted(ks))
        for n, lod in lods.items():
            t = stacked[n]
            if t.dim() < 2 or lod[-1][-1] != t.shape[1]:
                raise ValueError(
                    "run_fused: feed %r's LoD %s does not cover its batches' "
                    "leading dimension %s" % (n, [list(l) for l in lod],
                                              tuple(t.shape[1:2])))
        return stacked, ks.pop()

    def _fused_segments(self, program, feed_list, steps):
        """[(stacked feeds, their LoDs, K)]: one for a stacked {name: array
        or tensor [K, ...]} (a value may be an ``(array, lod)`` pair, the
        LoD of each batch), or for each run of consecutive feed dicts of
        one LoD, in order. ``steps`` takes one LoD (else ValueError)."""
        if isinstance(feed_list, dict):
            split = {n: _split_lod_feed(v) for n, v in feed_list.items()}
            lods = {n: l for n, (_, l) in split.items() if l}
            stacked, k = self._stack(
                program, {n: v for n, (v, _) in split.items()}, lods)
            return [(stacked, lods, k)]
        names = sorted(feed_list[0])
        runs = []
        for f in feed_list:
            if sorted(f) != names:
                raise ValueError('run_fused: every feed dict takes the '
                                 'feeds %s, got %s' % (names, sorted(f)))
            split = {n: _split_lod_feed(f[n]) for n in names}
            lods = {n: l for n, (_, l) in split.items() if l}
            vals = {n: v for n, (v, _) in split.items()}
            if runs and runs[-1][0] == lods:
                runs[-1][1].append(vals)
            else:
                runs.append((lods, [vals]))
        if len(runs) > 1 and steps:
            raise ValueError(
                'run_fused(steps=...) cycles the staged batches and takes '
                'one LoD; omit steps for a list of mixed LoDs (each run of '
                'one LoD takes its own steps)')
        out = []
        for lods, batch in runs:
            stacked = {}
            for n in names:
                vals = [b[n] for b in batch]
                if all(isinstance(v, torch.Tensor) for v in vals):
                    stacked[n] = torch.stack(vals)
                else:
                    stacked[n] = np.stack([np.asarray(v) for v in vals])
            stacked, k = self._stack(program, stacked, lods)
            out.append((stacked, lods, k))
        return out

    def run_fused(self, program=None, feed_list=None, fetch_list=None,
                  scope=None, return_numpy=True, steps=None, donate=None):
        """Run one step for each of the K staged batches of ``feed_list``
        (K feed dicts of one signature, or a stacked {name: array or tensor
        [K, ...]}: device tensors are not copied again), or ``steps`` steps
        cycling them, and return the last step's fetches; every state
        update lands in the scope. On the card each step is a
        device-to-device copy of its batch into the bound feed and one
        replay of the graph that `bind` uses; the fetches are read once,
        at the end. Each step is one program run of the counted RNG
        stream, so a call over K batches equals K ``run()`` calls, draws
        included; the JAX executor instead derives one key a call and folds
        in the step index (the two packages' bits differ anyway, see
        core/lowering.py). Ragged feeds: feed dicts whose LoDs differ run
        as consecutive runs of one LoD, in order, each on the bound plan of
        its LoD (one capture a LoD), which ``steps`` refuses; a stacked
        value may be an ``(array [K, ...], lod)`` pair, one LoD for every
        batch. ``donate`` changes nothing (see `bind`)."""
        if not feed_list:
            return []
        program = self._check_program(program, 'run_fused')
        if scope is None:
            scope = global_scope()
        with monitor.timed_span('run_fused', 'executor_run_fused_seconds'):
            monitor.inc('executor_run_fused_total')
            fetch_names = self._fetch_names(fetch_list)
            plan = None
            for stacked, lods, k in self._fused_segments(program, feed_list,
                                                         steps):
                feed0 = {n: t[0] for n, t in stacked.items()}
                t0 = time.perf_counter()
                plan, _ = self._bound_plan(program, scope, feed0, lods,
                                           fetch_names, 'run_fused')
                fresh = plan.fresh
                monitor.inc('compile_cache_miss' if fresh else
                            'compile_cache_hit')
                blackbox.note_step(program)
                n = int(steps) if steps else k
                first = 1 if fresh else 0
                if fresh:
                    # the eager first step and, on the card, the capture
                    with monitor.span('compile'):
                        plan.stage({name: t[0]
                                    for name, t in stacked.items()})
                        plan.step(scope)
                    seconds = time.perf_counter() - t0
                    monitor.observe('compile_seconds', seconds)
                    goodput.note_compile(plan.entry.fp, seconds)
                else:
                    _run_site()
                    plan.begin_check()
                if n > first:
                    with goodput.timed(plan.entry.fp, 'fused', self.device,
                                       steps=n - first):
                        for i in range(first, n):
                            plan.stage({name: t[i % k]
                                        for name, t in stacked.items()})
                            plan.step(scope)
                graphs.check_flags(plan.graph)
                plan.check()
            out = plan.fetches(return_numpy)
            _count_fetch_bytes(out, return_numpy)
            return out


def _copies(state, names):
    """{name: a copy} of the tensors of ``state`` among ``names``
    (`resilience.foreach_copy`)."""
    names = [n for n in names if isinstance(state.get(n), torch.Tensor)]
    srcs = [state[n].detach() for n in names]
    dsts = [torch.empty_like(t) for t in srcs]
    resilience.foreach_copy(dsts, srcs)
    return dict(zip(names, dsts))


def _run_site():
    """The ``run`` fault site of a bound call or a fused window, checked
    before its first step (nothing has run, so a retry is the call
    itself)."""
    try:
        resilience.maybe_fault('run')
    except Exception as e:              # noqa: BLE001 — classified inside
        resilience.retry_after(e, lambda: resilience.maybe_fault('run'),
                               site='run')


def _finite_flags(values, device):
    """A float32 vector on ``device``, one entry a value of ``values``: 0
    where every element is finite, NaN where one is not (or a value that
    is no float tensor: 0). Each entry is the 1-norm of the tensor times 0,
    exact (no sum can overflow), in one multi-tensor pass a dtype, so that
    a CUDA graph captures the check with the step; a SelectedRows is
    checked over its values."""
    flags = [None] * len(values)
    groups = {}
    for i, v in enumerate(values):
        if isinstance(v, SelectedRows):
            v = v.values
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            groups.setdefault(v.dtype, []).append((i, v))
    for items in groups.values():
        norms = torch._foreach_norm(
            torch._foreach_mul([v for _, v in items], 0.0), 1,
            dtype=torch.float32)
        for (i, _), n in zip(items, norms):
            flags[i] = n
    if any(f is None for f in flags):
        zero = torch.zeros((), dtype=torch.float32, device=device)
        flags = [zero if f is None else f for f in flags]
    if not flags:
        return torch.zeros(0, dtype=torch.float32, device=device)
    return torch.stack(flags)


def _raise_nonfinite(names, vec):
    """Raise the ``FLAGS_check_nan_inf`` error naming each of ``names``
    whose entry of ``vec`` (`_finite_flags`, read to the host here) is
    NaN, counting ``nan_check_trigger_total``; nothing when none is."""
    bad = sorted(set(n for n, f in zip(names, vec.tolist())
                     if math.isnan(f)))
    if bad:
        monitor.inc('nan_check_trigger_total')
        raise RuntimeError(
            "FLAGS_check_nan_inf: NaN/Inf detected in %s after executor "
            "run" % bad)


def check_nan_inf(new_state, fetches, device):
    """``FLAGS_check_nan_inf`` at the program boundary (the JAX executor's
    `_check_nan_inf`): the state a run wrote and its fetches ({name:
    value}), checked for NaN or Inf; RuntimeError names the variables."""
    _raise_nonfinite(list(new_state) + list(fetches), _finite_flags(
        list(new_state.values()) + list(fetches.values()), device))


def _count_fetch_bytes(out, return_numpy):
    """``fetch_host_bytes``: the bytes of the fetches handed out as numpy
    arrays."""
    if return_numpy and out:
        monitor.inc('fetch_host_bytes',
                    sum(int(getattr(f, 'nbytes', 0)) for f in out))


def _fetch_values(entry, values, return_numpy, copy):
    """The fetches as a run returns them: one with a LoD as a
    `FetchedTensor`, the others as numpy arrays or, without
    ``return_numpy``, as the tensors (a copy of those ``copy`` marks)."""
    lod_out = entry.plan.lod_out
    out = []
    for n, v, c in zip(entry.fetch_names, values, copy):
        lod = lod_out.get(n)
        if lod:
            out.append(_fetched(_to_numpy(v), lod))
        elif return_numpy:
            out.append(_to_numpy(v))
        else:
            out.append(v.clone() if c else v)
    return out


def _keep_lods(scope, entry):
    """Keep the LoD of each state variable the plan wrote in the scope (the
    JAX executor's ``scope._lods``), and drop a stale one."""
    lod_out = entry.plan.lod_out
    for n in entry.written_names:
        lod = lod_out.get(n)
        if lod:
            scope._lods[n] = lod
        else:
            scope._lods.pop(n, None)
