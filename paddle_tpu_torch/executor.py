"""Executor and Scope: run a Program on the card.

The port's own copy of paddle_tpu/executor.py's `Scope`, `global_scope`,
`scope_guard` and `Executor.run`. ``Executor(place=None)`` runs on
``cuda:0`` (framework.resolve_device); ``Executor(CPUPlace())`` on the
CPU, where every kernel wrapper takes its plain version.

- ``run(program, feed, fetch_list, scope, return_numpy)`` prepares the feed
  (a float64 array becomes float32 when the variable is float32, ints take
  the variable's int type), reads the persistable state the program needs
  from the scope (a variable the startup program has not written raises
  RuntimeError naming it), runs the program's run plan
  (core/lowering.py), writes the state it wrote back into the scope, and
  returns the fetches as numpy arrays (or, with ``return_numpy=False``, as
  tensors on the device; a fetched state variable is then a copy, since the
  optimizers update state in place).
- Run plans are cached per executor by (program, version, feed signature,
  fetch list), the key the JAX executor's `_feed_signature` builds: the op
  list, the lowerings and the state names are resolved once per key, and
  constants are built once per plan.
- The RNG stream is counted as the JAX executor counts it (`_run_seed`,
  `_next_program_run`, `_op_needs_rng`): a seeded program draws from
  (random_seed, its own run index), so it replays its trajectory from a
  fresh build; an unseeded one from the executor's run counter.

The scope holds torch tensors on the run's device. State given as numpy
arrays (or tensors elsewhere) is copied there on first read and cached
back into the scope; the optimizer ops then update those tensors in
place. `run_async`, `run_fused`, `bind`, `precompile`, `explain`, donation,
segmented host ops and the monitor counters wait for later slices.
"""
import numpy as np
import torch

from . import ops  # noqa: F401  (registers every op's lowering)
from .core import lowering
from .core.types import torch_dtype
from .framework import Program, Variable, default_main_program, resolve_device

__all__ = ['Executor', 'Scope', 'global_scope', 'scope_guard']


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


class _VarShim(object):
    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return _TensorShim(self._scope, self._name)


class Scope(object):
    """A flat name -> value store of persistable state (torch tensors, or
    numpy arrays not yet read by a run)."""

    def __init__(self):
        self._vars = {}

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
    if isinstance(v, torch.Tensor):
        return v.detach().to('cpu', copy=True).numpy()
    return np.asarray(v)


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


def _op_needs_rng(opdef, op):
    """An OpDef's needs_rng: a bool, or a predicate over the op's attrs."""
    nr = opdef.needs_rng
    return nr(op) if callable(nr) else bool(nr)


class _Entry(object):
    """A cached run plan: its function, the state it reads, whether it
    draws random numbers, and which fetches are state variables."""

    def __init__(self, fn, read_names, needs_rng, state_fetches):
        self.fn = fn
        self.read_names = read_names
        self.needs_rng = needs_rng
        self.state_fetches = state_fetches


class Executor(object):
    """``Executor(place=None)``: None or a ``CUDAPlace`` runs on the card,
    ``CPUPlace()`` on the CPU."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._cache = {}
        self._run_counter = 0

    def close(self):
        self._cache.clear()

    # ------------------------------------------------------------------
    @staticmethod
    def _feed_signature(feed):
        return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in feed.items()))

    def _prepare_feed(self, program, feed):
        """{name: tensor on the device}: numpy, lists and tensors in; a
        value whose dtype differs from its variable's is converted as the
        JAX executor converts it (ints to the variable's int type, floats
        to its float type, float64 always)."""
        out = {}
        gb = program.global_block()
        for name, value in feed.items():
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
            out[name] = t.to(self.device)
        return out

    def _state_value(self, scope, name):
        """The scope's value of ``name`` as a tensor on the device, cached
        back into the scope (a copy: the optimizers update state in place,
        so the scope never shares memory with the caller's array)."""
        v = scope.get(name)
        if v is None:
            raise RuntimeError(
                "persistable variable %r is not initialized in the scope — "
                "run the startup program first" % name)
        if isinstance(v, torch.Tensor) and v.device == self.device:
            return v
        if isinstance(v, torch.Tensor):
            t = v.detach().to(self.device, copy=True)
        else:
            t = torch.from_numpy(np.array(v)).to(self.device)
        scope.set(name, t)
        return t

    @staticmethod
    def _read_before_write(program, read, written, feed_names, fetch_names):
        """A persistable var written earlier in the program than any read
        (a startup program's init ops) need not come from the scope."""
        first_write, first_read = {}, {}
        for idx, op in enumerate(program.global_block().ops):
            names_in = list(op.input_arg_names)
            if op.type == 'backward':
                names_in += list(op.attr('wrt_names'))
            for n in names_in:
                first_read.setdefault(n, idx)
            for n in op.output_arg_names:
                first_write.setdefault(n, idx)
        end = len(program.global_block().ops)
        for n in fetch_names:
            first_read.setdefault(n, end)
        return [n for n in read if n not in feed_names and not (
            n in first_write and first_write[n] < first_read.get(n, end + 1))]

    def _build(self, program, feed_names, fetch_names):
        read, written = lowering.analyze_state(program, fetch_names)
        needed = self._read_before_write(program, read, written, feed_names,
                                         fetch_names)
        fn, plan = lowering.build_fn(program, fetch_names, needed, written,
                                     self.device)
        needs_rng = any(_op_needs_rng(d, op)
                        for d, op in zip(plan.defs, plan.ops))
        state = set(read) | set(written)
        return _Entry(fn, needed, needs_rng,
                      [n in state for n in fetch_names])

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True, use_program_cache=True):
        if program is None:
            program = default_main_program()
        if not isinstance(program, Program):
            raise TypeError('Executor.run takes a Program, got %r'
                            % type(program).__name__)
        if scope is None:
            scope = global_scope()
        feed = self._prepare_feed(program, feed or {})
        fetch_names = [v.name if isinstance(v, Variable) else v
                       for v in (fetch_list or [])]
        key = (program._uid, program._version, self._feed_signature(feed),
               tuple(fetch_names))
        entry = self._cache.get(key) if use_program_cache else None
        if entry is None:
            entry = self._build(program, set(feed), fetch_names)
            if use_program_cache:
                self._cache[key] = entry
        state = {n: self._state_value(scope, n) for n in entry.read_names}
        self._run_counter += 1
        runs = _next_program_run(program)
        seed = _run_seed(program.random_seed, runs, self._run_counter) \
            if entry.needs_rng else None
        fetches, new_state = entry.fn(feed, state, seed)
        scope.update(new_state)
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        # state is updated in place by later runs: a fetched state
        # variable is handed out as a copy
        return [f.clone() if aliased else f
                for f, aliased in zip(fetches, entry.state_fetches)]
