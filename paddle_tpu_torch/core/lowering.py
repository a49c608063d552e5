"""Running a Program on torch tensors: the LowerContext, the op walk, the
``backward`` meta-op and the run plan.

The port's own copy of paddle_tpu/core/lowering.py. The JAX package traces
a whole program into one XLA computation; here the program runs op by op:
each op's registered lowering (core/registry.py) reads torch tensors from
the environment, calls the port's op functions (which launch the CUDA
kernels on the card) and writes its outputs back. What the JAX trace
resolves once per compile, :func:`build_fn` resolves once per run plan:
the op list, each op's lowering, which ops and outputs anything reads
(the rest do not run), after which op each value is dropped, and a memo
for constants (the causal mask, the position table) built once per
device.

The ``backward`` meta-op at index b: each ``wrt`` tensor enters the
environment as a fresh leaf (``detach().requires_grad_()``), ops [lo:b]
run under ``torch.enable_grad()``, ``torch.autograd.grad`` of the loss
(its cotangent 1) binds ``<name>@GRAD``, and the ops after b (the
optimizer) run under ``torch.no_grad()``; each activation left the
environment after its last reader, so autograd frees it once the backward
has used it. Scaling the loss's gradient (the JAX package's
GradientScaleStrategy across devices) waits for the parallel slice. Each kernel's gradient is its
``autograd.Function``'s backward. Everything else runs under
``torch.no_grad()``, so a kernel wrapper there takes its bare forward.

Random ops draw from one ``torch.Generator`` on the run's device
(:meth:`LowerContext.rng`), in op order, seeded for each run from
(``program.random_seed``, the program's run index) when the program is
seeded and from the executor's run counter when it is not (executor.py);
an op with a ``seed`` attr draws from a generator of its own, seeded from
(seed, op index) at every run. The generators belong to the caller, a
:class:`RunRNG` handed to the plan's function: it stays the same object
from run to run and is seeded before each, so that a CUDA graph that
captured the plan can register it and draw each replay's masks from the
seed set before that replay (executor.py `BoundProgram`). Its bits are not
the JAX package's threefry bits: the two packages draw different masks,
and agree only where nothing is dropped.
"""
import torch

from .registry import get_op

__all__ = ['LowerContext', 'RunRNG', 'lower_ops', 'lower_block',
           'analyze_state', 'build_fn']


class _Plan(object):
    """What a run plan resolves once: the lowerings of the block's ops and
    which of them run (an op whose outputs nothing reads, not a fetch,
    not state, not a gradient the optimizer takes, does not run: XLA drops
    it from the JAX package's trace), the names the running ops read (an
    output nobody reads need not be computed), the stop-gradient names,
    after which op each value is dropped, and a memo of constants on the
    run's device.

    A value leaves the environment after the last op that reads or writes
    it, unless it is fetched or state: as PyTorch frees a temporary nothing
    holds, so that a forward keeps only what autograd saved and the
    backward frees each activation once it is used."""

    def __init__(self, program, fetch_names, written_names):
        block = program.global_block()
        self.ops = block.ops
        self.defs = [get_op(op.type) for op in self.ops]
        reads = set(fetch_names) | set(written_names)
        self.live = [False] * len(self.ops)
        for i in reversed(range(len(self.ops))):
            op = self.ops[i]
            if self.defs[i].stateful or \
                    any(n in reads for n in op.output_arg_names):
                self.live[i] = True
                reads.update(_reads(op))
        self.reads = reads
        self.stop = set(n for n, v in block.vars.items() if v.stop_gradient)
        self.backward_at = [i for i, op in enumerate(self.ops)
                            if op.type == 'backward' and self.live[i]]
        kept = set(fetch_names) | set(written_names)
        last = {}
        for i, op in enumerate(self.ops):
            if self.live[i]:
                for n in _reads(op) + op.output_arg_names:
                    last[n] = i
        self.free_after = [[] for _ in self.ops]
        for n, i in last.items():
            if n not in kept:
                self.free_after[i].append(n)
        # {op index: seed} of the running ops that draw from a generator of
        # their own (a ``seed`` attr)
        self.seeded_ops = {i: int(op.attr('seed', 0))
                           for i, op in enumerate(self.ops)
                           if self.live[i] and op.attr('seed', 0) and
                           _needs_rng(self.defs[i], op)}
        self.memo = {}


def _needs_rng(opdef, op):
    """An OpDef's needs_rng: a bool, or a predicate over the op's attrs."""
    nr = opdef.needs_rng
    return nr(op) if callable(nr) else bool(nr)


class RunRNG(object):
    """The generators a run of a plan draws from: ``run`` (every random op
    without a ``seed`` attr, in op order) and ``ops`` ({op index: generator}
    for the ops with one). :meth:`seed` seeds them all for one run, as a
    fresh generator of that seed starts."""

    def __init__(self, plan, device):
        self.run = torch.Generator(device=device)
        self.ops = {i: torch.Generator(device=device)
                    for i in plan.seeded_ops}
        self._op_seeds = {i: s * 1000003 + i
                          for i, s in plan.seeded_ops.items()}

    def seed(self, run_seed):
        self.run.manual_seed(run_seed)
        for i, g in self.ops.items():
            g.manual_seed(self._op_seeds[i])

    def generators(self):
        return [self.run] + list(self.ops.values())


def _reads(op):
    names = list(op.input_arg_names)
    if op.type == 'backward':
        names += list(op.attr('wrt_names'))
    return names


class LowerContext(object):
    """The environment while one block runs: var name -> torch tensor."""

    def __init__(self, program, block, env, device, rng=None, wrt=(),
                 plan=None):
        self.program = program
        self.block = block
        self.env = env
        self.device = device
        self._rng = rng
        self.op_index = 0
        self.wrt = set(wrt)
        self.plan = plan
        self._run_memo = {}

    # ---- reading inputs --------------------------------------------------
    def get(self, name):
        try:
            return self.env[name]
        except KeyError:
            raise KeyError(
                "variable %r used before definition while running op #%d "
                "(%s) — is it fed / initialized?" %
                (name, self.op_index, self.block.ops[self.op_index].type))

    def in1(self, op, slot, default=None):
        names = op.input(slot)
        if not names:
            return default
        return self.get(names[0])

    def in_list(self, op, slot):
        return [self.get(n) for n in op.input(slot)]

    # ---- writing outputs -------------------------------------------------
    def set(self, name, value):
        if value.requires_grad and name in self.plan.stop and \
                name not in self.wrt:
            value = value.detach()
        self.env[name] = value
        self._run_memo.pop(name, None)

    def out(self, op, slot, value, idx=0):
        names = op.output(slot)
        if not names:
            return
        self.set(names[idx], value)

    def needed(self, op, slot):
        """True when something reads the op's ``slot`` output (a later op, a
        fetch or the scope): an output nobody reads need not be computed,
        as XLA drops it from the JAX package's trace."""
        names = op.output(slot)
        return bool(names) and names[0] in self.plan.reads

    def var(self, name):
        return self.block._find_var_recursive(name)

    def memo(self, key, build):
        """A constant built once per run plan (so once per device):
        ``build()`` on the first call with ``key``."""
        v = self.plan.memo.get(key)
        if v is None:
            v = self.plan.memo[key] = build()
        return v

    def run_memo(self, name, key, build):
        """A value derived from variable ``name`` in this run: ``build()`` on
        the first call with (``name``, ``key``); dropped when the variable
        is written again or leaves the environment."""
        memo = self._run_memo.setdefault(name, {})
        v = memo.get(key)
        if v is None:
            v = memo[key] = build()
        return v

    # ---- rng -------------------------------------------------------------
    def rng(self):
        """The run's generator: every random op of the run draws from it,
        in op order."""
        return self._run_rng().run

    def op_rng(self):
        """The generator of the running op, which has a ``seed`` attr:
        seeded from (seed, op index), the same at every run, as the JAX
        package folds the op index into ``PRNGKey(seed)``."""
        return self._run_rng().ops[self.op_index]

    def _run_rng(self):
        if self._rng is None:
            raise RuntimeError('op #%d (%s) draws random numbers but the '
                               'run has no seed' % (
                                   self.op_index,
                                   self.block.ops[self.op_index].type))
        return self._rng


def lower_ops(ctx, ops, lo, hi):
    defs, live = ctx.plan.defs, ctx.plan.live
    for i in range(lo, hi):
        if live[i]:
            ctx.op_index = i
            defs[i].lower(ctx, ops[i])
            _free(ctx, i)


def _free(ctx, i):
    """Drop the values whose last reader or writer is op ``i``."""
    for n in ctx.plan.free_after[i]:
        ctx.env.pop(n, None)
        ctx._run_memo.pop(n, None)


def lower_block(ctx, lo=0):
    """Run ops [lo:] of the block, the ``backward`` meta-op as the module
    docstring says."""
    ops = ctx.block.ops
    b = next((i for i in ctx.plan.backward_at if i >= lo), None)
    if b is None:
        lower_ops(ctx, ops, lo, len(ops))
        return
    ctx.op_index = b
    _lower_backward(ctx, ops, lo, b, ops[b])
    _free(ctx, b)
    lower_block(ctx, b + 1)


def _lower_backward(ctx, ops, lo, b, bop):
    loss_name = bop.input('Loss')[0]
    wrt_names = list(bop.attr('wrt_names'))
    if bop.attr('sparse_wrt') or bop.attr('checkpoints'):
        raise NotImplementedError(
            'backward: sparse embedding gradients and rematerialization '
            'wait for a later slice of paddle_tpu_torch')
    missing = [n for n in wrt_names if n not in ctx.env]
    if missing:
        raise ValueError(
            "backward: cannot differentiate w.r.t. %s — they are neither "
            "fed nor in scope state (only leaf variables are supported)"
            % missing)
    held = {n: ctx.env[n] for n in wrt_names}
    leaves = []
    for n in wrt_names:
        leaf = held[n].detach().requires_grad_()
        ctx.env[n] = leaf
        leaves.append(leaf)
    ctx.wrt = set(wrt_names)
    with torch.enable_grad():
        lower_ops(ctx, ops, lo, b)
    loss = ctx.get(loss_name)
    grads = torch.autograd.grad(loss, leaves,
                                grad_outputs=torch.ones_like(loss),
                                allow_unused=True)
    ctx.wrt = set()
    # what the forward left for later ops lets go of the autograd graph
    for k, v in list(ctx.env.items()):
        if v.requires_grad:
            ctx.env[k] = v.detach()
    ctx.env.update(held)
    grad_outs = bop.output('Grads')
    for i, n in enumerate(wrt_names):
        g = grads[i]
        if g is None:          # the loss does not depend on it
            g = torch.zeros_like(held[n])
        ctx.env[grad_outs[i]] = g


# ---------------------------------------------------------------------------
# Program-level analysis and the run plan
# ---------------------------------------------------------------------------

def analyze_state(program, fetch_names=()):
    """Which persistable vars a program reads and which it writes: read
    persistables come from the Scope, written ones go back into it."""
    read, written = [], []
    read_set, written_set = set(), set()

    def _persistable(block, name):
        v = block._find_var_recursive(name)
        return v is not None and v.persistable

    for block in program.blocks:
        for op in block.ops:
            for n in _reads(op):
                if _persistable(block, n) and n not in read_set:
                    read_set.add(n)
                    read.append(n)
            for n in op.output_arg_names:
                if _persistable(block, n) and n not in written_set:
                    written_set.add(n)
                    written.append(n)
    gb = program.global_block()
    for n in fetch_names:
        if _persistable(gb, n) and n not in read_set:
            read_set.add(n)
            read.append(n)
    return read, written


def build_fn(program, fetch_names, read_names, written_names, device):
    """The run plan of (program, fetch list) as a function
    ``fn(feed, state, rng) -> (fetches, new_state)`` over {name: tensor}
    dicts on ``device``; ``rng`` is a :class:`RunRNG` of the plan, seeded
    for this run (None for a program that draws nothing). Sub-blocks
    (control flow) wait for a later slice."""
    if len(program.blocks) > 1:
        raise NotImplementedError(
            'programs with sub-blocks (control flow) wait for a later slice '
            'of paddle_tpu_torch')
    plan = _Plan(program, fetch_names, written_names)
    block = program.global_block()

    def fn(feed, state, rng=None):
        env = dict(feed)
        env.update(state)
        ctx = LowerContext(program, block, env, device, rng=rng, plan=plan)
        with torch.no_grad():
            lower_block(ctx)
        env = ctx.env
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError('fetch %s: neither fed nor computed by the '
                           'program (nor state it reads)' % missing)
        fetches = [env[n] for n in fetch_names]
        new_state = {n: env[n] for n in written_names if n in env}
        return fetches, new_state

    return fn, plan
