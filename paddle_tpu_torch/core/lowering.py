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

An ``is_sparse`` table (the op's ``sparse_wrt``, backward.py) is held out
of the leaves, so autograd never builds its dense [V, D] gradient: each
of its lookups (ops/embedding_ops.py) gathers the rows once, makes them a
leaf that requires grad and records (table, ids, rows) in
``ctx.sparse_sites``; after ``torch.autograd.grad`` the table's gradient
is the SelectedRows (core/selected_rows.py) of every site's ids and row
gradients, site by site in program order, as the JAX lowering's scout and
zero dummies build it. The rows leaf is the gather's output before
``padding_idx``'s mask, so a padded id's row gradient is 0.

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

Ragged sequences carry a static LoD (core/lod.py), as in the JAX package:
the executor hands the plan the LoDs of the feeds and of the scope's state
(``static_lods``), which are part of the plan's key. An op reads its
input's LoD with :meth:`LowerContext.in1_lod` and sets its output's with
:meth:`LowerContext.set_lod`; every other output takes the LoD of the
first LoD-carrying input whose leading dimension it shares (`_share_lod`,
Fluid's default ShareLoD), unless its op is registered
``share_lod=False``. After each run ``plan.lod_out`` holds the LoD of
every value, which the executor attaches to fetches and keeps in the
scope for written state. The index maps a sequence op derives from a LoD
are device tensors built once per plan (:meth:`LowerContext.memo`, keyed
by the op's index): no run copies one from the host, so a CUDA graph of
the plan replays no host-to-device copy. Shape-bearing feeds (an op's
``static_inputs``) reach the lowering as numpy (``static_feed``,
:meth:`LowerContext.static_value`), and key the plan by their values.

Control flow (ops/control_flow_ops.py): an op that owns a sub-block
(``while``, ``conditional_block``, ``recurrent``; framework.py
``SUB_BLOCK_ATTRS``) runs it through :func:`lower_ops` in a child context
(:meth:`LowerContext.child`) that shares the LoDs, static values, memo,
generators and gradient leaves, over the sub-block's own plan
(`_BlockPlan`). The memo keys a sub-block's constants by its index, so a
sequence op inside a loop builds its index maps once a plan, not once an
iteration. Under `Executor.bind` and ``run_fused`` the context holds
``loop_flags``, which the bounded loops report to.
"""
import contextlib
import copy

import numpy as np
import torch

from ..framework import SUB_BLOCK_ATTRS
from .lod import normalize_lod
from .registry import get_op
from .selected_rows import SelectedRows

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
    backward frees each activation once it is used. An op that owns a
    sub-block (control flow) reads every name that its sub-blocks read or
    write, at any depth (`_reads`): the values a loop carries stay until
    the loop has run. Each sub-block gets a plan of its own
    (`_BlockPlan`, in ``blocks``), whose ops all run and drop nothing."""

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
        self.memo = {}
        self.blocks = {}
        for b in program.blocks[1:]:
            self.blocks[b.idx] = _BlockPlan(b, self)
        # {op key: seed} of the running ops that draw from a generator of
        # their own (a ``seed`` attr): the op's index, or (block index, op
        # index) in a sub-block
        self.seeded_ops = {i: int(op.attr('seed', 0))
                           for i, op in enumerate(self.ops)
                           if self.live[i] and op.attr('seed', 0) and
                           _needs_rng(self.defs[i], op)}
        for bp in self.blocks.values():
            self.seeded_ops.update(
                ((bp.idx, i), int(op.attr('seed', 0)))
                for i, op in enumerate(bp.ops)
                if op.attr('seed', 0) and _needs_rng(bp.defs[i], op))
        # {name: LoD} of every value after the last run (module docstring)
        self.lod_out = {}

    def all_ops(self):
        """(OpDef, op) of every op of the program, sub-blocks included."""
        for d, op in zip(self.defs, self.ops):
            yield d, op
        for bp in self.blocks.values():
            for d, op in zip(bp.defs, bp.ops):
                yield d, op


class _BlockPlan(object):
    """The plan of a sub-block: every op runs (the JAX package lowers
    them all), nothing is dropped (each run of the block has an
    environment of its own), every output counts as read, and the memo is
    the run plan's."""

    def __init__(self, block, root):
        self.idx = block.idx
        self.ops = block.ops
        self.defs = [get_op(op.type) for op in self.ops]
        self.live = [True] * len(self.ops)
        self.free_after = [()] * len(self.ops)
        self.backward_at = []
        self.reads = set(root.reads)
        self.stop = set(root.stop)
        b = block
        while b is not None and b.idx != 0:
            self.stop.update(n for n, v in b.vars.items() if v.stop_gradient)
            b = b.parent_block
        for op in self.ops:
            self.reads.update(_reads(op))
            self.reads.update(op.output_arg_names)
        self.memo = root.memo
        self.blocks = root.blocks


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
        self.ops = {k: torch.Generator(device=device)
                    for k in plan.seeded_ops}
        self._op_seeds = {k: s * 1000003 + (k if isinstance(k, int) else
                                            k[1])
                          for k, s in plan.seeded_ops.items()}

    def seed(self, run_seed):
        self.run.manual_seed(run_seed)
        for i, g in self.ops.items():
            g.manual_seed(self._op_seeds[i])

    def generators(self):
        return [self.run] + list(self.ops.values())


def _reads(op):
    """The names op reads: its inputs, a ``backward`` op's ``wrt_names``,
    and every name that the sub-blocks of a control-flow op read or
    write, at any depth."""
    names = list(op.input_arg_names)
    if op.type == 'backward':
        names += list(op.attr('wrt_names'))
    for a in SUB_BLOCK_ATTRS:
        idx = op.attr(a)
        if idx is not None:
            names += _block_names(op.block.program.block(int(idx)))
    return names


def _block_names(block):
    """Every name the ops of ``block`` and its sub-blocks read or write."""
    names = []
    for op in block.ops:
        names += _reads(op) + op.output_arg_names
    return names


class LowerContext(object):
    """The environment while one block runs: var name -> torch tensor."""

    def __init__(self, program, block, env, device, rng=None, wrt=(),
                 plan=None, lods=None, statics=None, loop_flags=None):
        self.program = program
        self.block = block
        self.env = env
        self.device = device
        self._rng = rng
        self.op_index = 0
        self.wrt = set(wrt)
        self.plan = plan
        self._run_memo = {}
        # var name -> static LoD (a tuple of offset tuples)
        self.lods = lods if lods is not None else {}
        # names whose LoD an op set (or cleared) itself: `_share_lod` leaves
        # them alone
        self.lod_explicit = set()
        # var name -> numpy value of a shape-bearing input
        self.statics = statics if statics is not None else {}
        self._static_written = set()
        # while a backward's forward runs: the is_sparse tables it holds
        # out of autograd, and [(table, ids, rows leaf)] of their lookups
        self.sparse_tables = frozenset()
        self.sparse_sites = None
        # under `bind` and `run_fused`: a list that each bounded ``while``
        # appends its final condition to (ops/control_flow_ops.py); None
        # when the run is eager
        self.loop_flags = loop_flags

    def child(self, env, block):
        """The context of a sub-block's run over ``env``: it shares this
        context's LoDs, static values, run plan memo, generators, gradient
        leaves, sparse tables and loop flags."""
        c = LowerContext(self.program, block, env, self.device,
                         rng=self._rng, wrt=self.wrt,
                         plan=self.plan.blocks[block.idx], lods=self.lods,
                         statics=self.statics, loop_flags=self.loop_flags)
        c.sparse_tables = self.sparse_tables
        c.sparse_sites = self.sparse_sites
        return c

    @contextlib.contextmanager
    def detached(self):
        """A copy of this context for a run whose effects are dropped: its
        LoDs and static values are copies, and the run's generators are put
        back as they were when the block ends."""
        gens = self._rng.generators() if self._rng is not None else []
        states = [g.get_state() for g in gens]
        c = copy.copy(self)
        c.lods, c.statics = dict(self.lods), dict(self.statics)
        try:
            yield c
        finally:
            for g, st in zip(gens, states):
                g.set_state(st)

    def has(self, name):
        return name in self.env

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
        if isinstance(value, torch.Tensor) and value.requires_grad and \
                name in self.plan.stop and name not in self.wrt:
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

    # ---- static LoD and static values --------------------------------------
    def lod_of(self, name):
        """The static LoD of a variable, () for a dense one."""
        return self.lods.get(name, ())

    def set_lod(self, name, lod):
        lod = normalize_lod(lod)
        self.lod_explicit.add(name)
        if lod:
            self.lods[name] = lod
        else:
            self.lods.pop(name, None)

    def in1_lod(self, op, slot):
        names = op.input(slot)
        return self.lods.get(names[0], ()) if names else ()

    def set_static(self, name, value):
        """Record the value of an output that is a function of static LoDs
        alone (``sequence_pad``'s Length), for a ``static_inputs`` reader
        downstream."""
        self.statics[name] = np.asarray(value)
        self._static_written.add(name)

    def static_value(self, name):
        """The numpy value of a shape-bearing input: a feed named in an
        op's ``static_inputs`` or a value an op recorded with
        :meth:`set_static`."""
        if name in self.statics:
            return self.statics[name]
        raise ValueError(
            "op #%d (%s) needs the value of %r when its plan is built (its "
            "output's layout depends on it): feed it, so that the executor "
            "binds it with the plan" % (self.op_index,
                                        self.block.ops[self.op_index].type,
                                        name))

    def in1_static(self, op, slot, default=None):
        names = op.input(slot)
        if not names:
            return default
        return self.static_value(names[0])

    def memo(self, key, build):
        """A constant built once per run plan (so once per device):
        ``build()`` on the first call with ``key`` in this block (a key
        made of an op index names the op of this block)."""
        if self.block.idx:
            key = (self.block.idx, key)
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
        key = self.op_index if not self.block.idx else \
            (self.block.idx, self.op_index)
        return self._run_rng().ops[key]

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
            op = ops[i]
            if ctx.statics:
                ctx._static_written = set()
                defs[i].lower(ctx, op)
                for n in op.output_arg_names:
                    if n not in ctx._static_written:
                        ctx.statics.pop(n, None)
            else:
                defs[i].lower(ctx, op)
            if ctx.lods and defs[i].share_lod:
                _share_lod(ctx, op)
            _free(ctx, i)


def _share_lod(ctx, op):
    """The default LoD propagation (the JAX package's `_share_lod`, Fluid's
    InferShapeContext::ShareLoD): each output whose leading dimension
    equals that of the op's first LoD-carrying input takes its LoD, unless
    the op set or cleared the output's LoD itself or it has one."""
    in_lod = lead = None
    for n in op.input_arg_names:
        lod = ctx.lods.get(n)
        if lod and n in ctx.env:
            v = ctx.env[n]
            if isinstance(v, torch.Tensor) and v.dim() >= 1:
                in_lod, lead = lod, v.shape[0]
                break
    if in_lod is None:
        return
    for n in op.output_arg_names:
        if n in ctx.lods or n in ctx.lod_explicit or n not in ctx.env:
            continue
        v = ctx.env[n]
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and \
                v.shape[0] == lead:
            ctx.lods[n] = in_lod


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
    sparse = set(bop.attr('sparse_wrt') or ())
    if bop.attr('checkpoints'):
        raise NotImplementedError(
            'backward: rematerialization (checkpoints) waits for a later '
            'slice of paddle_tpu_torch')
    missing = [n for n in wrt_names if n not in ctx.env]
    if missing:
        raise ValueError(
            "backward: cannot differentiate w.r.t. %s — they are neither "
            "fed nor in scope state (only leaf variables are supported)"
            % missing)
    dense = [n for n in wrt_names if n not in sparse]
    held = {n: ctx.env[n] for n in dense}
    leaves = []
    for n in dense:
        leaf = held[n].detach().requires_grad_()
        ctx.env[n] = leaf
        leaves.append(leaf)
    ctx.wrt = set(dense)
    ctx.sparse_tables, ctx.sparse_sites = frozenset(sparse), []
    with torch.enable_grad():
        lower_ops(ctx, ops, lo, b)
    sites = ctx.sparse_sites
    ctx.sparse_tables, ctx.sparse_sites = frozenset(), None
    loss = ctx.get(loss_name)
    inputs = leaves + [rows for _, _, rows in sites]
    grads = torch.autograd.grad(loss, inputs,
                                grad_outputs=torch.ones_like(loss),
                                allow_unused=True) if inputs else ()
    ctx.wrt = set()
    # what the forward left for later ops lets go of the autograd graph
    for k, v in list(ctx.env.items()):
        if isinstance(v, torch.Tensor) and v.requires_grad:
            ctx.env[k] = v.detach()
    ctx.env.update(held)
    grad_outs = dict(zip(wrt_names, bop.output('Grads')))
    for n, g in zip(dense, grads):
        if g is None:          # the loss does not depend on it
            g = torch.zeros_like(held[n])
        ctx.env[grad_outs[n]] = g
    per_table = {}
    for (n, ids, rows), g in zip(sites, grads[len(leaves):]):
        per_table.setdefault(n, []).append(
            (ids, torch.zeros_like(rows) if g is None else g))
    for n in wrt_names:
        if n in sparse:
            ctx.env[grad_outs[n]] = _sparse_grad(ctx.env[n],
                                                 per_table.get(n, ()))


def _sparse_grad(table, pairs):
    """The SelectedRows gradient of an is_sparse ``table`` from its lookup
    sites' (ids, row gradients) in program order; a table that no site
    read gets one sentinel row (``height``) of zeros, the JAX lowering's
    empty form."""
    V = table.shape[0]
    if not pairs:
        return SelectedRows(
            torch.full((1,), V, dtype=torch.int64, device=table.device),
            torch.zeros((1,) + tuple(table.shape[1:]), dtype=table.dtype,
                        device=table.device), V)
    return SelectedRows(torch.cat([i for i, _ in pairs]),
                        torch.cat([g for _, g in pairs]), V)


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


def build_fn(program, fetch_names, read_names, written_names, device,
             static_lods=None, static_feed=None):
    """The run plan of (program, fetch list) as a function
    ``fn(feed, state, rng, loop_flags=None) -> (fetches, new_state)`` over
    {name: tensor} dicts on ``device``; ``rng`` is a :class:`RunRNG` of
    the plan, seeded for this run (None for a program that draws nothing).
    ``loop_flags`` is a list under `bind` and `run_fused`: every bounded
    ``while`` then runs its bound's iterations and appends whether its
    condition still held after them (ops/control_flow_ops.py).
    ``static_lods`` ({name: LoD} of the feeds and the scope's state) and
    ``static_feed`` ({name: numpy} of the shape-bearing feeds) are the
    plan's, fixed by its key; after each run ``plan.lod_out`` holds every
    value's LoD."""
    plan = _Plan(program, fetch_names, written_names)
    block = program.global_block()
    static_lods = {n: normalize_lod(l) for n, l in (static_lods or {})
                   .items() if l}
    static_feed = dict(static_feed or {})

    def fn(feed, state, rng=None, loop_flags=None):
        env = dict(feed)
        env.update(state)
        ctx = LowerContext(program, block, env, device, rng=rng, plan=plan,
                           lods=dict(static_lods),
                           statics=dict(static_feed), loop_flags=loop_flags)
        with torch.no_grad():
            lower_block(ctx)
        plan.lod_out = ctx.lods
        env = ctx.env
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError('fetch %s: neither fed nor computed by the '
                           'program (nor state it reads)' % missing)
        # a fetched sparse gradient densifies, as the JAX executor's
        # fetch of a SelectedRows does (the scope never holds one)
        fetches = [env[n].to_dense() if isinstance(env[n], SelectedRows)
                   else env[n] for n in fetch_names]
        new_state = {n: env[n] for n in written_names if n in env}
        return fetches, new_state

    return fn, plan
