"""Momentum, weight decay and gradient clipping of paddle_tpu_torch against
the JAX package, on the CPU.

Every input comes from a numpy seed and goes through both packages.

(a) The new ops as one-op programs run by both Executors: ``momentum``
    (plain and Nesterov; ParamOut and VelocityOut), ``elementwise_mul``,
    ``_div``, ``_max`` and ``_min`` (trailing broadcast, ``axis=1`` and
    the squeeze-excitation's ``axis=0`` of [N, C] into [N, C, H, W]),
    ``sum``, ``sign``, ``squared_l2_norm``, ``clip``, ``clip_by_norm``
    (a norm above ``max_norm`` and one below), ``sqrt`` and ``sigmoid``:
    within 1e-6 of each output's largest magnitude.
(b) The program dicts (`core.serialization.program_to_dict`, built under a
    fresh ``unique_name.guard()``) of an fc net under ``Momentum`` (plain,
    Nesterov), L2 and L1 decay on the optimizer, a parameter's own
    ``ParamAttr(regularizer=)`` beside the optimizer's (the parameter's
    wins), ``set_gradient_clip`` with each clip kind (value, norm, global
    norm with a ``group_name``), equal to the JAX package's, main and
    startup programs.
(c) A program with decay saved by one package loads in the other: the
    dicts equal and every parameter's regularizer back with its class and
    coefficient.
(d) Three steps of each program of (b) from the JAX startup scope, the
    same batches, against the JAX executor at the float32 limits of
    `PERF.md` §2: the losses within 1e-4 relative, every parameter and
    accumulator within 1e-3 of its largest magnitude (measured: within
    1e-6). The clip thresholds are set so that every clip bites: each
    clip and the L2 decays move the first layer otherwise than plain
    Momentum does.
(e) Momentum applies each run of consecutive ``momentum`` ops at the
    run's first op (ops/optimizer_ops.py `_momentum_runs`): one run for a
    plain program; a parameter with its own learning-rate multiplier (a
    ``scale`` op before its update) splits the runs; a run of one op
    equals the per-op update bitwise.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.core import serialization as jser

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.ops import optimizer_ops

CPU = fluid.CPUPlace()
STEPS = 3


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels;
    restart the window after this module."""
    yield
    goodput.reset()
    # the monitor keeps at most 64 series a metric: leave it empty
    monitor.reset()


def _r(rs, *shape, scale=1.0):
    return (scale * rs.randn(*shape)).astype('float32')


def _run_one_op(pkg, op_type, inputs, outputs, attrs, state=()):
    """Run a one-op program of ``pkg`` once: ``inputs`` {slot: [(name,
    array)]} are fed, but for the names in ``state``, which live in the
    scope. Returns {output name: numpy array}."""
    main = pkg.Program()
    block = main.global_block()
    feed, scope = {}, pkg.Scope()
    for items in inputs.values():
        for name, arr in items:
            block.create_var(name=name, shape=arr.shape, dtype=arr.dtype,
                             persistable=name in state)
            if name in state:
                scope.set(name, arr.copy())
            else:
                feed[name] = arr
    names = []
    for outs in outputs.values():
        for n in outs:
            if not block.has_var(n):
                block.create_var(name=n, dtype='float32')
            if n not in names:
                names.append(n)
    block.append_op(type=op_type,
                    inputs={k: [i[0] for i in v] for k, v in inputs.items()},
                    outputs=outputs, attrs=dict(attrs))
    exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
    got = exe.run(main, feed=feed, fetch_list=names, scope=scope)
    return dict(zip(names, [np.asarray(g) for g in got]))


def _close(got, want, tol=1e-6):
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, name
        assert g.dtype == w.dtype, name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale, name


# ---------------------------------------------------------------------------
# (a) the ops


def _momentum_case(nesterov):
    rs = np.random.RandomState(1)
    inputs = {'Param': [('p', _r(rs, 5, 3))], 'Grad': [('g', _r(rs, 5, 3))],
              'Velocity': [('v', _r(rs, 5, 3, scale=0.1))],
              'LearningRate': [('lr', np.array([0.05], 'float32'))]}
    return ('momentum', inputs, {'ParamOut': ['p'], 'VelocityOut': ['v']},
            {'mu': 0.9, 'use_nesterov': nesterov}, ('p', 'v', 'lr'))


def _ew_case(op, xs, ys, axis, seed):
    rs = np.random.RandomState(seed)
    y = _r(rs, *ys)
    if op == 'elementwise_div':
        y = np.where(np.abs(y) < 0.2, 0.7, y).astype('float32')
    return (op, {'X': [('x', _r(rs, *xs))], 'Y': [('y', y)]},
            {'Out': ['out']}, {'axis': axis})


def _op_cases():
    rs = np.random.RandomState(3)
    c = {'momentum': _momentum_case(False),
         'momentum_nesterov': _momentum_case(True)}
    shapes = {'trailing': ((4, 6), (6,), -1), 'axis1': ((2, 3, 4), (3,), 1),
              'se_axis0': ((2, 3, 4, 5), (2, 3), 0)}
    for i, op in enumerate(('elementwise_mul', 'elementwise_div',
                            'elementwise_max', 'elementwise_min')):
        for key, (xs, ys, axis) in shapes.items():
            c['%s_%s' % (op, key)] = _ew_case(op, xs, ys, axis, 10 * i)
    c['sum'] = ('sum', {'X': [('a', _r(rs, 3, 4)), ('b', _r(rs, 3, 4)),
                              ('c', _r(rs, 3, 4))]}, {'Out': ['out']}, {})
    x = _r(rs, 4, 5)
    x[0, 0] = 0.0
    c['sign'] = ('sign', {'X': [('x', x)]}, {'Out': ['out']}, {})
    c['squared_l2_norm'] = ('squared_l2_norm', {'X': [('x', _r(rs, 6, 7))]},
                            {'Out': ['out']}, {})
    c['clip'] = ('clip', {'X': [('x', _r(rs, 4, 5))]}, {'Out': ['out']},
                 {'min': -0.5, 'max': 0.3})
    for key, max_norm in (('bites', 1.0), ('passes', 100.0)):
        c['clip_by_norm_' + key] = ('clip_by_norm',
                                    {'X': [('x', _r(rs, 4, 5))]},
                                    {'Out': ['out']}, {'max_norm': max_norm})
    c['sqrt'] = ('sqrt', {'X': [('x', np.abs(_r(rs, 4, 5)) + 0.01)]},
                 {'Out': ['out']}, {})
    c['sigmoid'] = ('sigmoid', {'X': [('x', _r(rs, 4, 5, scale=3.0))]},
                    {'Out': ['out']}, {})
    return c


OP_CASES = _op_cases()


@pytest.mark.parametrize('key', sorted(OP_CASES))
def test_op_matches_the_jax_lowering(key):
    args = OP_CASES[key]
    got = _run_one_op(fluid, *args)
    _close(got, _run_one_op(jfluid, *args))
    if key.startswith('clip_by_norm'):
        x = args[1]['X'][0][1]
        changed = not np.array_equal(got['out'], x)
        assert changed == (key == 'clip_by_norm_bites')


# ---------------------------------------------------------------------------
# (b) the program dicts


def _opt(pkg, kind):
    """The optimizer of program ``kind`` (and its regularizer)."""
    opt = pkg.optimizer
    reg = pkg.regularizer
    if kind == 'momentum':
        return opt.Momentum(0.1, 0.9)
    if kind == 'nesterov':
        return opt.Momentum(0.1, 0.9, use_nesterov=True)
    if kind == 'l2':
        return opt.Momentum(0.1, 0.9, regularization=reg.L2Decay(0.05))
    if kind == 'l1':
        return opt.SGD(0.1, regularization=reg.L1Decay(0.02))
    if kind == 'param_l2':
        return opt.Momentum(0.1, 0.9, use_nesterov=True,
                            regularization=reg.L1Decay(0.01))
    return opt.Momentum(0.1, 0.9)


# the clips' thresholds: every clip bites on the batches of (d)
CLIPS = {'clip_value': lambda c: c.GradientClipByValue(0.05, -0.02),
         'clip_norm': lambda c: c.GradientClipByNorm(0.1),
         'clip_global': lambda c: c.GradientClipByGlobalNorm(
             0.2, group_name='head')}
KINDS = ['momentum', 'nesterov', 'l2', 'l1', 'param_l2'] + sorted(CLIPS)


def _build(pkg, kind, seed=3):
    """An fc net (two hidden layers of ReLU, a square error) under ``kind``:
    (main, startup, loss)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name='x', shape=[6], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        attr = pkg.ParamAttr(regularizer=pkg.regularizer.L2Decay(0.1)) \
            if kind == 'param_l2' else None
        h = pkg.layers.fc(x, size=8, act='relu', param_attr=attr)
        h = pkg.layers.fc(h, size=8, act='relu')
        p = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(p, y))
        if kind in CLIPS:
            pkg.clip.set_gradient_clip(CLIPS[kind](pkg.clip))
        _opt(pkg, kind).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize('kind', KINDS)
def test_program_dicts_equal_the_jax_package(kind):
    jmain, jstart, _ = _build(jfluid, kind)
    tmain, tstart, _ = _build(fluid, kind)
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    assert tser.program_to_dict(tstart) == jser.program_to_dict(jstart)
    types = [op.type for op in tmain.global_block().ops]
    want = {'momentum': 'momentum', 'l2': 'sum', 'l1': 'sign',
            'clip_value': 'clip', 'clip_norm': 'clip_by_norm',
            'clip_global': 'squared_l2_norm'}.get(kind)
    assert want is None or want in types


# ---------------------------------------------------------------------------
# (c) save and load of a program with decay


def _regularizers(program):
    return {p.name: (type(p.regularizer).__name__,
                     p.regularizer._regularization_coeff)
            for p in program.global_block().all_parameters()
            if p.regularizer is not None}


def test_a_program_with_decay_loads_in_the_other_package():
    jmain, _, _ = _build(jfluid, 'param_l2')
    tmain, _, _ = _build(fluid, 'param_l2')
    regs = _regularizers(tmain)
    assert regs == {'fc_0.w_0': ('L2DecayRegularizer', 0.1)}
    with tempfile.TemporaryDirectory() as d:
        tpath, jpath = os.path.join(d, 't.json'), os.path.join(d, 'j.json')
        tser.save_program(tmain, tpath)
        jser.save_program(jmain, jpath)
        from_port = jser.load_program(tpath)
        from_jax = tser.load_program(jpath)
    assert jser.program_to_dict(from_port) == jser.program_to_dict(jmain)
    assert tser.program_to_dict(from_jax) == tser.program_to_dict(tmain)
    assert _regularizers(from_jax) == regs
    assert isinstance(from_jax.global_block().var('fc_0.w_0').regularizer,
                      fluid.regularizer.L2DecayRegularizer)


# ---------------------------------------------------------------------------
# (d) the trajectories


def _scope_arrays(scope):
    return {n: np.array(scope.get(n)) for n in scope.names()
            if hasattr(scope.get(n), 'shape')}


def _batches(n=STEPS, rows=16, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = _r(rs, rows, 6)
        out.append({'x': x, 'y': (np.sin(x).sum(1, keepdims=True)
                                  .astype('float32'))})
    return out


def _trajectories(kind):
    """Both packages' losses and final scopes over (d)'s batches, from the
    JAX startup scope, and that scope."""
    jmain, jstart, jloss = _build(jfluid, kind)
    tmain, _, tloss = _build(fluid, kind)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(jstart, scope=scope)
    init = _scope_arrays(scope)
    texe, tscope = fluid.Executor(CPU), scope_from_numpy(init, device='cpu')
    want, got = [], []
    for f in _batches():
        want.append(float(exe.run(jmain, feed=f, fetch_list=[jloss],
                                  scope=scope)[0][0]))
        got.append(float(texe.run(tmain, feed=f, fetch_list=[tloss],
                                  scope=tscope)[0][0]))
    return got, want, _scope_arrays(tscope), _scope_arrays(scope), init


@pytest.fixture(scope='module')
def trajectories():
    """{kind: `_trajectories(kind)`}, each run once."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _trajectories(kind)
        return cache[kind]
    return get


@pytest.mark.parametrize('kind', KINDS)
def test_three_steps_match_the_jax_executor(kind, trajectories):
    got, want, tstate, jstate, init = trajectories(kind)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert sorted(tstate) == sorted(jstate) == sorted(init)
    for n in jstate:
        scale = max(float(np.abs(jstate[n]).max()), 1e-30)
        assert float(np.abs(tstate[n] - jstate[n]).max()) <= 1e-3 * scale, n
    assert not np.allclose(tstate['fc_2.w_0'], init['fc_2.w_0'])
    if kind not in ('momentum', 'nesterov', 'l1'):
        # the decay or the clip took effect: the first layer moved
        # otherwise than under plain Momentum
        base = trajectories('momentum')[2]['fc_0.w_0']
        assert not np.allclose(tstate['fc_0.w_0'], base, rtol=0,
                               atol=1e-6), kind


# ---------------------------------------------------------------------------
# (e) Momentum's runs


def _plan(main, loss):
    _, written = lowering.analyze_state(main, [loss.name])
    return lowering._Plan(main, [loss.name], written)


def test_momentum_runs_group_consecutive_updates():
    main, _, loss = _build(fluid, 'momentum')
    plan = _plan(main, loss)
    idx = [i for i, op in enumerate(plan.ops) if op.type == 'momentum']
    assert len(idx) == 6
    assert optimizer_ops._momentum_runs(plan) == {idx[0]: idx}


def test_a_learning_rate_multiplier_splits_the_runs():
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data(name='x', shape=[6], dtype='float32')
            y = pkg.layers.data(name='y', shape=[1], dtype='float32')
            h = pkg.layers.fc(x, size=8, act='relu')
            h = pkg.layers.fc(h, size=8, act='relu',
                              param_attr=pkg.ParamAttr(learning_rate=3.0))
            p = pkg.layers.fc(h, size=1)
            loss = pkg.layers.mean(pkg.layers.square_error_cost(p, y))
            pkg.optimizer.Momentum(0.1, 0.9).minimize(loss)
        return main, startup, loss

    main, _, loss = build(fluid)
    plan = _plan(main, loss)
    runs = optimizer_ops._momentum_runs(plan)
    types = [op.type for op in plan.ops]
    # fc_1.w_0's update reads a scaled learning rate: three runs
    assert len(runs) == 3 and sum(len(r) for r in runs.values()) == 6
    for first, run in runs.items():
        assert run == list(range(first, first + len(run)))
        assert all(types[i] == 'momentum' for i in run)
    jmain, jstart, jloss = build(jfluid)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(jstart, scope=scope)
    init = _scope_arrays(scope)
    texe, tscope = fluid.Executor(CPU), scope_from_numpy(init, device='cpu')
    for f in _batches():
        want = exe.run(jmain, feed=f, fetch_list=[jloss], scope=scope)[0]
        got = texe.run(main, feed=f, fetch_list=[loss], scope=tscope)[0]
        np.testing.assert_allclose(got, want, rtol=1e-4)
    for n, w in _scope_arrays(scope).items():
        g = np.array(tscope.get(n))
        assert float(np.abs(g - w).max()) <= \
            1e-3 * max(float(np.abs(w).max()), 1e-30), n


@pytest.mark.parametrize('nesterov', [False, True], ids=['plain', 'nesterov'])
def test_a_run_of_one_equals_the_per_op_update(nesterov):
    """`momentum` over a set equals the op's expressions one tensor at a
    time, bitwise."""
    rs = np.random.RandomState(4)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    ps = [torch.from_numpy(_r(rs, *s)) for s in shapes]
    gs = [torch.from_numpy(_r(rs, *s)) for s in shapes]
    vs = [torch.from_numpy(_r(rs, *s, scale=0.1)) for s in shapes]
    lr = torch.tensor([0.05])
    want_p, want_v = [], []
    for p, g, v in zip(ps, gs, vs):
        v2 = 0.9 * v + g
        want_v.append(v2)
        want_p.append(p - (g + 0.9 * v2) * lr if nesterov else p - lr * v2)
    optimizer_ops.momentum(ps, gs, vs, lr, 0.9, nesterov)
    for a, b in zip(ps + vs, want_p + want_v):
        assert torch.equal(a, b)
