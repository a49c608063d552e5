"""Variable operators (layers/math_op_patch.py), the step counter and the
learning-rate schedules (layers/learning_rate_scheduler.py) of
paddle_tpu_torch against the JAX package, on the CPU.

(a) Every operator of ``Variable`` (``+ - * / **``, reflected, unary
    ``-``, ``< <= > >=``, ``astype``) on a Variable and on a Python
    scalar: the program dict equals the JAX package's (a scalar added or
    multiplied is one ``scale`` op, any other a ``fill_constant`` of shape
    [1]; comparisons bool), and the values the JAX executor's within rtol
    1e-6.
(b) Each schedule: the program dict (main and startup) equals the JAX
    one, and its rate over 5 ``Executor.run`` steps the JAX executor's
    within a relative 1e-6 (``pow``, ``exp`` and ``cos`` may differ by an
    ulp between XLA's CPU and torch). ``append_LARS``: its rates and the
    decayed parameters' SGD steps within rtol 1e-6 and atol 1e-6 (the
    norms' sums of squares run in another order).
(c) ``run_fused`` over K steps equals K ``run()`` calls bitwise, the
    counter at K, state included; the counter's ``increment`` is appended
    once however many schedules read it.
(d) A run resumed from the JAX executor's scope after n steps (its
    counter an int32: the JAX package runs with x64 off) reads the JAX
    executor's rate at step n + 1, its counter an int64 again; so does
    one loaded by ``io.load_persistables`` from the JAX package's files.
(e) examples/train_lm.py's program (the flagship `build_lm` with
    ``noam_decay(d_model, 400)`` and ``Adam(learning_rate=lr)``) at 2
    layers, d 64, B 2, L 16, dropout 0 (the two packages draw other
    masks), float32 and ``mixed_precision.decorate``d: the program dicts
    equal the JAX ones, and three steps from the JAX startup scope, its
    counter set to EXAMPLE_COUNTER0 on both sides (steps 128-130, the
    rate 2.0e-3, so that three Adam updates, up to 6e-3 an element, are
    not lost in the limits), hold the JAX executor's within the f32
    limits (losses 1e-4 relative, each parameter and moment within 1e-3
    of its own largest magnitude) and the AMP limits (losses 5e-3, each
    within 2e-2 of its group's largest magnitude: the parameters, the
    first moments, the second moments, the other float state); the K
    slice of each ``qkv.b``, whose true gradient is 0, within 10 x the
    largest rate. The parameters' change over the three steps, the K
    slices aside, holds the JAX executor's change as a whole: its norm
    within 1e-3 (f32) or 2e-2 (AMP) relative, and its difference's norm
    within 1e-3 (f32) or 0.1 (AMP) of the change's norm (under AMP an
    element whose gradient is within bf16's rounding of 0 may take the
    other sign of Adam's first, normalised update: about 0.1% of them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.core import serialization as jser
from paddle_tpu.models import transformer as jtrans

import paddle_tpu_torch as fluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import transformer as ttrans

CPU = fluid.CPUPlace()
STEPS = 5
COUNTER = '@LR_DECAY_COUNTER@'


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels and
    fills monitor series; leave both empty after this module."""
    yield
    goodput.reset()
    monitor.reset()


def _arrays(scope):
    out = {}
    for n in scope.names():
        v = scope.get(n)
        if isinstance(v, torch.Tensor):
            out[n] = v.detach().cpu().numpy().copy()
        elif hasattr(v, 'shape'):
            out[n] = np.array(v)
    return out


def _build(pkg, fn, seed=0):
    """(main, startup, fetch vars) of ``fn(pkg)`` under a fresh name
    guard."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        fetch = fn(pkg)
    return main, startup, fetch


def _dicts(fn):
    """Build ``fn`` in both packages; assert the program dicts equal.
    Returns both builds."""
    j, t = _build(jfluid, fn), _build(fluid, fn)
    assert tser.program_to_dict(t[0]) == jser.program_to_dict(j[0])
    assert tser.program_to_dict(t[1]) == jser.program_to_dict(j[1])
    return j, t


def _runs(j, t, feeds, steps=STEPS):
    """Each package's fetches over ``steps`` runs of its build (startup
    first, in a scope of its own)."""
    out = []
    for pkg, (main, startup, fetch), exe in (
            (jfluid, j, jfluid.Executor()),
            (fluid, t, fluid.Executor(CPU))):
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        out.append([[np.asarray(v) for v in exe.run(
            main, feed=feeds[i % len(feeds)], fetch_list=fetch,
            scope=scope)] for i in range(steps)])
    return out


# ---------------------------------------------------------------------------
# (a) Variable operators

X = np.random.RandomState(26).uniform(0.5, 2.0, (3, 4)).astype('float32')
Y = np.random.RandomState(27).uniform(0.5, 2.0, (3, 4)).astype('float32')
OPERATORS = {
    'add': lambda x, y: x + y, 'add_scalar': lambda x, y: x + 2.5,
    'radd_scalar': lambda x, y: 2.5 + x,
    'sub': lambda x, y: x - y, 'sub_scalar': lambda x, y: x - 2.5,
    'rsub_scalar': lambda x, y: 2.5 - x,
    'mul': lambda x, y: x * y, 'mul_scalar': lambda x, y: x * 3.0,
    'rmul_scalar': lambda x, y: 3.0 * x,
    'div': lambda x, y: x / y, 'div_scalar': lambda x, y: x / 4.0,
    'rdiv_scalar': lambda x, y: 4.0 / x,
    'pow': lambda x, y: x ** y, 'pow_scalar': lambda x, y: x ** -0.5,
    'rpow_scalar': lambda x, y: 0.5 ** x,
    'neg': lambda x, y: -x,
    'lt': lambda x, y: x < y, 'le_scalar': lambda x, y: x <= 1.0,
    'gt': lambda x, y: x > y, 'ge_scalar': lambda x, y: x >= 1.0,
    'astype': lambda x, y: x.astype('int32'),
    'chain': lambda x, y: (x * 2.0 + y) / (1.0 - y) ** 2.0,
}


@pytest.mark.parametrize('name', sorted(OPERATORS))
def test_variable_operator_matches_the_jax_package(name):
    def fn(pkg):
        x = pkg.layers.data('x', shape=[3, 4], append_batch_size=False)
        y = pkg.layers.data('y', shape=[3, 4], append_batch_size=False)
        return [OPERATORS[name](x, y)]

    j, t = _dicts(fn)
    out = t[2][0]
    if name in ('lt', 'le_scalar', 'gt', 'ge_scalar'):
        assert out.dtype == np.dtype('bool')
    ops = [op.type for op in t[0].global_block().ops]
    if name in ('add_scalar', 'mul_scalar'):
        assert ops == ['scale']
    if name.endswith('_scalar') and name not in ('add_scalar', 'mul_scalar'):
        fill = [op for op in t[0].global_block().ops
                if op.type == 'fill_constant']
        assert len(fill) == 1 and fill[0].attr('shape') == [1]
    (want,), (got,) = (r[0] for r in _runs(j, t, [{'x': X, 'y': Y}], 1))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_variable_has_no_equality_operator():
    """Variables stay dict keys: no ``==`` of their own, as in the JAX
    package."""
    assert fluid.Variable.__eq__ is object.__eq__
    assert jfluid.Variable.__eq__ is object.__eq__
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data('x', shape=[2])
    assert {x: 1}[x] == 1


# ---------------------------------------------------------------------------
# (b) the schedules

LRS = fluid.layers.learning_rate_scheduler
SCHEDULES = {
    'noam_decay': lambda L: L.noam_decay(64, 3),
    'exponential_decay': lambda L: L.exponential_decay(0.1, 2, 0.5),
    'exponential_decay:staircase': lambda L: L.exponential_decay(
        0.1, 2, 0.5, staircase=True),
    'natural_exp_decay': lambda L: L.natural_exp_decay(0.1, 2, 0.5),
    'natural_exp_decay:staircase': lambda L: L.natural_exp_decay(
        0.1, 2, 0.5, staircase=True),
    'inverse_time_decay': lambda L: L.inverse_time_decay(0.1, 2, 0.5),
    'inverse_time_decay:staircase': lambda L: L.inverse_time_decay(
        0.1, 2, 0.5, staircase=True),
    'polynomial_decay': lambda L: L.polynomial_decay(0.1, 3, power=2.0),
    'polynomial_decay:cycle': lambda L: L.polynomial_decay(
        0.1, 2, end_learning_rate=0.01, power=1.5, cycle=True),
    'piecewise_decay': lambda L: L.piecewise_decay([1, 3], [0.1, 0.05,
                                                            0.01]),
    'cosine_decay': lambda L: L.cosine_decay(0.1, 2, 4),
    'linear_lr_warmup': lambda L: L.linear_lr_warmup(0.1, 3, 0.0, 0.1),
    'linear_lr_warmup:noam': lambda L: L.linear_lr_warmup(
        L.noam_decay(64, 10), 2, 0.001, 0.01),
}


def test_schedules_are_exported_as_in_the_jax_package():
    assert sorted(LRS.__all__) == sorted(
        jfluid.layers.learning_rate_scheduler.__all__)
    for name in LRS.__all__:
        assert getattr(fluid.layers, name) is getattr(LRS, name)
        assert name in fluid.layers.__all__


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_matches_the_jax_executor(name):
    def fn(pkg):
        return [SCHEDULES[name](pkg.layers.learning_rate_scheduler)]

    j, t = _dicts(fn)
    ops = [op.type for op in t[0].global_block().ops]
    assert ops.count('increment') == 1
    want, got = _runs(j, t, [{}])
    rates = np.array([g[0] for g in got]).ravel()
    np.testing.assert_allclose(rates, np.array([w[0] for w in want]).ravel(),
                               rtol=1e-6, atol=0)
    assert len(set(rates.tolist())) > 1 or name == 'piecewise_decay'


def test_noam_decay_follows_its_closed_form():
    """The rate at step s is d ** -0.5 * min(s ** -0.5, s * w ** -1.5),
    float64, within 1e-6 relative, the counter starting at 1."""
    main, startup, (lr,) = _build(fluid, lambda pkg: [
        pkg.layers.learning_rate_scheduler.noam_decay(512, 3)])
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    for s in range(1, 7):
        got, = exe.run(main, fetch_list=[lr], scope=scope)
        want = 512 ** -0.5 * min(s ** -0.5, s * 3 ** -1.5)
        assert abs(float(got[0]) / want - 1) <= 1e-6
        assert scope.get(COUNTER).dtype == torch.int64
        assert int(scope.get(COUNTER)[0]) == s


def _lars(pkg):
    x = pkg.layers.data('x', shape=[4])
    loss = pkg.layers.mean(pkg.layers.fc(x, size=3, act='tanh'))
    lr = pkg.layers.exponential_decay(0.5, 2, 0.5)
    params_grads = pkg.backward.append_backward(loss)
    pkg.layers.append_LARS(params_grads, lr, 0.1)
    decayed = [p.optimize_attr['learning_rate'] for p, _ in params_grads]
    pkg.optimizer.SGD(0.1).apply_gradients(params_grads)
    return [loss] + decayed + [p for p, _ in params_grads]


def test_append_lars_matches_the_jax_executor():
    """``append_LARS`` over an fc layer's parameters, then an SGD step a
    parameter at the decayed rates: the same ops (type, arguments and
    attrs: neither package's ``program_to_dict`` takes a parameter whose
    ``optimize_attr`` holds a Variable), and the same rates, losses and
    parameters over 5 steps (the JAX startup's weights)."""
    j, t = _build(jfluid, _lars), _build(fluid, _lars)

    def ops(main):
        return [(op.type, sorted(op.input_arg_names),
                 sorted(op.output_arg_names),
                 sorted((k, repr(v)) for k, v in op.attrs.items()))
                for op in main.global_block().ops]
    assert ops(t[0]) == ops(j[0])
    assert tser.program_to_dict(t[1]) == jser.program_to_dict(j[1])
    feed = {'x': np.random.RandomState(3).randn(5, 4).astype('float32')}
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(j[1], scope=jscope)
    tscope = scope_from_numpy(_arrays(jscope), device='cpu')
    texe = fluid.Executor(CPU)
    for _ in range(STEPS):
        want = jexe.run(j[0], feed=feed, fetch_list=j[2], scope=jscope)
        got = texe.run(t[0], feed=feed, fetch_list=t[2], scope=tscope)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# (c) run_fused against run, the counter shared

def _mlp(pkg):
    x = pkg.layers.data('x', shape=[6])
    y = pkg.layers.data('y', shape=[1])
    h = pkg.layers.dropout(pkg.layers.fc(x, size=8, act='relu'), 0.2)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(
        pkg.layers.fc(h, size=1), y))
    L = pkg.layers.learning_rate_scheduler
    lr = L.linear_lr_warmup(L.noam_decay(8, 2), 2, 0.0, 0.05)
    pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    return [loss, lr]


def _mlp_feeds(k):
    rs = np.random.RandomState(11)
    return [{'x': rs.randn(4, 6).astype('float32'),
             'y': rs.randn(4, 1).astype('float32')} for _ in range(k)]


@pytest.mark.parametrize('k', [1, 4])
def test_run_fused_equals_k_run_calls_counter_included(k):
    feeds = _mlp_feeds(k)
    runs = []
    for fused in (False, True):
        main, startup, fetch = _build(fluid, _mlp, seed=9)
        assert [op.type for op in main.global_block().ops].count(
            'increment') == 1
        exe, scope = fluid.Executor(CPU), fluid.Scope()
        exe.run(startup, scope=scope)
        if fused:
            out = exe.run_fused(main, feeds, fetch_list=fetch, scope=scope,
                                steps=k)
        else:
            for f in feeds:
                out = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        runs.append((out, _arrays(scope)))
    (out_r, st_r), (out_f, st_f) = runs
    assert int(st_f[COUNTER][0]) == k and st_f[COUNTER].dtype == np.int64
    assert sorted(st_r) == sorted(st_f)
    for n in st_r:
        assert np.array_equal(st_r[n], st_f[n]), n
    for a, b in zip(out_r, out_f):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# (d) resuming from the JAX package's scope

@pytest.mark.parametrize('how', ['scope_from_numpy', 'load_persistables'])
def test_resume_from_a_jax_scope_reads_the_jax_rate(how, tmp_path):
    def fn(pkg):
        x = pkg.layers.data('x', shape=[3])
        loss = pkg.layers.mean(pkg.layers.fc(x, size=2))
        lr = pkg.layers.noam_decay(16, 4)
        pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
        return [loss, lr]

    j, t = _dicts(fn)
    feed = {'x': np.random.RandomState(5).randn(2, 3).astype('float32')}
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(j[1], scope=jscope)
    for _ in range(3):
        jexe.run(j[0], feed=feed, fetch_list=j[2], scope=jscope)
    saved = _arrays(jscope)
    assert saved[COUNTER].dtype == np.int32 and saved[COUNTER][0] == 3
    texe = fluid.Executor(CPU)
    if how == 'scope_from_numpy':
        tscope = scope_from_numpy(saved, device='cpu')
    else:
        with jfluid.scope_guard(jscope):
            jfluid.io.save_persistables(jexe, str(tmp_path), j[0])
        tscope = fluid.Scope()
        with fluid.scope_guard(tscope):
            fluid.io.load_persistables(texe, str(tmp_path), t[0])
    for _ in range(3):
        want = jexe.run(j[0], feed=feed, fetch_list=j[2], scope=jscope)
        got = texe.run(t[0], feed=feed, fetch_list=t[2], scope=tscope)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    assert tscope.get(COUNTER).dtype == torch.int64
    assert int(tscope.get(COUNTER)[0]) == 6


# ---------------------------------------------------------------------------
# (e) the repo's training example

EXAMPLE = dict(vocab_size=128, seq_len=16, d_model=64, n_head=4, n_layer=2,
               d_ff=128, dropout=0.0, attn_dropout=0.0,
               use_flash_attention=True)
EXAMPLE_COUNTER0 = 127


def example_program(pkg, amp):
    """examples/train_lm.py's program in ``pkg`` at EXAMPLE's size."""
    tmod = jtrans if pkg is jfluid else ttrans
    mpmod = jmp if pkg is jfluid else tmp

    def fn(pkg):
        _, _, _, loss = tmod.build_lm(tmod.LMConfig(**EXAMPLE))
        lr = pkg.layers.learning_rate_scheduler.noam_decay(
            EXAMPLE['d_model'], 400)
        opt = pkg.optimizer.Adam(learning_rate=lr)
        if amp:
            opt = mpmod.decorate(opt)
        opt.minimize(loss)
        return [loss, lr]
    return _build(pkg, fn)


@pytest.mark.parametrize('amp', [False, True], ids=['f32', 'amp'])
def test_train_lm_example_program_matches_the_jax_executor(amp):
    j = example_program(jfluid, amp)
    t = example_program(fluid, amp)
    assert tser.program_to_dict(t[0]) == jser.program_to_dict(j[0])
    assert tser.program_to_dict(t[1]) == jser.program_to_dict(j[1])
    types = [op.type for op in t[0].global_block().ops]
    assert types.count('adam') == 28 and 'fused_adam' not in types
    # the schedule's ops stay unmarked float32 under AMP
    for op in t[0].global_block().ops:
        if op.type in ('increment', 'cast', 'elementwise_pow',
                       'elementwise_min', 'fill_constant'):
            assert op.attr('__amp_dtype__') is None
    rs = np.random.RandomState(0)
    feeds = [{k: rs.randint(0, EXAMPLE['vocab_size'], (2, 16))
              .astype('int64') for k in ('tokens', 'labels')}
             for _ in range(3)]
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(j[1], scope=jscope)
    jscope.set(COUNTER, jnp.full((1,), EXAMPLE_COUNTER0, jnp.int32))
    init = _arrays(jscope)
    tscope = scope_from_numpy(init, device='cpu')
    texe = fluid.Executor(CPU)
    got, want, rates = [], [], []
    for f in feeds:
        w = jexe.run(j[0], feed=f, fetch_list=j[2], scope=jscope)
        g = texe.run(t[0], feed=f, fetch_list=t[2], scope=tscope)
        want.append(float(np.asarray(w[0]).ravel()[0]))
        got.append(float(g[0].ravel()[0]))
        np.testing.assert_allclose(g[1], np.asarray(w[1]), rtol=1e-6)
        rates.append(float(g[1][0]))
    loss_tol, tol, change_tol = (5e-3, 2e-2, 0.1) if amp else \
        (1e-4, 1e-3, 1e-3)
    np.testing.assert_allclose(got, want, rtol=loss_tol)
    jst, tst = _arrays(jscope), _arrays(tscope)
    d = EXAMPLE['d_model']
    names = [n for n in jst if n != COUNTER and
             jst[n].dtype.kind == 'f' and n in tst]
    for st in (jst, tst, init):
        for n in [n for n in names if n.endswith('.attn.qkv.b')]:
            st[n + '[K]'] = st[n][d:2 * d]
            st[n] = np.concatenate([st[n][:d], st[n][2 * d:]])
    params = [p.name for p in t[0].all_parameters()]
    groups = [params, [n for n in names if '_moment1_' in n],
              [n for n in names if '_moment2_' in n]]
    groups.append([n for n in names if not any(n in g for g in groups)])
    assert [len(g) for g in groups] == [28, 28, 28, 56]
    for group in groups:
        top = max(float(np.abs(jst[n]).max()) for n in group)
        for n in group:
            scale = top if amp else float(np.abs(jst[n]).max())
            err = float(np.abs(tst[n] - jst[n]).max())
            assert err <= tol * max(scale, 1e-30), (n, err, scale)
    for n in [n for n in jst if n.endswith('[K]')]:
        assert float(np.abs(tst[n] - jst[n]).max()) <= 10 * max(rates)
    dj = np.concatenate([(jst[n] - init[n]).ravel() for n in params])
    dt = np.concatenate([(tst[n] - init[n]).ravel() for n in params])
    ref = float(np.linalg.norm(dj.astype(np.float64)))
    assert ref > 1e-3 * float(np.linalg.norm(np.concatenate(
        [init[n].ravel() for n in params]).astype(np.float64)))
    assert abs(float(np.linalg.norm(dt.astype(np.float64))) / ref - 1) \
        <= tol
    assert float(np.linalg.norm((dt - dj).astype(np.float64))) <= \
        change_tol * ref
    assert int(tst[COUNTER][0]) == EXAMPLE_COUNTER0 + len(feeds)
