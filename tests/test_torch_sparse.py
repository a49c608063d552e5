"""Sparse embedding gradients (SelectedRows) and the optimizer family of
paddle_tpu_torch against the JAX package, on the CPU.

Every input comes from a numpy seed and goes through both packages.

(a) `SelectedRows.to_dense` and `merged` equal the JAX functions exactly:
    duplicate rows, long runs of one row (each row's values add in index
    order), the sentinel rows a merge leaves, the empty form of a table no
    lookup read, rows counted from the end and rows past the table.
(b) Each optimizer op, appended after ``append_backward`` of a lookup of
    a [12, 4] table (its ids touch rows 0..7, with repeats) beside an fc
    weight, on a dense and on a sparse gradient, one step through both
    Executors: every output within 1e-6 of its largest magnitude; under a
    sparse gradient the lazy updates (`sgd`, `momentum`, `adam`,
    `fused_adam`, `adagrad`) leave rows 8..11 of the table and of its
    state bitwise as they were, the others densify.
(c) `log_loss` and the ops a sparse gradient meets on its way to the
    optimizer (`scale`, `clip`, `clip_by_norm`, `elementwise_mul`/`_div`
    by one element, `elementwise_add`, `sum`, `squared_l2_norm`,
    `merge_selected_rows`, `get_tensor_from_selected_rows`) against the
    JAX lowerings within 1e-6 of each output's largest magnitude;
    `fused_embedding_gather` (bias form), dense and sparse.
(d) The program dicts of every new optimizer class, and of the bench's
    CTR program, equal the JAX package's; three steps under each class
    from the JAX startup scope match the JAX Executor at the float32
    limits of `PERF.md` §2 (losses 1e-4 relative, every parameter and
    accumulator within 1e-3 of its largest magnitude).
(e) The CTR program (bench.py `_bench_ctr`) at V 1000, 26 slots, D 16,
    fc 64, B 64, five steps under Adagrad, Adam (fused and per
    parameter), Momentum (plain and with L2 decay) and SGD (plain and
    under a global-norm clip), held to the JAX Executor at the same
    limits; ``is_distributed=True`` equals ``False`` on one device; a
    fetched sparse gradient equals the JAX package's dense fetch (with a
    ``padding_idx`` whose rows get none); ``run_fused`` over four batches
    and ``bind`` equal as many ``run()`` calls bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.core import selected_rows as jsr
from paddle_tpu.core import serialization as jser
from paddle_tpu.layer_helper import LayerHelper as JHelper

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import selected_rows as tsr
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.layer_helper import LayerHelper as THelper

CPU = fluid.CPUPlace()
# the gradient programs' table: ids touch rows 0..TOUCHED-1 with repeats
V, D, N, TOUCHED = 12, 4, 10, 8
LIMIT = 1e-6


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


def _close(got, want, tol=LIMIT):
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale, name


# ---------------------------------------------------------------------------
# (a) SelectedRows


def _sr_cases():
    rs = np.random.RandomState(7)
    c = {'duplicates': (np.array([3, 1, 3, 0, 1, 3]), 5),
         'single': (np.array([2]), 4),
         'empty_site': (np.array([6]), 6),
         'sentinels': (np.array([2, 5, 5, 0, 5, 5]), 5),
         'wrapped_and_dropped': (np.array([-1, 4, 7, -6, 3, 4, 9]), 5),
         'long_runs': (rs.randint(0, 3, 600), 3)}
    return {k: (rows, _r(rs, len(rows), 3), h) for k, (rows, h) in c.items()}


SR_CASES = _sr_cases()


def _both_sr(key):
    rows, vals, h = SR_CASES[key]
    if key == 'empty_site':
        vals = np.zeros_like(vals)
    j = jsr.SelectedRows(jnp.asarray(rows.astype('int32')),
                         jnp.asarray(vals), h)
    t = tsr.SelectedRows(torch.from_numpy(rows.astype('int64')),
                         torch.from_numpy(vals), h)
    return j, t


@pytest.mark.parametrize('key', sorted(SR_CASES))
def test_to_dense_equals_the_jax_function(key):
    j, t = _both_sr(key)
    want = np.asarray(j.to_dense())
    got = t.to_dense().numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize('key', sorted(SR_CASES))
def test_merged_equals_the_jax_function(key):
    j, t = _both_sr(key)
    jrows, jvals = j.merged()
    trows, tvals = t.merged()
    assert trows.dtype == torch.int64
    assert np.array_equal(trows.numpy(), np.asarray(jrows))
    assert np.array_equal(tvals.numpy(), np.asarray(jvals))
    if (SR_CASES[key][0] >= 0).all():
        # the merged rows hold the same dense gradient (a wrapped row
        # would add in another order)
        assert np.array_equal(t.to_dense().numpy(),
                              tsr.SelectedRows(trows, tvals, t.height)
                              .to_dense().numpy())


def test_set_rows_drops_sentinels_and_keeps_bits():
    rs = np.random.RandomState(2)
    t = torch.from_numpy(_r(rs, 6, 3))
    before = t.clone()
    idx, keep = tsr.row_index(torch.tensor([4, 1, 6, 6]), 6)
    new = torch.from_numpy(_r(rs, 4, 3))
    tsr.set_rows(idx, keep, [(t, new)])
    assert torch.equal(t[4], new[0]) and torch.equal(t[1], new[1])
    for r in (0, 2, 3, 5):
        assert torch.equal(t[r], before[r])
    # no kept slot: the table is left as it was
    idx, keep = tsr.row_index(torch.tensor([6, 6]), 6)
    tsr.set_rows(idx, keep, [(t, new[:2])])
    assert torch.equal(t[0], before[0])


# ---------------------------------------------------------------------------
# (b) the optimizer ops on dense and sparse gradients


def _ids():
    rs = np.random.RandomState(11)
    ids = rs.randint(0, TOUCHED, (N, 1)).astype('int64')
    ids[:2, 0] = [5, 5]
    return ids


def _grad_program(pkg, sparse, padding_idx=None):
    """(main, startup, loss): the fed rows' embedding plus an fc of ``c``
    against a target, so that both the table ``w`` and the fc weight
    ``u`` get a gradient, ``w``'s sparse when ``sparse``."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ids = pkg.layers.data(name='ids', shape=[1], dtype='int64')
        c = pkg.layers.data(name='c', shape=[D], dtype='float32')
        t = pkg.layers.data(name='t', shape=[D], dtype='float32')
        emb = pkg.layers.embedding(ids, size=[V, D], is_sparse=sparse,
                                   padding_idx=padding_idx,
                                   param_attr=pkg.ParamAttr(name='w'))
        fc = pkg.layers.fc(c, size=D, param_attr=pkg.ParamAttr(name='u'),
                           bias_attr=False)
        s = pkg.layers.elementwise_add(emb, fc)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(s, t))
        pkg.append_backward(loss)
    return main, startup, loss


def _feed():
    rs = np.random.RandomState(12)
    return {'ids': _ids(), 'c': _r(rs, N, D), 't': _r(rs, N, D)}


def _grad_init():
    """The two packages' startup programs draw other values: the
    gradient programs' ``w`` and ``u`` from a seed."""
    rs = np.random.RandomState(21)
    return {'w': _r(rs, V, D), 'u': _r(rs, D, D)}


# op type: ({state slot: (output slot, 'any' | 'small' | 'positive' |
# 'pow')},
# attrs, takes a learning rate); fused_adam takes lists over (w, u)
_ADAM_STATE = {'Moment1': ('Moment1Out', 'any'),
               'Moment2': ('Moment2Out', 'positive'),
               'Beta1Pow': ('Beta1PowOut', 'pow'),
               'Beta2Pow': ('Beta2PowOut', 'pow')}
OPT_OPS = {
    'sgd': ({}, {}, True),
    'momentum': ({'Velocity': ('VelocityOut', 'any')},
                 {'mu': 0.9, 'use_nesterov': False}, True),
    'momentum_nesterov': ({'Velocity': ('VelocityOut', 'any')},
                          {'mu': 0.9, 'use_nesterov': True}, True),
    'lars_momentum': ({'Velocity': ('VelocityOut', 'any')},
                      {'mu': 0.9, 'lars_coeff': 0.01,
                       'lars_weight_decay': 0.0005}, True),
    'adam': (_ADAM_STATE, {'beta1': 0.9, 'beta2': 0.999,
                           'epsilon': 1e-8}, True),
    'fused_adam': (_ADAM_STATE, {'beta1': 0.9, 'beta2': 0.999,
                                 'epsilon': 1e-8}, True),
    'adagrad': ({'Moment': ('MomentOut', 'positive')}, {'epsilon': 1e-6},
                True),
    'adamax': ({'Moment': ('MomentOut', 'any'),
                'InfNorm': ('InfNormOut', 'positive'),
                'Beta1Pow': (None, 'pow')},
               {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}, True),
    'decayed_adagrad': ({'Moment': ('MomentOut', 'positive')},
                        {'decay': 0.95, 'epsilon': 1e-6}, True),
    'adadelta': ({'AvgSquaredGrad': ('AvgSquaredGradOut', 'positive'),
                  'AvgSquaredUpdate': ('AvgSquaredUpdateOut', 'positive')},
                 {'rho': 0.95, 'epsilon': 1e-6}, False),
    'rmsprop': ({'MeanSquare': ('MeanSquareOut', 'positive'),
                 'Moment': ('MomentOut', 'any'),
                 'MeanGrad': (None, 'small')},
                {'decay': 0.9, 'epsilon': 1e-6, 'momentum': 0.5,
                 'centered': False}, True),
    'rmsprop_centered': ({'MeanSquare': ('MeanSquareOut', 'positive'),
                          'Moment': ('MomentOut', 'any'),
                          'MeanGrad': ('MeanGradOut', 'small')},
                         {'decay': 0.9, 'epsilon': 1e-6, 'momentum': 0.5,
                          'centered': True}, True),
    'ftrl': ({'SquaredAccumulator': ('SquaredAccumOut', 'positive'),
              'LinearAccumulator': ('LinearAccumOut', 'any')},
             {'l1': 0.01, 'l2': 0.02, 'lr_power': -0.5}, True),
    'proximal_gd': ({}, {'l1': 0.01, 'l2': 0.02}, True),
    'proximal_adagrad': ({'Moment': ('MomentOut', 'positive')},
                         {'l1': 0.01, 'l2': 0.02}, True),
}
LAZY = ('sgd', 'momentum', 'momentum_nesterov', 'adam', 'fused_adam',
        'adagrad')


def _state_value(rs, kind, shape):
    if kind == 'pow':
        return np.array([0.9 ** 3], 'float32')
    v = _r(rs, *shape, scale=0.01 if kind == 'small' else 0.1)
    return np.abs(v) + 0.05 if kind == 'positive' else v


def _optimizer_step(pkg, key, sparse):
    """One run of the gradient program with the op ``key`` appended:
    ({name: array} of the updated parameters and state, the initial
    values)."""
    state, attrs, takes_lr = OPT_OPS[key]
    op_type = key.split('_nesterov')[0].split('_centered')[0]
    main, startup, _ = _grad_program(pkg, sparse)
    block = main.global_block()
    init = _grad_init()
    rs = np.random.RandomState(22)
    params = ['w', 'u'] if op_type == 'fused_adam' else ['w']
    names = {}
    for p in params:
        for slot, (_, kind) in sorted(state.items()):
            n = '%s_%s' % (p, slot.lower())
            shape = (1,) if kind == 'pow' else init[p].shape
            block.create_var(name=n, shape=shape, dtype='float32',
                             persistable=True)
            init[n] = _state_value(rs, kind, shape)
            names.setdefault(slot, []).append(n)
    block.create_var(name='lr', shape=(1,), dtype='float32',
                     persistable=True)
    init['lr'] = np.array([0.1], 'float32')
    if op_type == 'fused_adam':
        inputs = {'Params': params, 'Grads': [p + '@GRAD' for p in params],
                  'LearningRate': ['lr']}
        inputs.update({slot + 's': names[slot] for slot in state})
        outputs = {'ParamsOut': params}
        outputs.update({out[:-3] + 'sOut': names[slot]
                        for slot, (out, _) in state.items()})
    else:
        inputs = {'Param': ['w'], 'Grad': ['w@GRAD']}
        if takes_lr:
            inputs['LearningRate'] = ['lr']
        inputs.update({slot: names[slot] for slot in state})
        outputs = {'ParamOut': ['w']}
        outputs.update({out: names[slot] for slot, (out, _) in state.items()
                        if out})
    block.append_op(type=op_type, inputs=inputs, outputs=outputs,
                    attrs=dict(attrs))
    exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    for n, v in init.items():
        scope.set(n, v.copy())
    fetch = sorted(init)
    got = exe.run(main, feed=_feed(), fetch_list=fetch, scope=scope)
    return dict(zip(fetch, [np.array(g) for g in got])), init


@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'sparse'])
@pytest.mark.parametrize('key', sorted(OPT_OPS))
def test_optimizer_op_matches_the_jax_lowering(key, sparse):
    got, init = _optimizer_step(fluid, key, sparse)
    want, _ = _optimizer_step(jfluid, key, sparse)
    _close(got, want)
    assert not np.allclose(got['w'], init['w'])
    if sparse and key in LAZY:
        for n, v in init.items():
            if v.shape[:1] == (V,):
                assert np.array_equal(got[n][TOUCHED:], v[TOUCHED:]), n


# ---------------------------------------------------------------------------
# (c) log_loss, the ops a sparse gradient meets, fused_embedding_gather


def test_log_loss_matches_the_jax_lowering():
    rs = np.random.RandomState(4)
    p = 1.0 / (1.0 + np.exp(-_r(rs, 6, 1, scale=3.0)))
    y = (rs.rand(6, 1) > 0.5).astype('float32')
    out = {}
    for pkg in (fluid, jfluid):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            pv = pkg.layers.data(name='p', shape=[1], dtype='float32')
            yv = pkg.layers.data(name='y', shape=[1], dtype='float32')
            loss = pkg.layers.log_loss(pv, yv, epsilon=1e-4)
        exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
        out[pkg] = {'loss': exe.run(main, feed={'p': p.astype('float32'),
                                                'y': y},
                                    fetch_list=[loss], scope=pkg.Scope())[0]}
    _close(out[fluid], out[jfluid])


# op on the table's gradient: (type, attrs, extra inputs {slot: (name,
# array)}, output slot)
BRANCH_OPS = {
    'scale': ('scale', {'scale': 0.5, 'bias': 0.0}, {}),
    'scale_bias': ('scale', {'scale': 0.5, 'bias': 0.25}, {}),
    'clip': ('clip', {'min': -0.004, 'max': 0.003}, {}),
    'clip_by_norm': ('clip_by_norm', {'max_norm': 0.01}, {}),
    'mul_one': ('elementwise_mul', {'axis': -1},
                {'Y': ('f', np.array([0.7], 'float32'))}),
    'div_one': ('elementwise_div', {'axis': -1},
                {'Y': ('f', np.array([1.3], 'float32'))}),
    'add_dense': ('elementwise_add', {'axis': -1},
                  {'Y': ('f', np.full((V, D), 0.5, 'float32'))}),
    'sum': ('sum', {}, {'X2': ('f', np.full((V, D), 0.5, 'float32'))}),
    'squared_l2_norm': ('squared_l2_norm', {}, {}),
    'get_tensor': ('get_tensor_from_selected_rows', {}, {}),
    'merge': ('merge_selected_rows', {}, {}),
}


def _branch_out(pkg, key):
    op_type, attrs, extra = BRANCH_OPS[key]
    main, startup, _ = _grad_program(pkg, True)
    block = main.global_block()
    feed = _feed()
    inputs = {'X': ['w@GRAD']}
    for slot, (name, arr) in extra.items():
        block.create_var(name=name, shape=arr.shape, dtype='float32')
        feed[name] = arr
        if slot == 'X2':
            inputs['X'].append(name)
        else:
            inputs[slot] = [name]
    out = block.create_var(name='out', dtype='float32')
    block.append_op(type=op_type, inputs=inputs, outputs={'Out': [out]},
                    attrs=attrs)
    fetch = ['out']
    if key == 'merge':
        vals = block.create_var(name='vals', dtype='float32')
        block.append_op(type='get_tensor_from_selected_rows',
                        inputs={'X': ['out']}, outputs={'Out': [vals]})
        fetch.append('vals')
    exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    for n, v in _grad_init().items():
        scope.set(n, v)
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return dict(zip(fetch, [np.array(g) for g in got]))


@pytest.mark.parametrize('key', sorted(BRANCH_OPS))
def test_sparse_gradient_branch_matches_the_jax_lowering(key):
    got, want = _branch_out(fluid, key), _branch_out(jfluid, key)
    _close(got, want)
    if key == 'clip':
        # the bounds bite on the merged rows
        assert got['out'].max() == np.float32(0.003)


def _fused_gather(pkg, sparse):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 6
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ids = pkg.layers.data(name='ids', shape=[1], dtype='int64')
        t = pkg.layers.data(name='t', shape=[D], dtype='float32')
        block = main.global_block()
        helper = (THelper if pkg is fluid else JHelper)(
            'fused_embedding_gather')
        w = helper.create_parameter(attr=pkg.ParamAttr(name='w'),
                                    shape=[V, D], dtype='float32')
        b = helper.create_parameter(attr=pkg.ParamAttr(name='b'),
                                    shape=[D], dtype='float32',
                                    is_bias=True)
        out = block.create_var(name='emb', shape=(-1, D), dtype='float32')
        block.append_op(type='fused_embedding_gather',
                        inputs={'W': [w], 'Ids': [ids], 'Bias': [b]},
                        outputs={'Out': [out]},
                        attrs={'is_sparse': sparse, 'padding_idx': 3})
        loss = pkg.layers.mean(pkg.layers.square_error_cost(out, t))
        pkg.optimizer.SGD(0.5).minimize(loss)
    rs = np.random.RandomState(8)
    exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    scope.set('w', _r(rs, V, D))
    scope.set('b', _r(rs, D))
    feed = _feed()
    got = exe.run(main, feed={'ids': feed['ids'], 't': feed['t']},
                  fetch_list=[loss, 'emb', 'w', 'b'], scope=scope)
    return {k: np.array(v) for k, v in zip(['loss', 'emb', 'w', 'b'], got)}


@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'sparse'])
def test_fused_embedding_gather_matches_the_jax_lowering(sparse):
    got, want = _fused_gather(fluid, sparse), _fused_gather(jfluid, sparse)
    _close(got, want)


# ---------------------------------------------------------------------------
# (d) the optimizer classes


def _opt(pkg, kind):
    o = pkg.optimizer
    return {'adagrad': lambda: o.Adagrad(0.05, initial_accumulator_value=0.1),
            'adamax': lambda: o.Adamax(0.01),
            'decayed_adagrad': lambda: o.DecayedAdagrad(0.05),
            'adadelta': lambda: o.Adadelta(1.0, rho=0.9),
            'rmsprop': lambda: o.RMSProp(0.01, momentum=0.5),
            'rmsprop_centered': lambda: o.RMSProp(0.01, centered=True),
            'ftrl': lambda: o.Ftrl(0.1, l1=0.001, l2=0.001),
            'lars': lambda: o.LarsMomentum(0.1, 0.9, lars_coeff=0.01)}[kind]()


OPT_KINDS = ['adagrad', 'adamax', 'decayed_adagrad', 'adadelta', 'rmsprop',
             'rmsprop_centered', 'ftrl', 'lars']


def _small_net(pkg, kind):
    """A sparse embedding and two fc layers under optimizer ``kind``."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ids = pkg.layers.data(name='ids', shape=[3], dtype='int64')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        emb = pkg.layers.embedding(pkg.layers.reshape(ids, [-1, 3, 1]),
                                   size=[20, 4], is_sparse=True)
        h = pkg.layers.fc(pkg.layers.reshape(emb, [-1, 12]), size=8,
                          act='relu')
        p = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(p, y))
        _opt(pkg, kind).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize('kind', OPT_KINDS)
def test_optimizer_program_dicts_equal_the_jax_package(kind):
    jmain, jstart, _ = _small_net(jfluid, kind)
    tmain, tstart, _ = _small_net(fluid, kind)
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    assert tser.program_to_dict(tstart) == jser.program_to_dict(jstart)


def _scope_arrays(scope):
    return {n: np.array(scope.get(n)) for n in scope.names()
            if hasattr(scope.get(n), 'shape')}


def _hold(jmain, jstart, jloss, tmain, tloss, batches):
    """Both Executors over ``batches`` from the JAX startup scope: losses
    within 1e-4 relative, every scope tensor within 1e-3 of its largest
    magnitude. Returns (losses, final port scope arrays, init)."""
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(jstart, scope=scope)
    init = _scope_arrays(scope)
    texe, tscope = fluid.Executor(CPU), scope_from_numpy(init, device='cpu')
    want, got = [], []
    for f in batches:
        want.append(float(exe.run(jmain, feed=f, fetch_list=[jloss],
                                  scope=scope)[0][0]))
        got.append(float(texe.run(tmain, feed=f, fetch_list=[tloss],
                                  scope=tscope)[0][0]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    jstate, tstate = _scope_arrays(scope), _scope_arrays(tscope)
    assert sorted(tstate) == sorted(jstate)
    for n in jstate:
        scale = max(float(np.abs(jstate[n]).max()), 1e-30)
        assert float(np.abs(tstate[n] - jstate[n]).max()) <= 1e-3 * scale, n
    return got, tstate, init


def _small_batches(n=3):
    rs = np.random.RandomState(9)
    return [{'ids': rs.randint(0, 20, (6, 3)).astype('int64'),
             'y': _r(rs, 6, 1)} for _ in range(n)]


@pytest.mark.parametrize('kind', OPT_KINDS)
def test_optimizer_three_steps_match_the_jax_executor(kind):
    jmain, jstart, jloss = _small_net(jfluid, kind)
    tmain, _, tloss = _small_net(fluid, kind)
    _, tstate, init = _hold(jmain, jstart, jloss, tmain, tloss,
                            _small_batches())
    assert not np.allclose(tstate['fc_1.w_0'], init['fc_1.w_0'])


def test_model_average_waits_for_a_later_slice():
    with pytest.raises(NotImplementedError, match='average_accumulates'):
        fluid.optimizer.ModelAverage(0.15)


# ---------------------------------------------------------------------------
# (e) the CTR program


CTR_V, CTR_SLOTS, CTR_D, CTR_H, CTR_B, CTR_STEPS = 1000, 26, 16, 64, 64, 5


def _ctr(pkg, opt='adagrad', is_distributed=False):
    """bench.py `_bench_ctr`'s program at the CTR test size: 26 slots'
    ids, one sparse embedding, fc relu, fc relu, fc 1 sigmoid,
    ``mean(log_loss)``, minimized by ``opt``."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ids = pkg.layers.data(name='ids', shape=[CTR_SLOTS], dtype='int64')
        label = pkg.layers.data(name='label', shape=[1], dtype='float32')
        emb = pkg.layers.embedding(
            input=pkg.layers.reshape(ids, [-1, CTR_SLOTS, 1]),
            size=[CTR_V, CTR_D], is_sparse=True,
            is_distributed=is_distributed)
        flat = pkg.layers.reshape(emb, [-1, CTR_SLOTS * CTR_D])
        h = pkg.layers.fc(flat, size=CTR_H, act='relu')
        h = pkg.layers.fc(h, size=CTR_H, act='relu')
        p = pkg.layers.fc(h, size=1, act='sigmoid')
        loss = pkg.layers.mean(pkg.layers.log_loss(p, label))
        o, reg = pkg.optimizer, pkg.regularizer
        if opt == 'sgd_global_norm':
            pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(0.05))
        {'adagrad': lambda: o.Adagrad(learning_rate=0.01),
         'adam_fused': lambda: o.Adam(1e-3, fuse=True),
         'adam': lambda: o.Adam(1e-3),
         'momentum': lambda: o.Momentum(0.05, 0.9),
         'momentum_l2': lambda: o.Momentum(
             0.05, 0.9, regularization=reg.L2Decay(1e-3)),
         'sgd': lambda: o.SGD(0.1),
         'sgd_global_norm': lambda: o.SGD(0.1)}[opt]().minimize(loss)
    return main, startup, loss


def _ctr_batches(n=CTR_STEPS, seed=0):
    """bench.py:545-551: one distinct batch a step, labelled by a teacher
    (a click iff the ids' fixed random scores sum positive)."""
    rng = np.random.RandomState(seed)
    score = rng.randn(CTR_V).astype('float32')
    out = []
    for _ in range(n):
        ids = rng.randint(0, CTR_V, (CTR_B, CTR_SLOTS)).astype('int64')
        out.append({'ids': ids, 'label': (score[ids].sum(1) > 0)
                    .astype('float32').reshape(-1, 1)})
    return out


CTR_OPTS = ['adagrad', 'adam_fused', 'adam', 'momentum', 'momentum_l2',
            'sgd', 'sgd_global_norm']


@pytest.mark.parametrize('opt', CTR_OPTS)
def test_ctr_trajectory_matches_the_jax_executor(opt):
    jmain, jstart, jloss = _ctr(jfluid, opt)
    tmain, _, tloss = _ctr(fluid, opt)
    grads = [v for v in tmain.global_block().vars.values()
             if v.name.endswith('@GRAD')]
    assert [v.name for v in grads if v.type == 'selected_rows'] == \
        ['embedding_0.w_0@GRAD']
    losses, tstate, init = _hold(jmain, jstart, jloss, tmain, tloss,
                                 _ctr_batches())
    assert all(np.isfinite(losses))
    assert not np.array_equal(tstate['embedding_0.w_0'],
                              init['embedding_0.w_0'])


def test_ctr_program_dicts_equal_the_jax_package():
    for opt in ('adagrad', 'adam_fused'):
        for dist in (False, True):
            jmain, jstart, _ = _ctr(jfluid, opt, dist)
            tmain, tstart, _ = _ctr(fluid, opt, dist)
            assert tser.program_to_dict(tmain) == \
                jser.program_to_dict(jmain)
            assert tser.program_to_dict(tstart) == \
                jser.program_to_dict(jstart)


def _port_run(main, loss, init, batches, fused=False, bind=False):
    exe, scope = fluid.Executor(CPU), scope_from_numpy(init, device='cpu')
    if fused:
        out = [exe.run_fused(main, batches, fetch_list=[loss],
                             scope=scope)[0]]
    elif bind:
        bp = exe.bind(main, batches[0], fetch_list=[loss], scope=scope)
        out = [bp.first_out[0]] + [bp(b)[0] for b in batches[1:]]
    else:
        out = [exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]
               for b in batches]
    return [np.array(o) for o in out], _scope_arrays(scope)


def _ctr_init(opt='adagrad'):
    main, startup, loss = _ctr(fluid, opt)
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    return main, loss, {n: v.copy() for n, v in _scope_arrays(scope).items()}


def test_is_distributed_equals_the_plain_lookup_on_one_device():
    main, loss, init = _ctr_init()
    dmain, _, dloss = _ctr(fluid, 'adagrad', is_distributed=True)
    batches = _ctr_batches(3)
    plain, pstate = _port_run(main, loss, init, batches)
    dist, dstate = _port_run(dmain, dloss, init, batches)
    assert all(np.array_equal(a, b) for a, b in zip(plain, dist))
    assert all(np.array_equal(pstate[n], dstate[n]) for n in pstate)


@pytest.mark.parametrize('padding_idx', [None, 3], ids=['plain', 'padded'])
def test_fetched_sparse_gradient_equals_the_jax_dense_fetch(padding_idx):
    out = {}
    for pkg in (fluid, jfluid):
        main, startup, loss = _grad_program(pkg, True, padding_idx)
        exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        for n, v in _grad_init().items():
            scope.set(n, v)
        feed = _feed()
        feed['ids'][4, 0] = 3
        g, = exe.run(main, feed=feed, fetch_list=['w@GRAD'], scope=scope)
        out[pkg] = {'w@GRAD': np.array(g)}
    _close(out[fluid], out[jfluid])
    g = out[fluid]['w@GRAD']
    assert g.shape == (V, D) and not g[TOUCHED:].any()
    assert g[3].any() == (padding_idx is None)


@pytest.mark.parametrize('how', ['run_fused', 'bind'])
def test_bound_ctr_steps_equal_run_calls(how):
    main, loss, init = _ctr_init('adam_fused')
    batches = _ctr_batches(4, seed=1)
    want, wstate = _port_run(main, loss, init, batches)
    got, gstate = _port_run(main, loss, init, batches,
                            fused=how == 'run_fused', bind=how == 'bind')
    assert np.array_equal(got[-1], want[-1])
    assert all(np.array_equal(gstate[n], wstate[n]) for n in wstate)
