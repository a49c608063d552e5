"""The image ops and ResNet of paddle_tpu_torch against the JAX package, on
the CPU.

Every input comes from a numpy seed and goes through both packages.

(a) `conv2d` and `depthwise_conv2d` as one-op programs run by both
    Executors, over stride, padding, dilation and groups (ResNet's 7 x 7
    stride-2 stem and 1 x 1 stride-2 shortcut among them): within 1e-5 of
    the largest magnitude; and the port's convolution under an AMP mark
    against the JAX lowering under the same mark, bf16 operands (within
    1e-2 of the largest magnitude, bf16's step).
(b) `pool2d` over max / avg x ``exclusive`` x ``ceil_mode`` x padding, on
    9 x 7 maps whose ``ceil_mode`` windows need right padding beyond the
    left, plus global and adaptive windows: within 1e-5.
(c) `batch_norm` in training (``Y``, ``MeanOut``, ``VarianceOut``,
    ``SavedMean``, ``SavedVariance``; one channel of mean 1e3 and
    variance about 2e-4, which a one-pass variance would lose) and under ``is_test``: within
    1e-5 of each output's largest magnitude.
(d) `cross_entropy` (hard labels with a wrapped negative label and
    ``ignore_index``, soft labels), `top_k` and `accuracy`: within 1e-5
    (the indices and counts exactly).
(e) The program dicts of `models.resnet`: cifar10 depth 8, a narrow
    `bottleneck` stage, and the bench's ImageNet ResNet-50, equal to the
    JAX package's (`core.serialization.program_to_dict`).
(f) The cifar10 ResNet of depth 8, one forward in training mode and one
    in test mode (the moving statistics), from the JAX startup scope: the
    softmax's input within 1e-5 of its largest magnitude, every moving
    statistic the training forward writes back within 1e-5; and two SGD
    steps (every op's backward): the losses within 1e-5 relative, the
    parameters and moving statistics within 1e-4 of their largest
    magnitudes.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.core import serialization as jser
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import amp as tamp
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import resnet as tresnet

CPU = fluid.CPUPlace()


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


def _close(got, want, tol=1e-5, exact=()):
    """Each output of ``got`` within ``tol`` of its largest magnitude in
    ``want`` (the names in ``exact`` equal), and the same non-finite
    values where ``want`` has them (a window of padding alone pools to
    -inf, or to 0 / 0 in an exclusive average, in the reference). Integer
    outputs are held by value: the JAX package without x64 makes int64
    int32."""
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, name
        assert g.dtype == w.dtype or g.dtype.kind == w.dtype.kind == 'i', \
            name
        if name in exact:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        odd = ~np.isfinite(w)
        np.testing.assert_array_equal(g[odd], w[odd], err_msg=name)
        scale = max(float(np.abs(w[~odd]).max()), 1e-30)
        assert float(np.abs(g - w)[~odd].max()) <= tol * scale, name


# ---------------------------------------------------------------------------
# (a) convolution

# (op, N, C, H, W, O, k, stride, padding, dilation, groups)
CONV_CASES = {
    'plain': ('conv2d', 2, 3, 9, 8, 4, 3, 1, 0, 1, 1),
    'stride2_pad1': ('conv2d', 2, 4, 9, 9, 6, 3, 2, 1, 1, 1),
    'dilation2_pad2': ('conv2d', 2, 3, 10, 9, 5, 3, 1, 2, 2, 1),
    'groups2': ('conv2d', 2, 4, 8, 8, 6, 3, 2, 3, 1, 2),
    'stem_7x7_s2': ('conv2d', 1, 3, 16, 16, 8, 7, 2, 3, 1, 1),
    'shortcut_1x1_s2': ('conv2d', 2, 8, 7, 7, 16, 1, 2, 0, 1, 1),
    'depthwise': ('depthwise_conv2d', 2, 6, 9, 7, 6, 3, 1, 1, 1, 6),
}


def _conv_inputs(case, seed=0):
    op, n, c, h, w, o, k, s, p, d, g = case
    rs = np.random.RandomState(seed)
    inputs = {'Input': [('x', _r(rs, n, c, h, w))],
              'Filter': [('w', _r(rs, o, c // g, k, k, scale=0.3))]}
    attrs = {'strides': [s, s], 'paddings': [p, p], 'dilations': [d, d],
             'groups': g}
    return op, inputs, attrs


@pytest.mark.parametrize('key', sorted(CONV_CASES))
def test_conv2d_matches_the_jax_lowering(key):
    op, inputs, attrs = _conv_inputs(CONV_CASES[key])
    outs = {'Output': ['y']}
    _close(_run_one_op(fluid, op, inputs, outs, attrs),
           _run_one_op(jfluid, op, inputs, outs, attrs))


def test_marked_conv2d_computes_in_bf16_as_the_jax_lowering():
    op, inputs, attrs = _conv_inputs(CONV_CASES['stride2_pad1'], seed=1)
    attrs[tamp.AMP_ATTR] = 'bfloat16'
    outs = {'Output': ['y']}
    got = _run_one_op(fluid, op, inputs, outs, attrs)
    _close(got, _run_one_op(jfluid, op, inputs, outs, attrs), tol=1e-2)
    # and not the float32 product: the mark took effect
    attrs.pop(tamp.AMP_ATTR)
    f32 = _run_one_op(fluid, op, inputs, outs, attrs)['y']
    assert not np.array_equal(got['y'], f32)


# ---------------------------------------------------------------------------
# (b) pooling

def _pool_cases():
    c = {}
    for ceil in (False, True):
        for pad in (0, 1):
            c['max_ceil%d_pad%d' % (ceil, pad)] = ('max', True, ceil, pad)
            for excl in (False, True):
                c['avg_excl%d_ceil%d_pad%d' % (excl, ceil, pad)] = (
                    'avg', excl, ceil, pad)
    return c


POOL_CASES = _pool_cases()


def _pool_x(seed=3):
    return _r(np.random.RandomState(seed), 2, 3, 9, 7)


@pytest.mark.parametrize('key', sorted(POOL_CASES))
def test_pool2d_matches_the_jax_lowering(key):
    ptype, excl, ceil, pad = POOL_CASES[key]
    attrs = {'pooling_type': ptype, 'ksize': [3, 2], 'strides': [2, 2],
             'paddings': [pad, pad], 'global_pooling': False,
             'ceil_mode': ceil, 'exclusive': excl}
    args = ('pool2d', {'X': [('x', _pool_x())]}, {'Out': ['y']}, attrs)
    got = _run_one_op(fluid, *args)
    _close(got, _run_one_op(jfluid, *args))
    if ceil:
        # the 9 x 7 map's last windows start past its floor-mode ones
        assert got['y'].shape[2:] == ((9 + 2 * pad - 3 + 1) // 2 + 1,
                                      (7 + 2 * pad - 2 + 1) // 2 + 1)


@pytest.mark.parametrize('ptype', ['max', 'avg'])
@pytest.mark.parametrize('how', ['global', 'adaptive'])
def test_global_and_adaptive_pool2d_match_the_jax_lowering(ptype, how):
    attrs = {'pooling_type': ptype, 'ksize': [7, 7] if how == 'global'
             else [4, 3], 'strides': [1, 1], 'paddings': [1, 1],
             'global_pooling': how == 'global', 'ceil_mode': False,
             'exclusive': True, 'adaptive': how == 'adaptive'}
    args = ('pool2d', {'X': [('x', _pool_x(4))]}, {'Out': ['y']}, attrs)
    _close(_run_one_op(fluid, *args), _run_one_op(jfluid, *args))


# ---------------------------------------------------------------------------
# (c) batch norm

BN_STATE = ('m', 'v', 'sc', 'b')


def _bn_inputs(seed=5):
    rs = np.random.RandomState(seed)
    x = _r(rs, 4, 3, 4, 8)
    # large mean, tiny variance: steps of 2^-7 around 1e3 keep every
    # partial sum exact and 128 values a channel make the division exact,
    # so both packages' means agree to the bit and the comparison sees the
    # variance's arithmetic, not the summation order
    x[:, 1] = 1e3 + 2.0 ** -7 * rs.randint(-3, 4, x[:, 1].shape)
    return {'X': [('x', x)], 'Scale': [('sc', 1 + _r(rs, 3, scale=0.1))],
            'Bias': [('b', _r(rs, 3, scale=0.1))],
            'Mean': [('m', _r(rs, 3))],
            'Variance': [('v', 0.5 + rs.rand(3).astype('float32'))]}


@pytest.mark.parametrize('is_test', [False, True], ids=['train', 'test'])
def test_batch_norm_matches_the_jax_lowering(is_test):
    outs = {'Y': ['y'], 'MeanOut': ['m'], 'VarianceOut': ['v'],
            'SavedMean': ['sm'], 'SavedVariance': ['sv']}
    attrs = {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': is_test,
             'data_layout': 'NCHW', 'use_global_stats': False}
    args = ('batch_norm', _bn_inputs(), outs, attrs, BN_STATE)
    got = _run_one_op(fluid, *args)
    want = _run_one_op(jfluid, *args)
    for name in want:
        _close({name: got[name]}, {name: want[name]})
    if not is_test:
        # the tiny-variance channel keeps its variance (about 2e-4, against
        # the 1e6 of its mean's square)
        x = _bn_inputs()['X'][0][1].astype(np.float64)
        true = 1.0 / np.sqrt(x[:, 1].var() + 1e-5)
        assert abs(float(got['sv'][1]) / true - 1.0) < 1e-3


# ---------------------------------------------------------------------------
# (d) cross entropy, top_k, accuracy

def _probs(rs, n, c):
    e = np.exp(_r(rs, n, c))
    return (e / e.sum(-1, keepdims=True)).astype('float32')


@pytest.mark.parametrize('soft', [False, True], ids=['hard', 'soft'])
def test_cross_entropy_matches_the_jax_lowering(soft):
    rs = np.random.RandomState(6)
    x = _probs(rs, 6, 5)
    x[0, 2] = 0.0                               # clipped at 1e-20
    if soft:
        label = _probs(rs, 6, 5)
    else:
        label = np.array([[2], [1], [-1], [4], [-100], [0]], 'int64')
    args = ('cross_entropy', {'X': [('x', x)], 'Label': [('lab', label)]},
            {'Y': ['y']}, {'soft_label': soft, 'ignore_index': -100})
    got = _run_one_op(fluid, *args)
    _close(got, _run_one_op(jfluid, *args))
    if not soft:
        assert got['y'][4, 0] == 0.0 and got['y'][0, 0] > 40


def test_top_k_and_accuracy_match_the_jax_lowerings():
    rs = np.random.RandomState(8)
    x = _r(rs, 7, 6)
    label = rs.randint(0, 6, (7, 1)).astype('int64')
    for k in (1, 3):
        args = ('top_k', {'X': [('x', x)]},
                {'Out': ['vals'], 'Indices': ['idx']}, {'k': k})
        got = _run_one_op(fluid, *args)
        _close(got, _run_one_op(jfluid, *args), exact=('idx',))
        args = ('accuracy', {'Out': [('vals', got['vals'])],
                             'Indices': [('idx', got['idx'])],
                             'Label': [('lab', label)]},
                {'Accuracy': ['acc'], 'Correct': ['ok'], 'Total': ['n']}, {})
        acc = _run_one_op(fluid, *args)
        _close(acc, _run_one_op(jfluid, *args), exact=('ok', 'n'))
        assert acc['n'].tolist() == [7]


# ---------------------------------------------------------------------------
# (e) the program dicts

def _build(pkg, rmod, what):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if what == 'cifar10_d8':
            out = rmod.build('cifar10', depth=8)
        elif what == 'imagenet_d50':
            out = rmod.build('imagenet', depth=50)
        else:       # one narrow bottleneck stage, stride 2
            x = pkg.layers.data(name='x', shape=[8, 12, 12],
                                dtype='float32')
            out = rmod._layer_warp(rmod.bottleneck, x, 8, 4, 2, 2, False)
    return main, startup, out


@pytest.mark.parametrize('what', ['cifar10_d8', 'bottleneck',
                                  'imagenet_d50'])
def test_resnet_program_dicts_equal_the_jax_package(what):
    jmain, jstart, _ = _build(jfluid, jresnet, what)
    tmain, tstart, _ = _build(fluid, tresnet, what)
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    assert tser.program_to_dict(tstart) == jser.program_to_dict(jstart)


# ---------------------------------------------------------------------------
# (f) the cifar10 ResNet

def _scope_arrays(scope):
    return {n: np.array(scope.get(n)) for n in scope.names()
            if hasattr(scope.get(n), 'shape')}


def test_resnet_cifar10_forward_matches_the_jax_executor():
    jmain, jstart, (_, _, jpred, _, _) = _build(jfluid, jresnet, 'cifar10_d8')
    tmain, _, (_, _, tpred, _, _) = _build(fluid, tresnet, 'cifar10_d8')
    logits = [op for op in jmain.global_block().ops
              if op.type == 'softmax'][0].input('X')[0]
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(jstart, scope=scope)
    init = _scope_arrays(scope)
    stats = sorted(n for n in init if n.endswith(('.mean', '.variance')))
    assert len(stats) == 2 * 9           # nine batch norms
    feed = {'img': _r(np.random.RandomState(9), 2, 3, 32, 32),
            'label': np.array([[3], [7]], 'int64')}
    texe = fluid.Executor(CPU)
    tscope = scope_from_numpy(init, device='cpu')
    for prog in ('train', 'test'):
        jp, tp = (jmain, tmain) if prog == 'train' else \
            (jmain.clone(for_test=True), tmain.clone(for_test=True))
        want = exe.run(jp, feed=feed, fetch_list=[logits, jpred.name],
                       scope=scope)
        got = texe.run(tp, feed=feed, fetch_list=[logits, tpred.name],
                       scope=tscope)
        _close({'logits': got[0], 'pred': got[1]},
               {'logits': want[0], 'pred': want[1]})
    # the training forward wrote the moving statistics back
    moved = {n: np.array(tscope.get(n)) for n in stats}
    _close(moved, {n: np.array(scope.get(n)) for n in stats})
    assert any(not np.array_equal(moved[n], init[n]) for n in stats)


def test_resnet_cifar10_sgd_steps_match_the_jax_executor():
    """Two ``SGD(0.05)`` steps of the cifar10 ResNet of depth 8 (the
    backward of conv2d, batch norm, pooling, the softmax and
    cross_entropy) from the JAX startup scope: the losses within 1e-5
    relative, every parameter and moving statistic within 1e-4 of its
    largest magnitude."""
    def build(pkg, rmod):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            _, _, _, avg, _ = rmod.build('cifar10', depth=8)
            pkg.optimizer.SGD(0.05).minimize(avg)
        return main, startup, avg

    jmain, jstart, javg = build(jfluid, jresnet)
    tmain, _, tavg = build(fluid, tresnet)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(jstart, scope=scope)
    init = _scope_arrays(scope)
    tscope = scope_from_numpy(init, device='cpu')
    rs = np.random.RandomState(10)
    feeds = [{'img': _r(rs, 4, 3, 32, 32),
              'label': rs.randint(0, 10, (4, 1)).astype('int64')}
             for _ in range(2)]
    texe = fluid.Executor(CPU)
    for f in feeds:
        want = exe.run(jmain, feed=f, fetch_list=[javg], scope=scope)[0]
        got = texe.run(tmain, feed=f, fetch_list=[tavg], scope=tscope)[0]
        assert abs(float(got[0]) / float(want[0]) - 1.0) <= 1e-5
    want = _scope_arrays(scope)
    got = {n: np.array(tscope.get(n)) for n in want}
    assert not np.allclose(got['conv2d_0.w_0'], init['conv2d_0.w_0'])
    _close(got, want, tol=1e-4)
