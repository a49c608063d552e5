"""Image-classification training of paddle_tpu_torch against the JAX
package, on the CPU: SE-ResNeXt-50, VGG-16, `nets`, keep-bf16 AMP and
bound steps over batch norm's running statistics.

Every input comes from a numpy seed and goes through both packages.

(a) The program dicts (`core.serialization.program_to_dict`, under a fresh
    ``unique_name.guard()``) of the bench's rows at full width,
    SE-ResNeXt-50 (ImageNet, 1000 classes) and VGG-16 (CIFAR, 10
    classes), each under ``Momentum`` plain and under
    ``decorate(Momentum, keep_bf16_activations=True)``, and of
    `nets.simple_img_conv_pool`: equal to the JAX package's, main and
    startup. Under keep, the ops that carry the keep mark are exactly the
    convolutions (``batch_norm`` is black-listed), as in JAX.
(b) Keep mode, op by op: a marked, kept ``conv2d`` returns bf16 equal to
    the JAX lowering's bitwise; a ``batch_norm`` of that bf16 output
    returns bf16 ``Y`` within 1e-2 of its largest magnitude of JAX's
    (bf16's step), and its float32 ``SavedMean`` within 1e-6 of the
    float64 mean of the same bf16 values. The JAX lowering's mean of a
    bf16 input is coarser on the CPU (measured 9e-4 of the largest
    magnitude off, the reason (e) holds the port to AMP limits rather than
    to a float32 control). A global average pool of a kept activation sums
    in float32: within one bf16 rounding of the exact mean, closer to it
    than the JAX lowering's bf16 sum.
(c) A narrow SE bottleneck (cardinality 4, stride 2, the 1 x 1 shortcut)
    and a narrow `img_conv_group` (two conv + batch norm + ReLU, then a
    2 x 2 max pool): three ``Momentum`` steps from the JAX startup scope
    against the JAX executor at the float32 limits (loss 1e-4 relative,
    every parameter, velocity and moving statistic within 1e-3 of its
    largest magnitude; the group's conv biases, which sit ahead of a batch
    norm and so have a gradient of 0 up to rounding, within 1e-3 of the
    state's largest magnitude), and under keep-bf16 AMP every float variable of
    the forward has the JAX run's dtype (the SE gate's ``elementwise_mul``
    of a bf16 map by a float32 gate is float32 in both; a marked ``mul`` of
    a bf16 input returns bf16 in both; in the group a conv's bias add
    promotes its bf16 output to float32 in both).
(d) VGG-16 at full width, CIFAR shape, B 2: the test-mode clone's logits
    and probabilities within 1e-5 of their largest magnitudes of JAX's,
    from the JAX startup scope (the conv groups' dropouts draw in
    training and take no ``is_test``: the clone turns them off). In
    training mode the port's first dropout (p 0.3, downgrade_in_infer)
    gives ``Out == X * Mask`` exactly and a keep fraction within five
    binomial standard deviations of 0.7 (the two packages' draws differ).
(e) The cifar10 ResNet of depth 8 under ``decorate(Momentum(0.05, 0.9,
    use_nesterov=True), keep_bf16_activations=True)``, three steps from
    the JAX startup scope at `PERF.md` §2's AMP limits: the losses within
    5e-3 relative, the parameters and the moving statistics within 2e-2 of
    the whole model's largest magnitude (measured 1.5e-3 and 2.9e-3); the
    forward's float dtypes equal JAX's, the activations bf16; the port's
    AMP run differs from its float32 run.
(f) Bound steps carry batch norm's running statistics: `Executor.bind`
    calls and ``run_fused`` over K batches of the cifar10 ResNet under
    Momentum equal K ``run()`` calls bitwise, every parameter, velocity and
    moving statistic included.
(g) The conv lowering's TF32 guard takes only a float32 convolution on a
    CUDA tensor (card tests: `-k "kept_conv or bound_momentum"` in
    tests/test_torch_cuda.py).
(h) The float64 witness of chip_smoke.py's image holds: a float64 batch
    norm keeps float64 statistics (1e-12 of numpy's), and the hold's
    verdict passes equal sides and fails a float64 velocity 1e-6 off, a
    zeroed float32 gradient, a 1.5x AMP gradient and a 2% AMP loss.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.core import serialization as jser
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import se_resnext as jse
from paddle_tpu.models import vgg as jvgg

import paddle_tpu_torch as fluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.core import amp as tamp
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import se_resnext as tse
from paddle_tpu_torch.models import vgg as tvgg

CPU = fluid.CPUPlace()
STEPS = 3
F32 = dict(loss=1e-4, state=1e-3)
AMP = dict(loss=5e-3, state=2e-2)

# (JAX model module, port model module) of each package
MODS = {'se_resnext': (jse, tse), 'vgg': (jvgg, tvgg),
        'resnet': (jresnet, tresnet)}


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


def _is_jax(pkg):
    return pkg is jfluid


def _mp(pkg):
    return jmp if _is_jax(pkg) else tmp


def _program(pkg, body, opt=None, amp=False, seed=3):
    """(main, startup, outs) of ``body(pkg)`` (which returns (..., loss,
    ...) with the loss at ``outs[3]``, or a bare output), minimized by
    ``opt(pkg)`` (decorated with keep-bf16 AMP if ``amp``) if given."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        outs = body(pkg)
        if opt is not None:
            o = opt(pkg)
            if amp:
                o = _mp(pkg).decorate(o, keep_bf16_activations=True)
            o.minimize(outs[3])
    return main, startup, outs


def _momentum(lr=0.05, nesterov=False):
    return lambda pkg: pkg.optimizer.Momentum(lr, 0.9, use_nesterov=nesterov)


def _model(name, **kw):
    def body(pkg):
        mod = MODS[name][0 if _is_jax(pkg) else 1]
        return mod.build(**kw)
    return body


def _scope_arrays(scope):
    return {n: np.array(scope.get(n)) for n in scope.names()
            if hasattr(scope.get(n), 'shape')}


def _jax_init(startup):
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    return _scope_arrays(scope)


def _jax_scope(init):
    scope = jfluid.Scope()
    for n, v in init.items():
        scope.set(n, v.copy())
    return scope


def _forward_vars(program):
    """The non-persistable float variables the forward writes, in op
    order (everything before the ``backward`` meta-op)."""
    names, block = [], program.global_block()
    for op in block.ops:
        if op.type == 'backward':
            break
        for n in op.output_arg_names:
            v = block.var(n)
            if not v.persistable and n not in names and \
                    str(v.dtype).startswith(('float', 'bfloat')):
                names.append(n)
    return names


def _jax_dtype(a):
    return 'bfloat16' if str(a.dtype) == 'bfloat16' else str(a.dtype)


def _port_dtype(t):
    return str(t.dtype).replace('torch.', '')


# ---------------------------------------------------------------------------
# (a) the program dicts

DICT_CASES = {
    'se_resnext': _model('se_resnext'),
    'vgg': _model('vgg'),
}


@pytest.mark.parametrize('amp', [False, True], ids=['f32', 'keep_bf16'])
@pytest.mark.parametrize('name', sorted(DICT_CASES))
def test_program_dicts_equal_the_jax_package(name, amp):
    jmain, jstart, _ = _program(jfluid, DICT_CASES[name], _momentum(0.02),
                                amp)
    tmain, tstart, _ = _program(fluid, DICT_CASES[name], _momentum(0.02),
                                amp)
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    assert tser.program_to_dict(tstart) == jser.program_to_dict(jstart)
    kept = [op.type for op in tmain.global_block().ops
            if op.attr(tamp.AMP_KEEP_ATTR)]
    convs = [op for op in tmain.global_block().ops if op.type == 'conv2d']
    assert kept == (['conv2d'] * len(convs) if amp else [])
    assert len(convs) == {'se_resnext': 53, 'vgg': 13}[name]


def test_simple_img_conv_pool_program_equals_the_jax_package():
    def body(pkg):
        x = pkg.layers.data(name='x', shape=[3, 12, 12], dtype='float32')
        return pkg.nets.simple_img_conv_pool(
            x, num_filters=4, filter_size=3, pool_size=2, pool_stride=2,
            conv_padding=1, act='relu')

    jmain, jstart, _ = _program(jfluid, body)
    tmain, tstart, _ = _program(fluid, body)
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    assert tser.program_to_dict(tstart) == jser.program_to_dict(jstart)


# ---------------------------------------------------------------------------
# (b) keep mode, op by op


def _conv_bn(pkg, x, w, sc, b):
    """A kept conv2d and a batch_norm of its output, as a two-op program
    run once: {name: value} of the conv output, Y and SavedMean (numpy;
    the port's as its tensors too)."""
    main = pkg.Program()
    block = main.global_block()
    scope = pkg.Scope()
    for name, arr, state in (('x', x, False), ('w', w, True),
                             ('sc', sc, True), ('b', b, True),
                             ('m', np.zeros(w.shape[0], 'float32'), True),
                             ('v', np.ones(w.shape[0], 'float32'), True)):
        block.create_var(name=name, shape=arr.shape, dtype='float32',
                         persistable=state)
        if state:
            scope.set(name, arr.copy())
    for n in ('y', 'z', 'sm', 'sv'):
        block.create_var(name=n, dtype='float32')
    block.append_op(type='conv2d', inputs={'Input': ['x'], 'Filter': ['w']},
                    outputs={'Output': ['y']},
                    attrs={'strides': [1, 1], 'paddings': [1, 1],
                           'dilations': [1, 1], 'groups': 1,
                           tamp.AMP_ATTR: 'bfloat16',
                           tamp.AMP_KEEP_ATTR: True})
    block.append_op(type='batch_norm',
                    inputs={'X': ['y'], 'Scale': ['sc'], 'Bias': ['b'],
                            'Mean': ['m'], 'Variance': ['v']},
                    outputs={'Y': ['z'], 'MeanOut': ['m'],
                             'VarianceOut': ['v'], 'SavedMean': ['sm'],
                             'SavedVariance': ['sv']},
                    attrs={'momentum': 0.9, 'epsilon': 1e-5,
                           'is_test': False, 'data_layout': 'NCHW',
                           'use_global_stats': False})
    if _is_jax(pkg):
        got = pkg.Executor().run(main, feed={'x': x},
                                 fetch_list=['y', 'z', 'sm'], scope=scope)
        return dict(zip(('y', 'z', 'sm'), got))
    got = pkg.Executor(CPU).run(main, feed={'x': x},
                                fetch_list=['y', 'z', 'sm'], scope=scope,
                                return_numpy=False)
    return dict(zip(('y', 'z', 'sm'), got))


def test_kept_conv_and_batch_norm_match_the_jax_lowerings():
    rs = np.random.RandomState(2)
    args = (_r(rs, 4, 3, 12, 12), _r(rs, 8, 3, 3, 3, scale=0.3),
            1 + _r(rs, 8, scale=0.1), _r(rs, 8, scale=0.1))
    want = _conv_bn(jfluid, *args)
    got = _conv_bn(fluid, *args)
    assert _jax_dtype(want['y']) == _jax_dtype(want['z']) == 'bfloat16'
    assert got['y'].dtype == got['z'].dtype == torch.bfloat16
    assert got['sm'].dtype == torch.float32
    y = got['y'].float().numpy()
    np.testing.assert_array_equal(y, np.asarray(want['y'], np.float32))
    z, wz = got['z'].float().numpy(), np.asarray(want['z'], np.float32)
    assert float(np.abs(z - wz).max()) <= 1e-2 * float(np.abs(wz).max())
    exact = y.astype(np.float64).mean(axis=(0, 2, 3))
    scale = float(np.abs(exact).max())
    assert float(np.abs(got['sm'].numpy() - exact).max()) <= 1e-6 * scale
    # the JAX lowering's float32 mean of the bf16 values, for the record
    jerr = float(np.abs(np.asarray(want['sm']) - exact).max()) / scale
    assert jerr < 5e-3


def _kept_conv_pool(pkg, x, w):
    """A kept conv2d and a global average pool of its bf16 output, run
    once: (conv output, pooled), float64 numpy."""
    main = pkg.Program()
    block = main.global_block()
    scope = pkg.Scope()
    block.create_var(name='x', shape=x.shape, dtype='float32')
    block.create_var(name='w', shape=w.shape, dtype='float32',
                     persistable=True)
    scope.set('w', w.copy())
    for n in ('y', 'p'):
        block.create_var(name=n, dtype='float32')
    block.append_op(type='conv2d', inputs={'Input': ['x'], 'Filter': ['w']},
                    outputs={'Output': ['y']},
                    attrs={'strides': [1, 1], 'paddings': [1, 1],
                           'dilations': [1, 1], 'groups': 1,
                           tamp.AMP_ATTR: 'bfloat16',
                           tamp.AMP_KEEP_ATTR: True})
    block.append_op(type='pool2d', inputs={'X': ['y']},
                    outputs={'Out': ['p']},
                    attrs={'pooling_type': 'avg', 'ksize': [1, 1],
                           'global_pooling': True, 'strides': [1, 1],
                           'paddings': [0, 0], 'ceil_mode': False,
                           'exclusive': True})
    exe = pkg.Executor() if _is_jax(pkg) else pkg.Executor(CPU)
    got = exe.run(main, feed={'x': x}, fetch_list=['y', 'p'], scope=scope)
    return [np.asarray(g, np.float64) for g in got]


@pytest.mark.parametrize('hw', [7, 14, 56])
def test_kept_average_pool_sums_in_float32(hw):
    """A global average pool of a kept bf16 activation (the heads of
    ResNet-50 and SE-ResNeXt-50 pool 7 x 7 maps, SE's gates up to 56 x
    56): the port sums in float32 and rounds once to bf16, within 4e-3
    (one bf16 rounding, 2^-8) of the float64 mean of its own bf16 input
    (measured 3.6e-3 to 3.8e-3 of the largest magnitude). The JAX lowering
    sums the window in bf16 (`lax.reduce_window`): on the same inputs it
    lies farther from the exact mean of its own bf16 input than the port
    does (measured on the CPU 1.9e-2 and 2.0e-2 at 7 and 14, around AMP's
    2e-2, and 2.0 at 56 x 56, where a bf16 running sum of 3136 values stops
    growing); the port keeps the float32 sum rather than follow it."""
    rs = np.random.RandomState(hw)
    x = _r(rs, 4, 16, hw, hw)
    w = _r(rs, 32, 16, 3, 3, scale=0.3)
    errs = []
    for pkg in (fluid, jfluid):
        y, pooled = _kept_conv_pool(pkg, x, w)
        exact = y.mean(axis=(2, 3), keepdims=True)
        errs.append(float(np.abs(pooled - exact).max()) /
                    float(np.abs(exact).max()))
    assert errs[0] <= 4e-3
    assert errs[0] <= errs[1]


# ---------------------------------------------------------------------------
# (c) the narrow SE bottleneck and img_conv_group


def _se_body(pkg):
    mod = MODS['se_resnext'][0 if _is_jax(pkg) else 1]
    img = pkg.layers.data(name='img', shape=[16, 8, 8], dtype='float32')
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    out = mod.bottleneck_block(img, 8, 2, 4, 4)
    pool = pkg.layers.pool2d(input=out, pool_type='avg', global_pooling=True)
    pred = pkg.layers.fc(input=pool, size=5, act='softmax')
    avg = pkg.layers.mean(pkg.layers.cross_entropy(input=pred, label=label))
    return img, label, pred, avg


def _group_body(pkg):
    img = pkg.layers.data(name='img', shape=[3, 8, 8], dtype='float32')
    label = pkg.layers.data(name='label', shape=[1], dtype='int64')
    out = pkg.nets.img_conv_group(
        input=img, conv_num_filter=[4, 6], pool_size=2, pool_stride=2,
        conv_act='relu', conv_with_batchnorm=True,
        conv_batchnorm_drop_rate=[0.0, 0.0], pool_type='max')
    pred = pkg.layers.fc(input=out, size=5, act='softmax')
    avg = pkg.layers.mean(pkg.layers.cross_entropy(input=pred, label=label))
    return img, label, pred, avg


def _feeds(shape, classes, n=STEPS, batch=4, seed=0):
    rs = np.random.RandomState(seed)
    return [{'img': _r(rs, batch, *shape),
             'label': rs.randint(0, classes, (batch, 1)).astype('int64')}
            for _ in range(n)]


def _trajectory(body, feeds, opt, amp=False):
    """Both packages' losses and final scopes over ``feeds`` from the JAX
    startup scope: (port losses, JAX losses, port state, JAX state,
    init)."""
    jmain, jstart, jouts = _program(jfluid, body, opt, amp)
    tmain, _, touts = _program(fluid, body, opt, amp)
    init = _jax_init(jstart)
    exe, scope = jfluid.Executor(), _jax_scope(init)
    texe, tscope = fluid.Executor(CPU), scope_from_numpy(init, device='cpu')
    got, want = [], []
    for f in feeds:
        want.append(float(exe.run(jmain, feed=f, fetch_list=[jouts[3]],
                                  scope=scope)[0][0]))
        got.append(float(texe.run(tmain, feed=f, fetch_list=[touts[3]],
                                  scope=tscope)[0][0]))
    return got, want, _scope_arrays(tscope), _scope_arrays(scope), init


def _hold_each(tstate, jstate, tol, noise=()):
    """Each tensor within ``tol`` of its largest magnitude; those in
    ``noise`` (a conv bias ahead of a batch norm, whose gradient is 0 in
    exact arithmetic: the normalization removes it, and what the steps
    leave there is rounding noise, about 1e-8) within ``tol`` of the
    state's largest magnitude."""
    assert sorted(tstate) == sorted(jstate)
    top = max(float(np.abs(v).max()) for v in jstate.values())
    for n in jstate:
        scale = top if n in noise else \
            max(float(np.abs(jstate[n]).max()), 1e-30)
        assert float(np.abs(tstate[n] - jstate[n]).max()) <= tol * scale, n


NARROW = {'se_bottleneck': (_se_body, (16, 8, 8)),
          'img_conv_group': (_group_body, (3, 8, 8))}


@pytest.mark.parametrize('name', sorted(NARROW))
def test_narrow_blocks_train_as_the_jax_executor(name):
    body, shape = NARROW[name]
    got, want, tstate, jstate, init = _trajectory(
        body, _feeds(shape, 5), _momentum())
    np.testing.assert_allclose(got, want, rtol=F32['loss'])
    noise = [n for n in init if n.startswith('conv2d_') and
             '.b_0' in n] if name == 'img_conv_group' else []
    _hold_each(tstate, jstate, F32['state'], noise)
    moved = [n for n in init if n.endswith('.mean')]
    assert moved and all(not np.array_equal(tstate[n], init[n])
                         for n in moved)


def _forward_dtypes(body, feed):
    """{var: dtype} of the forward's float variables in each package under
    keep-bf16 AMP, from one run."""
    jmain, jstart, _ = _program(jfluid, body, _momentum(), True)
    tmain, _, _ = _program(fluid, body, _momentum(), True)
    names = _forward_vars(jmain)
    assert names == _forward_vars(tmain)
    init = _jax_init(jstart)
    exe, scope = jfluid.Executor(), _jax_scope(init)
    want = exe.run(jmain, feed=feed, fetch_list=names, scope=scope)
    got = fluid.Executor(CPU).run(tmain, feed=feed, fetch_list=names,
                                  scope=scope_from_numpy(init, device='cpu'),
                                  return_numpy=False)
    return ({n: _port_dtype(t) for n, t in zip(names, got)},
            {n: _jax_dtype(a) for n, a in zip(names, want)}, tmain)


@pytest.mark.parametrize('name', sorted(NARROW))
def test_keep_mode_dtypes_equal_the_jax_run(name):
    body, shape = NARROW[name]
    got, want, tmain = _forward_dtypes(body, _feeds(shape, 5, n=1)[0])
    assert got == want
    types = {n: op.type for op in tmain.global_block().ops
             for n in op.output_arg_names}
    bf16 = {types[n] for n, d in got.items() if d == 'bfloat16'}
    if name == 'img_conv_group':
        # its convolutions carry a bias: the add of a float32 [C] vector
        # promotes the kept bf16 output to float32, in JAX as here
        assert bf16 == {'conv2d'}
    else:
        # the squeeze fc's marked mul of the bf16 pool returns bf16, as
        # the JAX mul returns its input's dtype; its bias add is float32
        assert bf16 == {'conv2d', 'batch_norm', 'relu', 'pool2d', 'mul'}
        gate = [n for n in got if types[n] == 'elementwise_mul']
        assert [got[n] for n in gate] == ['float32']


# ---------------------------------------------------------------------------
# (d) VGG-16 at full width


def test_vgg16_test_clone_matches_the_jax_executor():
    jmain, jstart, jouts = _program(jfluid, _model('vgg'))
    tmain, _, touts = _program(fluid, _model('vgg'))
    init = _jax_init(jstart)
    logits = [op for op in jmain.global_block().ops
              if op.type == 'softmax'][-1].input('X')[0]
    feed = {'img': _r(np.random.RandomState(9), 2, 3, 32, 32),
            'label': np.array([[3], [7]], 'int64')}
    exe, scope = jfluid.Executor(), _jax_scope(init)
    want = exe.run(jmain.clone(for_test=True), feed=feed,
                   fetch_list=[logits, jouts[2].name], scope=scope)
    got = fluid.Executor(CPU).run(tmain.clone(for_test=True), feed=feed,
                                  fetch_list=[logits, touts[2].name],
                                  scope=scope_from_numpy(init, device='cpu'))
    for g, w in zip(got, want):
        assert float(np.abs(g - w).max()) <= 1e-5 * float(np.abs(w).max())


def test_vgg16_training_dropout_keeps_its_rate():
    tmain, tstart, _ = _program(fluid, _model('vgg'))
    drop = [op for op in tmain.global_block().ops if op.type == 'dropout'][0]
    assert drop.attr('dropout_prob') == 0.3 and not drop.attr('is_test')
    assert drop.attr('dropout_implementation') == 'downgrade_in_infer'
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(tstart, scope=scope)
    feed = {'img': _r(np.random.RandomState(4), 8, 3, 32, 32),
            'label': np.zeros((8, 1), 'int64')}
    x, out, mask = exe.run(
        tmain, feed=feed, scope=scope,
        fetch_list=[drop.input('X')[0], drop.output('Out')[0],
                    drop.output('Mask')[0]])
    np.testing.assert_array_equal(out, x * mask)
    assert set(np.unique(mask)) <= {0.0, 1.0}
    n = mask.size
    assert abs(float(mask.mean()) - 0.7) <= 5 * np.sqrt(0.7 * 0.3 / n)


# ---------------------------------------------------------------------------
# (e) the cifar10 ResNet under keep-bf16 AMP


def _flat(state, names):
    return np.concatenate([state[n].ravel() for n in names])


def test_resnet_cifar10_keep_bf16_steps_match_the_jax_executor():
    body = _model('resnet', variant='cifar10', depth=8)
    opt = _momentum(nesterov=True)
    feeds = _feeds((3, 32, 32), 10)
    got, want, tstate, jstate, init = _trajectory(body, feeds, opt, amp=True)
    np.testing.assert_allclose(got, want, rtol=AMP['loss'])
    stats = sorted(n for n in init if n.endswith(('.mean', '.variance')))
    params = sorted(n for n in init if n not in stats and
                    'velocity' not in n and not n.startswith('learning'))
    for names in (params, stats):
        g, w = _flat(tstate, names), _flat(jstate, names)
        assert float(np.abs(g - w).max()) <= \
            AMP['state'] * float(np.abs(w).max())
    # the marks took effect: the float32 run of the same program differs
    f32, _, f32_state, _, _ = _trajectory(body, feeds, opt, amp=False)
    assert not np.allclose(got, f32, rtol=1e-6, atol=0)
    assert not np.array_equal(_flat(f32_state, params),
                              _flat(tstate, params))
    dtypes, jdtypes, _ = _forward_dtypes(body, feeds[0])
    assert dtypes == jdtypes
    assert sum(d == 'bfloat16' for d in dtypes.values()) >= 30


# ---------------------------------------------------------------------------
# (f) bound steps carry the running statistics


def _port_resnet():
    main, startup, outs = _program(
        fluid, _model('resnet', variant='cifar10', depth=8), _momentum())
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return exe, main, outs[3], scope


def test_bound_and_fused_steps_equal_run_calls_with_batch_norm():
    feeds = _feeds((3, 32, 32), 10, n=STEPS)
    exe, main, loss, scope = _port_resnet()
    init = _scope_arrays(scope)
    want = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
            for f in feeds]
    ref = _scope_arrays(scope)
    stats = [n for n in init if n.endswith(('.mean', '.variance'))]
    assert len(stats) == 18 and all(
        not np.array_equal(ref[n], init[n]) for n in stats)

    # run_fused over the K batches
    exe2, main2, loss2, _ = _port_resnet()
    scope2 = scope_from_numpy(init, device='cpu')
    last = exe2.run_fused(main2, feeds, fetch_list=[loss2], scope=scope2)
    np.testing.assert_array_equal(last[0], want[-1])
    for n, v in ref.items():
        np.testing.assert_array_equal(np.array(scope2.get(n)), v,
                                      err_msg=n)

    # bind, then K - 1 calls
    exe3, main3, loss3, _ = _port_resnet()
    scope3 = scope_from_numpy(init, device='cpu')
    bp = exe3.bind(main3, feeds[0], fetch_list=[loss3], scope=scope3)
    got = [bp.first_out[0]] + [bp(f)[0] for f in feeds[1:]]
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    for n, v in ref.items():
        np.testing.assert_array_equal(np.array(scope3.get(n)), v,
                                      err_msg=n)


# ---------------------------------------------------------------------------
# (g) the TF32 guard


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_only_a_float32_conv_on_the_card_clears_tf32(dtype):
    """The conv lowering clears cuDNN's TF32 flag, under its lock, around a
    float32 convolution on a CUDA tensor only: a marked (bf16) one leaves
    the flag and the lock alone, and so does any convolution on the CPU
    (the guard reads only the tensor's device and dtype, so this runs
    without a card)."""
    import types
    from paddle_tpu_torch.ops import conv_ops
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for dev in ('cuda', 'cpu'):
            x = types.SimpleNamespace(device=torch.device(dev), dtype=dtype)
            with conv_ops._f32_cudnn(x):
                cleared = dev == 'cuda' and dtype == torch.float32
                assert torch.backends.cudnn.allow_tf32 is not cleared
                assert conv_ops._tf32_lock.locked() is cleared
            assert torch.backends.cudnn.allow_tf32 is True
            assert not conv_ops._tf32_lock.locked()
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# (h) the float64 witness of chip_smoke.py's image holds


def test_batch_norm_of_a_float64_input_keeps_float64_statistics():
    """The float64 twin of a training batch norm (`chip_smoke.float64_twin`,
    the witness the card's image holds are measured against) takes its
    statistics in float64: ``Y``, ``MeanOut`` and ``VarianceOut`` within
    1e-12 of their largest magnitudes of numpy's float64 batch norm (a
    channel of mean 1e3 and variance 2e-4 included; statistics taken in
    float32 are about 1e-7 off)."""
    import chip_smoke
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[3, 5, 5], dtype='float32')
        y = fluid.layers.batch_norm(input=x, momentum=0.8)
    twin = chip_smoke.float64_twin(main)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.get(n)).astype(np.float64)
            for n in scope.names()}
    scope = scope_from_numpy(init, device='cpu')
    rs = np.random.RandomState(0)
    xs = rs.randn(4, 3, 5, 5)
    xs[:, 1] = 1e3 + 1.4e-2 * xs[:, 1]
    got = exe.run(twin, feed={'x': xs}, fetch_list=[y], scope=scope)[0]
    m = xs.mean(axis=(0, 2, 3))
    v = ((xs - m.reshape(1, 3, 1, 1)) ** 2).mean(axis=(0, 2, 3))
    want = (xs - m.reshape(1, 3, 1, 1)) / np.sqrt(v.reshape(1, 3, 1, 1)
                                                  + 1e-5)
    assert got.dtype == np.float64
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    for name, stat, prev in (('mean', m, 'mean'), ('variance', v, 'var')):
        key = next(n for n in init if n.endswith('.' + name))
        moved = 0.8 * init[key] + 0.2 * stat
        assert np.abs(np.array(scope.get(key)) - moved).max() <= \
            1e-12 * np.abs(moved).max(), prev


def _hold_runs():
    """chip_smoke.py's `image_hold_runs` of the cifar10 ResNet of depth 8
    (the bench's keep-bf16 program and its float32 twin) at B 4, the
    card's side on the CPU, with the programs."""
    import chip_smoke
    build = lambda: tresnet.build('cifar10', depth=8)
    main, startup, loss = chip_smoke.image_program(fluid, build, 0.05)
    main32, _, loss32 = chip_smoke.image_program(fluid, build, 0.05,
                                                 amp=False)
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    init = chip_smoke.state_arrays(scope)
    feed = _feeds((3, 32, 32), 10, n=1)[0]
    runs = chip_smoke.image_hold_runs(
        torch, fluid, main, main32, {'f32': loss32.name, 'amp': loss.name},
        init, feed, place=CPU)
    return runs, main32


@pytest.mark.parametrize('fault', ['none', 'f64_state', 'f32_grad_1pct',
                                   'amp_zero_grad', 'amp_loss'])
def test_image_hold_catches_a_wrong_step(fault):
    """The checks of chip_smoke.py's `image_hold_verdict` pass two equal
    sides and fail one that is wrong: a float64 velocity 1e-6 off, a
    float32 gradient 1e-2 off, an AMP gradient set to 0, an AMP loss 2%
    off. Each run's state is its own copy: the second
    float64 step leaves the first's arrays as they were."""
    import chip_smoke
    runs, main32 = _hold_runs()
    f64 = runs['card', 'f64']['state']
    vel = sorted(n for n in f64[0] if '_velocity_' in n)[0]
    assert not np.array_equal(f64[0][vel], f64[1][vel])
    if fault == 'f64_state':
        f64[1][vel] = f64[1][vel] * (1 + 1e-6)
    elif fault == 'f32_grad_1pct':
        g = runs['card', 'f32']['state'][0][vel]
        runs['card', 'f32']['state'][0][vel] = g * (1 + 1e-2 * np.sign(
            np.random.RandomState(0).randn(*g.shape)))
    elif fault == 'amp_zero_grad':
        runs['card', 'amp']['state'][0][vel] = \
            0 * runs['card', 'amp']['state'][0][vel]
    elif fault == 'amp_loss':
        runs['card', 'amp']['losses'][0] *= 1.02
    out, failures = chip_smoke.image_hold_verdict(runs, main32)
    if fault == 'none':
        assert failures == []
        assert out['f64']['state_rel_err_max'] == 0.0
        # here the float32 step's gradients lie within 1e-5 of float64's
        assert out['f32']['grad_rms_err_cpu_median'] <= 1e-5
    else:
        assert len(failures) == 1, failures
        assert {'f64_state': 'float64', 'f32_grad_1pct': 'f32 gradient',
                'amp_zero_grad': 'amp gradient',
                'amp_loss': 'amp loss'}[fault] in failures[0]
