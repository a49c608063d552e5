"""The Fluid front end of paddle_tpu_torch (Program, layers, append_backward,
the optimizers, Executor.run) against the JAX package, on the CPU.

Small size: V 128, L 16, d 64, 4 heads, 2 layers, d_ff 128. Every input
comes from a numpy seed and goes through both packages.

(a) `build_lm` (flash training, default training, inference) and the
    README's quick start, built by each package under a fresh
    ``unique_name.guard()``: `program_to_dict` of the main and startup
    programs are equal.
(b) Each op type the slice lowers, as a one-op program run by both
    Executors: within f32 1e-5 (rtol and atol). The kernel ops run the
    JAX side at ``PADDLE_FUSED_TIER=interpret`` (set with
    ``monkeypatch.setenv``, as tests/test_fused_tier.py does) and the port
    on its plain versions. A random op's draws cannot match (threefry
    against torch's generator): `uniform_random`, `gaussian_random` and
    `truncated_gaussian_random` are held to their shape, dtype and range
    and to their distribution's mean and std within 6 standard errors,
    `dropout` runs in test mode.
(c) The slice as a whole: three ``Adam(1e-3, fuse=True)`` steps of the
    flash program and of the unfused one (``use_flash_attention=False``:
    the ``assign_value`` causal mask, ``matmul`` with alpha, ``softmax``),
    dropout 0 and attention dropout 0, from the JAX startup scope carried
    by `io.scope_from_numpy`: losses at rtol 1e-5,
    parameters and Adam state at rtol 1e-4 / atol 1e-5, and the K slice
    of each ``*.attn.qkv.b`` within STEPS * lr (tests/test_torch_train.py
    `_check_trajectory`'s tolerances and rule: that slice's true gradient
    is 0, and Adam turns rounding noise into steps of lr).
(d) The same programs against the port's own `TransformerLM` +
    `TensorAdam` from the same weights: the same PyTorch functions in the
    same order, so losses and weights agree to 1e-6.
(e) Inference logits (``build_lm(cfg, is_test=True)``) against JAX's:
    rtol 1e-5 / atol 1e-5.
(f) The quick start's losses over five SGD steps against JAX's: rtol 1e-5.
(g) A seeded program replays its trajectory from a fresh build, and its
    dropout masks differ from run to run.
(h) The verify skill's probes: a feed before the startup program raises a
    RuntimeError naming the variable; a float64 feed is coerced to float32;
    the batch size varies across runs; a parameter is fetched by name; an
    unknown op type raises NotImplementedError naming it.
(i) `build_bert_pretrain` (V 128, L 16, d 64, 4 heads, 2 layers, 4 masked
    positions; key lengths cut as phase 12 of chip_smoke.py cuts them),
    flash (attention dropout 0) and unfused, dropout 0: the program dicts
    equal the JAX package's (training and inference); the inference losses
    within 1e-5 of JAX's; three ``Adam(1e-3, fuse=True)`` steps within
    (c)'s tolerances of JAX's and within 1e-6 of `BertPretrain` +
    `TensorAdam`.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.core import serialization as jser
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import transformer as jtrans

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.io import scope_from_numpy, train_state_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import transformer as ttrans
from paddle_tpu_torch.optimizer import TensorAdam

SMALL = dict(vocab_size=128, seq_len=16, d_model=64, n_head=4, n_layer=2,
             d_ff=128)
# the bench's flash configuration (bench.py:1058-1060), and without dropout
FLASH = dict(SMALL, dropout=0.1, attn_dropout=0.0)
FLASH0 = dict(SMALL, dropout=0.0, attn_dropout=0.0)
# the default configuration's unfused branch, without dropout
UNFUSED0 = dict(FLASH0, use_flash_attention=False)
# BERT at the same width, no dropout; its attention flash or unfused
BERT_FLASH = dict(SMALL, dropout=0.0, attn_dropout=0.0, max_predictions=4)
BERT_UNFUSED = dict(BERT_FLASH, use_flash_attention=False)
STEPS = 3
CPU = fluid.CPUPlace()


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels;
    restart the window after this module."""
    yield
    goodput.reset()
    # the monitor keeps at most 64 series a metric: leave it empty
    monitor.reset()


def _scope_arrays(scope):
    out = {}
    for n in scope.names():
        v = scope.get(n)
        if hasattr(v, 'shape'):
            out[n] = v.detach().cpu().numpy().copy() \
                if isinstance(v, torch.Tensor) else np.array(v)
    return out


def _build_lm(pkg, tmod, kw, is_test=False, opt=True, seed=0):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, logits, loss = tmod.build_lm(tmod.LMConfig(**kw),
                                           is_test=is_test)
        if opt:
            pkg.optimizer.Adam(1e-3, fuse=True).minimize(loss)
    return main, startup, logits, loss


def _build_quick_start(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name='x', shape=[13], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        cost = pkg.layers.square_error_cost(pkg.layers.fc(x, size=1), y)
        avg = pkg.layers.mean(cost)
        pkg.optimizer.SGD(0.01).minimize(avg)
    return main, startup, avg


def _build_bert(pkg, bmod, kw, is_test=False, seed=0):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        losses = bmod.build_bert_pretrain(bmod.BertConfig(**kw),
                                          is_test=is_test)
        if not is_test:
            pkg.optimizer.Adam(1e-3, fuse=True).minimize(losses[0])
    return main, startup, list(losses)


def _bert_feeds(n=STEPS, batch=4):
    """One BERT batch with key lengths cut to 16, 9, 3 and 12, ``n`` times
    (random tokens: the loss falls only on a batch seen again)."""
    f = jbert.make_pretrain_batch(jbert.BertConfig(**BERT_FLASH), batch,
                                  np.random.RandomState(30))
    for row, keep in enumerate((16, 9, 3, 12)):
        f['input_mask'][row, keep:] = 0.0
    return [f] * n


def _lm_feeds(n=STEPS, batch=4, seed=0):
    rs = np.random.RandomState(seed)
    V, L = SMALL['vocab_size'], SMALL['seq_len']
    return [{'tokens': rs.randint(0, V, (batch, L)).astype('int64'),
             'labels': rs.randint(0, V, (batch, L)).astype('int64')}
            for _ in range(n)]


# ---------------------------------------------------------------------------
# (a) the same programs


@pytest.mark.parametrize('which', ['flash', 'default', 'inference',
                                   'quick_start', 'bert_flash',
                                   'bert_unfused', 'bert_inference'])
def test_program_dicts_equal_the_jax_package(which):
    def build(pkg, tmod, ser):
        if which == 'quick_start':
            main, startup, _ = _build_quick_start(pkg)
        elif which.startswith('bert'):
            bmod = jbert if pkg is jfluid else tbert
            main, startup, _ = _build_bert(
                pkg, bmod, BERT_UNFUSED if which == 'bert_unfused'
                else BERT_FLASH, is_test=which == 'bert_inference')
        else:
            kw = {'flash': FLASH, 'default': SMALL,
                  'inference': SMALL}[which]
            main, startup, _, _ = _build_lm(
                pkg, tmod, kw, is_test=which == 'inference',
                opt=which != 'inference')
        return ser.program_to_dict(main), ser.program_to_dict(startup)

    jmain, jstart = build(jfluid, jtrans, jser)
    tmain, tstart = build(fluid, ttrans, tser)
    assert tmain == jmain
    assert tstart == jstart
    types = [op['type'] for op in tmain['blocks'][0]['ops']]
    if which == 'flash':
        assert types.count('flash_attention') == SMALL['n_layer']
        assert types.count('fused_adam') == 1
    if which == 'default':
        assert 'flash_attention' not in types and 'assign_value' in types
    if which.startswith('bert'):
        assert types.count('gather') == 1
        assert types.count('gelu') == types.count('tanh') == 1
        assert types.count('flash_attention') == (
            0 if which == 'bert_unfused' else SMALL['n_layer'])
    # the port reads back what it wrote
    assert tser.program_to_dict(tser.program_from_dict(tmain)) == tmain


# ---------------------------------------------------------------------------
# (b) one op at a time


def _r(rs, *shape, scale=1.0):
    return (scale * rs.randn(*shape)).astype('float32')


def _op_cases():
    rs = np.random.RandomState(7)
    f = lambda *s, **k: _r(rs, *s, **k)
    c = {}
    c['lookup_table'] = dict(
        inputs={'W': [('w', f(50, 128))],
                'Ids': [('ids',
                         rs.randint(0, 50, (4, 8, 1)).astype('int64'))]},
        outputs={'Out': ['out']}, attrs={'is_sparse': False,
                                         'is_distributed': False,
                                         'padding_idx': 3})
    c['fused_ln_residual'] = dict(
        inputs={'X': [('x', f(4, 8, 128))], 'Residual': [('r', f(4, 8, 128))],
                'Scale': [('sc', 1 + f(128, scale=0.1))],
                'Bias': [('b', f(128, scale=0.1))]},
        outputs={'Y': ['y'], 'ResidualOut': ['s']},
        attrs={'epsilon': 1e-5, 'begin_norm_axis': 2})
    c['fused_ffn_tail'] = dict(
        inputs={'X': [('x', f(4, 8, 128))],
                'W1': [('w1', f(128, 256, scale=.05))],
                'B1': [('b1', f(256, scale=.05))],
                'W2': [('w2', f(256, 128, scale=.05))],
                'B2': [('b2', f(128, scale=.05))]},
        outputs={'Out': ['out']},
        attrs={'x_num_col_dims': 2, 'dropout_prob': 0.0, 'is_test': False,
               'seed': 0, 'dropout_implementation': 'upscale_in_train'})
    # x_num_col_dims 1 on a 3-d input, test-mode downgrade_in_infer
    # dropout: the JAX op's own composition on both sides
    c['fused_ffn_tail:composed'] = dict(
        inputs={'X': [('x', f(4, 8, 16))],
                'W1': [('w1', f(128, 64, scale=.05))],
                'B1': [('b1', f(64, scale=.05))],
                'W2': [('w2', f(64, 32, scale=.05))],
                'B2': [('b2', f(32, scale=.05))]},
        outputs={'Out': ['out']},
        attrs={'x_num_col_dims': 1, 'dropout_prob': 0.3, 'is_test': True,
               'seed': 0, 'dropout_implementation': 'downgrade_in_infer'})
    c['flash_attention'] = dict(
        inputs={'Q': [('q', f(2, 4, 16, 32))], 'K': [('k', f(2, 4, 16, 32))],
                'V': [('v', f(2, 4, 16, 32))]},
        outputs={'Out': ['out']},
        attrs={'scale': 32 ** -0.5, 'causal': True, 'ring_zigzag': False})
    c['softmax_with_cross_entropy'] = dict(
        inputs={'Logits': [('x', f(32, 128, scale=3.0))],
                'Label': [('lab',
                           rs.randint(0, 128, (32, 1)).astype('int64'))]},
        outputs={'Softmax': ['sm'], 'Loss': ['loss']},
        attrs={'soft_label': False, 'ignore_index': -100,
               'numeric_stable_mode': False})
    shapes = [(7, 5), (128,)]
    c['fused_adam'] = dict(
        inputs={'Params': [('p%d' % i, f(*s), True)
                           for i, s in enumerate(shapes)],
                'Grads': [('g%d' % i, f(*s)) for i, s in enumerate(shapes)],
                'Moment1s': [('m%d' % i, f(*s, scale=.1), True)
                             for i, s in enumerate(shapes)],
                'Moment2s': [('v%d' % i, (.01 * rs.rand(*s)).astype('float32'),
                              True) for i, s in enumerate(shapes)],
                'Beta1Pows': [('b1p%d' % i, np.array([.9 ** 3], 'float32'),
                               True) for i in range(2)],
                'Beta2Pows': [('b2p%d' % i, np.array([.999 ** 3], 'float32'),
                               True) for i in range(2)],
                'LearningRate': [('lr', np.array([1e-3], 'float32'), True)]},
        outputs={'ParamsOut': ['p0', 'p1'], 'Moment1sOut': ['m0', 'm1'],
                 'Moment2sOut': ['v0', 'v1'], 'Beta1PowsOut': ['b1p0', 'b1p1'],
                 'Beta2PowsOut': ['b2p0', 'b2p1']},
        attrs={'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8})
    c['adam'] = dict(
        inputs={'Param': [('p', f(7, 5), True)], 'Grad': [('g', f(7, 5))],
                'LearningRate': [('lr', np.array([1e-3], 'float32'), True)],
                'Moment1': [('m', f(7, 5, scale=.1), True)],
                'Moment2': [('v', (.01 * rs.rand(7, 5)).astype('float32'),
                             True)],
                'Beta1Pow': [('b1p', np.array([.9 ** 2], 'float32'), True)],
                'Beta2Pow': [('b2p', np.array([.999 ** 2], 'float32'), True)]},
        outputs={'ParamOut': ['p'], 'Moment1Out': ['m'], 'Moment2Out': ['v'],
                 'Beta1PowOut': ['b1p'], 'Beta2PowOut': ['b2p']},
        attrs={'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8,
               'lazy_mode': False})
    c['sgd'] = dict(
        inputs={'Param': [('p', f(7, 5), True)], 'Grad': [('g', f(7, 5))],
                'LearningRate': [('lr', np.array([0.1], 'float32'), True)]},
        outputs={'ParamOut': ['p']}, attrs={})
    c['mul'] = dict(inputs={'X': [('x', f(4, 8, 16))],
                            'Y': [('y', f(16, 12))]},
                    outputs={'Out': ['out']},
                    attrs={'x_num_col_dims': 2, 'y_num_col_dims': 1})
    c['matmul'] = dict(
        inputs={'X': [('x', f(2, 3, 8, 16))], 'Y': [('y', f(2, 3, 8, 16))]},
        outputs={'Out': ['out']},
        attrs={'transpose_X': False, 'transpose_Y': True, 'alpha': 0.25})
    c['dropout'] = dict(
        inputs={'X': [('x', f(4, 8, 16))]},
        outputs={'Out': ['out'], 'Mask': ['mask']},
        attrs={'dropout_prob': 0.3, 'is_test': True, 'seed': 0,
               'dropout_implementation': 'downgrade_in_infer'})
    c['uniform_random'] = dict(
        inputs={}, outputs={'Out': ['out']},
        attrs={'shape': [64, 64], 'dtype': np.dtype('float32'),
               'min': -0.5, 'max': 0.5, 'seed': 0})
    for op in ('gaussian_random', 'truncated_gaussian_random'):
        c[op] = dict(inputs={}, outputs={'Out': ['out']},
                     attrs={'shape': [256, 256], 'dtype': np.dtype('float32'),
                            'mean': 0.5, 'std': 2.0, 'seed': 0})
    c['add_position_encoding'] = dict(
        inputs={'X': [('x', f(2, 16, 64))]}, outputs={'Out': ['out']},
        attrs={'alpha': 0.5, 'beta': 2.0})
    c['reshape2'] = dict(
        inputs={'X': [('x', f(2, 16, 64))]},
        outputs={'Out': ['out'], 'XShape': ['xs']},
        attrs={'shape': [0, 16, 4, -1]})
    c['transpose2'] = dict(
        inputs={'X': [('x', f(2, 3, 4, 5))]},
        outputs={'Out': ['out'], 'XShape': ['xs']},
        attrs={'axis': [2, 0, 3, 1]})
    c['slice'] = dict(
        inputs={'Input': [('x', f(3, 4, 5))]}, outputs={'Out': ['out']},
        attrs={'axes': [0, 2], 'starts': [1, -3], 'ends': [2, 10]})
    # one index of one axis (the LM's q, k and v): a view of an unbind
    c['slice:one_index'] = dict(
        inputs={'Input': [('x', f(3, 4, 5))]}, outputs={'Out': ['out']},
        attrs={'axes': [1], 'starts': [-2], 'ends': [3]})
    c['squeeze2'] = dict(
        inputs={'X': [('x', f(1, 4, 1, 5))]},
        outputs={'Out': ['out'], 'XShape': ['xs']}, attrs={'axes': [0, 2]})
    c['elementwise_add'] = dict(
        inputs={'X': [('x', f(4, 8, 16))], 'Y': [('y', f(8))]},
        outputs={'Out': ['out']}, attrs={'axis': 1})
    c['elementwise_sub'] = dict(
        inputs={'X': [('x', f(4, 8))], 'Y': [('y', f(4, 8))]},
        outputs={'Out': ['out']}, attrs={'axis': -1})
    c['mean'] = dict(inputs={'X': [('x', f(4, 8))]}, outputs={'Out': ['out']},
                     attrs={})
    c['softmax'] = dict(inputs={'X': [('x', f(4, 8, 16))]},
                        outputs={'Out': ['out']}, attrs={})
    c['square'] = dict(inputs={'X': [('x', f(4, 8))]},
                       outputs={'Out': ['out']}, attrs={})
    c['gelu'] = dict(inputs={'X': [('x', f(4, 8, scale=3.0))]},
                     outputs={'Out': ['out']}, attrs={})
    c['tanh'] = dict(inputs={'X': [('x', f(4, 8, scale=2.0))]},
                     outputs={'Out': ['out']}, attrs={})
    # ids over [-n, 2n): negative ones count from the end, those at n and
    # past give a row of NaN (jnp.take's default mode)
    c['gather'] = dict(
        inputs={'X': [('x', f(10, 6))],
                'Index': [('ids', rs.randint(-10, 20, (24,)).astype(
                    'int64'))]},
        outputs={'Out': ['out']}, attrs={})
    c['scale'] = dict(inputs={'X': [('x', f(4, 8))]}, outputs={'Out': ['out']},
                      attrs={'scale': 0.5, 'bias': 2.0,
                             'bias_after_scale': False})
    c['fill_constant'] = dict(
        inputs={}, outputs={'Out': ['out']},
        attrs={'shape': [3, 4], 'dtype': np.dtype('float32'), 'value': 1.5})
    c['assign_value'] = dict(
        inputs={}, outputs={'Out': ['out']},
        attrs={'shape': [2, 3], 'dtype': np.dtype('float32'),
               'values': [float(v) for v in f(6)]})
    return c


OP_CASES = _op_cases()
# ops whose JAX lowering reaches a Pallas kernel (its interpret mode here)
KERNEL_OPS = ('lookup_table', 'fused_ln_residual', 'fused_ffn_tail',
              'flash_attention', 'softmax_with_cross_entropy', 'fused_adam')


def _run_one_op(pkg, place, op_type, case):
    """Build a one-op program in ``pkg``, run it once and return {output
    name: numpy array}. Inputs marked persistable live in the scope, the
    others are fed."""
    main = pkg.Program()
    block = main.global_block()
    feed, state = {}, {}
    for items in case['inputs'].values():
        for name, arr, *persist in items:
            persist = bool(persist and persist[0])
            block.create_var(name=name, shape=arr.shape, dtype=arr.dtype,
                             persistable=persist)
            (state if persist else feed)[name] = arr
    names = []
    for outs in case['outputs'].values():
        for n in outs:
            if not block.has_var(n):
                block.create_var(name=n, dtype='float32')
            if n not in names:
                names.append(n)
    block.append_op(type=op_type, inputs={k: [i[0] for i in v] for k, v in
                                          case['inputs'].items()},
                    outputs=case['outputs'], attrs=dict(case['attrs']))
    scope = pkg.Scope()
    for n, a in state.items():
        scope.set(n, a.copy())
    exe = pkg.Executor(place) if place is not None else pkg.Executor()
    got = exe.run(main, feed=feed, fetch_list=names, scope=scope)
    return dict(zip(names, [np.asarray(g) for g in got]))


# ops whose draws cannot match: held to their distribution instead
RANDOM_OPS = ('uniform_random', 'gaussian_random', 'truncated_gaussian_random')
# the std of a standard normal truncated to [-2, 2]
_TRUNC_STD = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                      / math.erf(math.sqrt(2)))


def _check_draws(op_type, attrs, *draws):
    """Each of ``draws`` has the op's shape and dtype, lies in its range,
    and its mean and std lie within 6 standard errors of the
    distribution's."""
    if op_type == 'uniform_random':
        lo, hi = attrs['min'], attrs['max']
        mean, std = (lo + hi) / 2, (hi - lo) / np.sqrt(12)
    else:
        mean = attrs['mean']
        std = attrs['std'] * (_TRUNC_STD if op_type.startswith('truncated')
                              else 1.0)
        lo, hi = ((mean - 2 * attrs['std'], mean + 2 * attrs['std'])
                  if op_type.startswith('truncated') else (-np.inf, np.inf))
    for a in draws:
        n = a.size
        assert a.shape == tuple(attrs['shape']) and a.dtype == np.float32
        assert a.min() >= lo and a.max() <= hi
        assert abs(float(a.mean()) - mean) < 6 * std / np.sqrt(n)
        # the std of a sample std is about std / sqrt(2n)
        assert abs(float(a.std()) - std) < 6 * std / np.sqrt(2 * n)


@pytest.mark.parametrize('key', sorted(OP_CASES))
def test_one_op_program_matches_the_jax_executor(key, monkeypatch):
    case, op_type = OP_CASES[key], key.split(':')[0]
    if op_type in KERNEL_OPS:
        monkeypatch.setenv('PADDLE_FUSED_TIER', 'interpret')
    want = _run_one_op(jfluid, None, op_type, case)
    monkeypatch.delenv('PADDLE_FUSED_TIER', raising=False)
    got = _run_one_op(fluid, CPU, op_type, case)
    assert sorted(got) == sorted(want)
    if op_type in RANDOM_OPS:
        _check_draws(op_type, case['attrs'], got['out'], want['out'])
        return
    for name in want:
        if name == 'xs':         # XShape: an empty [0, *x.shape]
            assert got[name].shape == want[name].shape
            continue
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_fused_ln_residual_off_its_fusable_form_runs_the_composition():
    """begin_norm_axis 1 on a 3-d input: the JAX op's own composition
    (elementwise_add + layer_norm over both trailing axes), not the
    kernel."""
    case = dict(OP_CASES['fused_ln_residual'])
    rs = np.random.RandomState(3)
    case['inputs'] = dict(case['inputs'])
    case['inputs']['Scale'] = [('sc', (1 + .1 * rs.randn(8 * 128)
                                       ).astype('float32'))]
    case['inputs']['Bias'] = [('b', (.1 * rs.randn(8 * 128)
                                      ).astype('float32'))]
    case['attrs'] = {'epsilon': 1e-5, 'begin_norm_axis': 1}
    before = fluid.launch_counts()
    want = _run_one_op(jfluid, None, 'fused_ln_residual', case)
    got = _run_one_op(fluid, CPU, 'fused_ln_residual', case)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert fluid.launch_counts() == before


# ---------------------------------------------------------------------------
# (c), (d) the slice as a whole


def _jax_run(kw):
    """(startup arrays, losses, final arrays) of the JAX program of ``kw``
    (dropout 0), three Adam(1e-3, fuse=True) steps at the interpret
    tier."""
    import os
    old = os.environ.get('PADDLE_FUSED_TIER')
    os.environ['PADDLE_FUSED_TIER'] = 'interpret'
    try:
        main, startup, _, loss = _build_lm(jfluid, jtrans, kw, seed=5)
        exe, scope = jfluid.Executor(), jfluid.Scope()
        exe.run(startup, scope=scope)
        init = _scope_arrays(scope)
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0][0]) for f in _lm_feeds()]
        return init, losses, _scope_arrays(scope)
    finally:
        if old is None:
            os.environ.pop('PADDLE_FUSED_TIER', None)
        else:
            os.environ['PADDLE_FUSED_TIER'] = old


def _port_run(init, kw):
    main, startup, _, loss = _build_lm(fluid, ttrans, kw, seed=5)
    types = [op.type for op in main.global_block().ops]
    assert ('flash_attention' in types) == kw.get('use_flash_attention',
                                                  True)
    exe = fluid.Executor(CPU)
    scope = scope_from_numpy(init, device='cpu')
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0][0]) for f in _lm_feeds()]
    return losses, _scope_arrays(scope)


@pytest.fixture(scope='module')
def jax_flash_run():
    return _jax_run(FLASH0)


@pytest.fixture(scope='module')
def port_flash_run(jax_flash_run):
    return _port_run(jax_flash_run[0], FLASH0)


@pytest.fixture(scope='module')
def jax_unfused_run():
    return _jax_run(UNFUSED0)


@pytest.fixture(scope='module')
def port_unfused_run(jax_unfused_run):
    return _port_run(jax_unfused_run[0], UNFUSED0)


def _k_bias_apart(name, have, want, tol):
    """The K slice of a qkv bias within ``tol``; returns the rest."""
    if not name.endswith('.attn.qkv.b'):
        return have, want
    d = SMALL['d_model']
    assert np.abs(have[d:2 * d] - want[d:2 * d]).max() <= tol, name
    return (np.delete(have, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d]))


def _check_against_jax(jax_run, port_run, noise=None):
    """``noise``: {parameter name: a mask of the elements whose gradient is
    rounding noise}, held within STEPS * lr as the K bias is."""
    init, want_losses, want = jax_run[:3]
    losses, got = port_run
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert sorted(got) == sorted(want)
    for name in want:
        have, w = got[name], want[name]
        if '_moment' not in name:
            have, w = _k_bias_apart(name, have, w, STEPS * 1e-3)
        if noise and name in noise:
            apart = noise[name]
            assert np.abs(have[apart] - w[apart]).max(initial=0) <= \
                STEPS * 1e-3, name
            have, w = have[~apart], w[~apart]
        np.testing.assert_allclose(have, w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _check_against_transformer_lm(kw, init, port_run):
    losses, got = port_run
    cfg = ttrans.LMConfig(**kw)
    params, state, lr = train_state_from_numpy(init, 'cpu', config=cfg)
    model = ttrans.TransformerLM(cfg, params, cfg.seq_len)
    opt = TensorAdam(model.p, 1e-3, fuse=True)
    opt.load_state(state, lr)
    want = [float(opt.minimize(model.loss(torch.from_numpy(f['tokens']),
                                          torch.from_numpy(f['labels']))))
            for f in _lm_feeds()]
    np.testing.assert_allclose(losses, want, rtol=1e-6)
    for name, p in model.p.items():
        np.testing.assert_allclose(got[name], p.detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_flash_program_trajectory_matches_the_jax_executor(jax_flash_run,
                                                           port_flash_run):
    _check_against_jax(jax_flash_run, port_flash_run)


def test_flash_program_matches_transformer_lm(jax_flash_run, port_flash_run):
    _check_against_transformer_lm(FLASH0, jax_flash_run[0], port_flash_run)


def test_unfused_program_trajectory_matches_the_jax_executor(
        jax_unfused_run, port_unfused_run):
    _check_against_jax(jax_unfused_run, port_unfused_run)


def test_unfused_program_matches_transformer_lm(jax_unfused_run,
                                                port_unfused_run):
    _check_against_transformer_lm(UNFUSED0, jax_unfused_run[0],
                                  port_unfused_run)


@pytest.mark.parametrize('n_slices', [1, 3])
def test_one_index_slices_share_an_unbind_only_when_several(n_slices):
    """One-index slices of one variable along one axis share an unbind
    (their gradients stack into one tensor) when there are several, as
    q, k and v of the QKV product are; a lone one (BERT's first position)
    indexes, since an unbind's backward fills a zero tensor for every index
    nothing reads. Values and gradients are the same either way."""
    from torch.profiler import ProfilerActivity, profile
    main = fluid.Program()
    block = main.global_block()
    x = np.random.RandomState(6).randn(3, 40, 4).astype('float32')
    block.create_var(name='x', shape=x.shape, dtype='float32')
    outs = []
    for i in range(n_slices):
        block.create_var(name='s%d' % i, dtype='float32')
        block.append_op(type='slice', inputs={'Input': ['x']},
                        outputs={'Out': ['s%d' % i]},
                        attrs={'axes': [1], 'starts': [i], 'ends': [i + 1]})
        outs.append('s%d' % i)
    for name in ('sq', 'sum', 'loss'):
        block.create_var(name=name, dtype='float32')
    block.append_op(type='square', inputs={'X': [outs[-1]]},
                    outputs={'Out': ['sq']})
    block.append_op(type='mean', inputs={'X': ['sq']},
                    outputs={'Out': ['loss']})
    block.create_var(name='x@GRAD', shape=x.shape, dtype='float32')
    block.append_op(type='backward', inputs={'Loss': ['loss']},
                    outputs={'Grads': ['x@GRAD']},
                    attrs={'wrt_names': ['x'], 'sparse_wrt': []})
    exe = fluid.Executor(CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = exe.run(main, feed={'x': x}, fetch_list=outs + ['x@GRAD'],
                      scope=fluid.Scope())
    unbinds = sum(e.count for e in prof.key_averages()
                  if e.key == 'aten::unbind')
    assert unbinds == (1 if n_slices > 1 else 0)
    for i in range(n_slices):
        np.testing.assert_array_equal(got[i], x[:, i:i + 1])
    want = np.zeros_like(x)
    last = n_slices - 1
    want[:, last] = 2 * x[:, last] / x[:, last].size
    np.testing.assert_allclose(got[-1], want, rtol=1e-6)


def test_gather_values_and_gradient_match_jnp_take():
    """`ops.tensor_ops.gather` against ``jnp.take(x, ids, axis=0)`` over ids
    in [-n, 2n) with repeats: the same rows (NaN past n), and the gradient
    (a scatter-add of the rows' cotangents; out-of-range rows drop
    theirs) within f32 1e-6."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu_torch.ops.tensor_ops import gather
    rs = np.random.RandomState(4)
    x = rs.randn(10, 6).astype('float32')
    ids = np.concatenate([rs.randint(-10, 20, 40), [3, 3, -7, 10, 19]])
    ct = rs.randn(len(ids), 6).astype('float32')
    want, vjp = jax.vjp(lambda a: jnp.take(a, jnp.asarray(ids, jnp.int32),
                                           axis=0), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = gather(xt, torch.from_numpy(ids))
    got.backward(torch.from_numpy(ct))
    assert np.isnan(got.detach().numpy()).any()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct))[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('dtype', [torch.int64, torch.bool])
def test_gather_of_other_than_floating_rows_raises(dtype):
    """Out-of-range rows are NaN, which only a floating dtype holds; no
    program of the port gathers another."""
    from paddle_tpu_torch.ops.tensor_ops import gather
    with pytest.raises(NotImplementedError, match='gather'):
        gather(torch.zeros((4, 2), dtype=dtype), torch.tensor([0, 5]))


# ---------------------------------------------------------------------------
# (e), (f) inference and the quick start


def test_inference_logits_match_the_jax_executor():
    feed = _lm_feeds(1)[0]
    jmain, jstart, jlogits, _ = _build_lm(jfluid, jtrans, SMALL,
                                          is_test=True, opt=False)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(jstart, scope=scope)
    want, = exe.run(jmain, feed=feed, fetch_list=[jlogits], scope=scope)
    main, _, logits, _ = _build_lm(fluid, ttrans, SMALL, is_test=True,
                                   opt=False)
    tscope = scope_from_numpy(_scope_arrays(scope), device='cpu')
    got, = fluid.Executor(CPU).run(main, feed=feed, fetch_list=[logits],
                                   scope=tscope)
    assert got.shape == (4, 16, 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_quick_start_losses_match_the_jax_executor():
    rs = np.random.RandomState(11)
    X = rs.randn(32, 13).astype('float32')
    Y = (X @ rs.randn(13, 1) + 0.5).astype('float32')

    def run(pkg, place, scope, startup_scope=None):
        main, startup, avg = _build_quick_start(pkg)
        exe = pkg.Executor(place) if place is not None else pkg.Executor()
        if startup_scope is None:
            exe.run(startup, scope=scope)
        return [float(exe.run(main, feed={'x': X, 'y': Y}, fetch_list=[avg],
                              scope=scope)[0][0]) for _ in range(5)]

    jscope = jfluid.Scope()
    main, startup, _ = _build_quick_start(jfluid)
    jfluid.Executor().run(startup, scope=jscope)
    init = _scope_arrays(jscope)
    want = run(jfluid, None, jscope, startup_scope=True)
    got = run(fluid, CPU, scope_from_numpy(init, device='cpu'),
              startup_scope=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    # and from the port's own startup program
    own = run(fluid, CPU, fluid.Scope())
    assert own[-1] < own[0]


# ---------------------------------------------------------------------------
# (g) the counted RNG stream


def test_seeded_program_replays_and_masks_differ_across_runs():
    feeds = _lm_feeds()
    init = None
    runs = []
    for _ in range(2):
        main, startup, _, loss = _build_lm(fluid, ttrans, FLASH, seed=7)
        drop = [op for op in main.global_block().ops
                if op.type == 'dropout'][0].output('Out')[0]
        exe = fluid.Executor(CPU)
        scope = fluid.Scope()
        if init is None:
            exe.run(startup, scope=scope)
            init = _scope_arrays(scope)
        else:
            scope = scope_from_numpy(init, device='cpu')
        out = [exe.run(main, feed=f, fetch_list=[loss, drop], scope=scope)
               for f in feeds]
        runs.append(out)
    for (l1, d1), (l2, d2) in zip(*runs):
        assert l1[0] == l2[0]
        np.testing.assert_array_equal(d1, d2)
    # from run to run the mask moves (the same feed, another draw)
    zeros = [d == 0 for _, d in runs[0]]
    assert not np.array_equal(zeros[0], zeros[1])
    frac = np.mean(zeros[0])
    assert 0.05 < frac < 0.15


# ---------------------------------------------------------------------------
# (h) the verify skill's probes


def test_feed_before_startup_raises_naming_the_variable():
    main, startup, avg = _build_quick_start(fluid)
    with pytest.raises(RuntimeError, match="'fc_0.w_0'.*startup"):
        fluid.Executor(CPU).run(main, feed={
            'x': np.zeros((2, 13), 'float32'),
            'y': np.zeros((2, 1), 'float32')}, fetch_list=[avg],
            scope=fluid.Scope())


def test_float64_feed_batch_sizes_and_parameter_fetch():
    main, startup, avg = _build_quick_start(fluid)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(2)
    for batch in (3, 8, 5):
        X = rs.randn(batch, 13)                      # float64
        Y = rs.randn(batch, 1)
        loss, w, x = exe.run(main, feed={'x': X, 'y': Y},
                             fetch_list=[avg, 'fc_0.w_0', 'x'], scope=scope)
        assert loss.dtype == np.float32 and x.dtype == np.float32
        assert x.shape == (batch, 13) and w.shape == (13, 1)
        np.testing.assert_array_equal(w, scope.get('fc_0.w_0').numpy())
    # a fetched parameter keeps its value at fetch time
    w_before = w.copy()
    exe.run(main, feed={'x': X, 'y': Y}, scope=scope)
    assert not np.array_equal(scope.get('fc_0.w_0').numpy(), w_before)
    np.testing.assert_array_equal(w, w_before)
    kept, = exe.run(main, feed={'x': X, 'y': Y}, fetch_list=['fc_0.w_0'],
                    scope=scope, return_numpy=False)
    exe.run(main, feed={'x': X, 'y': Y}, scope=scope)
    assert not torch.equal(kept, scope.get('fc_0.w_0'))


def test_unknown_op_type_raises_naming_it():
    main = fluid.Program()
    block = main.global_block()
    block.create_var(name='x', shape=(2,), dtype='float32')
    block.create_var(name='y', dtype='float32')
    block.append_op(type='no_such_op', inputs={'X': ['x']},
                    outputs={'Out': ['y']})
    with pytest.raises(NotImplementedError, match='no_such_op'):
        fluid.Executor(CPU).run(main, feed={'x': np.ones(2, 'float32')},
                                fetch_list=['y'], scope=fluid.Scope())


def test_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is usable')
    with pytest.raises(RuntimeError, match='none is available'):
        fluid.Executor()
    assert fluid.Executor(CPU).device == torch.device('cpu')


def test_features_left_for_later_raise():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data(name='ids', shape=[4], dtype='int64')
        emb = fluid.layers.embedding(ids, size=[10, 8], is_sparse=True)
        loss = fluid.layers.mean(emb)
        with pytest.raises(NotImplementedError, match='sparse'):
            fluid.optimizer.SGD(0.1).minimize(loss)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        loss = fluid.layers.mean(fluid.layers.fc(x, size=2))
        with pytest.raises(NotImplementedError, match='regulariz'):
            fluid.optimizer.SGD(0.1, regularization=object()).minimize(loss)


# ---------------------------------------------------------------------------
# (i) the BERT program


@pytest.mark.parametrize('kw', [BERT_FLASH, BERT_UNFUSED],
                         ids=['flash', 'unfused'])
def test_bert_inference_losses_match_the_jax_executor(kw):
    feed = _bert_feeds(1)[0]
    jmain, jstart, jlosses = _build_bert(jfluid, jbert, kw, is_test=True)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(jstart, scope=scope)
    want = exe.run(jmain, feed=feed, fetch_list=jlosses, scope=scope)
    main, _, losses = _build_bert(fluid, tbert, kw, is_test=True)
    tscope = scope_from_numpy(_scope_arrays(scope), device='cpu')
    got = fluid.Executor(CPU).run(main, feed=feed, fetch_list=losses,
                                  scope=tscope)
    assert [g.shape for g in got] == [(1,)] * 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _jax_bert_run(kw):
    """_jax_run's (startup arrays, losses, final arrays) for BERT, and the
    arrays after the first step."""
    import os
    old = os.environ.get('PADDLE_FUSED_TIER')
    os.environ['PADDLE_FUSED_TIER'] = 'interpret'
    try:
        main, startup, losses = _build_bert(jfluid, jbert, kw, seed=5)
        exe, scope = jfluid.Executor(), jfluid.Scope()
        exe.run(startup, scope=scope)
        init = _scope_arrays(scope)
        out, first = [], None
        for f in _bert_feeds():
            out.append(float(exe.run(main, feed=f, fetch_list=losses[:1],
                                     scope=scope)[0][0]))
            first = first or _scope_arrays(scope)
        return init, out, _scope_arrays(scope), first
    finally:
        if old is None:
            os.environ.pop('PADDLE_FUSED_TIER', None)
        else:
            os.environ['PADDLE_FUSED_TIER'] = old


def _port_bert_run(init, kw):
    main, _, losses = _build_bert(fluid, tbert, kw, seed=5)
    exe = fluid.Executor(CPU)
    scope = scope_from_numpy(init, device='cpu')
    out = [float(exe.run(main, feed=f, fetch_list=losses[:1],
                         scope=scope)[0][0]) for f in _bert_feeds()]
    return out, _scope_arrays(scope)


@pytest.fixture(scope='module', params=['flash', 'unfused'])
def bert_runs(request):
    kw = BERT_FLASH if request.param == 'flash' else BERT_UNFUSED
    jax_run = _jax_bert_run(kw)
    return kw, jax_run, _port_bert_run(jax_run[0], kw)


def test_bert_program_trajectory_matches_the_jax_executor(bert_runs):
    """(c)'s check, where a parameter element whose first-step gradient is
    nonzero but under 1e-5 of its tensor's largest (f32 rounding noise,
    about 1e-6 of the largest here) is held within STEPS * lr as the K bias
    is: Adam's first step moves it by lr * g / (|g| + 1e-8), so noise on a
    gradient near 1e-8 moves it by a share of lr (measured: one element of
    ``bert.layer_1.ffn1.w``, first-step gradient 6.8e-8 against the
    tensor's 6.3e-2, lands 3.4e-5 from JAX's, in the port's model path
    alike). An element whose first-step gradient is exactly 0 (a token
    row no batch holds) keeps the full tolerance."""
    _, jax_run, port_run = bert_runs
    first = jax_run[3]
    noise = {}
    for name in jax_run[0]:
        m1 = first.get(name + '_moment1_0')
        if m1 is not None and not name.endswith('.attn.qkv.b'):
            noise[name] = (m1 != 0) & (np.abs(m1) < 1e-5 * np.abs(m1).max())
    _check_against_jax(jax_run, port_run, noise)


def test_bert_program_matches_bert_pretrain(bert_runs):
    kw, jax_run, (losses, got) = bert_runs
    cfg = tbert.BertConfig(**kw)
    params, state, lr = train_state_from_numpy(jax_run[0], 'cpu', config=cfg)
    model = tbert.BertPretrain(cfg, params)
    opt = TensorAdam(model.p, 1e-3, fuse=True)
    opt.load_state(state, lr)
    want = [float(opt.minimize(model.loss(**{
        k: torch.from_numpy(v) for k, v in f.items()})[0]))
        for f in _bert_feeds()]
    np.testing.assert_allclose(losses, want, rtol=1e-6)
    for name, p in model.p.items():
        np.testing.assert_allclose(got[name], p.detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
