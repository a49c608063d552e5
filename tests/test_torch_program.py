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
    The flash program also at head width 256 (d 512, 2 heads, one layer,
    V 128, L 32: on the card the flash kernels' column-split form), one
    batch three times (at this width three random batches do not lower the
    loss), with the same tolerances.
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
import os

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
from torch_state_hold import noise_mask

import torch_decode_cases

SMALL = dict(vocab_size=128, seq_len=16, d_model=64, n_head=4, n_layer=2,
             d_ff=128)
# the bench's flash configuration (bench.py:1058-1060), and without dropout
FLASH = dict(SMALL, dropout=0.1, attn_dropout=0.0)
FLASH0 = dict(SMALL, dropout=0.0, attn_dropout=0.0)
# the default configuration's unfused branch, without dropout
UNFUSED0 = dict(FLASH0, use_flash_attention=False)
# the flash program at head width 256 (d 512 over 2 heads), one layer
WIDE0 = dict(FLASH0, vocab_size=128, seq_len=32, d_model=512, n_head=2,
             n_layer=1, d_ff=512)
# and above 256 (d 1024 over 2 heads of 512: the wide kernels' width)
WIDE512 = dict(WIDE0, d_model=1024)
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


def _build_op_library(pkg):
    """One program through every layer of the op library's shape, cast,
    compare and reduce ops (and the control-flow comparisons)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        x = L.data(name='x', shape=[4, 6], dtype='float32')
        ids = L.data(name='ids', shape=[1], dtype='int64')
        img = L.data(name='img', shape=[4, 6, 6], dtype='float32')
        prob = L.data(name='prob', shape=[5], dtype='float32')
        y = L.cast(L.cast(x, 'float64'), 'float32')
        L.concat([x, y], axis=1)
        L.sums([x, y])
        diag = L.diag(L.fill_constant([5], 'float32', 1.5))
        L.fill_constant_batch_size_like(x, [-1, 3], 'float32', 0.5)
        L.ones([2], 'int64')
        L.zeros([3], 'float32')
        L.zeros_like(diag)
        L.reverse(x, [1])
        L.argmin(x, 1)
        L.argmax(x, -1)
        L.argsort(x, -1)
        L.isfinite(x)
        L.has_inf(x)
        L.has_nan(x)
        L.reshape(x, [0, -1])
        L.squeeze(L.unsqueeze(x, [1]), [1])
        L.flatten(x, 2)
        L.transpose(x, [0, 2, 1])
        L.split(x, 2, dim=1)
        L.split(x, [1, 3], dim=1)
        L.reduce_mean(x, 1)
        L.reduce_max(x, [1, 2], keep_dim=True)
        L.reduce_min(x)
        L.reduce_prod(x, -1)
        L.elementwise_pow(x, y)
        L.elementwise_mod(x, y)
        L.elementwise_floordiv(x, y, axis=0)
        lt, ge = L.less_than(x, y), L.greater_equal(x, y)
        for cmp in (L.less_equal, L.greater_than, L.equal, L.not_equal):
            cmp(x, y)
        L.logical_and(lt, ge)
        L.logical_or(lt, ge)
        L.logical_xor(lt, ge)
        L.logical_not(lt)
        L.label_smooth(L.one_hot(ids, 10), epsilon=0.2)
        padded = L.pad(x, [0, 0, 1, 1, 2, 0], pad_value=1.0)
        L.pad_constant_like(padded, x, pad_value=2.0)
        L.pad2d(img, [1, 1, 2, 2], mode='reflect')
        L.stack([x, y], axis=1)
        L.unstack(x, axis=1)
        L.expand(x, [1, 2, 1])
        L.gather_nd(x, ids)
        L.scatter(x, ids, y, overwrite=False)
        L.crop(x, shape=[2, 2, 3], offsets=[0, 1, 1])
        L.shape(x)
        step = L.fill_constant([1], 'int64', 0)
        L.increment(step, 1.0)
        L.increment(step, 2.0, in_place=False)
        L.is_empty(x)
        L.multiplex([x, y], L.cast(ids, 'int32'))
        L.where(lt, x, y)
        L.space_to_depth(img, 2)
        L.shuffle_channel(img, 2)
        L.sampling_id(prob)
        L.hash(ids, 1000, num_hash=2)
    return main, startup


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


def _lm_feeds(n=STEPS, batch=4, seed=0, kw=SMALL):
    rs = np.random.RandomState(seed)
    V, L = kw['vocab_size'], kw['seq_len']
    return [{'tokens': rs.randint(0, V, (batch, L)).astype('int64'),
             'labels': rs.randint(0, V, (batch, L)).astype('int64')}
            for _ in range(n)]


WIDE_FEEDS = _lm_feeds(1, kw=WIDE0) * STEPS


# ---------------------------------------------------------------------------
# (a) the same programs


def _build_slice26_layers(pkg):
    """One program through the eleven layers of op types lowered before
    slice 26, the activation, loss and norm layers, the Variable
    operators and every learning-rate schedule."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        x = L.data(name='x', shape=[4, 6], dtype='float32')
        y = L.data(name='y', shape=[4, 6], dtype='float32')
        w = L.data(name='w', shape=[6, 3], dtype='float32',
                   append_batch_size=False)
        img = L.data(name='img', shape=[4, 3, 3], dtype='float32')
        lab = L.data(name='lab', shape=[1], dtype='int64')
        col = L.data(name='col', shape=[1], dtype='float32')
        q = L.data(name='q', shape=[2, 8, 16], dtype='float32')
        h0 = L.data(name='h0', shape=[5], dtype='float32')
        L.mul(x, w, x_num_col_dims=2)
        L.sum([x, y])
        L.sums_([x, y, x])
        L.clip(x, -0.5, 0.5)
        L.clip_by_norm(x, 1.0)
        L.sign(x)
        L.gaussian_random([3, 4], mean=1.0, std=2.0, seed=3)
        L.uniform_random([2, 5], min=-2.0, max=3.0, seed=4)
        L.lstm_unit(L.reshape(x, [-1, 24]), h0, h0, forget_bias=0.5)
        L.flash_attention(q, q, q)
        L.flash_attention(q, q, q, scale=0.0, causal=False)
        ids = L.data(name='ids', shape=[1], dtype='int64')
        emb = L.embedding(ids, size=[10, 4], is_sparse=True)
        pg = pkg.backward.append_backward(L.mean(emb))
        L.get_tensor_from_selected_rows(L.merge_selected_rows(pg[0][1]))
        for act in ('exp', 'rsqrt', 'abs', 'ceil', 'floor', 'cos', 'sin',
                    'round', 'reciprocal', 'softplus', 'softsign',
                    'tanh_shrink', 'logsigmoid', 'softshrink', 'elu',
                    'relu6', 'pow', 'stanh', 'hard_shrink', 'hard_sigmoid',
                    'thresholded_relu', 'log', 'brelu', 'leaky_relu',
                    'soft_relu', 'selu', 'swish'):
            getattr(L, act)(x)
        L.pow(x, factor=3.0)
        L.selu(x, scale=1.5, alpha=0.5)
        L.cumsum(x, axis=1, exclusive=True, reverse=True)
        for mode in ('all', 'channel', 'element'):
            L.prelu(img, mode)
        L.maxout(img, groups=2)
        L.huber_loss(x, y, 0.5)
        L.smooth_l1(x, y, x, y, sigma=2.0)
        L.smooth_l1(x, y)
        L.bpr_loss(x, lab)
        L.rank_loss(col, col, col)
        L.margin_rank_loss(col, col, col, margin=0.2)
        L.hinge_loss(col, col)
        L.teacher_student_sigmoid_loss(col, col)
        L.l2_normalize(x, axis=1)
        L.cos_sim(x, y)
        L.bilinear_tensor_product(x, y, 3, act='tanh')
        v = (x + 1.0) * 2.0 - y / 3.0
        v = (1.0 - v) ** 2.0 + 2.0 ** -v
        (v < y, v >= 0.5, v.astype('float64'))
        S = L.learning_rate_scheduler
        S.noam_decay(512, 400)
        S.exponential_decay(0.1, 100, 0.9, staircase=True)
        S.natural_exp_decay(0.1, 100, 0.9)
        S.inverse_time_decay(0.1, 100, 0.5, staircase=True)
        S.polynomial_decay(0.1, 100, cycle=True)
        S.polynomial_decay(0.1, 100, power=2.0)
        S.piecewise_decay([10, 20], [0.1, 0.01, 0.001])
        S.cosine_decay(0.1, 10, 5)
        S.linear_lr_warmup(0.1, 5, 0.0, 0.1)
    return main, startup


def _build_train_lm_example(pkg, tmod):
    """examples/train_lm.py's program at SMALL's size with its dropout."""
    from paddle_tpu.contrib import mixed_precision as jmp
    from paddle_tpu_torch.contrib import mixed_precision as tmp
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, loss = tmod.build_lm(tmod.LMConfig(
            **dict(FLASH, use_flash_attention=True)))
        lr = pkg.layers.learning_rate_scheduler.noam_decay(
            SMALL['d_model'], 400)
        (jmp if pkg is jfluid else tmp).decorate(
            pkg.optimizer.Adam(learning_rate=lr)).minimize(loss)
    return main, startup


@pytest.mark.parametrize('which', ['flash', 'default', 'inference',
                                   'quick_start', 'bert_flash',
                                   'bert_unfused', 'bert_inference',
                                   'op_library', 'slice26_layers',
                                   'train_lm_example'] +
                         list(torch_decode_cases.PROGRAMS))
def test_program_dicts_equal_the_jax_package(which):
    def build(pkg, tmod, ser):
        if which in torch_decode_cases.PROGRAMS:
            main, startup, _ = torch_decode_cases.build(pkg, tmod, which)
        elif which == 'quick_start':
            main, startup, _ = _build_quick_start(pkg)
        elif which == 'op_library':
            main, startup = _build_op_library(pkg)
        elif which == 'slice26_layers':
            main, startup = _build_slice26_layers(pkg)
        elif which == 'train_lm_example':
            main, startup = _build_train_lm_example(pkg, tmod)
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
    c.update(_shape_cast_compare_reduce_cases(rs, f))
    return c


def _one(x_name, x, **attrs):
    """A one-input, one-output case."""
    return dict(inputs={x_name: [('x', x)]}, outputs={'Out': ['out']},
                attrs=attrs)


def _two(x, y, out='Out', **attrs):
    return dict(inputs={'X': [('x', x)], 'Y': [('y', y)]},
                outputs={out: ['out']}, attrs=attrs)


def _shape_cast_compare_reduce_cases(rs, f):
    """The op library's shape, cast, compare and reduce ops (one case a
    type, a second where a mode takes another path)."""
    i = lambda lo, hi, *s: rs.randint(lo, hi, s).astype('int64')
    b = lambda *s: rs.rand(*s) < 0.5
    c = {}
    # meta
    c['cast'] = _one('X', f(4, 8, scale=3.0), in_dtype=np.dtype('float32'),
                     out_dtype=np.dtype('int64'))
    c['fill'] = dict(inputs={}, outputs={'Out': ['out']},
                     attrs={'shape': [2, 3], 'dtype': np.dtype('float32'),
                            'value': [float(v) for v in f(6)]})
    c['fill_zeros_like'] = _one('X', f(3, 4))
    c['fill_constant_batch_size_like'] = _one(
        'Input', f(5, 3), shape=[-1, 7], dtype=np.dtype('float32'),
        value=2.5, input_dim_idx=0, output_dim_idx=0)
    c['shape'] = _one('Input', f(3, 4, 5))
    c['increment'] = _one('X', f(1), step=2.0)
    # ids outside [0, depth) give a row of zeros
    c['one_hot'] = _one('X', i(-1, 6, 7, 1), depth=5)
    c['is_empty'] = _one('X', f(3, 4))
    # compare and logical ops, Y broadcast along axis 1
    c['equal'] = _two(i(0, 3, 4, 6), i(0, 3, 4, 6))
    c['not_equal'] = _two(i(0, 3, 4, 6), i(0, 3, 6), axis=1)
    c['less_than'] = _two(f(4, 8), f(8), axis=1)
    c['less_equal'] = _two(i(0, 3, 4, 6), i(0, 3, 4, 6))
    c['greater_than'] = _two(f(4, 8), f(4, 8))
    c['greater_equal'] = _two(i(0, 3, 4, 6), i(0, 3, 4, 6))
    for op in ('logical_and', 'logical_or', 'logical_xor'):
        c[op] = _two(b(4, 6), b(4, 6))
    c['logical_not'] = _one('X', b(4, 6))
    x = f(4, 8)
    x[1, 2] = np.inf
    c['isfinite'] = _one('X', x)
    c['isfinite:finite'] = _one('X', f(4, 8))
    # reductions and the elementwise ops on integer semantics
    c['reduce_mean'] = _one('X', f(3, 4, 5), dim=[1, 2], keep_dim=False)
    c['reduce_max'] = _one('X', f(3, 4, 5), dim=[-1], keep_dim=True)
    c['reduce_min'] = _one('X', f(3, 4, 5), reduce_all=True)
    c['reduce_prod'] = _one('X', 1 + f(3, 4, 5, scale=0.1), dim=[0, 2])
    c['reduce_all'] = _one('X', b(3, 4), dim=[1])
    c['reduce_any'] = _one('X', b(3, 4), reduce_all=True, keep_dim=True)
    c['elementwise_pow'] = _two(0.5 + rs.rand(4, 8).astype('float32'),
                                f(4, 8), axis=-1)
    # the remainder takes the divisor's sign, the quotient is floored
    c['elementwise_mod'] = _two(f(4, 8, scale=5.0),
                                np.where(b(4, 8), 1.5, -2.5).astype(
                                    'float32'), axis=-1)
    c['elementwise_floordiv'] = _two(i(-20, 20, 4, 8),
                                     np.where(b(4, 8), 3, -4).astype(
                                         'int64'), axis=-1)
    # shape ops
    c['reshape'] = _one('X', f(4, 6, 5), shape=[0, -1])
    c['transpose'] = _one('X', f(2, 3, 4), axis=[2, 0, 1])
    c['concat'] = dict(inputs={'X': [('a', f(2, 3)), ('b', f(4, 3))]},
                       outputs={'Out': ['out']}, attrs={'axis': 0})
    c['split'] = dict(inputs={'X': [('x', f(6, 4))]},
                      outputs={'Out': ['o0', 'o1', 'o2']},
                      attrs={'axis': 0, 'sections': [1, 2, 3], 'num': 0})
    c['split:num'] = dict(inputs={'X': [('x', f(6, 4))]},
                          outputs={'Out': ['o0', 'o1']},
                          attrs={'axis': 1, 'sections': [], 'num': 2})
    c['squeeze'] = _one('X', f(1, 4, 1, 5), axes=[0])
    c['unsqueeze'] = _one('X', f(3, 4), axes=[0, 2])
    c['unsqueeze2'] = dict(inputs={'X': [('x', f(3, 4))]},
                           outputs={'Out': ['out'], 'XShape': ['xs']},
                           attrs={'axes': [1]})
    c['flatten'] = _one('X', f(2, 3, 4), axis=2)
    c['flatten2'] = dict(inputs={'X': [('x', f(2, 3, 4))]},
                         outputs={'Out': ['out'], 'XShape': ['xs']},
                         attrs={'axis': 1})
    c['stack'] = dict(inputs={'X': [('a', f(3, 4)), ('b', f(3, 4))]},
                      outputs={'Y': ['out']}, attrs={'axis': 1})
    c['unstack'] = dict(inputs={'X': [('x', f(3, 2, 4))]},
                        outputs={'Y': ['y0', 'y1']}, attrs={'axis': 1})
    c['expand'] = _one('X', f(2, 3), expand_times=[2, 3])
    # fewer repeats than axes: jnp.tile pads them with leading 1s
    c['tile'] = _one('X', f(2, 3), repeat_times=[3])
    # padding and slicing
    c['pad'] = _one('X', f(2, 3), paddings=[1, 0, 2, 1], pad_value=0.5)
    for mode in ('constant', 'reflect', 'edge'):
        c['pad2d' + ('' if mode == 'reflect' else ':' + mode)] = _one(
            'X', f(1, 2, 4, 5), paddings=[1, 2, 2, 1], mode=mode,
            pad_value=0.25, data_format='NCHW')
    c['pad_constant_like'] = _two(f(4, 5), f(2, 3), pad_value=1.5)
    c['strided_slice'] = _one('Input', f(6, 7), axes=[0, 1], starts=[1, 6],
                              ends=[6, 0], strides=[2, -2])
    c['crop'] = _one('X', f(5, 6), offsets=[1, 2], shape=[3, 3])
    c['reverse'] = _one('X', f(3, 4), axis=[0, 1])
    # index ops; a repeated id: the last update wins, or both add
    for key, over in (('scatter', True), ('scatter:add', False)):
        c[key] = dict(inputs={'X': [('x', f(6, 4))],
                              'Ids': [('ids', np.array([1, 3, 1, 5],
                                                       'int64'))],
                              'Updates': [('u', f(4, 4))]},
                      outputs={'Out': ['out']}, attrs={'overwrite': over})
    c['gather_nd'] = dict(inputs={'X': [('x', f(4, 5, 6))],
                                  'Index': [('ids', np.stack(
                                      [i(0, 4, 3), i(0, 5, 3)], -1))]},
                          outputs={'Out': ['out']}, attrs={})
    c['where'] = dict(inputs={'Condition': [('c', b(4, 5))],
                              'X': [('x', f(4, 5))], 'Y': [('y', f(4, 5))]},
                      outputs={'Out': ['out']}, attrs={})
    c['multiplex'] = dict(inputs={'X': [('a', f(4, 3)), ('b', f(4, 3)),
                                        ('d', f(4, 3))],
                                  'Ids': [('ids', rs.randint(0, 3, (4, 1))
                                           .astype('int32'))]},
                          outputs={'Out': ['out']}, attrs={})
    c['arg_max'] = _one('X', f(4, 6), axis=1)
    c['arg_min'] = _one('X', f(4, 6), axis=0)
    # ties: stable, their first position first
    c['argsort'] = dict(inputs={'X': [('x', rs.randint(0, 4, (3, 8))
                                       .astype('float32'))]},
                        outputs={'Out': ['out'], 'Indices': ['idx']},
                        attrs={'axis': -1})
    c['diag'] = dict(inputs={'Diagonal': [('x', f(5))]},
                     outputs={'Out': ['out']}, attrs={})
    c['label_smooth'] = _one('X', np.eye(6, dtype='float32')[:4],
                             epsilon=0.1)
    c['label_smooth:prior'] = dict(
        inputs={'X': [('x', np.eye(6, dtype='float32')[:4])],
                'PriorDist': [('p', rs.dirichlet(np.ones(6), 1)
                               .astype('float32'))]},
        outputs={'Out': ['out']}, attrs={'epsilon': 0.2})
    c['space_to_depth'] = _one('X', f(1, 2, 4, 6), blocksize=2)
    c['shuffle_channel'] = _one('X', f(2, 6, 3, 3), group=3)
    # uint32 products and sums that wrap, negative ids too
    c['hash'] = _one('X', i(-2 ** 31, 2 ** 31, 4, 3), num_hash=2,
                     mod_by=1000)
    # one-hot rows: the draw is certain (the others clip to 1e-20)
    c['sampling_id'] = _one('X', np.eye(5, dtype='float32')[[3, 0, 4, 4]])
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


def _jax_run(kw, feeds=None):
    """(startup arrays, losses, final arrays, arrays after the first step)
    of the JAX program of ``kw`` (dropout 0), three Adam(1e-3, fuse=True)
    steps at the interpret tier."""
    import os
    old = os.environ.get('PADDLE_FUSED_TIER')
    os.environ['PADDLE_FUSED_TIER'] = 'interpret'
    try:
        main, startup, _, loss = _build_lm(jfluid, jtrans, kw, seed=5)
        exe, scope = jfluid.Executor(), jfluid.Scope()
        exe.run(startup, scope=scope)
        init = _scope_arrays(scope)
        losses, first = [], None
        for f in feeds or _lm_feeds():
            losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                        scope=scope)[0][0]))
            first = first or _scope_arrays(scope)
        return init, losses, _scope_arrays(scope), first
    finally:
        if old is None:
            os.environ.pop('PADDLE_FUSED_TIER', None)
        else:
            os.environ['PADDLE_FUSED_TIER'] = old


def _port_run(init, kw, feeds=None):
    main, startup, _, loss = _build_lm(fluid, ttrans, kw, seed=5)
    types = [op.type for op in main.global_block().ops]
    assert ('flash_attention' in types) == kw.get('use_flash_attention',
                                                  True)
    exe = fluid.Executor(CPU)
    scope = scope_from_numpy(init, device='cpu')
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0][0]) for f in feeds or _lm_feeds()]
    return losses, _scope_arrays(scope)


@pytest.fixture(scope='module')
def jax_flash_run():
    return _jax_run(FLASH0)


@pytest.fixture(scope='module')
def port_flash_run(jax_flash_run):
    return _port_run(jax_flash_run[0], FLASH0)


@pytest.fixture(scope='module')
def jax_wide_run():
    return _jax_run(WIDE0, WIDE_FEEDS)


@pytest.fixture(scope='module')
def port_wide_run(jax_wide_run):
    return _port_run(jax_wide_run[0], WIDE0, WIDE_FEEDS)


@pytest.fixture(scope='module')
def jax_wide512_run():
    return _jax_run(WIDE512, WIDE_FEEDS)


@pytest.fixture(scope='module')
def port_wide512_run(jax_wide512_run):
    return _port_run(jax_wide512_run[0], WIDE512, WIDE_FEEDS)


@pytest.fixture(scope='module')
def jax_unfused_run():
    return _jax_run(UNFUSED0)


@pytest.fixture(scope='module')
def port_unfused_run(jax_unfused_run):
    return _port_run(jax_unfused_run[0], UNFUSED0)


def _k_bias_apart(name, have, want, tol, d=SMALL['d_model']):
    """The K slice of a ``d``-wide model's qkv bias within ``tol``; returns
    the rest."""
    if not name.endswith('.attn.qkv.b'):
        return have, want
    assert np.abs(have[d:2 * d] - want[d:2 * d]).max() <= tol, name
    return (np.delete(have, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d]))


def _check_against_jax(jax_run, port_run, noise=None, d=SMALL['d_model']):
    """``noise``: {parameter name: a mask of the elements whose gradient is
    rounding noise}, held within STEPS * lr as the K bias is; ``d``: the
    model's width."""
    init, want_losses, want = jax_run[:3]
    losses, got = port_run
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert sorted(got) == sorted(want)
    for name in want:
        have, w = got[name], want[name]
        if '_moment' not in name:
            have, w = _k_bias_apart(name, have, w, STEPS * 1e-3, d)
        if noise and name in noise:
            apart = noise[name]
            assert np.abs(have[apart] - w[apart]).max(initial=0) <= \
                STEPS * 1e-3, name
            have, w = have[~apart], w[~apart]
        np.testing.assert_allclose(have, w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _noise(jax_run):
    """{parameter name: `noise_mask` of the JAX run's first-step moment 1},
    the K bias of each qkv apart (held on its own)."""
    first, noise = jax_run[3], {}
    for name in jax_run[0]:
        m1 = first.get(name + '_moment1_0')
        if m1 is not None and not name.endswith('.attn.qkv.b'):
            noise[name] = noise_mask(m1)
    return noise


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


def test_flash_program_at_head_width_256_matches_the_jax_executor(
        jax_wide_run, port_wide_run):
    """(c)'s check at head width 256, the rounding noise of `_noise` held
    within STEPS * lr (measured: one element of ``layer_0.ffn2.w`` lands
    1.8e-5 from JAX's)."""
    _check_against_jax(jax_wide_run, port_wide_run, _noise(jax_wide_run),
                       d=WIDE0['d_model'])


def test_flash_program_at_head_width_512_matches_the_jax_executor(
        jax_wide512_run, port_wide512_run):
    """(c)'s check at head width 512 (the card's wide kernels; their plain
    versions here), the rounding noise of `_noise` held within STEPS *
    lr."""
    _check_against_jax(jax_wide512_run, port_wide512_run,
                       _noise(jax_wide512_run), d=WIDE512['d_model'])


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


def _one_layer_program(pkg, build):
    """A program of what ``build(pkg)`` appends; returns (main, startup,
    build's result)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = build(pkg)
    return main, startup, out


def _eleven(pkg, which):
    """(fetch vars, feed) of one of the eleven layers whose op types the
    port lowered before it had their layers, on seeded inputs."""
    L = pkg.layers
    rs = np.random.RandomState(26)
    f = lambda *s: rs.randn(*s).astype('float32')
    feed = {'x': f(4, 6), 'y': f(4, 6)}
    x = L.data(name='x', shape=[6])
    y = L.data(name='y', shape=[6])
    if which == 'mul':
        feed['w'] = f(6, 3)
        w = L.data(name='w', shape=[6, 3], append_batch_size=False)
        return [L.mul(x, w)], feed
    if which == 'sum':
        return [L.sum([x, y, x])], feed
    if which == 'clip':
        return [L.clip(x, -0.5, 0.75)], feed
    if which == 'clip_by_norm':
        return [L.clip_by_norm(x, 1.5), L.clip_by_norm(y, 100.0)], feed
    if which == 'sign':
        feed['x'][0, :3] = 0.0
        return [L.sign(x)], feed
    if which == 'lstm_unit':
        feed['c'] = f(4, 5)
        h = L.fc(y, size=5, act='tanh')
        return list(L.lstm_unit(x, h, L.data(name='c', shape=[5]),
                                forget_bias=0.5)), feed
    if which == 'flash_attention':
        feed = {n: f(2, 2, 8, 16) for n in 'qkv'}
        q, k, v = (L.data(name=n, shape=[2, 2, 8, 16],
                          append_batch_size=False) for n in 'qkv')
        return [L.flash_attention(q, k, v),
                L.flash_attention(q, k, v, scale=0.5, causal=False)], feed
    # merge_selected_rows, get_tensor_from_selected_rows: the sparse
    # table's gradient (repeated ids) merged, then its rows as a tensor
    feed = {'ids': np.array([[3], [1], [3], [7], [1]], 'int64')}
    ids = L.data(name='ids', shape=[1], dtype='int64')
    emb = L.embedding(ids, size=[10, 4], is_sparse=True)
    (_, grad), = pkg.backward.append_backward(L.mean(L.square(emb)))
    merged = L.merge_selected_rows(grad)
    return [L.get_tensor_from_selected_rows(merged), merged], feed


ELEVEN = ['mul', 'sum', 'clip', 'clip_by_norm', 'sign', 'lstm_unit',
          'flash_attention', 'merge_selected_rows']


@pytest.mark.parametrize('which', ELEVEN)
def test_layers_of_ops_lowered_before_match_the_jax_executor(which):
    """The deterministic of the eleven layers (Queue 3 item 1 of the
    port's ROADMAP; ``merge_selected_rows`` with
    ``get_tensor_from_selected_rows``): the same program as the JAX
    package's, and the same fetches through ``Executor.run`` from the JAX
    startup scope within 1e-5 (rtol and atol)."""
    feeds = []

    def build(pkg):
        out, feed = _eleven(pkg, which)
        feeds.append(feed)
        return out

    jmain, jstart, jouts = _one_layer_program(jfluid, build)
    tmain, tstart, touts = _one_layer_program(fluid, build)
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    assert tser.program_to_dict(tstart) == jser.program_to_dict(jstart)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    if which == 'flash_attention':
        os.environ['PADDLE_FUSED_TIER'] = 'interpret'
    try:
        want = jexe.run(jmain, feed=feeds[0], fetch_list=jouts,
                        scope=jscope)
    finally:
        os.environ.pop('PADDLE_FUSED_TIER', None)
    got = fluid.Executor(CPU).run(
        tmain, feed=feeds[1], fetch_list=touts,
        scope=scope_from_numpy(_scope_arrays(jscope), device='cpu'))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('which', ['uniform_random', 'gaussian_random'])
def test_random_layers_hold_their_distribution(which):
    """``layers.uniform_random`` and ``layers.gaussian_random``: the JAX
    program, and draws of the op's shape, dtype, range and moments in both
    packages (threefry and torch's generator cannot agree draw by draw)."""
    attrs = dict(shape=[64, 50], seed=0)
    attrs.update(dict(min=-2.0, max=3.0) if which == 'uniform_random'
                 else dict(mean=1.0, std=2.0))

    def build(pkg):
        return [getattr(pkg.layers, which)(**attrs)]

    runs = []
    for pkg, place in ((jfluid, None), (fluid, CPU)):
        main, startup, outs = _one_layer_program(pkg, build)
        runs.append(main)
        exe = pkg.Executor(place) if place else pkg.Executor()
        draws = [np.asarray(exe.run(main, fetch_list=outs,
                                    scope=pkg.Scope())[0]) for _ in range(2)]
        _check_draws(which, attrs, *draws)
    assert tser.program_to_dict(runs[1]) == jser.program_to_dict(runs[0])


@pytest.mark.parametrize('name', ['Block', 'Operator', 'cpu_places',
                                  'cuda_places'])
def test_framework_names_of_the_jax_package(name):
    """``Block``, ``Operator``, ``cpu_places`` and ``cuda_places`` at the
    top level, as in the JAX package: ``cpu_places()`` reads ``CPU_NUM``
    (1 without it), ``cuda_places()`` lists every visible card."""
    import paddle_tpu_torch
    from paddle_tpu_torch import framework
    assert hasattr(jfluid, name) and name in paddle_tpu_torch.__all__
    assert getattr(paddle_tpu_torch, name) is getattr(framework, name)
    if name == 'cpu_places':
        old = os.environ.pop('CPU_NUM', None)
        try:
            assert len(fluid.cpu_places()) == 1
            os.environ['CPU_NUM'] = '3'
            places = fluid.cpu_places()
            assert len(places) == 3 and all(
                isinstance(p, fluid.CPUPlace) for p in places)
            assert len(fluid.cpu_places(2)) == 2
        finally:
            os.environ.pop('CPU_NUM', None)
            if old is not None:
                os.environ['CPU_NUM'] = old
    if name == 'cuda_places':
        assert len(fluid.cuda_places()) == torch.cuda.device_count()
        assert [p.device_id for p in fluid.cuda_places([1, 0])] == [1, 0]


@pytest.mark.parametrize('dtype', ['int32', 'int64', 'uint8', 'bool',
                                   'float32'])
def test_gather_op_of_any_dtype_matches_the_jax_executor(dtype):
    """``layers.gather`` (the `gather` op) through the Executor, and
    `ops.tensor_ops.gather` itself, against the JAX program and ``jnp.take``
    exactly: ids in range, in [-n, 0) (counted from the end) and outside
    [-n, n), whose rows hold the fill value (NaN, int32's least value for
    an int32 or int64 program, 255 for uint8, True for bool)."""
    import jax.numpy as jnp
    from paddle_tpu_torch.ops.tensor_ops import gather
    rs = np.random.RandomState(6)
    x = rs.randint(0, 200, (7, 3))
    x = (x % 2).astype(dtype) if dtype == 'bool' else x.astype(dtype)
    ids = np.concatenate([rs.randint(-7, 7, 10),
                          [-7, -1, 6, 7, 9, -8, -20]]).astype('int64')

    def build(pkg):
        xv = pkg.layers.data(name='x', shape=list(x.shape), dtype=dtype,
                             append_batch_size=False)
        iv = pkg.layers.data(name='ids', shape=[len(ids)], dtype='int64',
                             append_batch_size=False)
        return pkg.layers.gather(xv, iv)

    def run(pkg, place):
        main, _, out = _one_layer_program(pkg, build)
        exe = pkg.Executor(place) if place is not None else pkg.Executor()
        return np.asarray(exe.run(main, feed={'x': x, 'ids': ids},
                                  fetch_list=[out])[0])

    want = run(jfluid, None)
    got = run(fluid, CPU)
    assert got.shape == want.shape == (len(ids), 3)
    np.testing.assert_array_equal(got, want)
    fill = {'int32': -2 ** 31, 'int64': -2 ** 31, 'uint8': 255,
            'bool': True}.get(dtype)
    outside = (ids >= 7) | (ids < -7)
    if fill is None:
        assert np.isnan(got[outside]).all()
    else:
        assert (got[outside] == fill).all()
    direct = gather(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(direct, np.asarray(jnp.take(
        jnp.asarray(x), jnp.asarray(ids, jnp.int32), axis=0)))


@pytest.mark.parametrize('name', ['calc_gradient', 'gradients'])
def test_calc_gradient_matches_the_jax_executor(name):
    """``calc_gradient`` (and its alias ``gradients``) w.r.t. a fed variable
    and a parameter, the bias named in ``no_grad_set``: the same program
    as the JAX package's, and the same gradients through ``Executor.run``
    within 1e-5 relative."""
    rs = np.random.RandomState(8)
    feed = {'x': rs.randn(6, 5).astype('float32')}

    def build(pkg):
        x = pkg.layers.data(name='x', shape=[5], dtype='float32')
        h = pkg.layers.fc(x, size=4, act='tanh')
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(h, h))
        w, b = pkg.default_main_program().global_block().all_parameters()
        grads = getattr(pkg, name)(loss, [x, w, b], no_grad_set=[b.name])
        return [loss] + grads

    jmain, jstart, jouts = _one_layer_program(jfluid, build)
    tmain, tstart, touts = _one_layer_program(fluid, build)
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    assert tser.program_to_dict(tstart) == jser.program_to_dict(jstart)
    assert [v.name for v in touts[1:]] == ['x@GRAD', 'fc_0.w_0@GRAD']
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    want = jexe.run(jmain, feed=feed, fetch_list=jouts, scope=jscope)
    got = fluid.Executor(CPU).run(
        tmain, feed=feed, fetch_list=touts,
        scope=scope_from_numpy(_scope_arrays(jscope), device='cpu'))
    assert got[1].shape == (6, 5) and got[2].shape == (5, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7)
    assert np.abs(got[1]).max() > 0


@pytest.mark.parametrize('name', [
    'calc_gradient', 'gradients', 'save_vars', 'save_params',
    'save_persistables', 'load_vars', 'load_params', 'load_persistables'])
def test_top_level_names_of_the_jax_package(name):
    """The names the JAX package exports at its top level for gradients and
    for saving and loading variables: importable from the port, in its
    ``__all__``, and the same functions as in its modules."""
    import paddle_tpu_torch
    from paddle_tpu_torch import backward, io
    assert hasattr(jfluid, name)
    fn = getattr(paddle_tpu_torch, name)
    assert name in paddle_tpu_torch.__all__
    assert fn is getattr(backward if 'grad' in name else io, name)


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
    # sparse embedding gradients train since the CTR slice (see
    # tests/test_torch_sparse.py); rematerialization and ModelAverage wait
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data(name='ids', shape=[4], dtype='int64')
        emb = fluid.layers.embedding(ids, size=[10, 8], is_sparse=True)
        loss = fluid.layers.mean(emb)
        with pytest.raises(NotImplementedError, match='rematerialization'):
            fluid.append_backward(loss, checkpoints=[emb])
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data(name='ids', shape=[4], dtype='int64')
        emb = fluid.layers.embedding(ids, size=[10, 8], is_sparse=True)
        loss = fluid.layers.mean(emb)
        fluid.optimizer.Momentum(
            0.1, 0.9, regularization=fluid.regularizer.L2Decay(1e-4)
        ).minimize(loss)
        with pytest.raises(NotImplementedError, match='average_accumulates'):
            fluid.optimizer.ModelAverage(0.15)


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
    _check_against_jax(jax_run, port_run, _noise(jax_run))


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
