"""The AMP program pass of paddle_tpu_torch against the JAX package's, on the
CPU.

(a) `rewrite_program_bf16` and ``decorate(Adam).minimize`` mark exactly the
    ops the JAX pass marks, in count and type, on `build_lm` (flash and
    unfused) and `build_bert_pretrain` (flash and unfused): the program
    dicts after the pass equal the JAX package's, ``__amp_dtype__`` attrs
    included.
(b) One marked op a program, run by both Executors: ``mul``, ``matmul``
    with transposes and alpha, ``flash_attention`` with and without the
    key-padding bias, ``fused_ffn_tail`` (fusable, and the composition),
    its output and the gradient of sum(out * ct) by every input, within
    1e-3 relative RMS of the JAX lowering's (tests/test_torch_amp.py's
    tolerance: the same roundings, float32 sums in another order); the
    JAX float32 run is the control and falls outside. The JAX kernel ops
    run at ``PADDLE_FUSED_TIER=interpret`` with
    `attention_ops._resolve_impl` patched to ``'interpret'``, as
    tests/test_torch_amp.py (d) runs them. ``fused_ffn_tail`` with live
    dropout draws another mask than JAX's threefry stream: the port's
    marked op is held to the JAX XLA tier (`fused_ffn_core` on the op's
    casts) under the port's own mask, read off its output.
(c) Three ``Adam(1e-3, fuse=True)`` steps of the AMP flash LM program and
    of the AMP BERT program against the JAX package's ``mp.decorate`` runs
    (tests/test_torch_amp.py `check_amp_trajectory`: its tolerances, the
    JAX float32 run as the control) and against the port's model path
    (`TransformerLM` / `BertPretrain` + `rewrite_model_bf16` +
    ``decorate(TensorAdam)``): the same functions in the same order, so
    losses and weights agree to 1e-6. On CPU tensors no kernel launches.
    The LM program also at head width 256 (d 512, 2 heads, one layer, V
    128; on the card the bf16 flash kernels' column-split form) against
    the JAX run, its parameters after three steps within 1.6e-3 relative
    RMS (measured 1.2e-3, the float32 control 2.5e-3: at d 512 a weight's
    lr-sized Adam steps are a larger share of its size than at d 128's
    5.7e-4 / 1.3e-3).
(d) Marking a program after it has run invalidates the cached plan: the
    next run computes in bf16.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.core import serialization as jser
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import transformer as jtrans
from paddle_tpu.ops import attention_ops as jattn
from paddle_tpu.ops import ffn_ops as jffn

import jax
import jax.numpy as jnp

import paddle_tpu_torch as fluid
from paddle_tpu_torch.contrib import mixed_precision as mp
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import transformer as ttrans
from paddle_tpu_torch.ops import kernel_tier

import test_torch_amp as amp_tests

CPU = fluid.CPUPlace()
SMALL = dict(vocab_size=128, seq_len=16, d_model=64, n_head=4, n_layer=2,
             d_ff=128, dropout=0.1)
MODELS = {
    'lm_flash': (jtrans, ttrans, dict(SMALL, attn_dropout=0.0)),
    'lm_unfused': (jtrans, ttrans, SMALL),
    'bert_flash': (jbert, tbert, dict(SMALL, attn_dropout=0.0,
                                      max_predictions=4)),
    'bert_unfused': (jbert, tbert, dict(SMALL, max_predictions=4)),
}
# the op types each program's pass marks, and how many
MARKED = {
    'lm_flash': {'mul': 5, 'flash_attention': 2, 'fused_ffn_tail': 2},
    'lm_unfused': {'mul': 5, 'matmul': 4, 'fused_ffn_tail': 2},
    'bert_flash': {'mul': 8, 'flash_attention': 2, 'fused_ffn_tail': 2},
    'bert_unfused': {'mul': 8, 'matmul': 4, 'fused_ffn_tail': 2},
}
TOL = 1e-3
# the AMP LM at head width 256: d 512 over 2 heads, one layer
WIDE_LM = dict(amp_tests.LM, vocab_size=128, d_model=512, n_head=2,
               n_layer=1, d_ff=512)


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels;
    restart the window after this module."""
    yield
    goodput.reset()
    # the monitor keeps at most 64 series a metric: leave it empty
    monitor.reset()


@pytest.fixture(scope='module')
def interpret_tier():
    """The JAX kernel ops in interpret mode, flash attention through its
    interpreted kernels (tests/test_torch_amp.py (d))."""
    old = os.environ.get('PADDLE_FUSED_TIER')
    os.environ['PADDLE_FUSED_TIER'] = 'interpret'
    resolve = jattn._resolve_impl
    jattn._resolve_impl = lambda use_pallas: 'interpret'
    yield
    jattn._resolve_impl = resolve
    if old is None:
        os.environ.pop('PADDLE_FUSED_TIER', None)
    else:
        os.environ['PADDLE_FUSED_TIER'] = old


# ---------------------------------------------------------------------------
# (a) the pass marks what the JAX pass marks


def _build(pkg, pmp, ser, model, how):
    """(main dict, startup dict, marked count) of a model's training program
    in ``pkg``, marked by ``how``."""
    jmod, tmod, kw = MODELS[model]
    mod = jmod if pkg is jfluid else tmod
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if model.startswith('lm'):
            loss = mod.build_lm(mod.LMConfig(**kw))[3]
        else:
            loss = mod.build_bert_pretrain(mod.BertConfig(**kw))[0]
        opt = pkg.optimizer.Adam(1e-3, fuse=True)
        n = None
        if how == 'decorate':
            pmp.decorate(opt).minimize(loss)
        else:
            lists = pmp.AutoMixedPrecisionLists(
                custom_black_list=['flash_attention', 'matmul']) \
                if how == 'black_list' else None
            n = pmp.rewrite_program_bf16(main, lists)
            opt.minimize(loss)
    return ser.program_to_dict(main), ser.program_to_dict(startup), n


@pytest.mark.parametrize('how', ['rewrite', 'decorate', 'black_list'])
@pytest.mark.parametrize('model', sorted(MODELS))
def test_pass_marks_what_the_jax_pass_marks(model, how):
    jmain, jstart, jn = _build(jfluid, jmp, jser, model, how)
    tmain, tstart, tn = _build(fluid, mp, tser, model, how)
    assert tmain == jmain
    assert tstart == jstart
    assert tn == jn
    ops = tmain['blocks'][0]['ops']
    marked = {}
    for op in ops:
        if op['attrs'].get(mp.AMP_ATTR):
            assert op['attrs'][mp.AMP_ATTR] == 'bfloat16'
            marked[op['type']] = marked.get(op['type'], 0) + 1
    want = dict(MARKED[model])
    if how == 'black_list':
        want.pop('flash_attention', None)
        want.pop('matmul', None)
    assert marked == want
    if tn is not None:
        assert tn == sum(want.values())


def test_decorate_rejects_loss_scaling_for_a_program_optimizer():
    with pytest.raises(ValueError, match='loss scaling is unnecessary'):
        mp.decorate(fluid.optimizer.Adam(1e-3), init_loss_scaling=128.0)


def test_keep_bf16_activations_raises_without_a_conv_lowering():
    """The JAX package's conv-net bandwidth mode no longer raises since the
    convolution's lowering keeps its bf16 output (the image training
    slice; tests/test_torch_image.py holds it to JAX): on a program without
    a convolution, such as the LM's, ``decorate(keep_bf16_activations=
    True)`` marks what the plain pass marks and keeps nothing, exactly as
    the JAX pass does."""
    marks = {}
    for pkg, mpmod, tmod in ((fluid, mp, ttrans), (jfluid, jmp, jtrans)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            _, _, _, loss = tmod.build_lm(tmod.LMConfig(
                **MODELS['lm_flash'][2]))
            mpmod.decorate(pkg.optimizer.Adam(1e-3),
                           keep_bf16_activations=True).minimize(loss)
        marks[pkg] = [(op.type, op.attr(mp.AMP_ATTR),
                       op.attr(mp.AMP_KEEP_ATTR))
                      for op in main.global_block().ops]
    assert marks[fluid] == marks[jfluid]
    assert not any(keep for _, _, keep in marks[fluid])
    counts = {}
    for t, dt, _ in marks[fluid]:
        if dt:
            counts[t] = counts.get(t, 0) + 1
    assert counts == MARKED['lm_flash']


# ---------------------------------------------------------------------------
# (b) one marked op a program against the JAX Executor's lowering


def _r(rs, *shape, scale=1.0):
    return (scale * rs.randn(*shape)).astype('float32')


def _op_cases():
    rs = np.random.RandomState(5)
    f = lambda *s, **k: _r(rs, *s, **k)
    bias = np.zeros((2, 32), 'float32')
    bias[0, 20:] = -1e9
    bias[1, 7:] = -1e9
    qkv = lambda: {'Q': [('q', f(2, 2, 32, 32))], 'K': [('k', f(2, 2, 32, 32))],
                   'V': [('v', f(2, 2, 32, 32))]}
    ffn = lambda d_in: {
        'W1': [('w1', f(d_in, 128, scale=.05))],
        'B1': [('b1', f(128, scale=.1))],
        'W2': [('w2', f(128, 64, scale=.05))],
        'B2': [('b2', f(64, scale=.1))]}
    ffn_attrs = dict(x_num_col_dims=2, dropout_prob=0.0, is_test=False,
                     seed=0, dropout_implementation='upscale_in_train')
    return {
        'mul': ('mul', {'X': [('x', f(4, 8, 128))],
                        'Y': [('y', f(128, 96, scale=.1))]},
                dict(x_num_col_dims=2, y_num_col_dims=1)),
        'matmul': ('matmul', {'X': [('x', f(2, 3, 20, 24))],
                              'Y': [('y', f(2, 3, 16, 20))]},
                   dict(transpose_X=True, transpose_Y=True, alpha=0.125)),
        'flash_attention:causal': (
            'flash_attention', qkv(),
            dict(scale=32 ** -0.5, causal=True, ring_zigzag=False)),
        'flash_attention:biased': (
            'flash_attention',
            dict(qkv(), KeyPaddingBias=[('bias', bias)]),
            dict(scale=32 ** -0.5, causal=False, ring_zigzag=False)),
        'fused_ffn_tail': ('fused_ffn_tail',
                           dict(ffn(64), X=[('x', f(4, 8, 64))]), ffn_attrs),
        # x_num_col_dims 1 on a 3-d input: the JAX op's composition, a cast
        # before each of its two products
        'fused_ffn_tail:composed': (
            'fused_ffn_tail', dict(ffn(128), X=[('x', f(4, 8, 16))]),
            dict(ffn_attrs, x_num_col_dims=1)),
    }


OP_CASES = _op_cases()


def _one_op(pkg, place, pmp, op_type, inputs, attrs, marked, ct):
    """Run one op in a program of ``pkg`` (marked by ``pmp``'s pass or
    not), followed by loss = sum(out * ct) as reshape2, mul and mean (so
    the loss's own ops stay unmarked) and the ``backward`` meta-op by every
    float input but the bias: [out, gradient by each input]."""
    main = pkg.Program()
    main.random_seed = 3
    block = main.global_block()
    feed, wrt = {}, []
    for slot, items in inputs.items():
        for name, arr in items:
            block.create_var(name=name, shape=arr.shape, dtype=arr.dtype)
            feed[name] = arr
            if slot != 'KeyPaddingBias':
                wrt.append(name)
    block.create_var(name='out', dtype='float32')
    block.append_op(type=op_type,
                    inputs={k: [n for n, _ in v] for k, v in inputs.items()},
                    outputs={'Out': ['out']}, attrs=dict(attrs))
    if marked:
        assert pmp.rewrite_program_bf16(main) == 1
    for name in ('flat', 'xs', 'dot', 'loss'):
        block.create_var(name=name, dtype='float32')
    block.create_var(name='ct', shape=ct.shape, dtype='float32')
    feed['ct'] = ct
    block.append_op(type='reshape2', inputs={'X': ['out']},
                    outputs={'Out': ['flat'], 'XShape': ['xs']},
                    attrs={'shape': [1, -1]})
    block.append_op(type='mul', inputs={'X': ['flat'], 'Y': ['ct']},
                    outputs={'Out': ['dot']},
                    attrs={'x_num_col_dims': 1, 'y_num_col_dims': 1})
    block.append_op(type='mean', inputs={'X': ['dot']},
                    outputs={'Out': ['loss']})
    grads = [n + '@GRAD' for n in wrt]
    for g, n in zip(grads, wrt):
        block.create_var(name=g, shape=feed[n].shape, dtype='float32')
    block.append_op(type='backward', inputs={'Loss': ['loss']},
                    outputs={'Grads': grads},
                    attrs={'wrt_names': wrt, 'sparse_wrt': []})
    exe = pkg.Executor(place) if place is not None else pkg.Executor()
    got = exe.run(main, feed=feed, fetch_list=['out'] + grads,
                  scope=pkg.Scope())
    return [np.asarray(g) for g in got]


def _ct(n):
    return np.random.RandomState(9).randn(n, 1).astype('float32')


def _out_size(key):
    return {'mul': 4 * 8 * 96, 'matmul': 2 * 3 * 24 * 16,
            'fused_ffn_tail': 4 * 8 * 64, 'fused_ffn_tail:composed': 4 * 64
            }.get(key, 2 * 2 * 32 * 32)


@pytest.fixture(scope='module')
def jax_op_runs(interpret_tier):
    out = {}
    for key, (op_type, inputs, attrs) in OP_CASES.items():
        ct = _ct(_out_size(key))
        for marked in (True, False):
            out[(key, marked)] = _one_op(jfluid, None, jmp, op_type, inputs,
                                         attrs, marked, ct)
    return out


@pytest.mark.parametrize('key', sorted(OP_CASES))
def test_marked_op_program_matches_the_jax_lowering(jax_op_runs, key):
    """The marked op's output and every gradient within 1e-3 relative RMS
    of the JAX lowering's, and the JAX float32 run outside that; the port's
    unmarked op within 1e-5 of the JAX float32 run. Measured on the CPU
    (the worst of the outputs, against the control's best): flash 0 (both
    sides bitwise) against 3.0e-3 / 3.3e-3 (biased), mul 2.6e-4 against
    2.3e-3, matmul 7.2e-5 against 2.3e-3, the FFN 3.9e-6 against 2.3e-3,
    its composition 7.2e-5 against 2.5e-3."""
    op_type, inputs, attrs = OP_CASES[key]
    ct = _ct(_out_size(key))
    kernel_tier.reset_counts()
    got = _one_op(fluid, CPU, mp, op_type, inputs, attrs, True, ct)
    f32 = _one_op(fluid, CPU, mp, op_type, inputs, attrs, False, ct)
    assert all(n == 0 for n in kernel_tier.launch_counts().values())
    want, control = jax_op_runs[(key, True)], jax_op_runs[(key, False)]
    assert len(got) == len(want) == len(control)
    for i, (g, w, c, f) in enumerate(zip(got, want, control, f32)):
        assert g.shape == w.shape and g.dtype == np.float32, (key, i)
        rel = amp_tests._rel(g, w)
        assert rel <= TOL, (key, i, rel)
        if np.array_equal(c, w):
            # a gradient the mark does not move (the composition's B2 is
            # the sum of ct in both runs): float32's limit
            assert key == 'fused_ffn_tail:composed', (key, i)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert amp_tests._rel(c, w) > TOL, (key, i,
                                                 amp_tests._rel(c, w))
        np.testing.assert_allclose(f, c, rtol=1e-5, atol=1e-5,
                                   err_msg='%s %d' % (key, i))


def test_marked_ffn_with_live_dropout_matches_the_jax_tier_on_its_mask():
    """The marked fusable FFN with dropout 0.2 in training: its keep mask
    (read off the output: a dropped element is exactly 0, a kept one is
    the bf16 value / 0.8) drops about 20%; the output and every gradient
    lie within 1e-3 relative RMS of the JAX XLA tier on the op's casts
    under that mask, the float32 tier outside."""
    op_type, inputs, attrs = OP_CASES['fused_ffn_tail']
    attrs = dict(attrs, dropout_prob=0.2)
    ct = _ct(4 * 8 * 64)
    got = _one_op(fluid, CPU, mp, op_type, inputs, attrs, True, ct)
    mask = (got[0].reshape(32, 64) != 0).astype('float32') / np.float32(0.8)
    assert 0.15 < np.mean(mask == 0) < 0.25
    # the gradients come in the order of the op's inputs
    names = list(inputs)
    args = [jnp.asarray(inputs[n][0][1]) for n in names]

    def tier(amp_on):
        def fn(*vals):
            x, w1, b1, w2, b2 = (vals[names.index(n)] for n in (
                'X', 'W1', 'B1', 'W2', 'B2'))
            x = x.reshape(32, 64)
            if amp_on:
                x, w1, w2 = (a.astype(jnp.bfloat16) for a in (x, w1, w2))
            y = jffn.fused_ffn_core(x, w1, b1, w2, b2, jnp.asarray(mask),
                                    'xla')
            return y.astype(jnp.float32).reshape(4, 8, 64)
        y, vjp = jax.vjp(fn, *args)
        return [y] + list(vjp(jnp.asarray(ct.reshape(4, 8, 64))))

    want, control = tier(True), tier(False)
    for i, (g, w, c) in enumerate(zip(got, want, control)):
        w, c = np.asarray(w, 'float32'), np.asarray(c, 'float32')
        assert amp_tests._rel(g, w) <= TOL, (i, amp_tests._rel(g, w))
        assert amp_tests._rel(c, w) > TOL, (i, amp_tests._rel(c, w))


# ---------------------------------------------------------------------------
# (c) three AMP steps of the LM and BERT programs


def _param_names(model, lm=amp_tests.LM):
    if model == 'lm':
        return list(ttrans.param_shapes(ttrans.LMConfig(**lm)))
    return list(tbert.param_shapes(tbert.BertConfig(**amp_tests.BERT)))


def _program_run(model, init, lm=amp_tests.LM):
    """(first-step moment 1, losses, final parameters, final moment 1,
    launch counts) of the port's ``mp.decorate``d training program (the LM
    in configuration ``lm``) from the JAX startup scope ``init``, on the
    CPU."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if model == 'lm':
            fetch = [ttrans.build_lm(ttrans.LMConfig(**lm))[3]]
            feeds = amp_tests._lm_feeds(lm)
        else:
            fetch = list(tbert.build_bert_pretrain(
                tbert.BertConfig(**amp_tests.BERT)))
            feeds = amp_tests._bert_feeds()
        mp.decorate(fluid.optimizer.Adam(1e-3, fuse=True)).minimize(fetch[0])
    names = _param_names(model, lm)
    exe = fluid.Executor(CPU)
    scope = scope_from_numpy(init, device='cpu')
    kernel_tier.reset_counts()
    losses, first = [], None
    for f in feeds:
        out = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        losses.append([float(o.reshape(())) for o in out])
        if first is None:
            first = {n: scope.get(n + '_moment1_0').numpy().copy()
                     for n in names}
    params = {n: scope.get(n).numpy() for n in names}
    m1 = {n: scope.get(n + '_moment1_0').numpy() for n in names}
    return first, losses, params, m1, kernel_tier.launch_counts()


@pytest.fixture(scope='module')
def jax_runs(interpret_tier):
    return {(m, marked): amp_tests._jax_run(m, marked) for m in ('lm', 'bert')
            for marked in (True, False)}


@pytest.fixture(scope='module')
def program_runs(jax_runs):
    return {m: _program_run(m, jax_runs[(m, True)][0])
            for m in ('lm', 'bert')}


@pytest.mark.parametrize('model', ['lm', 'bert'])
def test_three_step_amp_program_matches_jax_decorate(jax_runs, program_runs,
                                                     model):
    first, losses, params, m1, counts = program_runs[model]
    names = _param_names(model)
    marked = [n for n in names if n.endswith('.w') and params[n].ndim == 2
              and not n.endswith('_emb.w')]
    amp_tests.check_amp_trajectory(jax_runs, model, names, marked, first,
                                   losses, params, m1)
    # CPU tensors take the plain versions and count no launch
    assert all(n == 0 for n in counts.values())


@pytest.fixture(scope='module')
def wide_jax_runs(interpret_tier):
    return {('lm', marked): amp_tests._jax_run('lm', marked, WIDE_LM)
            for marked in (True, False)}


def test_three_step_amp_program_at_head_width_256_matches_jax_decorate(
        wide_jax_runs):
    first, losses, params, m1, counts = _program_run(
        'lm', wide_jax_runs[('lm', True)][0], WIDE_LM)
    names = _param_names('lm', WIDE_LM)
    marked = [n for n in names if n.endswith('.w') and params[n].ndim == 2
              and not n.endswith('_emb.w')]
    amp_tests.check_amp_trajectory(wide_jax_runs, 'lm', names, marked, first,
                                   losses, params, m1, param_tol=1.6e-3)
    assert all(n == 0 for n in counts.values())


@pytest.mark.parametrize('model', ['lm', 'bert'])
def test_three_step_amp_program_matches_the_model_path(jax_runs,
                                                       program_runs, model):
    _, losses, params, _, _ = program_runs[model]
    m, _, want, _ = amp_tests._port_run(model, jax_runs[(model, True)][0])
    np.testing.assert_allclose(losses, want, rtol=1e-6)
    for name, p in m.p.items():
        np.testing.assert_allclose(params[name], p.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# (d) marking a program after it ran


def test_marking_a_program_that_ran_invalidates_its_plan():
    """The plan cached by the first run is not reused once the pass marks
    the program: the next run's loss is a freshly marked program's, not
    the float32 one."""
    kw = dict(amp_tests.LM, n_layer=1)

    def build():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 5
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss = ttrans.build_lm(ttrans.LMConfig(**kw))[3]
        return main, startup, loss

    feed = amp_tests._lm_feeds()[0]
    main, startup, loss = build()
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    f32 = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
    assert mp.rewrite_program_bf16(main) == 5
    marked = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
    fresh, _, fresh_loss = build()
    mp.rewrite_program_bf16(fresh)
    want = fluid.Executor(CPU).run(fresh, feed=feed, fetch_list=[fresh_loss],
                                   scope=scope)[0]
    np.testing.assert_array_equal(marked, want)
    assert marked[0] != f32[0]
    assert abs(marked[0] - f32[0]) < 1e-2 * abs(f32[0])
