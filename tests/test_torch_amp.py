"""bf16 mixed precision (AMP) in paddle_tpu_torch against the JAX package,
on the CPU.

(a) The policy: `AutoMixedPrecisionLists`' custom-list checks, `decorate`'s
    refusal of loss scaling, and `rewrite_model_bf16` marking the sites the
    JAX package's `rewrite_program_bf16` marks in the same model's program.
(b) The bf16 flash plain versions (what the CPU runs, the arithmetic of the
    bf16 kernels) against the JAX package's Pallas kernels in interpret
    mode on bf16 inputs: O, dQ, dK and dV within 1e-2 of each tensor's
    largest magnitude (both round P and dS to bf16 at the same places but
    sum in other orders and tiles, so an element may land one bf16 step,
    2^-8 of itself, away), LSE within 1e-5 (float32 sums of float32
    exponentials).
(c) The marked ``mul``, ``matmul`` and the FFN tail against the JAX
    package's own lowerings (`_mul`, `_matmul`, `_fused_ffn_tail_op` with
    the AMP mark) in a Program, values and every gradient.
(d) The slice as a whole: three `Adam(1e-3, fuse=True)` steps of the flash
    LM and of BERT under AMP against the JAX package's `mp.decorate` run at
    ``PADDLE_FUSED_TIER=interpret``, weights carried by
    `train_state_from_numpy`.
(e) CPU tensors take the plain versions and count no launch.

The measure of (c) and (d) is the relative RMS error, ||a - b|| / ||b||
over a tensor (or over all moment-1 tensors of a model), not the largest
element: bf16 rounds an output to 8 significant bits, and two correct
implementations that sum in another order round a few elements near a
rounding boundary one step apart, which a largest-element measure reads
as a whole bf16 step. Each AMP tolerance comes with a control: the JAX
package's float32 run falls outside it, so that the test tells AMP from
float32.

For (d) the JAX run attends through its flash kernels in interpret mode
(`attention_ops._resolve_impl` returns ``'interpret'`` for the run), the
arithmetic a TPU runs and the port's bf16 kernels reproduce. The JAX op on
the CPU would otherwise attend through its plain reference under
``jax.vjp``, which rounds the normalised P to bf16 and differentiates the
rounded graph: a different bf16 arithmetic, which moves every gradient
downstream of the attention by a bf16 step here and there, about as far
as AMP moves them from float32, so that no tolerance could tell AMP from
float32 there.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import goodput, layers, monitor
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.models import bert as jbert
from paddle_tpu.models.transformer import LMConfig as JLMConfig
from paddle_tpu.models.transformer import build_lm
from paddle_tpu.ops import attention_ops as jattn

import jax.numpy as jnp

from paddle_tpu_torch.contrib import mixed_precision as mp
from paddle_tpu_torch.core import amp
from paddle_tpu_torch.io import train_state_from_numpy
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.models.bert import BertConfig, BertPretrain
from paddle_tpu_torch.models.transformer import (LMConfig, TransformerLM,
                                                 init_params)
from paddle_tpu_torch.ops import (attention_ops, ffn_ops, kernel_tier,
                                  math_ops)
from paddle_tpu_torch.optimizer import TensorAdam

LM = dict(vocab_size=512, seq_len=32, d_model=128, n_head=4, n_layer=2,
          d_ff=256, dropout=0.0, attn_dropout=0.0, use_flash_attention=True)
BERT = dict(vocab_size=128, seq_len=32, d_model=64, n_head=4, n_layer=2,
            d_ff=128, dropout=0.0, attn_dropout=0.0, max_predictions=4)
STEPS = 3


def _rel(a, b):
    """||a - b|| / ||b|| over whole arrays."""
    a, b = np.asarray(a, 'float64'), np.asarray(b, 'float64')
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


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
    old = os.environ.get('PADDLE_FUSED_TIER')
    os.environ['PADDLE_FUSED_TIER'] = 'interpret'
    yield
    if old is None:
        os.environ.pop('PADDLE_FUSED_TIER', None)
    else:
        os.environ['PADDLE_FUSED_TIER'] = old


# ---------------------------------------------------------------------------
# (a) the policy


@pytest.mark.parametrize('kw', [dict(custom_white_list=['softmax']),
                                dict(custom_white_list=['layer_norm'])])
def test_custom_white_list_in_black_list_raises_as_in_jax(kw):
    with pytest.raises(ValueError, match='both custom white list'):
        jmp.AutoMixedPrecisionLists(**kw)
    with pytest.raises(ValueError, match='both custom white list'):
        mp.AutoMixedPrecisionLists(**kw)


def test_custom_lists_match_jax():
    kw = dict(custom_white_list=['relu'], custom_black_list=['matmul'])
    got, want = mp.AutoMixedPrecisionLists(**kw), \
        jmp.AutoMixedPrecisionLists(**kw)
    assert got.white_list == want.white_list
    assert got.black_list == want.black_list
    assert mp.WHITE_LIST == jmp.WHITE_LIST
    assert mp.BLACK_LIST == jmp.BLACK_LIST


@pytest.mark.parametrize('kw', [dict(use_dynamic_loss_scaling=True),
                                dict(init_loss_scaling=128.0)])
def test_decorate_rejects_loss_scaling_as_in_jax(kw):
    with pytest.raises(ValueError, match='loss scaling is unnecessary'):
        jmp.decorate(fluid.optimizer.SGD(0.1), **kw)
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(ValueError, match='loss scaling is unnecessary'):
        mp.decorate(TensorAdam([p]), **kw)


def test_cast_compute_casts_float32_only():
    f, i = torch.ones(2, 3), torch.ones(2, dtype=torch.int64)
    b = torch.ones(2, dtype=torch.bfloat16)
    assert amp.cast_compute(None, f) is f
    assert amp.cast_compute('', f, i) == (f, i)
    out = amp.cast_compute('bfloat16', f.t(), i, b, None)
    assert out[0].dtype == torch.bfloat16 and out[0].is_contiguous()
    assert out[1] is i and out[2] is b and out[3] is None
    with pytest.raises(ValueError, match='unknown AMP dtype'):
        amp.cast_compute('int8', f)


def _jax_marked(build):
    """The count and op types `rewrite_program_bf16` marks in a program."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        build()
    n = jmp.rewrite_program_bf16(main)
    return n, [op.type for b in main.blocks for op in b.ops
               if op.attr(jmp.AMP_ATTR)]


@pytest.mark.parametrize('model', ['lm_flash', 'lm_unfused', 'bert'])
def test_rewrite_model_marks_what_the_program_pass_marks(model):
    if model == 'bert':
        cfg = BertConfig(**BERT)
        m = BertPretrain(cfg, pbert.init_params(cfg, 0, 'cpu'))
        n, types = _jax_marked(lambda: jbert.build_bert_pretrain(
            jbert.BertConfig(**BERT)))
    else:
        kw = dict(LM, use_flash_attention=model == 'lm_flash')
        m = TransformerLM(LMConfig(**kw), init_params(LMConfig(**kw), 0,
                                                      'cpu'), 32)
        n, types = _jax_marked(lambda: build_lm(JLMConfig(**kw)))
    assert m.amp == {}
    assert mp.rewrite_model_bf16(m) == n
    assert m.forward_sites() == types
    # every site type of the model is white-listed, so each is marked
    assert set(types) <= set(m.amp) == set(m.SITE_TYPES)
    assert all(v == 'bfloat16' for v in m.amp.values())
    # a custom black list takes a site type out
    black = 'flash_attention' if model != 'lm_unfused' else 'matmul'
    k = types.count(black)
    assert mp.rewrite_model_bf16(m, mp.AutoMixedPrecisionLists(
        custom_black_list=[black])) == n - k
    assert black not in m.amp


def test_decorated_optimizer_delegates():
    cfg = LMConfig(**dict(LM, n_layer=1))
    m = TransformerLM(cfg, init_params(cfg, 0, 'cpu'), 32)
    mp.rewrite_model_bf16(m)
    opt = mp.decorate(TensorAdam(m.p, 1e-3, fuse=True))
    tok = torch.randint(0, 512, (2, 32), generator=torch.Generator()
                        .manual_seed(0))
    before = m.p['lm_head.w'].detach().clone()
    loss = opt.minimize(m.loss(tok, tok))
    assert torch.isfinite(loss) and m.p['lm_head.w'].grad is None
    assert not torch.equal(before, m.p['lm_head.w'])
    assert float(opt.state()['lm_head.w']['beta1_pow'][0]) == \
        pytest.approx(0.81, rel=1e-6)
    params_grads = opt.backward(m.loss(tok, tok))
    assert [p for p, _ in params_grads] == list(m.p.values())
    opt.apply_gradients(params_grads)
    assert m.p['lm_head.w'].grad is None


# ---------------------------------------------------------------------------
# (b) the bf16 flash plain versions against the interpreted Pallas kernels


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _pt(a):
    """A bf16 JAX array as a bf16 torch tensor (through float32, exact)."""
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize('causal,biased', [(True, False), (False, True),
                                           (True, True)],
                         ids=['causal', 'biased', 'causal-biased'])
def test_bf16_flash_plain_versions_match_pallas_interpret(causal, biased):
    rs = np.random.RandomState(3)
    bh, L, dh, H = 4, 256, 64, 2
    q, k, v, do = (_bf16(rs.randn(bh, L, dh)) for _ in range(4))
    bias = None
    if biased:
        b = np.zeros((bh // H, L), 'float32')
        b[0, 200:] = -1e9
        b[1, 37:] = -1e9
        bias = jnp.asarray(b)
    scale = dh ** -0.5
    kw = dict(bias=bias, n_heads=H)
    o_j, lse_j = jattn._flash_fwd_pallas(q, k, v, scale, causal, True, 128,
                                         128, **kw)
    dq_j, dk_j, dv_j = jattn._flash_bwd_pallas(q, k, v, o_j, lse_j, do,
                                               scale, causal, True, 128,
                                               128, **kw)
    assert o_j.dtype == jnp.bfloat16 and dq_j.dtype == jnp.bfloat16
    tb = None if bias is None else torch.from_numpy(np.asarray(bias))
    qt, kt_, vt, dot = (_pt(a) for a in (q, k, v, do))
    o, lse = attention_ops._flash_fwd(qt, kt_, vt, scale, causal, tb, H)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    dq, dk, dv = attention_ops._flash_bwd(qt, kt_, vt, o, lse, dot, scale,
                                          causal, tb, H)
    assert np.abs(lse.numpy() - np.asarray(lse_j)).max() <= 1e-5
    for got, want in ((o, o_j), (dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 1e-2 * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# (c) mul, matmul and the FFN tail against the JAX lowerings


def _op_data():
    rs = np.random.RandomState(0)
    n, d, f = 16, 128, 256
    return dict(
        x=rs.randn(n, d).astype('float32'),
        w1=(0.05 * rs.randn(d, f)).astype('float32'),
        b1=(0.1 * rs.randn(f)).astype('float32'),
        w2=(0.05 * rs.randn(f, d)).astype('float32'),
        b2=(0.1 * rs.randn(d)).astype('float32'),
        y=rs.randn(2, 3, 24, 20).astype('float32'),
        z=rs.randn(2, 3, 20, 24).astype('float32'),
        mask=(rs.rand(n, d) < 0.8).astype('float32') / np.float32(0.8))


def _jax_op(which, marked, d):
    """Outputs and gradients of one op in a JAX Program (marked by
    `rewrite_program_bf16` or not): the output, then d(sum(out * ct)) by
    each input."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        attr = fluid.ParamAttr
        if which == 'matmul':
            a = layers.data(name='y', shape=[3, 24, 20], dtype='float32')
            b = layers.data(name='z', shape=[3, 20, 24], dtype='float32')
            a.stop_gradient = b.stop_gradient = False
            out = layers.matmul(a, b)
            ins, feed = [a, b], dict(y=d['y'], z=d['z'])
        else:
            x = layers.data(name='x', shape=[128], dtype='float32')
            x.stop_gradient = False
            feed = dict(x=d['x'])
            if which == 'mul':
                out = layers.fc(x, size=256, param_attr=attr(name='w1'),
                                bias_attr=False)
                names = ['w1']
            else:
                out = layers.fused_ffn_tail(
                    x, 256, 128, inner_param_attr=attr(name='w1'),
                    inner_bias_attr=attr(name='b1'),
                    param_attr=attr(name='w2'), bias_attr=attr(name='b2'))
                names = ['w1', 'b1', 'w2', 'b2']
            ins = [x] + [main.global_block().var(nm) for nm in names]
        ct = layers.data(name='ct', shape=list(out.shape[1:]),
                         dtype='float32')
        loss = layers.reduce_sum(layers.elementwise_mul(out, ct))
        if marked:
            assert jmp.rewrite_program_bf16(main) >= 1
        grads = fluid.backward.calc_gradient(loss, ins)
    feed['ct'] = _ct(out.shape, which)
    exe, scope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        for nm in ('w1', 'b1', 'w2', 'b2'):
            if scope.has(nm):
                scope.set(nm, d[nm])
        res = exe.run(main, feed=feed, fetch_list=[out] + grads, scope=scope)
    return [np.asarray(r) for r in res]


def _ct(shape, which):
    rs = np.random.RandomState(7)
    shape = {'matmul': (2, 3, 24, 24), 'mul': (16, 256)}.get(which,
                                                             (16, 128))
    return rs.randn(*shape).astype('float32')


def _port_op(which, policy, d):
    t = lambda a: torch.from_numpy(a.copy()).requires_grad_()
    if which == 'matmul':
        args = [t(d['y']), t(d['z'])]
        out = math_ops.matmul(*args, policy)
    elif which == 'mul':
        args = [t(d['x']), t(d['w1'])]
        out = math_ops.mul(*args, policy)
    else:
        args = [t(d[k]) for k in ('x', 'w1', 'b1', 'w2', 'b2')]
        out = ffn_ops.fused_ffn_amp(*args) if policy else \
            ffn_ops.fused_ffn_core(*args)[0]
    out.backward(torch.from_numpy(_ct(None, which)))
    return [out.detach().numpy()] + [a.grad.numpy() for a in args]


@pytest.fixture(scope='module')
def op_runs(interpret_tier):
    d = _op_data()
    return d, {(w, m): _jax_op(w, m, d) for w in ('mul', 'matmul', 'ffn')
               for m in (True, False)}


@pytest.mark.parametrize('which', ['mul', 'matmul', 'ffn'])
def test_marked_ops_match_the_jax_lowerings(op_runs, which):
    """Values and every gradient within 1e-3 relative RMS of the JAX
    package's AMP lowering (the same roundings; float32 sums in another
    order, so a few elements land a bf16 step away), and the float32
    lowering outside that: AMP moves every output by 2e-3 or more. The
    unmarked port matches the float32 lowering to 1e-6."""
    d, runs = op_runs
    got = _port_op(which, 'bfloat16', d)
    f32 = _port_op(which, None, d)
    want, control = runs[(which, True)], runs[(which, False)]
    assert len(got) == len(want)
    for i, (g, w, c, f) in enumerate(zip(got, want, control, f32)):
        assert g.shape == w.shape and g.dtype == np.float32
        assert _rel(g, w) <= 1e-3, (which, i, _rel(g, w))
        assert _rel(c, w) > 1e-3, (which, i, _rel(c, w))
        assert _rel(f, c) <= 1e-6, (which, i, _rel(f, c))


@pytest.mark.parametrize('which', ['mul', 'matmul'])
def test_one_bf16_pass_on_the_cotangent_misses_the_jax_gradients(
        op_runs, which, monkeypatch):
    """Why the marked backward splits the float32 cotangent into two bf16
    terms: with one bf16 pass on bf16(g) (the low term zero) dX and dW land
    about 2.5e-3 relative RMS from the JAX package's float32-g products,
    outside the 1e-3 the split meets (8e-5 to 1.8e-4)."""
    d, runs = op_runs
    monkeypatch.setattr(math_ops, 'split', lambda g, dt: (
        g.to(dt), torch.zeros(g.shape, dtype=dt)))
    got = _port_op(which, 'bfloat16', d)
    want = runs[(which, True)]
    for g, w in zip(got[1:], want[1:]):
        assert _rel(g, w) > 1e-3, _rel(g, w)


def test_marked_ffn_with_mask_matches_the_jax_tier():
    """With a dropout mask the FFN's output is float32 (the bf16 value
    times the mask) and the cotangent stays float32: the XLA tier of
    `fused_ffn_core` on the op's casts, as `_fused_ffn_tail_op` runs it."""
    from paddle_tpu.ops import ffn_ops as jffn
    import jax
    d = _op_data()

    def jax_fn(x, w1, b1, w2, b2):
        x2, w1c, w2c = (a.astype(jnp.bfloat16) for a in (x, w1, w2))
        y = jffn.fused_ffn_core(x2, w1c, b1, w2c, b2,
                                jnp.asarray(d['mask']), 'xla')
        return y.astype(jnp.float32)

    names = ('x', 'w1', 'b1', 'w2', 'b2')
    y_j, vjp = jax.vjp(jax_fn, *(jnp.asarray(d[k]) for k in names))
    ct = np.random.RandomState(8).randn(16, 128).astype('float32')
    want = [y_j] + list(vjp(jnp.asarray(ct)))
    args = [torch.from_numpy(d[k].copy()).requires_grad_() for k in names]
    y = ffn_ops.fused_ffn_amp(*args, torch.from_numpy(d['mask']))
    y.backward(torch.from_numpy(ct))
    for g, w in zip([y.detach()] + [a.grad for a in args], want):
        assert _rel(g.numpy(), np.asarray(w, 'float32')) <= 1e-3


# ---------------------------------------------------------------------------
# (d) the slice as a whole: three AMP steps against mp.decorate


def _scope_arrays(scope):
    return {n: np.array(scope.get(n)) for n in sorted(scope.names())
            if hasattr(scope.get(n), 'shape')}


def _lm_feeds(lm=LM):
    rng = np.random.RandomState(0)
    V, L = lm['vocab_size'], lm['seq_len']
    return [{'tokens': rng.randint(0, V, (4, L)).astype('int64'),
             'labels': rng.randint(0, V, (4, L)).astype('int64')}
            for _ in range(STEPS)]


def _bert_feeds():
    cfg = BertConfig(**BERT)
    out = []
    for i in range(STEPS):
        f = jbert.make_pretrain_batch(jbert.BertConfig(**BERT), 4,
                                      np.random.RandomState(20 + i))
        for row, k in enumerate((7, 0, 13, 2)):
            if k:
                f['input_mask'][row, -k:] = 0.0
        out.append(f)
    assert cfg.seq_len == 32
    return out


def _jax_run(model, marked, lm=LM):
    """(startup scope, scope after the first step, losses, final scope) of
    the JAX package's training program (the LM's configuration ``lm``),
    ``mp.decorate``d when ``marked``, attending through its flash kernels
    in interpret mode."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if model == 'lm':
            loss = build_lm(JLMConfig(**lm))[3]
            fetch, feeds = [loss], _lm_feeds(lm)
        else:
            fetch = list(jbert.build_bert_pretrain(jbert.BertConfig(**BERT)))
            loss, feeds = fetch[0], _bert_feeds()
        opt = fluid.optimizer.Adam(1e-3, fuse=True)
        (jmp.decorate(opt) if marked else opt).minimize(loss)
    exe, scope = fluid.Executor(), fluid.Scope()
    resolve = jattn._resolve_impl
    jattn._resolve_impl = lambda use_pallas: 'interpret'
    try:
        losses = []
        with fluid.scope_guard(scope):
            exe.run(startup, scope=scope)
            init = _scope_arrays(scope)
            for f in feeds:
                out = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                losses.append([float(np.asarray(o).reshape(())) for o in out])
                if len(losses) == 1:
                    first = _scope_arrays(scope)
            final = _scope_arrays(scope)
    finally:
        jattn._resolve_impl = resolve
    return init, first, losses, final


@pytest.fixture(scope='module')
def runs(interpret_tier):
    return {(m, marked): _jax_run(m, marked) for m in ('lm', 'bert')
            for marked in (True, False)}


def _port_run(model, init):
    """(model, moment 1 after the first step, losses, final optimizer
    state) of the port's AMP run from the JAX startup scope ``init``."""
    if model == 'lm':
        cfg = LMConfig(**LM)
        params, state, lr = train_state_from_numpy(init, 'cpu', config=cfg)
        m = TransformerLM(cfg, params, cfg.seq_len)
        feeds = _lm_feeds()

        def loss(f):
            out = m.loss(torch.from_numpy(f['tokens']),
                         torch.from_numpy(f['labels']))
            return out, [out]
    else:
        cfg = BertConfig(**BERT)
        params, state, lr = train_state_from_numpy(init, 'cpu', config=cfg)
        m = BertPretrain(cfg, params)
        feeds = _bert_feeds()

        def loss(f):
            out = m.loss(**{k: torch.from_numpy(v) for k, v in f.items()})
            return out[0], out
    mp.rewrite_model_bf16(m)
    opt = mp.decorate(TensorAdam(m.p, 1e-3, fuse=True))
    opt.load_state(state, lr)
    losses, first = [], None
    for f in feeds:
        total, outs = loss(f)
        opt.minimize(total)
        losses.append([float(o.detach()) for o in outs])
        if first is None:
            first = {n: s['moment1'].numpy().copy()
                     for n, s in opt.state().items()}
    return m, first, losses, opt.state()


def _marked_weights(m):
    """The weights of the marked fc sites (under AMP their gradients are
    bf16 values)."""
    return [n for n in m.p if n.endswith('.w') and m.p[n].dim() == 2 and
            not n.endswith('_emb.w')]


@pytest.mark.parametrize('model', ['lm', 'bert'])
def test_three_step_amp_trajectory_matches_jax_decorate(runs, model):
    """The port's AMP run against the JAX package's ``mp.decorate`` run, and
    the JAX float32 run as the control, which falls outside
    (:func:`check_amp_trajectory`)."""
    init = runs[(model, True)][0]
    m, first, losses, state = _port_run(model, init)
    check_amp_trajectory(
        runs, model, list(m.p), _marked_weights(m), first, losses,
        {n: p.detach().numpy() for n, p in m.p.items()},
        {n: s['moment1'].numpy() for n, s in state.items()})


def check_amp_trajectory(runs, model, names, marked, first, losses, params,
                         last_m1, param_tol=8e-4):
    """Hold a port AMP run (parameter ``names``, the ``marked`` fc weights,
    moment 1 after the first step ``first``, the ``losses`` of each step,
    the final ``params`` and moment 1 ``last_m1``, {name: array}) to the
    JAX package's ``mp.decorate`` run in ``runs``, with the JAX float32
    run as the control, which falls outside.

    First step (moment 1 is 0.1 x the gradient): the marked fc weights'
    gradients are bf16 values in both AMP runs, and in every such tensor at
    least 20% of them are bitwise equal to the JAX run's (the rest sit near
    a rounding boundary and land a bf16 step away), against none of the
    float32 run's; over the whole model the gradients lie within 3.5e-3
    relative RMS, the float32 run's outside.
    Three steps: the losses within 3e-3 absolute (measured 2.3e-3 for
    BERT's total at the second step, most of it its NSP loss over four
    sequences), the parameters within ``param_tol`` (8e-4) relative
    RMS over the whole model, the float32 run's outside (Adam's first steps
    move a parameter by about lr whatever the gradient's size, so a
    gradient near 0 whose sign differs moves it 2 lr away), and moment 1
    within 1e-2.
    Measured on the CPU (LM / BERT): bitwise-equal shares 0.41-0.95 /
    0.34-0.85 against 0; first-step gradients 1.9e-3 / 2.8e-3 against
    float32's 4.7e-3 / 5.9e-3; parameters 5.7e-4 / 5.2e-4 against 1.3e-3 /
    1.0e-3; moment 1 3.4e-3 / 7.6e-3."""
    init, first_want, want_losses, final = runs[(model, True)]
    init_f32, first_f32, _, final_f32 = runs[(model, False)]
    # decorate adds no scope variable: train_state_from_numpy carries the
    # AMP run's startup scope as it carries a float32 one
    assert sorted(init) == sorted(init_f32)
    assert marked

    def m1(scope):
        return np.concatenate([scope[n + '_moment1_0'].ravel()
                               for n in names])

    def equal_share(scope):
        return min(np.mean(first[n] == scope[n + '_moment1_0'])
                   for n in marked)

    got = np.concatenate([first[n].ravel() for n in names])
    assert equal_share(first_want) >= 0.2, equal_share(first_want)
    assert equal_share(first_f32) <= 0.01, equal_share(first_f32)
    assert _rel(got, m1(first_want)) <= 3.5e-3, _rel(got, m1(first_want))
    assert _rel(got, m1(first_f32)) > 3.5e-3, _rel(got, m1(first_f32))

    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=3e-3)
    flat = np.concatenate([params[n].ravel() for n in names])

    def param_err(scope):
        return _rel(flat, np.concatenate([scope[n].ravel() for n in names]))

    assert param_err(final) <= param_tol, param_err(final)
    assert param_err(final_f32) > param_tol, param_err(final_f32)
    last = np.concatenate([last_m1[n].ravel() for n in names])
    assert _rel(last, m1(final)) <= 1e-2, _rel(last, m1(final))


# ---------------------------------------------------------------------------
# (e) CPU tensors take the plain versions


def test_amp_on_cpu_counts_no_launch():
    cfg = LMConfig(**dict(LM, n_layer=1))
    m = TransformerLM(cfg, init_params(cfg, 0, 'cpu'), 32)
    mp.rewrite_model_bf16(m)
    tok = torch.randint(0, 512, (2, 32), generator=torch.Generator()
                        .manual_seed(1))
    kernel_tier.reset_counts()
    loss = m.loss(tok, tok)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(n == 0 for n in kernel_tier.launch_counts().values())
    q = torch.randn(2, 8, 16, dtype=torch.bfloat16)
    o, lse = attention_ops._flash_fwd(q, q, q, 0.25, True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert all(n == 0 for n in kernel_tier.launch_counts().values())
