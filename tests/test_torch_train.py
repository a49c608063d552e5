"""The training slice of paddle_tpu_torch against the JAX package, on the CPU.

Per module that holds a kernel on the training path, the port's plain
PyTorch version (what a CPU tensor runs) and its autograd backward are held
against the JAX function with its ``jax.vjp``, the Pallas kernels run
through the interpreter (``'interpret'``) as tests/test_fused_tier.py runs
them. Then the slice as a whole: `build_lm` + ``Adam(fuse=True)`` for three
steps in both packages from the same startup scope and the same feeds.

Inputs come from numpy seeds. Tolerances: f32 rtol 1e-5 / atol 1e-5 on the
CE loss and lse (one exp-sum per row, summed in another order), rtol 1e-4
/ atol 1e-6 on its gradient (exp(x - lse) times ct: lse's rounding, at
|lse| ~ 10, becomes a relative error of ~1e-4); rtol 1e-4 / atol 1e-5 on the
LayerNorm and FFN gradients (row means and dot products of length 128 to
256 in another order); rtol 1e-6 on Adam (the same elementwise IEEE
operations); bitwise for the embedding gradient (two-term sums, which
commute). The three-step trajectory: losses at rtol 1e-5, parameters and
moments at rtol 1e-4 / atol 1e-5, the tolerances tests/test_fused_tier.py
measured for its own trajectory parity.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as fluid
from paddle_tpu import goodput, monitor
from paddle_tpu.models.transformer import LMConfig as JLMConfig
from paddle_tpu.models.transformer import build_lm
from paddle_tpu.ops import ce_ops as jce
from paddle_tpu.ops import embedding_ops as jemb
from paddle_tpu.ops import ffn_ops as jffn
from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu.ops import optimizer_ops as jopt

from paddle_tpu_torch.io import params_from_numpy, train_state_from_numpy
from paddle_tpu_torch.models.transformer import (LMConfig, TransformerLM,
                                                 init_params)
from paddle_tpu_torch.ops import (ce_ops, embedding_ops, ffn_ops,
                                  kernel_tier, nn_ops, optimizer_ops,
                                  random_ops)
from paddle_tpu_torch.optimizer import TensorAdam


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels;
    restart the window after this module so later test files in the same
    worker see a cold one."""
    yield
    goodput.reset()
    # the monitor keeps at most 64 series a metric: leave it empty
    monitor.reset()


# ---------------------------------------------------------------------------
# kernel modules vs the interpret-mode Pallas kernels, forward and backward


def _ce_data():
    rs = np.random.RandomState(0)
    n, V = 256, 512
    x = (3 * rs.randn(n, V)).astype('float32')
    lab = rs.randint(0, V, n).astype('int64')
    lab[[5, 17]] = -100                 # ignored rows
    lab[9] = 700                        # out of range, not ignored
    ct = rs.rand(n).astype('float32')
    return x, lab, ct


def test_fused_ce_matches_pallas_interpret():
    x, lab, ct = _ce_data()
    loss_j, vjp = jax.vjp(
        lambda z: jce.fused_softmax_ce(z, jnp.asarray(lab), -100,
                                       'interpret'), jnp.asarray(x))
    dx_j, = vjp(jnp.asarray(ct))
    _, lse_j = jce._fused_ce_fwd_pallas(jnp.asarray(x),
                                        jnp.asarray(lab, jnp.int32), -100,
                                        True)
    logits = _t(x, grad=True)
    loss = ce_ops.fused_softmax_ce(logits, _t(lab))
    loss.backward(_t(ct))
    _, lse = ce_ops._ce_fwd(_t(x), _t(lab), -100)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(loss_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-5)
    # exp(x - lse) carries lse's rounding (|lse| ~ 10 at rtol 1e-5) as a
    # relative error of ~1e-4
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(dx_j),
                               rtol=1e-4, atol=1e-6)
    # ignored rows: loss 0 and a gradient of exactly 0; the out-of-range
    # label picks nothing: loss = lse, no one-hot term
    loss = loss.detach()
    assert loss[5] == 0 and loss[17] == 0
    assert not logits.grad[[5, 17]].any()
    assert abs(float(loss[9]) - float(lse[9])) <= 1e-6
    p9 = torch.softmax(_t(x[9]), 0) * float(ct[9])
    np.testing.assert_allclose(logits.grad[9].numpy(), p9.numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('n', [8, 32])
def test_fused_ln_residual_backward_matches_pallas_interpret(n):
    rs = np.random.RandomState(n)
    D = 128
    x, r = rs.randn(n, D).astype('float32'), rs.randn(n, D).astype('float32')
    sc = (1 + 0.1 * rs.randn(D)).astype('float32')
    b = (0.1 * rs.randn(D)).astype('float32')
    dy, ds = rs.randn(n, D).astype('float32'), rs.randn(n, D).astype('float32')
    (y_j, s_j), vjp = jax.vjp(
        lambda *a: jnn.fused_ln_residual(*a, 1e-5, 'interpret'),
        *map(jnp.asarray, (x, r, sc, b)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    args = [_t(a, grad=True) for a in (x, r, sc, b)]
    y, s, _, _ = nn_ops.fused_ln_residual(*args, eps=1e-5)
    torch.autograd.backward([y, s], [_t(dy), _t(ds)])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-4, atol=1e-5)
    for got, w in zip(args, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)
    # the kernel's own plain version gives the same dx
    _, s2, m2, rs2 = nn_ops._ln_res_ref(_t(x), _t(r), _t(sc), _t(b), 1e-5)
    dx = nn_ops._ln_res_bwd(s2, m2, rs2, _t(sc), _t(dy), _t(ds))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize('with_mask', [False, True])
def test_fused_ffn_backward_matches_pallas_interpret(with_mask):
    rs = np.random.RandomState(5)
    n, d, f = 16, 128, 256
    x = rs.randn(n, d).astype('float32')
    w1 = (0.05 * rs.randn(d, f)).astype('float32')
    b1 = (0.05 * rs.randn(f)).astype('float32')
    w2 = (0.05 * rs.randn(f, d)).astype('float32')
    b2 = (0.05 * rs.randn(d)).astype('float32')
    mask = ((rs.rand(n, d) > 0.3) / 0.7).astype('float32') \
        if with_mask else None
    dy = rs.randn(n, d).astype('float32')
    jm = None if mask is None else jnp.asarray(mask)
    y_j, vjp = jax.vjp(
        lambda *a: jffn.fused_ffn_core(*a, jm, 'interpret'),
        *map(jnp.asarray, (x, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(dy))
    args = [_t(a, grad=True) for a in (x, w1, b1, w2, b2)]
    y, pre1 = ffn_ops.fused_ffn_core(*args, None if mask is None
                                     else _t(mask), want_pre1=True)
    y.backward(_t(dy))
    assert pre1 is not None and not pre1.requires_grad
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-4, atol=1e-4)
    for got, w in zip(args, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('with_bias', [False, True])
def test_embedding_backward_matches_jax_scatter(with_bias):
    """Repeated ids add up; out-of-range ids read a clamped row forward but
    follow the JAX scatter backward: -2 wraps to row V-2, while 45 and
    -50 add nothing anywhere."""
    rs = np.random.RandomState(1)
    V, D = 40, 128
    w = rs.randn(V, D).astype('float32')
    ids = np.array([3, 17, 0, 39, 17, -2, 45, -50, 8], 'int64')
    bias = rs.randn(D).astype('float32') if with_bias else None
    ct = rs.randn(len(ids), D).astype('float32')
    jargs = [jnp.asarray(w)] + ([jnp.asarray(bias)] if with_bias else [])
    out_j, vjp = jax.vjp(
        lambda w_, *b_: jemb.embedding_gather(
            w_, jnp.asarray(ids), b_[0] if b_ else None, impl='interpret'),
        *jargs)
    want = vjp(jnp.asarray(ct))
    tw = _t(w, grad=True)
    tb = _t(bias, grad=True) if with_bias else None
    out = embedding_ops.embedding_gather(tw, _t(ids), tb)
    out.backward(_t(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(want[0]))
    if with_bias:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[1]),
                                   rtol=1e-6, atol=1e-6)
    dw = tw.grad.numpy()
    np.testing.assert_array_equal(dw[17], ct[1] + ct[4])
    np.testing.assert_array_equal(dw[V - 2], ct[5])
    np.testing.assert_array_equal(dw[0], ct[2])     # 45 and -50: dropped


def test_embedding_backward_of_a_tall_table_matches_jax_scatter():
    """A table of more than 64 rows takes the sorted scatter-add
    (``index_put_``) where a short one takes the one-hot product: the same
    JAX scatter, repeated, wrapped and dropped ids included, and the two
    forms give the same table gradient."""
    rs = np.random.RandomState(2)
    V, D = 100, 64
    assert V > embedding_ops._ONE_HOT_ROWS
    w = rs.randn(V, D).astype('float32')
    ids = np.array([3, 77, 0, 99, 77, -2, 145, -150, 8, 77], 'int64')
    ct = rs.randn(len(ids), D).astype('float32')
    out_j, vjp = jax.vjp(lambda w_: jemb.embedding_gather(
        w_, jnp.asarray(ids), None, impl='interpret'), jnp.asarray(w))
    want, = vjp(jnp.asarray(ct))
    tw = _t(w, grad=True)
    embedding_ops.embedding_gather(tw, _t(ids)).backward(_t(ct))
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tw.grad.numpy()[V - 2], ct[5])
    rows = torch.arange(V)[:, None] == torch.where(
        _t(ids) < 0, _t(ids) + V, _t(ids))[None, :]
    one_hot = rows.float() @ _t(ct)
    np.testing.assert_allclose(tw.grad.numpy(), one_hot.numpy(), rtol=1e-6,
                               atol=1e-6)


def _adam_case(seed=3):
    rs = np.random.RandomState(seed)
    shapes = [(7, 5), (128,), (3, 4, 2), (1,)]
    p = [rs.randn(*s).astype('float32') for s in shapes]
    g = [rs.randn(*s).astype('float32') for s in shapes]
    m1 = [(0.1 * rs.randn(*s)).astype('float32') for s in shapes]
    m2 = [(0.01 * rs.rand(*s)).astype('float32') for s in shapes]
    return p, g, m1, m2


def test_fused_adam_matches_pallas_interpret_and_adam_dense():
    p, g, m1, m2 = _adam_case()
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr = np.array([1e-3], 'float32')
    b1p = np.array([0.9 ** 3], 'float32')
    b2p = np.array([0.999 ** 3], 'float32')
    cat = lambda xs: jnp.concatenate([jnp.asarray(a).reshape(-1) for a in xs])
    lr_t = jnp.asarray(lr).reshape(()) * jnp.sqrt(1 - jnp.asarray(b2p)[0]) \
        / (1 - jnp.asarray(b1p)[0])
    kern = jopt._fused_adam_flat(cat(p), cat(g), cat(m1), cat(m2), lr_t, b1,
                                 b2, eps, True)
    dense = jopt._adam_dense(cat(p), cat(g), cat(m1), cat(m2), lr_t, b1, b2,
                             eps)
    tp, tg, tm1, tm2 = ([_t(a) for a in xs] for xs in (p, g, m1, m2))
    b1ps = [_t(b1p) for _ in p]
    b2ps = [_t(b2p) for _ in p]
    optimizer_ops.fused_adam(tp, tg, tm1, tm2, b1ps, b2ps, _t(lr), b1, b2,
                             eps)
    got = [np.concatenate([t.numpy().reshape(-1) for t in ts])
           for ts in (tp, tm1, tm2)]
    for want in (kern, dense):
        for a, w in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(w), rtol=1e-6,
                                       atol=1e-9)
    for t in b1ps:
        np.testing.assert_array_equal(t.numpy(), np.float32(b1p * b1))
    for t in b2ps:
        np.testing.assert_array_equal(t.numpy(), np.float32(b2p * b2))
    # the per-parameter update gives the same result (lr_t from its own,
    # equal, beta powers)
    q = [_t(a) for a in p]
    qm1, qm2 = [_t(a) for a in m1], [_t(a) for a in m2]
    for i in range(len(p)):
        optimizer_ops.adam(q[i], tg[i], qm1[i], qm2[i], _t(b1p), _t(b2p),
                           _t(lr), b1, b2, eps)
        np.testing.assert_array_equal(q[i].numpy(), tp[i].numpy())
        np.testing.assert_array_equal(qm2[i].numpy(), tm2[i].numpy())


def test_adam_fuse_and_per_parameter_take_one_trajectory():
    cfg = LMConfig(vocab_size=64, seq_len=8, d_model=32, n_head=2,
                   n_layer=1, d_ff=64, dropout=0.0)
    rs = np.random.RandomState(4)
    tok = _t(rs.randint(0, 64, (2, 8)))
    lab = _t(rs.randint(0, 64, (2, 8)))
    runs = []
    for fuse in (True, False):
        m = TransformerLM(cfg, init_params(cfg, 0, 'cpu'), 8)
        opt = TensorAdam(m.p, 1e-2, fuse=fuse)
        losses = [float(opt.minimize(m.loss(tok, lab))) for _ in range(3)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in m.p.items()}))
        assert all(p.grad is None for p in m.p.values())
    assert runs[0][0] == runs[1][0] and runs[0][0][-1] < runs[0][0][0]
    for n in runs[0][1]:
        assert torch.equal(runs[0][1][n], runs[1][1][n]), n


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    before = kernel_tier.launch_counts()
    cfg = LMConfig(vocab_size=64, seq_len=8, d_model=32, n_head=2,
                   n_layer=1, d_ff=64, attn_dropout=0.1)
    m = TransformerLM(cfg, init_params(cfg, 0, 'cpu'), 8)
    opt = TensorAdam(m.p, 1e-3, fuse=True)
    opt.minimize(m.loss(torch.zeros(2, 8, dtype=torch.long),
                        torch.ones(2, 8, dtype=torch.long),
                        torch.Generator().manual_seed(0)))
    assert kernel_tier.launch_counts() == before


# ---------------------------------------------------------------------------
# dropout


def test_dropout_replays_and_keeps_rate_and_scale():
    x = torch.ones(200, 500)
    p = 0.3
    a = random_ops.dropout(x, p, torch.Generator().manual_seed(11))
    b = random_ops.dropout(x, p, torch.Generator().manual_seed(11))
    assert torch.equal(a, b)
    assert not torch.equal(a, random_ops.dropout(
        x, p, torch.Generator().manual_seed(12)))
    kept = a != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.01
    assert torch.all(a[kept] == np.float32(1.0) / np.float32(1 - p))
    m = random_ops.keep_mask((200, 500), p, torch.Generator().manual_seed(11),
                             'cpu')
    assert torch.equal(m, a)         # the same draw, pre-scaled
    assert random_ops.dropout(x, 0.0) is x
    assert not random_ops.dropout(x, 1.0, torch.Generator()).any()
    with pytest.raises(ValueError, match='explicit torch.Generator'):
        random_ops.dropout(x, p)


# ---------------------------------------------------------------------------
# the slice as a whole: build_lm + Adam(fuse=True), 3 steps, vs the JAX
# package at the interpret tier


LM = dict(vocab_size=512, seq_len=32, d_model=128, n_head=4, n_layer=2,
          d_ff=256, dropout=0.0, attn_dropout=0.0,
          use_flash_attention=False)
STEPS = 3


def _feeds():
    rng = np.random.RandomState(0)
    return [{'tokens': rng.randint(0, 512, (4, 32)).astype('int64'),
             'labels': rng.randint(0, 512, (4, 32)).astype('int64')}
            for _ in range(STEPS)]


def _scope_arrays(scope):
    return {n: np.array(scope.get(n)) for n in sorted(scope.names())
            if hasattr(scope.get(n), 'shape')}


def _jax_train_run(lm_kw):
    """(startup scope, losses, final scope) of the JAX package's training
    program for LMConfig(**lm_kw) at the interpret tier."""
    old = os.environ.get('PADDLE_FUSED_TIER')
    os.environ['PADDLE_FUSED_TIER'] = 'interpret'
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 5
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, _, _, avg_loss = build_lm(JLMConfig(**lm_kw))
            fluid.optimizer.Adam(1e-3, fuse=True).minimize(avg_loss)
        exe = fluid.Executor()
        scope = fluid.Scope()
        losses = []
        with fluid.scope_guard(scope):
            exe.run(startup, scope=scope)
            init = _scope_arrays(scope)
            for f in _feeds():
                l, = exe.run(main, feed=f, fetch_list=[avg_loss],
                             scope=scope)
                losses.append(float(np.asarray(l).reshape(())))
            final = _scope_arrays(scope)
        return init, losses, final
    finally:
        if old is None:
            os.environ.pop('PADDLE_FUSED_TIER', None)
        else:
            os.environ['PADDLE_FUSED_TIER'] = old


@pytest.fixture(scope='module')
def jax_run():
    return _jax_train_run(LM)


# the bench's flagship configuration in small: attention dropout 0 and flash
# attention on, so that both packages attend through flash attention (the
# JAX package through its plain reference on the CPU)
LM_FLASH = dict(LM, use_flash_attention=True)


@pytest.fixture(scope='module')
def jax_run_flash():
    return _jax_train_run(LM_FLASH)


def _check_trajectory(run, lm_kw):
    init, want_losses, final = run
    cfg = LMConfig(**lm_kw)
    params, state, lr = train_state_from_numpy(init, 'cpu', config=cfg)
    model = TransformerLM(cfg, params, cfg.seq_len)
    assert model.flash_in_training() is lm_kw['use_flash_attention']
    opt = TensorAdam(model.p, 1e-3, fuse=True)
    opt.load_state(state, lr)
    losses = []
    for f in _feeds():
        loss = model.loss(_t(f['tokens']), _t(f['labels']))
        losses.append(float(opt.minimize(loss)))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = opt.state()
    d = cfg.d_model
    for name, p in model.p.items():
        have, want = p.detach().numpy(), final[name]
        if name.endswith('.attn.qkv.b'):
            # softmax is invariant to a shift of every key's score, so the
            # K bias has a true gradient of 0: what reaches it is rounding
            # noise, which Adam normalises to steps of +-lr. Only the Q
            # and V parts of this bias carry a signal to compare.
            assert np.abs(have[d:2 * d] - want[d:2 * d]).max() <= STEPS * 1e-3
            have = np.delete(have, np.s_[d:2 * d])
            want = np.delete(want, np.s_[d:2 * d])
        np.testing.assert_allclose(have, want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        for key, acc in (('moment1', 'moment1'), ('moment2', 'moment2'),
                         ('beta1_pow', 'beta1_pow_acc'),
                         ('beta2_pow', 'beta2_pow_acc')):
            np.testing.assert_allclose(
                got[name][key].numpy(), final['%s_%s_0' % (name, acc)],
                rtol=1e-4, atol=1e-5, err_msg='%s %s' % (name, key))


def test_three_step_trajectory_matches_jax_build_lm(jax_run):
    _check_trajectory(jax_run, LM)


def test_three_step_trajectory_with_flash_matches_jax_build_lm(jax_run_flash):
    _check_trajectory(jax_run_flash, LM_FLASH)


def test_train_state_carry_checks_names(jax_run):
    init = jax_run[0]
    cfg = LMConfig(**LM)
    params, state, lr = train_state_from_numpy(init, 'cpu', config=cfg)
    assert list(params) == list(state)
    assert float(lr[0]) == np.float32(1e-3)
    assert state['tok_emb.w']['moment1'].shape == (512, 128)
    assert float(state['lm_head.w']['beta2_pow'][0]) == np.float32(0.999)
    # the plain parameter map stays strict about a training scope
    with pytest.raises(ValueError, match='unexpected'):
        params_from_numpy(init, config=cfg)
    bad = dict(init)
    del bad['final_ln.w_moment2_0']
    with pytest.raises(ValueError, match="'final_ln.w' lacks .*moment2"):
        train_state_from_numpy(bad, 'cpu', config=cfg)
    bad = dict(init, stray=np.zeros(3, 'float32'))
    with pytest.raises(ValueError, match='stray'):
        train_state_from_numpy(bad, 'cpu', config=cfg)
    bad = {k: v for k, v in init.items() if not k.startswith('learning')}
    with pytest.raises(ValueError, match='learning_rate'):
        train_state_from_numpy(bad, 'cpu', config=cfg)
    # like every entry point, the loaders default to the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_state_from_numpy(init, config=cfg)


def test_flash_training_on_cpu_runs_the_plain_flash_under_autograd():
    """With attention dropout 0 and flash on, the CPU trains through the
    plain flash version: the same loss and gradients as the unfused
    branch (both causal softmax attention)."""
    rs = np.random.RandomState(9)
    tok, lab = _t(rs.randint(0, 64, (2, 16))), _t(rs.randint(0, 64, (2, 16)))
    grads = []
    for flash in (True, False):
        cfg = LMConfig(vocab_size=64, seq_len=16, d_model=32, n_head=2,
                       n_layer=2, d_ff=64, dropout=0.0,
                       use_flash_attention=flash)
        m = TransformerLM(cfg, init_params(cfg, 1, 'cpu'), 16)
        assert m.flash_in_training() is flash
        loss = m.loss(tok, lab)
        loss.backward()
        grads.append((float(loss), m.p['layer_1.attn.qkv.w'].grad))
    assert abs(grads[0][0] - grads[1][0]) <= 1e-5
    np.testing.assert_allclose(grads[0][1].numpy(), grads[1][1].numpy(),
                               rtol=1e-4, atol=1e-6)


def test_decode_stays_without_autograd():
    cfg = LMConfig(vocab_size=64, seq_len=16, d_model=32, n_head=2,
                   n_layer=1, d_ff=64, dropout=0.0)
    m = TransformerLM(cfg, init_params(cfg, 0, 'cpu'), 16)
    assert all(p.requires_grad for p in m.p.values())
    m.allocate_cache(2)
    tok, logits = m.prefill(torch.zeros(1, 8, dtype=torch.long), 0, 5)
    assert not logits.requires_grad and logits.grad_fn is None
