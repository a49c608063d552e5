"""paddle_tpu_torch's BERT against the JAX package, on the CPU.

`build_bert_pretrain` at the small sizes of tests/test_bert.py and
tests/test_attention.py, its startup scope carried across with
`params_from_numpy` / `train_state_from_numpy`, the same numpy-seeded batch
(with a padded ``input_mask``) fed to both packages. The JAX side runs at
the fused tier ``'interpret'`` (Pallas kernels through the interpreter where
their tiling rules take the shape, plain math elsewhere), with its flash
attention on the plain reference, as tests/test_attention.py runs BERT on
the CPU.

Tolerances: the three losses at rtol 1e-5 (f32, one or two layers, sums in
another order); flash against unfused inside the port at rtol 1e-5 (the
JAX package's own contract for that pair is rtol 1e-4); the 3-step
trajectory's losses at rtol 1e-5, parameters and moments at rtol 1e-4 /
atol 1e-5, as tests/test_torch_train.py holds the LM's.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import goodput, monitor
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch.io import params_from_numpy, train_state_from_numpy
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models.bert import BertConfig, BertPretrain
from paddle_tpu_torch.ops import kernel_tier
from paddle_tpu_torch.optimizer import TensorAdam

SMALL = dict(vocab_size=64, seq_len=16, d_model=16, n_head=2, n_layer=1,
             d_ff=32, dropout=0.0, max_predictions=2)
TRAIN = dict(vocab_size=128, seq_len=32, d_model=32, n_head=4, n_layer=2,
             d_ff=64, dropout=0.0, attn_dropout=0.0, max_predictions=4)
STEPS = 3


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels;
    restart the window after this module so later test files in the same
    worker see a cold one."""
    yield
    goodput.reset()
    # the monitor keeps at most 64 series a metric: leave it empty
    monitor.reset()


@pytest.fixture(scope='module', autouse=True)
def _interpret_tier():
    old = os.environ.get('PADDLE_FUSED_TIER')
    os.environ['PADDLE_FUSED_TIER'] = 'interpret'
    yield
    if old is None:
        os.environ.pop('PADDLE_FUSED_TIER', None)
    else:
        os.environ['PADDLE_FUSED_TIER'] = old


def _batch(cfg, n, seed, pad):
    """A pretraining batch whose sequences end in ``pad[i]`` padded
    positions (input_mask 0 there)."""
    feed = bert.make_pretrain_batch(cfg, n, np.random.RandomState(seed))
    for i, k in enumerate(pad):
        if k:
            feed['input_mask'][i, -k:] = 0.0
    return feed


def _tensors(feed):
    return {k: torch.from_numpy(v) for k, v in feed.items()}


def _scope_arrays(scope):
    return {n: np.array(scope.get(n)) for n in sorted(scope.names())
            if hasattr(scope.get(n), 'shape')}


def _jax_program(cfg_kw, is_test, seed, lr=None):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        losses = jbert.build_bert_pretrain(jbert.BertConfig(**cfg_kw),
                                           is_test=is_test)
        if lr is not None:
            fluid.optimizer.Adam(lr, fuse=True).minimize(losses[0])
    return main, startup, list(losses)


def test_make_pretrain_batch_is_the_jax_package_s():
    cfg = BertConfig(**SMALL)
    got = bert.make_pretrain_batch(cfg, 4, np.random.RandomState(3))
    want = jbert.make_pretrain_batch(jbert.BertConfig(**SMALL), 4,
                                     np.random.RandomState(3))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    toks = np.arange(64).reshape(4, 16)
    got = bert.make_pretrain_batch(cfg, 4, np.random.RandomState(3), toks)
    assert ((got['tokens'] == toks) | (got['tokens'] == 3)).all()
    with pytest.raises(ValueError, match='toks must have shape'):
        bert.make_pretrain_batch(cfg, 4, np.random.RandomState(3), toks[:2])


@pytest.mark.parametrize('flash', [True, False], ids=['flash', 'unfused'])
def test_is_test_losses_match_jax_build_bert_pretrain(flash):
    kw = dict(SMALL, use_flash_attention=flash)
    main, startup, losses = _jax_program(kw, True, 17)
    cfg = BertConfig(**kw)
    feed = _batch(cfg, 4, 3, pad=[5, 0, 9, 1])
    exe, scope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        arrays = _scope_arrays(scope)
        want = [float(np.asarray(o).reshape(())) for o in exe.run(
            main, feed=feed, fetch_list=losses, scope=scope)]
    model = BertPretrain(cfg, params_from_numpy(arrays, 'cpu'))
    assert model.flash_ok(True) is flash
    before = kernel_tier.launch_counts()
    with torch.no_grad():
        got = model.loss(is_test=True, **_tensors(feed))
    assert kernel_tier.launch_counts() == before
    np.testing.assert_allclose([float(g) for g in got], want, rtol=1e-5)
    assert abs(float(got[0]) - float(got[1]) - float(got[2])) <= 1e-6


def test_flash_and_unfused_agree_and_pads_are_blocked():
    """The fused key-padding bias and the [B, 1, 1, L] additive mask give
    one loss, and garbage tokens under the padding change nothing that an
    unpadded MLM position sees."""
    feeds, out = None, {}
    for flash in (True, False):
        cfg = BertConfig(**dict(TRAIN, use_flash_attention=flash))
        if feeds is None:
            feed = _batch(cfg, 4, 5, pad=[6, 0, 11, 3])
            # MLM positions only where no sequence is padded
            feed['mlm_positions'] = (np.arange(4)[:, None] * cfg.seq_len
                                     + np.arange(4)[None, :]).astype('int64')
            noisy = dict(feed, tokens=feed['tokens'].copy())
            noisy['tokens'][feed['input_mask'] == 0] = 63
            feeds = (feed, noisy)
        model = BertPretrain(cfg, bert.init_params(cfg, 2, 'cpu'))
        with torch.no_grad():
            out[flash] = [[float(v) for v in model.loss(
                is_test=True, **_tensors(f))] for f in feeds]
    np.testing.assert_allclose(out[True], out[False], rtol=1e-5)
    for flash in (True, False):
        np.testing.assert_allclose(out[flash][0], out[flash][1], rtol=1e-5)


def test_training_rule_picks_flash_only_without_attention_dropout():
    cfg = BertConfig(**SMALL)
    assert cfg.use_flash_attention and cfg.attn_dropout == 0.0
    m = BertPretrain(cfg, bert.init_params(cfg, 0, 'cpu'))
    assert m.flash_ok(False) and m.flash_ok(True)
    cfg = BertConfig(**dict(SMALL, dropout=0.1))
    assert cfg.attn_dropout == 0.1            # follows dropout, as the LM's
    m = BertPretrain(cfg, bert.init_params(cfg, 0, 'cpu'))
    assert not m.flash_ok(False) and m.flash_ok(True)
    feed = _tensors(_batch(cfg, 2, 1, pad=[3, 0]))
    with pytest.raises(ValueError, match='explicit torch.Generator'):
        m.loss(**feed)
    a = m.loss(generator=torch.Generator().manual_seed(4), **feed)
    b = m.loss(generator=torch.Generator().manual_seed(4), **feed)
    c = m.loss(generator=torch.Generator().manual_seed(5), **feed)
    assert float(a[0].detach()) == float(b[0].detach()) != \
        float(c[0].detach())
    d = BertConfig()
    assert (d.vocab_size, d.seq_len, d.d_model, d.n_head, d.n_layer, d.d_ff,
            d.dropout, d.type_vocab_size, d.max_predictions) == \
        (30522, 128, 768, 12, 12, 3072, 0.1, 2, 20)
    assert len(bert.param_shapes(d)) == 160


@pytest.fixture(scope='module')
def jax_run():
    """(startup scope, feeds, losses, final scope) of the JAX package's BERT
    training program: dropout 0, attention dropout 0 (so that it attends
    through flash attention with the padding bias), Adam(fuse=True)."""
    main, startup, losses = _jax_program(TRAIN, False, 9, lr=1e-3)
    cfg = BertConfig(**TRAIN)
    feeds = [_batch(cfg, 4, 20 + i, pad=[7, 0, 13, 2]) for i in range(STEPS)]
    exe, scope = fluid.Executor(), fluid.Scope()
    got = []
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        init = _scope_arrays(scope)
        for f in feeds:
            out = exe.run(main, feed=f, fetch_list=losses, scope=scope)
            got.append([float(np.asarray(o).reshape(())) for o in out])
        final = _scope_arrays(scope)
    return init, feeds, got, final


def test_three_step_trajectory_matches_jax_build_bert_pretrain(jax_run):
    init, feeds, want_losses, final = jax_run
    cfg = BertConfig(**TRAIN)
    params, state, lr = train_state_from_numpy(init, 'cpu', config=cfg)
    model = BertPretrain(cfg, params)
    assert model.flash_ok(False)
    opt = TensorAdam(model.p, 1e-3, fuse=True)
    opt.load_state(state, lr)
    losses = []
    for f in feeds:
        total, mlm, nsp = model.loss(**_tensors(f))
        opt.minimize(total)
        losses.append([float(v.detach()) for v in (total, mlm, nsp)])
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


def test_bert_scope_carry_infers_the_config_and_checks_names(jax_run):
    init = jax_run[0]
    cfg = BertConfig(**TRAIN)
    # config inferred from the names and shapes
    params, state, lr = train_state_from_numpy(init, 'cpu')
    assert list(params) == list(bert.param_shapes(cfg)) == list(state)
    assert params['bert.mlm.out.w'].shape == (32, 128)
    assert params['bert.seg_emb.w'].shape == (2, 32)
    assert float(lr[0]) == np.float32(1e-3)
    assert float(state['bert.nsp.b']['beta1_pow'][0]) == np.float32(0.9)
    plain = {n: init[n] for n in params}
    bad = dict(plain)
    del bad['bert.pooler.b']
    with pytest.raises(ValueError, match=r"BERT model: missing "
                       r"\['bert.pooler.b'\]"):
        params_from_numpy(bad, 'cpu')
    with pytest.raises(ValueError, match='unexpected'):
        params_from_numpy(dict(plain, **{'lm_head.w': plain['bert.nsp.w']}),
                          'cpu')
    bad = dict(plain, **{'bert.nsp.w': np.zeros((32, 3), 'float32')})
    with pytest.raises(ValueError, match="'bert.nsp.w' has shape"):
        params_from_numpy(bad, 'cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_numpy(plain)


def test_adam_advances_every_beta_power_once_over_160_tensors():
    """BERT-base's 160 parameter tensors span four of the fused Adam's
    48-tensor tables: one step advances each tensor's beta powers exactly
    once and moves every parameter that has a gradient."""
    cfg = BertConfig(vocab_size=32, seq_len=8, d_model=8, n_head=2,
                     n_layer=12, d_ff=16, dropout=0.0, max_predictions=2)
    model = BertPretrain(cfg, bert.init_params(cfg, 0, 'cpu'))
    assert len(model.p) == 160
    opt = TensorAdam(model.p, 1e-2, fuse=True)
    start = {n: p.detach().clone() for n, p in model.p.items()}
    feed = _tensors(_batch(cfg, 2, 0, pad=[2, 0]))
    first = float(opt.minimize(model.loss(**feed)[0]))
    for n, s in opt.state().items():
        assert float(s['beta1_pow'][0]) == np.float32(0.9) * np.float32(0.9)
        assert float(s['beta2_pow'][0]) == \
            np.float32(0.999) * np.float32(0.999)
        assert not torch.equal(model.p[n], start[n]), n
    for _ in range(4):
        last = float(opt.minimize(model.loss(**feed)[0]))
    assert last < first
