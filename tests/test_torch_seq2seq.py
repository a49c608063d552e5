"""The machine-translation model (models/seq2seq.py), the decoders
(contrib/decoder) and the MNIST and word2vec models of paddle_tpu_torch
against the JAX package, on the CPU.

(a) ``build_nmt_train`` at V 64, embedding and encoder 16 wide, decoder
    32, on 3 sequences of lengths 4, 5 and 3 (LoD [0, 4, 9, 12]: the
    decoder's rows finish at different steps), under ``Adam(1e-2)``: the
    program dicts (main and startup) equal the JAX ones; from the JAX
    startup scope, 3 steps' losses hold the JAX executor's within 1e-5
    relative, each parameter within 1e-4 of its largest magnitude (an
    element whose first gradient is noise, under 1e-5 of its tensor's
    largest, within STEPS * lr, as ROADMAP notes: the attention's state
    projection adds one value to every score of a row, which the softmax
    ignores), each Adam moment within 1e-3 of its largest magnitude.
(b) ``build_nmt_generate`` (beam 2, max_len 6) over 3 source sentences:
    ``sent_ids`` equal and ``sent_scores`` within 1e-5 relative, through
    ``Executor.run`` and through ``Executor.bind`` (on the CPU a bound
    plan runs the bounded loop eagerly, as the card's capture runs it).
(c) tests/test_beam_search_decoder.py's case: ``TrainingDecoder`` trained
    3 Adam steps, then ``BeamSearchDecoder`` on the trained weights, held
    the same way.
(d) ``models.mnist.build`` (mlp and conv) and ``models.word2vec.build``
    (dense and sparse): the program dicts equal the JAX ones, and one SGD
    step's loss and updated parameters hold the JAX executor's within
    1e-5 relative and 1e-5 of each parameter's largest magnitude.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.contrib import decoder as jdec
from paddle_tpu.core import serialization as jser
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import seq2seq as jseq
from paddle_tpu.models import word2vec as jw2v

import paddle_tpu_torch as fluid
from paddle_tpu_torch.contrib import decoder as tdec
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import seq2seq as tseq
from paddle_tpu_torch.models import word2vec as tw2v
from torch_state_hold import noise_mask

CPU = fluid.CPUPlace()
STEPS = 3
LR = 1e-2
LOD = [[0, 4, 9, 12]]


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels and
    fills monitor series; leave both empty after this module."""
    yield
    goodput.reset()
    monitor.reset()


def _build(pkg, fn, seed=5):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = fn(pkg)
    return main, startup, out


def _pair(jfn, tfn):
    """Both packages' builds, their dicts equal; the JAX startup run, its
    scope carried into the port."""
    j = _build(jfluid, jfn)
    t = _build(fluid, tfn)
    assert tser.program_to_dict(t[0]) == jser.program_to_dict(j[0])
    assert tser.program_to_dict(t[1]) == jser.program_to_dict(j[1])
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(j[1], scope=jscope)
    tscope = scope_from_numpy(_jstate(jscope), device='cpu')
    return j, t, (jexe, jscope), (fluid.Executor(CPU), tscope)


def _jstate(scope):
    return {n: np.array(scope.get(n)) for n in scope.names()
            if hasattr(scope.get(n), 'shape')}


def _rel(got, want, rtol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-7, err_msg=what)


def _hold_state(jscope, tscope, params, p_limit, m_limit, noise=None,
                lr=0.0):
    """Each float state tensor within ``p_limit`` (one of ``params``) or
    ``m_limit`` (any other) of its largest magnitude; the elements of
    ``noise`` ({parameter name: mask}, rounding-noise gradients) within
    STEPS * ``lr`` instead; integer state equal."""
    noise = noise or {}
    for n, want in sorted(_jstate(jscope).items()):
        got = tscope.get(n).detach().cpu().numpy()
        assert got.shape == want.shape, n
        if want.dtype.kind != 'f':
            np.testing.assert_array_equal(got, want, err_msg=n)
            continue
        scale = max(float(np.abs(want).max()), 1e-30)
        err = np.abs(got - want)
        apart = noise.get(n, np.zeros(want.shape, bool))
        assert float(err[apart].max(initial=0)) <= STEPS * lr, n
        limit = p_limit if n in params else m_limit
        assert float(err[~apart].max(initial=0)) <= limit * scale, \
            (n, float(err[~apart].max(initial=0) / scale))


def _first_noise(jscope, params):
    """{parameter: `noise_mask` of its moment 1} after the JAX run's first
    Adam step."""
    return {n: noise_mask(np.array(jscope.get(n + '_moment1_0')))
            for n in params}


# ---------------------------------------------------------------------------
# (a) training

def _train(mod):
    def fn(pkg):
        cfg = mod.Seq2SeqConfig(dict_size=64, embedding_dim=16,
                                encoder_size=16, decoder_size=32)
        feeds, loss, _ = mod.build_nmt_train(cfg)
        pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
        return feeds, loss
    return fn


def _nmt_feeds(steps, seed=0):
    rs = np.random.RandomState(seed)
    return [{k: (rs.randint(1, 64, (12, 1)).astype('int64'), LOD)
             for k in ('source_sequence', 'target_sequence',
                       'label_sequence')} for _ in range(steps)]


def test_nmt_train_matches_the_jax_executor():
    j, t, (jexe, jscope), (texe, tscope) = _pair(_train(jseq), _train(tseq))
    assert [op.type for op in t[0].global_block().ops].count('recurrent') \
        == 1
    params = [p.name for p in t[0].all_parameters()]
    for step, feed in enumerate(_nmt_feeds(STEPS)):
        want, = jexe.run(j[0], feed=feed, fetch_list=[j[2][1]], scope=jscope)
        got, = texe.run(t[0], feed=feed, fetch_list=[t[2][1]], scope=tscope)
        _rel(got, want, 1e-5, 'loss at step %d' % step)
        if not step:
            noise = _first_noise(jscope, params)
    _hold_state(jscope, tscope, params, 1e-4, 1e-3, noise, LR)


# ---------------------------------------------------------------------------
# (b) generation

BEAM, MAX_LEN, GEN_B = 2, 6, 3


def _generate(mod):
    def fn(pkg):
        cfg = mod.Seq2SeqConfig(dict_size=64, embedding_dim=16,
                                encoder_size=16, decoder_size=32,
                                beam_size=BEAM)
        return mod.build_nmt_generate(cfg, max_len=MAX_LEN)
    return fn


def _gen_feed():
    rs = np.random.RandomState(3)
    init_ids, init_scores = jdec.BeamSearchDecoder.make_initial_beams(
        GEN_B, BEAM, 0)
    return {'source_sequence': (rs.randint(1, 64, (12, 1)).astype('int64'),
                                LOD),
            'init_ids': init_ids, 'init_scores': init_scores}


def test_nmt_generate_matches_the_jax_executor():
    j, t, (jexe, jscope), (texe, tscope) = _pair(_generate(jseq),
                                                 _generate(tseq))
    feed = _gen_feed()
    want = jexe.run(j[0], feed=feed, fetch_list=list(j[2][1]), scope=jscope)
    got = texe.run(t[0], feed=feed, fetch_list=list(t[2][1]), scope=tscope)
    assert got[0].shape == (GEN_B, BEAM, MAX_LEN)
    np.testing.assert_array_equal(got[0], want[0])
    _rel(got[1], want[1], 1e-5, 'sent_scores')
    bound = texe.bind(t[0], feed, fetch_list=list(t[2][1]), scope=tscope)
    for out in (bound.first_out, bound(feed)):
        np.testing.assert_array_equal(out[0], want[0])
        _rel(out[1], want[1], 1e-5, 'bound sent_scores')


# ---------------------------------------------------------------------------
# (c) the decoder test of the JAX package

V, D, H = 8, 12, 16


def _decoder_train(pkg, dec):
    def cell_for(boot):
        init = dec.InitState(init_boot=boot, shape=[-1, H], value=0.0)
        cell = dec.StateCell(inputs={'x': None}, states={'h': init},
                             out_state='h')

        @cell.state_updater
        def updater(c):
            h = pkg.layers.fc(
                pkg.layers.concat([c.get_input('x'), c.get_state('h')],
                                  axis=1), size=H, act='tanh',
                param_attr=pkg.ParamAttr(name='dec_cell.w'),
                bias_attr=pkg.ParamAttr(name='dec_cell.b'))
            c.set_state('h', h)
        return cell

    trg = pkg.layers.data(name='trg', shape=[1], dtype='int64', lod_level=1)
    lbl = pkg.layers.data(name='lbl', shape=[1], dtype='int64', lod_level=1)
    trg_emb = pkg.layers.embedding(
        trg, size=[V, D], param_attr=pkg.ParamAttr(name='dec.emb'))
    cell = cell_for(pkg.layers.sequence_pool(trg_emb, 'first'))
    decoder = dec.TrainingDecoder(cell)
    with decoder.block():
        cell.compute_state(inputs={'x': decoder.step_input(trg_emb)})
        score = pkg.layers.fc(
            cell.get_state('h'), size=V, act='softmax',
            param_attr=pkg.ParamAttr(name='dec.score.w'),
            bias_attr=pkg.ParamAttr(name='dec.score.b'))
        cell.update_states()
        decoder.output(score)
    loss = pkg.layers.mean(pkg.layers.cross_entropy(decoder(), lbl))
    pkg.optimizer.Adam(0.05).minimize(loss)
    return loss, cell_for


def _decoder_infer(pkg, dec, cell_for):
    init_ids = pkg.layers.data(name='init_ids', shape=[-1, 1],
                               dtype='int64')
    init_sc = pkg.layers.data(name='init_scores', shape=[-1, 1],
                              dtype='float32')
    emb = pkg.layers.reshape(pkg.layers.embedding(
        init_ids, size=[V, D], param_attr=pkg.ParamAttr(name='dec.emb')),
        [-1, D])
    d = dec.BeamSearchDecoder(
        cell_for(emb), init_ids, init_sc, target_dict_dim=V, word_dim=D,
        max_len=5, beam_size=2, end_id=0,
        embedding_param_attr=pkg.ParamAttr(name='dec.emb'),
        score_param_attr=pkg.ParamAttr(name='dec.score.w'),
        score_bias_attr=pkg.ParamAttr(name='dec.score.b'))
    d.decode()
    return list(d())


def test_training_decoder_then_beam_search_matches_the_jax_executor():
    outs = {}
    for pkg, dec in ((jfluid, jdec), (fluid, tdec)):
        main, startup, (loss, cell_for) = _build(
            pkg, lambda p, dec=dec: _decoder_train(p, dec))
        infer, istart, fetch = _build(
            pkg, lambda p, dec=dec, cf=cell_for: _decoder_infer(p, dec, cf))
        outs[pkg] = (main, startup, loss, infer, istart, fetch)
    (jm, js, jl, ji, jis, jf), (tm, ts, tl, ti, tis, tf) = \
        outs[jfluid], outs[fluid]
    for a, b in ((tm, jm), (ts, js), (ti, ji), (tis, jis)):
        assert tser.program_to_dict(a) == jser.program_to_dict(b)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = fluid.Executor(CPU), scope_from_numpy(_jstate(jscope),
                                                          device='cpu')
    rng = np.random.RandomState(0)
    toks = np.tile(rng.randint(1, V, (4, 1)), (1, 4)).reshape(16, 1)
    toks = toks.astype('int64')
    feed = {'trg': (toks, [[0, 4, 8, 12, 16]]),
            'lbl': (toks, [[0, 4, 8, 12, 16]])}
    for step in range(STEPS):
        want, = jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        got, = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
        _rel(got, want, 1e-5, 'decoder loss at step %d' % step)
    init_ids, init_scores = jdec.BeamSearchDecoder.make_initial_beams(3, 2,
                                                                      0)
    for i, t in enumerate(toks.reshape(4, 4)[:3, 0]):
        init_ids[i * 2:(i + 1) * 2] = t
    gfeed = {'init_ids': init_ids, 'init_scores': init_scores}
    want = jexe.run(ji, feed=gfeed, fetch_list=jf, scope=jscope)
    got = texe.run(ti, feed=gfeed, fetch_list=tf, scope=tscope)
    assert got[0].shape == (3, 2, 5)
    np.testing.assert_array_equal(got[0], want[0])
    _rel(got[1], want[1], 1e-5, 'decoder sent_scores')


# ---------------------------------------------------------------------------
# (d) MNIST and word2vec

def _mnist(mod, kind):
    def fn(pkg):
        img, label, _, loss, _ = mod.build(kind)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss
    return fn


def _word2vec(mod, sparse):
    def fn(pkg):
        _, _, loss = mod.build(50, is_sparse=sparse)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss
    return fn


def _mnist_feed(kind):
    rs = np.random.RandomState(4)
    shape = (4, 784) if kind == 'mlp' else (4, 1, 28, 28)
    return {'img': rs.rand(*shape).astype('float32'),
            'label': rs.randint(0, 10, (4, 1)).astype('int64')}


def _w2v_feed():
    rs = np.random.RandomState(5)
    return {n: rs.randint(0, 50, (6, 1)).astype('int64')
            for n in ('firstw', 'secondw', 'thirdw', 'forthw', 'nextw')}


MODELS = {
    'mnist_mlp': (_mnist(jmnist, 'mlp'), _mnist(tmnist, 'mlp'),
                  _mnist_feed('mlp')),
    'mnist_conv': (_mnist(jmnist, 'conv'), _mnist(tmnist, 'conv'),
                   _mnist_feed('conv')),
    'word2vec': (_word2vec(jw2v, False), _word2vec(tw2v, False),
                 _w2v_feed()),
    'word2vec_sparse': (_word2vec(jw2v, True), _word2vec(tw2v, True),
                        _w2v_feed()),
}


@pytest.mark.parametrize('name', sorted(MODELS))
def test_book_model_step_matches_the_jax_executor(name):
    jfn, tfn, feed = MODELS[name]
    j, t, (jexe, jscope), (texe, tscope) = _pair(jfn, tfn)
    want, = jexe.run(j[0], feed=feed, fetch_list=[j[2]], scope=jscope)
    got, = texe.run(t[0], feed=feed, fetch_list=[t[2]], scope=tscope)
    _rel(got, want, 1e-5, name + ' loss')
    _hold_state(jscope, tscope, set(p.name for p in t[0].all_parameters()),
                1e-5, 1e-5)
