"""The recurrent ops and layers of paddle_tpu_torch against the JAX package,
on the CPU.

(a) Each op (``lstm`` with and without peepholes, reversed, from a given
    H0/C0, with a ReLU candidate; ``lstmp``; ``gru`` in both
    ``origin_mode``s and reversed, from a given H0; ``gru_unit`` in both
    modes; ``lstm_unit``) as a one-op program of the sequence tests'
    harness (tests/test_torch_sequence.py `_run_seq_op`): every output,
    the unread ones included (``BatchGate``, ``BatchCellPreAct``,
    ``BatchResetHiddenPrev``), within 1e-5 of its largest magnitude, every
    input's gradient within 1e-4, on a batch with an empty sequence and
    one of length 1 (whose padded lanes gather row 0: its gradient is
    held as every row's).
(b) The bench's stacked-LSTM program (bench.py `_bench_stacked_lstm`: an
    embedding, three fc + ``dynamic_lstm`` layers, ``sequence_last_step``,
    a 2-way softmax fc, cross entropy, ``Adam(1e-3)``) at hidden 16, vocab
    50, embedding 8, built by each package under a fresh
    ``unique_name.guard()`` (equal program dicts), trained three steps on
    ragged batches of one LoD from the JAX startup scope: losses within 1e-4
    relative, every state tensor within 1e-3 of its largest magnitude
    (`PERF.md` §2's f32 limits). The same for a text classifier of
    ``dynamic_gru``, ``sequence_conv`` and ``sequence_pool(MAX)``.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.core import serialization as jser

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.io import scope_from_numpy
from test_torch_sequence import LOD_A, _f, _run_seq_op

CPU = fluid.CPUPlace()
STEPS = 3


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels;
    restart the window after this module."""
    yield
    goodput.reset()
    monitor.reset()


def _cases():
    rs = np.random.RandomState(1)
    d, p = 4, 3
    c = {}
    lstm = dict(
        op='lstm',
        inputs={'Input': [('x', _f(rs, 10, 4 * d), LOD_A, True)],
                'Weight': [('w', _f(rs, d, 4 * d, scale=0.5), None, True)],
                'Bias': [('b', _f(rs, 1, 7 * d, scale=0.5), None, True)]},
        outputs={'Hidden': ['h'], 'Cell': ['c'], 'BatchGate': ['bg'],
                 'BatchCellPreAct': ['bc']},
        attrs={'use_peepholes': True, 'is_reverse': False,
               'gate_activation': 'sigmoid', 'cell_activation': 'tanh',
               'candidate_activation': 'tanh'})
    c['lstm'] = lstm
    c['lstm_reverse'] = dict(lstm, attrs=dict(lstm['attrs'],
                                              is_reverse=True))
    c['lstm_no_peepholes'] = dict(
        lstm, inputs=dict(lstm['inputs'], Bias=[
            ('b', _f(rs, 1, 4 * d, scale=0.5), None, True)]),
        attrs=dict(lstm['attrs'], use_peepholes=False))
    c['lstm_h0_c0'] = dict(
        lstm, inputs=dict(lstm['inputs'],
                          H0=[('h0', _f(rs, 5, d), None, True)],
                          C0=[('c0', _f(rs, 5, d), None, True)]))
    c['lstm_relu_candidate'] = dict(
        lstm, attrs=dict(lstm['attrs'], candidate_activation='relu'))
    c['lstmp'] = dict(
        op='lstmp',
        inputs={'Input': [('x', _f(rs, 10, 4 * d), LOD_A, True)],
                'Weight': [('w', _f(rs, p, 4 * d, scale=0.5), None, True)],
                'ProjWeight': [('pw', _f(rs, d, p, scale=0.5), None, True)],
                'Bias': [('b', _f(rs, 1, 7 * d, scale=0.5), None, True)]},
        outputs={'Projection': ['proj'], 'Cell': ['c']},
        attrs=dict(lstm['attrs'], proj_activation='tanh'))
    gru = dict(
        op='gru',
        inputs={'Input': [('x', _f(rs, 10, 3 * d), LOD_A, True)],
                'Weight': [('w', _f(rs, d, 3 * d, scale=0.5), None, True)],
                'Bias': [('b', _f(rs, 1, 3 * d, scale=0.5), None, True)]},
        outputs={'Hidden': ['h'], 'BatchGate': ['bg'],
                 'BatchResetHiddenPrev': ['br'], 'BatchHidden': ['bh']},
        attrs={'is_reverse': False, 'origin_mode': False,
               'gate_activation': 'sigmoid', 'activation': 'tanh'})
    c['gru'] = gru
    c['gru_origin_mode'] = dict(gru, attrs=dict(gru['attrs'],
                                                origin_mode=True))
    c['gru_reverse'] = dict(gru, attrs=dict(gru['attrs'], is_reverse=True))
    c['gru_h0'] = dict(gru, inputs=dict(
        gru['inputs'], H0=[('h0', _f(rs, 5, d), None, True)]))
    unit = dict(
        op='gru_unit',
        inputs={'Input': [('x', _f(rs, 5, 3 * d), None, True)],
                'HiddenPrev': [('hp', _f(rs, 5, d), None, True)],
                'Weight': [('w', _f(rs, d, 3 * d, scale=0.5), None, True)],
                'Bias': [('b', _f(rs, 1, 3 * d, scale=0.5), None, True)]},
        outputs={'Gate': ['gate'], 'ResetHiddenPrev': ['rh'],
                 'Hidden': ['h']},
        attrs={'activation': 2, 'gate_activation': 1, 'origin_mode': False})
    c['gru_unit'] = unit
    c['gru_unit_origin_mode'] = dict(unit, attrs=dict(unit['attrs'],
                                                      origin_mode=True))
    c['lstm_unit'] = dict(
        op='lstm_unit',
        inputs={'X': [('x', _f(rs, 5, 4 * d), None, True)],
                'C_prev': [('cp', _f(rs, 5, d), None, True)]},
        outputs={'C': ['c'], 'H': ['h']}, attrs={'forget_bias': 0.5})
    return c


CASES = _cases()


@pytest.mark.parametrize('key', sorted(CASES))
def test_rnn_op_matches_the_jax_executor(key):
    _run_seq_op(CASES[key], seed=7)


# ---------------------------------------------------------------------------
# (b) whole programs


def stacked_lstm(pkg, hid=16, layers=3, vocab=50, emb=8):
    """bench.py `_bench_stacked_lstm`'s program at a small width."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        words = pkg.layers.data(name='words', shape=[1], dtype='int64',
                                lod_level=1)
        label = pkg.layers.data(name='label', shape=[1], dtype='int64')
        h = pkg.layers.embedding(words, size=[vocab, emb])
        for _ in range(layers):
            proj = pkg.layers.fc(h, size=hid * 4)
            h, _ = pkg.layers.dynamic_lstm(input=proj, size=hid * 4)
        last = pkg.layers.sequence_last_step(h)
        pred = pkg.layers.fc(last, size=2, act='softmax')
        loss = pkg.layers.mean(
            pkg.layers.cross_entropy(input=pred, label=label))
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def gru_text(pkg, hid=8, vocab=50, emb=8):
    """A text classifier: embedding, fc + ``dynamic_gru``,
    ``sequence_conv``, ``sequence_pool(MAX)``, a 2-way softmax fc."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 2
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        words = pkg.layers.data(name='words', shape=[1], dtype='int64',
                                lod_level=1)
        label = pkg.layers.data(name='label', shape=[1], dtype='int64')
        e = pkg.layers.embedding(words, size=[vocab, emb])
        g = pkg.layers.dynamic_gru(pkg.layers.fc(e, size=hid * 3), size=hid)
        conv = pkg.layers.sequence_conv(g, num_filters=hid, filter_size=3,
                                        act='relu')
        pooled = pkg.layers.sequence_pool(conv, 'max')
        pred = pkg.layers.fc(pooled, size=2, act='softmax')
        loss = pkg.layers.mean(
            pkg.layers.cross_entropy(input=pred, label=label))
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def ragged_batches(n, lens, vocab=50, seed=5):
    rs = np.random.RandomState(seed)
    out = []
    for k in range(n):
        ls = lens[k % len(lens)]
        lod = [[0] + list(np.cumsum(ls))]
        out.append({'words': (rs.randint(0, vocab, (sum(ls), 1))
                              .astype('int64'), lod),
                    'label': rs.randint(0, 2, (len(ls), 1))
                    .astype('int64')})
    return out


def train_both(build, batches):
    """(JAX losses, JAX state, port losses, port state) of ``STEPS`` run()
    steps from the JAX startup scope; the program dicts equal."""
    jmain, jstart, jloss = build(jfluid)
    tmain, tstart, tloss = build(fluid)
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    assert tser.program_to_dict(tstart) == jser.program_to_dict(jstart)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    init = {n: np.array(jscope.get(n)) for n in jscope.names()}
    texe = fluid.Executor(CPU)
    tscope = scope_from_numpy(init, device='cpu')
    want = [float(jexe.run(jmain, feed=b, fetch_list=[jloss],
                           scope=jscope)[0][0]) for b in batches]
    got = [float(texe.run(tmain, feed=b, fetch_list=[tloss],
                          scope=tscope)[0][0]) for b in batches]
    wstate = {n: np.array(jscope.get(n)) for n in init}
    gstate = {n: tscope.get(n).detach().numpy().copy() for n in init}
    return want, wstate, got, gstate


def _hold(want, wstate, got, gstate):
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for n, w in wstate.items():
        tol = 1e-3 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(gstate[n], w, rtol=0, atol=tol,
                                   err_msg=n)


# an empty sequence, one of length 1, and lengths up to 9: one LoD, so
# that each package builds one plan
LENGTHS = [[3, 0, 1, 9]]


def test_stacked_lstm_trains_as_the_jax_package():
    want, wstate, got, gstate = train_both(
        stacked_lstm, ragged_batches(STEPS, LENGTHS))
    _hold(want, wstate, got, gstate)


def test_gru_conv_max_pool_text_model_trains_as_the_jax_package():
    want, wstate, got, gstate = train_both(
        gru_text, ragged_batches(STEPS, LENGTHS, seed=6))
    _hold(want, wstate, got, gstate)
