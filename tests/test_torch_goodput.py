"""The port's goodput accounting, flight recorder and program analytics
against the JAX package's, on the CPU.

- goodput: the same synthetic dispatch sequence (no CUDA events, a fixed
  ``PADDLE_PEAK_FLOPS``, named models) through both packages' modules
  gives the same ``stats()`` but for the wall clock, and the same
  sentinel trips (``step_drift``, ``recompile_storm``,
  ``accept_collapse``, ``queue_burn``); each of the port's trips
  publishes a flight-recorder bundle with the JAX bundle's files.
- analysis: the product flops the port counts for one training step on
  the plain versions (the LM with flash attention off and on, BERT, a
  small conv net) equal ``torch.utils.flop_counter.FlopCounterMode``'s
  count of the same run, exactly; the ratio to the JAX package's XLA
  ``flops`` of the same program is printed, with no limit. An op-profiled
  run gives one row per op type with the run's op counts.
- the Executor's dispatches reach goodput under the program's
  fingerprint, with the registered flops a step; a ``run_fused`` call
  that builds its plan counts its first step as the compile and the rest
  as a fused dispatch.
- the monitor's own threads (a /metrics request, the log writer) never
  resolve CUDA events: the thread that reads ``stats()`` does.

Each test resets both packages' monitor, goodput, trace and blackbox
after itself, and writes bundles and logs under ``tmp_path``.
"""
import collections
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
from torch.utils.flop_counter import FlopCounterMode

import paddle_tpu as jfluid
from paddle_tpu import analysis as janalysis
from paddle_tpu import blackbox as jblackbox
from paddle_tpu import goodput as jgoodput
from paddle_tpu import monitor as jmonitor
from paddle_tpu import trace as jtrace
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import transformer as jtransformer

import paddle_tpu_torch as fluid
from paddle_tpu_torch import (analysis, blackbox, goodput, monitor,
                              profiler, trace)
from paddle_tpu_torch.models import bert, transformer

JAX = (jmonitor, jgoodput, jtrace, jblackbox)
PORT = (monitor, goodput, trace, blackbox)


def _reset_all():
    for mon, gp, tr, bb in (JAX, PORT):
        bb.flush(10.0)
        mon.snapshot()
        gp.reset()
        mon.reset()
        tr.reset()
        bb.reset()
    analysis.reset()


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


SENTINEL_ENV = {'PADDLE_PEAK_FLOPS': '1e12', 'PADDLE_PEAK_HBM_BPS': '1e11',
                'PADDLE_PERFWATCH_MIN_SAMPLES': '4',
                'PADDLE_PERFWATCH_RECOMPILE_N': '3',
                'PADDLE_PERFWATCH_QUEUE_SLO_MS': '5',
                'PADDLE_BLACKBOX': '1'}


def _drive(gp):
    """A synthetic dispatch sequence with each sentinel's trigger."""
    gp.name_model('fp:model-a', 'model_a')
    gp.name_model('fp:model-b', 'model_b')
    t = 100.0
    for i in range(4):          # baselines: 10 ms a step
        gp.note_dispatch('fp:model-a', 'run', t, t + 0.01)
        gp.note_dispatch('fp:model-b', 'fused', t, t + 0.04, steps=4)
        t += 0.05
    for i in range(6):          # model a drifts to 50 ms a step
        gp.note_dispatch('fp:model-a', 'run', t, t + 0.05)
        t += 0.06
    gp.note_dispatch('fp:model-a', 'bound', t, t + 0.002)
    st0 = gp.stats()            # drains: baselines froze, the drift trips
    for _ in range(3):
        gp.note_compile('fp:model-a', 0.5)
    for r in (0.9, 0.9, 0.8, 0.9, 0.1, 0.1, 0.0, 0.1):
        gp.note_accept(r, model='generate')
    for _ in range(5):
        gp.note_queue_wait(0.02)
    assert st0['dispatches'] == 15
    return gp.stats()


# read against the wall clock (productive seconds are capped by the
# window), or stamped with it (the trips, compared without their ts)
_WALL = ('window_s', 'goodput_frac', 'model_flops_per_s', 'productive_s',
         'regressions')


def _regression_view(st):
    return [{k: v for k, v in r.items() if k != 'ts'}
            for r in st['regressions']]


def test_goodput_stats_and_sentinel_trips_equal_the_jax_module(
        tmp_path, monkeypatch):
    for k, v in SENTINEL_ENV.items():
        monkeypatch.setenv(k, v)
    got = []
    for name, (mon, gp, tr, bb) in (('jax', JAX), ('port', PORT)):
        monkeypatch.setenv('PADDLE_BLACKBOX_DIR', str(tmp_path / name))
        st = _drive(gp)
        assert bb.flush(20.0)
        gp.flush()
        got.append((st, mon.counters(), bb.bundles()))
    (jst, jctr, jbundles), (pst, pctr, pbundles) = got
    assert {k: v for k, v in pst.items() if k not in _WALL} == \
        {k: v for k, v in jst.items() if k not in _WALL}
    kinds = [r['kind'] for r in _regression_view(pst)]
    assert kinds == ['step_drift', 'recompile_storm', 'accept_collapse',
                     'queue_burn']
    assert _regression_view(pst) == _regression_view(jst)
    series = ('perf_regression_total', 'goodput_')
    assert {k: v for k, v in pctr.items() if k.startswith(series)} == \
        {k: v for k, v in jctr.items() if k.startswith(series)}
    assert pctr['perf_regression_total{kind=queue_burn}'] == 1
    assert goodput.cost_estimate('model_a') == jgoodput.cost_estimate(
        'model_a')
    assert goodput.cost_estimate('nobody') is None
    # one bundle a trip, laid out as the JAX package lays it out
    assert len(pbundles) == len(jbundles) == 4

    def layout(path):
        with open(os.path.join(path, 'manifest.json')) as f:
            man = json.load(f)
        return (man['kind'], sorted(os.listdir(path)), sorted(man),
                sorted(man['files']))
    assert [layout(p) for p in pbundles] == [layout(p) for p in jbundles]
    with open(os.path.join(pbundles[0], 'env.json')) as f:
        env = json.load(f)
    assert 'torch' in env and 'jax' not in env
    with open(os.path.join(pbundles[0], 'goodput.json')) as f:
        assert json.load(f)['dispatches'] == 15


def test_a_step_error_bundle_carries_the_program_and_its_replay(tmp_path,
                                                                monkeypatch):
    """blackbox.record with a program, feed and state: the bundle holds
    program.json, the port's analysis.json and replay/ as .npz, as the JAX
    bundle does (no program.hlo)."""
    monkeypatch.setenv('PADDLE_BLACKBOX', '1')
    monkeypatch.setenv('PADDLE_BLACKBOX_DIR', str(tmp_path))
    main, startup, loss = _conv_program(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = _conv_feed()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    state = {n: scope.get(n) for n in scope.names()[:3]}
    assert blackbox.record('generate_step_error', error=ValueError('x'),
                           program=main, feed=feed, state=state, step=3)
    assert not blackbox.record('generate_step_error')   # rate-limited
    assert blackbox.flush(20.0)
    path, = blackbox.bundles()
    files = sorted(os.listdir(path))
    assert files == ['analysis.json', 'env.json', 'goodput.json',
                     'manifest.json', 'metrics.prom', 'monitor.json',
                     'program.json', 'replay', 'trace.json', 'traces.jsonl']
    with open(os.path.join(path, 'analysis.json')) as f:
        rec = json.load(f)
    assert rec['kind'] == 'run' and rec['product_flops'] > 0
    with open(os.path.join(path, 'replay', 'replay.json')) as f:
        meta = json.load(f)
    assert sorted(meta['feed_names']) == ['img', 'label']
    arrs = np.load(os.path.join(path, 'replay', 'state.npz'))
    assert len(arrs.files) == 3


# ---------------------------------------------------------------------------
# the count of a step's work

LM = dict(vocab_size=64, seq_len=16, d_model=32, n_head=2, n_layer=2,
          d_ff=64, dropout=0.0, attn_dropout=0.0)
BERT = dict(vocab_size=64, seq_len=16, d_model=16, n_head=2, n_layer=1,
            d_ff=32, dropout=0.0, attn_dropout=0.0, max_predictions=2)


def _lm_program(pkg, flash):
    tr = jtransformer if pkg is jfluid else transformer
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, loss = tr.build_lm(tr.LMConfig(
            use_flash_attention=flash, **LM))
        pkg.optimizer.Adam(1e-3).minimize(loss)
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 64, size=(4, 16)).astype('int64')
    feed = {'tokens': toks, 'labels': np.roll(toks, -1, axis=1)}
    return main, startup, loss, feed


def _bert_program(pkg, _):
    b = jbert if pkg is jfluid else bert
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        losses = b.build_bert_pretrain(b.BertConfig(**BERT))
        pkg.optimizer.Adam(1e-3).minimize(losses[0])
    feed = bert.make_pretrain_batch(bert.BertConfig(**BERT), 4,
                                    np.random.RandomState(3))
    feed['input_mask'][1, -5:] = 0.0
    return main, startup, losses[0], feed


def _conv_program(pkg, _=None):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = L.data(name='img', shape=[3, 8, 8], dtype='float32')
        label = L.data(name='label', shape=[1], dtype='int64')
        x = L.conv2d(img, num_filters=4, filter_size=3, padding=1,
                     act='relu')
        x = L.batch_norm(x)
        x = L.conv2d(x, num_filters=4, filter_size=3, groups=2,
                     bias_attr=False)
        x = L.pool2d(x, pool_size=2, pool_stride=2)
        logits = L.fc(x, size=5)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    return main, startup, loss


def _conv_feed():
    rs = np.random.RandomState(1)
    return {'img': rs.randn(4, 3, 8, 8).astype('float32'),
            'label': rs.randint(0, 5, size=(4, 1)).astype('int64')}


def _conv_case(pkg, flash):
    main, startup, loss = _conv_program(pkg)
    return main, startup, loss, _conv_feed()


CASES = {'lm_unfused': (_lm_program, False), 'lm_flash': (_lm_program, True),
         'bert': (_bert_program, True), 'conv': (_conv_case, None)}


@pytest.mark.parametrize('case', sorted(CASES))
def test_counted_product_flops_equal_flop_counter_mode(case, capsys):
    build, flash = CASES[case]
    main, startup, loss, feed = build(fluid, flash)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    with FlopCounterMode(display=False) as fc:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    rec = analysis.lookup(main, kind='run')
    assert rec is not None and rec.steps == 1
    assert rec.product_flops == fc.get_total_flops() > 0
    assert rec.flops > rec.product_flops and rec.bytes_accessed > 0
    assert rec.transcendentals > 0 and rec.peak_bytes is None
    # the gauges export at the next read, with the JAX labels
    gauges = monitor.snapshot()['gauges']
    key = 'program_flops{fingerprint=%s,kind=run}' % main._fingerprint()[:12]
    assert gauges[key] == rec.flops
    # the JAX package's XLA count of the same program, for the record
    jmain, jstartup, jloss, jfeed = build(jfluid, flash)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    jexe.run(jmain, feed=jfeed, fetch_list=[jloss], scope=jscope)
    xla = janalysis.lookup(jmain, kind='run').flops
    with capsys.disabled():
        print('\n%s: counted %d flops (products %d); XLA %d; ratio %.4f'
              % (case, rec.flops, rec.product_flops, xla,
                 rec.flops / xla))


def test_op_profile_rows_are_the_run_s_op_counts():
    main, startup, loss = _conv_program(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    before = monitor.counters()
    with profiler.profile_ops() as an:
        out = exe.run(main, feed=_conv_feed(), fetch_list=[loss],
                      scope=scope)
    assert np.isfinite(out[0]).all()
    prof = an.op_profile()
    want = collections.Counter(op.type for op in main.global_block().ops)
    assert {r['type']: r['calls'] for r in prof['ops']} == dict(want)
    assert prof['runs'] == 1 and prof['accounted_s'] > 0
    assert 'backward' in an.format_op_profile()
    spans = [s['name'] for s in monitor.spans()]
    assert spans.count('op:conv2d') == want['conv2d']
    delta = monitor.counter_delta(before)
    assert delta['op_profile_run_total'] == 1
    assert 'compile_cache_miss' not in delta    # nothing is cached
    assert not analysis.profile_ops_active()


def test_executor_dispatches_reach_goodput_with_their_flops(monkeypatch):
    """run() hits and bind calls are dispatches of kinds run and bound
    under the program's fingerprint; their flops a step are the
    registered ones, and a fused call of 3 counts 3 steps."""
    monkeypatch.setenv('PADDLE_PEAK_FLOPS', '1e12')
    main, startup, loss = _conv_program(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = _conv_feed()
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    bp = exe.bind(main, feed, fetch_list=[loss], scope=scope)
    bp(feed)
    exe.run_fused(main, [feed] * 3, fetch_list=[loss], scope=scope)
    fp = main._fingerprint()
    st = goodput.stats(fps={fp})
    assert {k: v['dispatches'] for k, v in st['by_kind'].items()} == \
        {'run': 2, 'bound': 1, 'fused': 1}
    assert st['by_kind']['fused']['steps'] == 3
    per_step = analysis.lookup(main, kind='run').flops
    assert st['flops'] == pytest.approx(per_step * 6)
    assert st['step_mfu'] is not None and st['step_mfu'] > 0
    assert analysis.lookup(main, kind='bound').flops == per_step
    assert analysis.lookup(main, kind='fused') is None   # bind's plan
    assert goodput.device_peaks() == (1e12, None)


@pytest.mark.parametrize('steps', [1, 5])
def test_run_fused_on_a_new_plan_accounts_its_steps_after_the_first(steps):
    """A run_fused call that builds its plan: its first step is the
    compile, and the rest are one fused dispatch of steps - 1 steps."""
    main, startup, loss = _conv_program(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    before = monitor.snapshot()['histograms'].get('compile_seconds', {})
    out = exe.run_fused(main, [_conv_feed()], fetch_list=[loss],
                        scope=scope, steps=steps)
    assert np.isfinite(out[0]).all()
    after = monitor.snapshot()['histograms']['compile_seconds']
    assert after['count'] == before.get('count', 0) + 1
    st = goodput.stats(fps={main._fingerprint()})
    if steps == 1:
        assert st['by_kind'] == {}
    else:
        assert st['by_kind']['fused']['dispatches'] == 1
        assert st['by_kind']['fused']['steps'] == steps - 1
    assert analysis.lookup(main, kind='fused').steps == 1


class _Event(object):
    """A stand-in for a completed CUDA event that records which threads
    call it."""

    def __init__(self, calls):
        self.calls = calls

    def query(self):
        self.calls.append(threading.current_thread().name)
        return True

    def synchronize(self):
        self.calls.append(threading.current_thread().name)

    def elapsed_time(self, end):
        self.calls.append(threading.current_thread().name)
        return 2.0


def test_telemetry_threads_leave_cuda_events_to_the_reader():
    """A /metrics scrape and a FLAGS_monitor_log line account only the
    records without events: they run on the monitor's own threads, where a
    CUDA call could invalidate another thread's graph capture. The reader
    of stats() resolves the events."""
    calls = []
    goodput.note_dispatch('fp:plain', 'run', 1.0, 1.5)
    goodput.note_dispatch('fp:cuda', 'bound', 2.0, 2.1,
                          events=(_Event(calls), _Event(calls)))
    server = monitor.serve_metrics(port=0)
    try:
        url = 'http://127.0.0.1:%d/metrics' % server.port
        for _ in range(3):
            text = urllib.request.urlopen(url, timeout=30).read().decode()
        assert 'goodput_dispatch_total' in text
    finally:
        server.close()
    assert calls == []
    assert len(goodput._q) == 1         # the record with events waits
    st = goodput.stats()
    assert st['dispatches'] == 2 and calls
    assert set(calls) == {threading.current_thread().name}
    assert st['by_kind']['bound']['device_s'] == pytest.approx(0.002)
