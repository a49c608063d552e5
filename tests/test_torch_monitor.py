"""The port's observability tier (paddle_tpu_torch.monitor, trace,
profiler, and the Executor, predictor and decode engine's hooks) against
the JAX package's, on the CPU.

The same fixed sequence of calls goes to both packages' modules: the
snapshots and the Prometheus text are equal but for timestamps; a
finished trace's record (but for its id and times), its flat timing and
``tools/tracereport.py``'s reading of both trace logs are equal; the
chrome traces hold the same event names with the same nesting. Every
series the port emits is in docs/observability.md's catalog. The same
small program through both executors (3 runs, a new batch size, a bind
and 2 calls, a fused run of 3, and a predictor's 2 runs) moves the same
counters by the same amounts, and the same requests through both decode
engines (greedy and sampled on the contiguous cache; paged, with a
prefix hit and speculative rounds) move the same request, token, cache
and speculation counters; the port's endpoint serves them. Each test
resets both packages' monitor, goodput, trace and blackbox after itself.
No test holds a wall-clock bound.
"""
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import blackbox as jblackbox
from paddle_tpu import goodput as jgoodput
from paddle_tpu import monitor as jmonitor
from paddle_tpu import profiler as jprofiler
from paddle_tpu import trace as jtrace
from paddle_tpu.models.transformer import LMConfig as JLMConfig
from paddle_tpu.serving import GenerateConfig as JGenerateConfig
from paddle_tpu.serving import GenerateEngine as JGenerateEngine

import paddle_tpu_torch as fluid
from paddle_tpu_torch import blackbox, goodput, monitor, profiler, trace
from paddle_tpu_torch.models.transformer import LMConfig
from paddle_tpu_torch.serving import GenerateConfig, GenerateEngine

from tools import obslint, tracereport

JAX = {'monitor': jmonitor, 'trace': jtrace, 'profiler': jprofiler,
       'goodput': jgoodput, 'blackbox': jblackbox}
PORT = {'monitor': monitor, 'trace': trace, 'profiler': profiler,
        'goodput': goodput, 'blackbox': blackbox}


def _reset_all():
    for m in (JAX, PORT):
        # a snapshot first: it flushes what the pre-snapshot hooks hold
        # (registered analytics, pending goodput records)
        m['monitor'].snapshot()
        m['goodput'].reset()
        m['monitor'].reset()
        m['trace'].reset()
        m['blackbox'].reset()


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


def _replay(mon, monkeypatch):
    """A fixed sequence of registry calls."""
    mon.inc('executor_run_total')
    mon.inc('compile_cache_hit', 3)
    mon.inc('generate_request_total', labels={'outcome': 'ok'})
    mon.inc('generate_request_total', 2, labels={'outcome': 'shed'})
    mon.inc('feed_host_bytes', np.float32(1024.0))
    mon.set_gauge('kv_slot_occupancy', 0.5)
    mon.set_gauge('program_flops', 1e9,
                  labels={'fingerprint': 'abc', 'kind': 'run'})
    for v in (1e-5, 3e-4, 0.02, 0.5, 7.0, 700.0):
        mon.observe('executor_run_seconds', v)
    mon.observe('prefill_seconds', float('nan'))
    monkeypatch.setenv('PADDLE_MONITOR_MAX_SERIES', '3')
    for i in range(5):
        mon.inc('kv_prefix_hit_total', labels={'outcome': 'o%d' % i})
    monkeypatch.delenv('PADDLE_MONITOR_MAX_SERIES')
    with mon.span('outer'):
        with mon.span('inner'):
            pass
    mon.record_span('request.queue', 1e15, 250.0, tid=7)


def test_monitor_replay_equals_the_jax_monitor(monkeypatch):
    """Snapshots (but for the timestamp) and Prometheus text are equal;
    the series cap, the non-finite guard and counter_delta agree."""
    snaps, proms, deltas = [], [], []
    for m in (JAX, PORT):
        mon = m['monitor']
        before = mon.counters()
        _replay(mon, monkeypatch)
        snap = mon.snapshot()
        del snap['ts']
        snaps.append(snap)
        proms.append(mon.export_prometheus())
        deltas.append(mon.counter_delta(before))
    assert snaps[1] == snaps[0]
    assert proms[1] == proms[0]
    assert deltas[1] == deltas[0]
    assert snaps[1]['counters']['monitor_series_dropped'] == 2
    assert snaps[1]['counters']['monitor_nonfinite_observations'] == 1
    assert 'kv_prefix_hit_total{other=true}' in snaps[1]['counters']
    assert monitor.hist_sum('executor_run_seconds') == \
        jmonitor.hist_sum('executor_run_seconds')


def test_timed_span_counts_and_span_ring_match():
    names = []
    for m in (JAX, PORT):
        mon = m['monitor']
        mon.clear_spans()
        with mon.timed_span('run', 'executor_run_seconds'):
            with mon.span('compile'):
                pass
        h = mon.snapshot()['histograms']['executor_run_seconds']
        assert h['count'] == 1
        names.append([s['name'] for s in mon.spans()])
    assert names[1] == names[0] == ['compile', 'run']


def _trace_run(m, log):
    """A sampled generate trace with stages, an event and a nested span,
    an unsampled error trace (keep-errors) and a step scope."""
    mon, tr = m['monitor'], m['trace']
    t = tr.start('generate')
    t.add_stage('queue', 0.01)
    t.add_stage('prefill', 0.02)
    t.add_stage('decode_step', 0.003, n=4)
    t.add_stage('decode_step', 0.004)
    t.event('note', step=3)
    with tr.activate(t):
        with mon.span('request.inner'):
            pass
        assert tr.current() is t
    rec = t.finish('ok', tokens=5)
    assert t.finish('error') is rec       # the first finish wins
    e = tr.start('step', sampled=False)
    e.finish('error', error=ValueError('bad feed'))
    with tr.step_scope('step') as st:
        assert st is not None and st.sampled
    return rec


def test_trace_records_and_report_equal_the_jax_trace(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv('PADDLE_TRACE_SAMPLE', 'all')
    recs, timings, logs = [], [], []
    for name, m in (('jax', JAX), ('port', PORT)):
        log = str(tmp_path / ('%s.jsonl' % name))
        monkeypatch.setenv('PADDLE_TRACE_LOG', log)
        rec = _trace_run(m, log)
        timings.append(sorted(m['trace'].flat_timing(rec)))
        recs.append({k: v for k, v in rec.items()
                     if k not in ('trace_id', 'ts', 'dur_s')})
        logs.append(log)
        assert [r['outcome'] for r in m['trace'].recent()] == \
            ['ok', 'error', 'ok']
    assert recs[1] == recs[0]
    assert timings[1] == timings[0]
    reads = [tracereport.read_records([p]) for p in logs]
    for (jt, je, jb), (pt, pe, pb) in [reads]:
        assert len(pt) == len(jt) == 3 and len(pe) == len(je) == 1
        assert [e['event'] for e in pe] == [e['event'] for e in je]
        jt_tab, pt_tab = tracereport.stage_table(jt), \
            tracereport.stage_table(pt)
        assert sorted(pt_tab) == sorted(jt_tab)
        for kind in jt_tab:
            assert pt_tab[kind]['n_by'] == jt_tab[kind]['n_by']
            assert sorted(pt_tab[kind]['stages']) == \
                sorted(jt_tab[kind]['stages'])
    outs = []
    for traces, _, _ in reads:
        import io
        buf = io.StringIO()
        tracereport.print_outcomes(traces, out=buf)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]


def _chrome(m, path):
    """Spans on two threads, one under a sampled trace, exported."""
    mon, prof, tr = m['monitor'], m['profiler'], m['trace']
    mon.clear_spans()
    with prof.record_event('outer'):
        with prof.record_event('inner'):
            pass
    t = tr.start('generate', sampled=True)

    def work():
        with tr.activate(t):
            with mon.span('worker.step'):
                with mon.span('worker.op'):
                    pass
    th = threading.Thread(target=work)
    th.start()
    th.join()
    with tr.activate(t):
        with mon.span('main.step'):
            pass
    t.finish('ok')
    mon.set_gauge('kv_blocks_in_use', 3.0)
    mon.set_gauge('step_mfu', 0.25)
    prof.export_chrome_tracing(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    by_sid = {e['args']['span_id']: e['name'] for e in events
              if e.get('ph') == 'X' and 'args' in e}
    nesting = sorted((e['name'], by_sid.get(e.get('args', {})
                                            .get('parent_id')))
                     for e in events if e.get('ph') == 'X')
    kinds = sorted((e['name'], e['ph']) for e in events)
    return nesting, kinds


def test_chrome_trace_names_and_nesting_equal_the_jax_profiler(tmp_path,
                                                               monkeypatch):
    monkeypatch.setenv('PADDLE_TRACE_SAMPLE', 'all')
    got = [_chrome(m, str(tmp_path / ('%s.json' % n)))
           for n, m in (('jax', JAX), ('port', PORT))]
    assert got[1] == got[0]
    nesting = dict(got[1][0])
    assert nesting['worker.op'] == 'worker.step'
    assert nesting['worker.step'] == 'generate'
    assert ('trace', 's') in got[1][1] and ('trace', 'f') in got[1][1]
    assert ('step_mfu', 'C') in got[1][1]


def test_profiler_session_exports_its_window(tmp_path):
    """``profiler()`` around spans: both packages export the session's
    spans; the port's torch.profiler session saw the record_event."""
    names = []
    for n, m in (('jax', JAX), ('port', PORT)):
        prof, mon = m['profiler'], m['monitor']
        mon.clear_spans()
        with mon.span('before'):
            pass
        path = str(tmp_path / ('%s.json' % n))
        with prof.profiler('All', profile_path=path):
            with prof.record_event('inside'):
                pass
        with open(path) as f:
            names.append(sorted(e['name']
                                for e in json.load(f)['traceEvents']))
    assert names[1] == names[0]
    keys = [e.key for e in profiler.last_session().key_averages()]
    assert 'inside' in keys


def test_every_series_the_port_emits_is_in_the_catalog():
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'paddle_tpu_torch')
    code, _ = obslint.collect_code_series(root=root)
    doc = obslint.collect_doc_series()
    assert len(code) > 40
    assert sorted(n for n in code if n not in doc) == []


# ---------------------------------------------------------------------------
# the Executor's and the predictor's counters


def _program(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = L.data(name='x', shape=[4], dtype='float32')
        y = L.data(name='y', shape=[1], dtype='float32')
        pred = L.fc(input=x, size=1)
        loss = L.mean(L.square_error_cost(input=pred, label=y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, pred, loss


def _feeds(n, seed):
    rs = np.random.RandomState(seed)
    return {'x': rs.randn(n, 4).astype('float32'),
            'y': rs.randn(n, 1).astype('float32')}


def _executor_counts(pkg, exe, mon, tmp):
    main, startup, pred, loss = _program(pkg)
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    before = mon.counters()
    fl = [loss]
    losses = [exe.run(main, feed=_feeds(4, s), fetch_list=fl, scope=scope)
              for s in range(3)]
    losses.append(exe.run(main, feed=_feeds(8, 3), fetch_list=fl,
                          scope=scope))
    bp = exe.bind(main, _feeds(4, 4), fetch_list=fl, scope=scope)
    losses += [bp(_feeds(4, s)) for s in (5, 6)]
    losses.append(exe.run_fused(main, [_feeds(8, s) for s in (7, 8, 9)],
                                fetch_list=fl, scope=scope))
    run_delta = mon.counter_delta(before)
    with pkg.scope_guard(scope):
        pkg.io.save_inference_model(tmp, ['x'], [pred], exe,
                                    main_program=main)
    cfg = pkg.inference.PredictorConfig(model_dir=tmp)
    if pkg is fluid:
        cfg.place = fluid.CPUPlace()
    predictor = pkg.inference.create_predictor(cfg)
    before = mon.counters()
    outs = [predictor.run({'x': _feeds(4, s)['x']}) for s in (10, 11)]
    return run_delta, mon.counter_delta(before), losses, outs


# what the port does not emit yet (the JAX executor's donation ledger),
# and the evictions of the JAX executor's process-wide cache, which the
# port does not keep, by name prefix: see executor.py's module docstring
_NOT_EMITTED = ('donation_', 'compile_persistent_cache',
                'compile_cache_eviction')


def test_executor_and_predictor_counters_equal_the_jax_executor(tmp_path):
    got = [_executor_counts(jfluid, jfluid.Executor(), jmonitor,
                            str(tmp_path / 'jax')),
           _executor_counts(fluid, fluid.Executor(fluid.CPUPlace()),
                            monitor, str(tmp_path / 'port'))]
    (jrun, jpred, jloss, jout), (trun, tpred, tloss, tout) = got

    def kept(d):
        return {k: v for k, v in d.items() if not k.startswith(_NOT_EMITTED)}
    assert kept(trun) == kept(jrun)
    assert kept(tpred) == kept(jpred)
    assert trun['executor_run_total'] == 5          # 4 runs and the bind
    assert trun['compile_cache_miss'] == 3         # 2 runs and the fused
    assert trun['compile_cache_hit'] == 3          # 2 runs and the bind
    assert trun['executor_bound_run_total'] == 2
    assert trun['executor_run_fused_total'] == 1
    # the rows of the runs, the bind's step and the fused batches (a
    # bound call's feed is staged, not prepared)
    assert trun['feed_host_bytes'] == (3 * 4 + 8 + 4 + 3 * 8) * 5 * 4
    assert tpred['predictor_run_total'] == 2
    assert len(tloss) == len(jloss) == 7
    assert all(np.isfinite(np.asarray(a[0])).all() for a in tloss)
    assert [np.shape(o[0]) for o in tout] == [np.shape(o[0]) for o in jout]
    spans = [s['name'] for s in monitor.spans()]
    assert 'predictor.run' in spans and 'run_fused' in spans
    assert 'compile' in spans


# ---------------------------------------------------------------------------
# the decode engines

V = 64
LM = dict(vocab_size=V, seq_len=32, d_model=32, n_head=2, n_layer=1,
          d_ff=64, dropout=0.0, attn_dropout=0.0, use_flash_attention=False)
ENGINE = dict(slots=4, max_len=48, prompt_buckets=[8, 16], seed=3)
PAGED = dict(paged=True, block_size=8, speculative=True, spec_k=2)
TRACKED = ('generate_request_total', 'decode_tokens_total', 'kv_',
           'spec_')
TIMING_KEYS = {'trace_id', 'total_s', 'outcome', 'queue_s', 'prefill_s',
               'decode_step_s', 'tokens', 'finish_reason', 'step_s_mean',
               'step_s_p99'}


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(2, V, size=n).astype('int64')


REQUESTS = [(_prompt(5, 1), 6, {}), (_prompt(11, 2), 5, {}),
            (_prompt(7, 3), 4, {'temperature': 0.8, 'top_k': 8,
                                'sample_seed': 11})]
PAGED_REQUESTS = [(_prompt(17, 4), 6, {}), (_prompt(17, 4), 5, {}),
                  (_prompt(9, 5), 7, {})]


def _serve(eng, requests, mon):
    before = mon.counters()
    with eng:
        reqs = [eng.submit(p, max_new_tokens=n, **kw)
                for p, n, kw in requests]
        outs = [r.result(60) for r in reqs]
    delta = {k: v for k, v in mon.counter_delta(before).items()
             if k.startswith(TRACKED)}
    return delta, outs


def test_engine_counters_timing_and_endpoint_equal_the_jax_engine():
    deltas = {}
    for name, extra, requests in (('contiguous', {}, REQUESTS),
                                  ('paged', PAGED, PAGED_REQUESTS)):
        jeng = JGenerateEngine(JGenerateConfig(model=JLMConfig(**LM),
                                               **dict(ENGINE, **extra)))
        jeng.warmup()
        s = jeng.scope
        params = {n: np.asarray(s.get(n)) for n in s.names()}
        jdelta, jouts = _serve(jeng, requests, jmonitor)
        eng = GenerateEngine(GenerateConfig(model=LMConfig(**LM),
                                            metrics_port=0,
                                            **dict(ENGINE, **extra)),
                             params=params, device='cpu')
        eng.warmup()
        before = monitor.counters()
        with eng:
            port = eng.metrics_port
            assert port
            reqs = [eng.submit(p, max_new_tokens=n, **kw)
                    for p, n, kw in requests]
            outs = [r.result(60) for r in reqs]
            base = 'http://127.0.0.1:%d' % port
            scrape = urllib.request.urlopen(base + '/metrics',
                                            timeout=10).read().decode()
            health = urllib.request.urlopen(base + '/healthz',
                                            timeout=10).read().decode()
        assert eng.metrics_port is None         # down with stop()
        tdelta = {k: v for k, v in monitor.counter_delta(before).items()
                  if k.startswith(TRACKED)}
        assert [list(o) for o in outs] == [list(o) for o in jouts]
        assert tdelta == jdelta, name
        deltas[name] = tdelta
        assert health.strip() == 'ok'
        for k, v in tdelta.items():
            series = k.replace('{', '{').split('{')[0]
            assert series in scrape, k
        assert 'decode_tokens_total %d' % (
            monitor.counters()['decode_tokens_total']) in scrape
        for o, jo in zip(outs, jouts):
            assert TIMING_KEYS <= set(o.timing), sorted(o.timing)
            assert set(o.timing) == set(jo.timing)
            stages = sum(v for k, v in o.timing.items()
                         if k.endswith('_s') and k not in (
                             'total_s', 'step_s_mean', 'step_s_p99'))
            assert stages <= o.timing['total_s'] + 1e-9
        st = eng.stats()
        assert st['goodput']['dispatches'] > 0
        assert set(st['goodput']['by_kind']) == {'bound'}
        _reset_all()
    assert deltas['contiguous']['generate_request_total{outcome=ok}'] == 3
    assert deltas['paged']['kv_prefix_hit_total{outcome=hit}'] == 1
    assert deltas['paged']['spec_propose_total'] > 0
