"""paddle_tpu_torch's fault-tolerance tier against the JAX package, on the
CPU: the ``FLAGS_*`` tier (flags.py), fault injection and retry
(resilience.py) through the Executor's ``compile`` and ``run`` sites, the
port's rule that a run which wrote state in place is never re-run, the
crc32 manifests and atomic writes (io.py's saves), and `TrainingGuard`.

(a) flags: the names, types and defaults equal the JAX package's; a
    failed side effect (an unwritable ``monitor_log``) raises and rolls
    every flag back; ``debug_nans`` raises at the backward that made a NaN.
(b) The fault grammar parses (or refuses) each spec as the JAX parser
    does, and each trigger fires on the same calls; the counters move as
    the reference's: retry to success, a permanent error and a fatal
    fault not retried, give-up after the attempts; injected ``compile``
    and ``run`` faults in the Executor (``run``, ``bind``, ``run_fused``)
    retried to the fault-free result, bitwise; a transient error after an
    in-place update is not retried; the CUDA taxonomy (out-of-memory
    transient, a sticky error permanent).
(c) The manifest of the same arrays equals the JAX package's (crc32
    included); io.py's saves publish atomically under a ``ckpt_write``
    fault (the counterpart of tests/test_resilience.py's
    ``test_save_vars_atomic_under_fault``).
(d) TrainingGuard: a NaN step is skipped with a bitwise rollback into the
    same tensors and training goes on to the JAX guard's losses (1e-5
    relative); the RNG run counter is rewound, so a guarded trajectory
    with a skipped step equals the clean one bitwise, dropout included
    (tests/test_health.py's ``test_guarded_rollback_replays_rng_bit_
    identical``); loss-scale backoff and growth; escalation after
    max_bad_steps with a NonFiniteError; composition with
    ``FLAGS_check_nan_inf`` and localization; the snapshot's bytes.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu import goodput as jgoodput
from paddle_tpu import health as jhealth
from paddle_tpu import monitor as jmonitor
from paddle_tpu import resilience as jres

import paddle_tpu_torch as fluid
from paddle_tpu_torch import flags, goodput, health, monitor, resilience

CPU = fluid.CPUPlace()


@pytest.fixture(scope='module', autouse=True)
def _reset_after():
    yield
    for m in (jgoodput, jmonitor, jhealth, goodput, monitor, health):
        m.reset()
    jres.clear_faults()
    resilience.clear_faults()


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """No fault spec and small backoffs (retries must not stall the
    suite)."""
    monkeypatch.delenv('PADDLE_FAULT_SPEC', raising=False)
    monkeypatch.setenv('PADDLE_RETRY_BASE_S', '0.001')
    monkeypatch.setenv('PADDLE_RETRY_MAX_S', '0.01')
    resilience.clear_faults()
    jres.clear_faults()
    yield
    resilience.clear_faults()
    jres.clear_faults()
    flags.set_flags({'check_nan_inf': False, 'debug_nans': False})


def _train_model(pkg, seed=5, dropout=0.0):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name='x', shape=[8], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='int64')
        h = pkg.layers.fc(x, size=16, act='relu')
        if dropout:
            h = pkg.layers.dropout(h, dropout)
        p = pkg.layers.fc(h, size=4, act='softmax')
        loss = pkg.layers.mean(pkg.layers.cross_entropy(p, y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return {'x': rng.randn(16, 8).astype('float32'),
            'y': rng.randint(0, 4, (16, 1)).astype('int64')}


def _bad(feed, value=np.nan):
    x = feed['x'].copy()
    x[0, 0] = value
    return dict(feed, x=x)


def _both_scopes(seed=5, dropout=0.0):
    """((jax main, startup, loss, exe, scope), (port ...)) from one init."""
    jm, js, jl = _train_model(jfluid, seed, dropout)
    je, jsc = jfluid.Executor(), jfluid.Scope()
    je.run(js, scope=jsc)
    tm, ts, tl = _train_model(fluid, seed, dropout)
    te, tsc = fluid.Executor(CPU), fluid.Scope()
    te.run(ts, scope=tsc)
    for n in jsc.names():
        if tsc.has(n):
            tsc.set(n, torch.from_numpy(np.asarray(jsc.get(n)).copy()).to(
                tsc.get(n).dtype))
    return (jm, js, jl, je, jsc), (tm, ts, tl, te, tsc)


def _state(scope):
    return {n: scope.get(n).detach().clone() for n in scope.names()
            if isinstance(scope.get(n), torch.Tensor)}


# ---------------------------------------------------------------------------
# (a) flags


def test_flags_names_types_and_defaults_equal_the_jax_package():
    mine, ref = flags.get_flags(), jflags.get_flags()
    assert sorted(mine) == sorted(ref)
    for n in ref:
        if n != 'monitor_log':
            assert type(mine[n]) is type(ref[n]) and mine[n] == ref[n], n
    assert flags.get_flags('FLAGS_benchmark') is False
    with pytest.raises(KeyError):
        flags.get_flags('no_such_flag')


def test_failed_side_effect_rolls_every_flag_back(tmp_path):
    bad = str(tmp_path / 'no_dir' / 'x.jsonl')
    with pytest.raises(OSError):
        flags.set_flags({'FLAGS_check_nan_inf': True,
                         'FLAGS_monitor_log': bad})
    assert flags.get_flags('check_nan_inf') is False
    assert flags.get_flags('monitor_log') == ''
    flags.set_flags('benchmark', 'yes')
    assert flags.get_flags('benchmark') is True
    flags.set_flags('benchmark', False)


def test_debug_nans_raises_at_the_backward_that_made_the_nan():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        z = fluid.layers.data(name='z', shape=[8], dtype='float32')
        h = fluid.layers.sqrt(fluid.layers.elementwise_mul(
            fluid.layers.fc(x, size=8), z))
        loss = fluid.layers.mean(h)
        fluid.optimizer.SGD(0.1).minimize(loss)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {'x': np.ones((2, 4), np.float32), 'z': np.zeros((2, 8),
                                                            np.float32)}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    flags.set_flags('debug_nans', True)
    with pytest.raises(RuntimeError, match='nan'):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


# ---------------------------------------------------------------------------
# (b) faults and retry


SPECS = ['compile:p=0.5', 'run:nth=3', 'run:n=2,kind=fatal',
         'ckpt_write:always;collective:every=4', ' run : nth=1 ',
         'run', 'run:often', 'run:kind=bad,always', 'run:nth=0',
         'run:p=x', 'run:always,junk']


@pytest.mark.parametrize('spec', SPECS)
def test_fault_spec_grammar_equals_the_jax_parser(spec):
    def parse(mod):
        try:
            rules = mod._parse_spec(spec)
        except ValueError as e:
            return 'ValueError', str(e)
        return {s: (r.mode, r.value, r.fatal) for s, r in rules.items()}
    assert parse(resilience) == parse(jres)


@pytest.mark.parametrize('spec', ['run:nth=3', 'run:n=2', 'run:every=3',
                                  'run:p=0.4', 'run:always'])
def test_fault_triggers_fire_on_the_jax_calls(spec, monkeypatch):
    monkeypatch.setenv('PADDLE_FAULT_SPEC', spec)
    monkeypatch.setenv('PADDLE_FAULT_SEED', '7')
    fired = []
    for mod in (jres, resilience):
        mod.clear_faults()
        seq = []
        for _ in range(12):
            try:
                mod.maybe_fault('run')
                seq.append(0)
            except mod.InjectedFault as e:
                seq.append(1 + (not e.transient))
        fired.append(seq)
    assert fired[0] == fired[1] and any(fired[1])


def test_retry_to_success_permanent_and_giveup_count_as_the_jax_layer():
    deltas = []
    for mod, mon in ((jres, jmonitor), (resilience, monitor)):
        before = mon.counters()
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError('connection reset')
            return 'ok'
        assert mod.retry_call(flaky, site='t') == 'ok'
        with pytest.raises(ValueError):
            mod.retry_call(lambda: (_ for _ in ()).throw(ValueError('x')),
                           site='t')
        with pytest.raises(ConnectionError):
            mod.retry_call(lambda: (_ for _ in ()).throw(
                ConnectionError('reset')), site='t',
                policy=mod.RetryPolicy(max_attempts=3, base_delay_s=0.0))
        deltas.append({k: v for k, v in mon.counter_delta(before).items()
                       if k.startswith('retry_') and k.endswith('{site=t}')})
    assert deltas[0] == deltas[1]
    assert deltas[1]['retry_attempt_total{site=t}'] == 4


def test_cuda_errors_transient_out_of_memory_permanent_sticky():
    assert resilience.is_transient(torch.cuda.OutOfMemoryError('oom'))
    assert not resilience.is_transient(RuntimeError(
        'CUDA error: an illegal memory access was encountered'))
    assert not resilience.is_transient(RuntimeError(
        'CUDA error: unspecified launch failure (UNAVAILABLE)'))
    assert resilience.is_transient(RuntimeError('UNAVAILABLE: retry'))
    assert not resilience.is_transient(ValueError('shape mismatch'))


@pytest.mark.parametrize('site,how', [('compile', 'run'), ('run', 'run'),
                                      ('run', 'bind'),
                                      ('run', 'run_fused')])
def test_injected_faults_are_retried_to_the_fault_free_result(
        site, how, monkeypatch):
    feeds = [_data(i) for i in range(3)]

    def train(spec):
        main, startup, loss = _train_model(fluid, dropout=0.3)
        exe, scope = fluid.Executor(CPU), fluid.Scope()
        exe.run(startup, scope=scope)
        if spec:
            monkeypatch.setenv('PADDLE_FAULT_SPEC', spec)
        resilience.clear_faults()
        if how == 'run':
            out = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                   for f in feeds]
        elif how == 'bind':
            bp = exe.bind(main, feeds[0], fetch_list=[loss], scope=scope)
            out = [bp.first_out[0]] + [bp(f)[0] for f in feeds[1:]]
        else:
            out = [exe.run_fused(main, [f], fetch_list=[loss],
                                 scope=scope)[0] for f in feeds]
        monkeypatch.delenv('PADDLE_FAULT_SPEC', raising=False)
        return out, _state(scope)

    want, wstate = train(None)
    before = monitor.counters()
    got, gstate = train('%s:n=2' % site)
    delta = monitor.counter_delta(before)
    assert delta.get('retry_attempt_total{site=%s}' % site) == 2, delta
    assert delta.get('fault_injected_total{site=%s}' % site) == 2
    assert 'retry_giveup_total{site=%s}' % site not in delta
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    for n in wstate:
        assert torch.equal(gstate[n], wstate[n]), n


def test_fatal_fault_is_not_retried(monkeypatch):
    main, startup, loss = _train_model(fluid)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_data(), fetch_list=[loss], scope=scope)
    monkeypatch.setenv('PADDLE_FAULT_SPEC', 'run:always,kind=fatal')
    before = monitor.counters()
    with pytest.raises(resilience.InjectedFault, match='fatal'):
        exe.run(main, feed=_data(), fetch_list=[loss], scope=scope)
    delta = monitor.counter_delta(before)
    assert 'retry_attempt_total{site=run}' not in delta
    assert delta['fault_injected_total{site=run}'] == 1


def test_a_run_that_wrote_state_in_place_is_not_retried(monkeypatch):
    """A transient error raised after the SGD update wrote the weights in
    place: the state is half-updated, so the run is not re-run (the
    reference's donated-buffer give-up, reason ``written``)."""
    from paddle_tpu_torch.core.registry import get_op
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[8], dtype='float32')
        loss = fluid.layers.mean(fluid.layers.fc(
            x, size=1, param_attr=fluid.ParamAttr(name='w')))
        fluid.optimizer.SGD(0.1).minimize(loss)
        after = fluid.layers.scale(main.global_block().var('w'), scale=2.0)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {'x': np.ones((2, 8), np.float32)}
    exe.run(main, feed=feed, fetch_list=[after], scope=scope)
    w0 = scope.get('w').clone()
    d = get_op('scale')
    lower = d.lower

    def flaky(ctx, op):
        raise RuntimeError('UNAVAILABLE: a transient failure')
    monkeypatch.setattr(d, 'lower', flaky)
    before = monitor.counters()
    with pytest.raises(RuntimeError, match='written state in place'):
        exe.run(main, feed=feed, fetch_list=[after], scope=scope)
    monkeypatch.setattr(d, 'lower', lower)
    delta = monitor.counter_delta(before)
    assert delta['retry_giveup_total{site=run}'] == 1
    assert 'retry_attempt_total{site=run}' not in delta, delta
    assert not torch.equal(scope.get('w'), w0)       # the half-update


# ---------------------------------------------------------------------------
# (c) manifests and atomic saves


def test_manifest_equals_the_jax_package():
    rs = np.random.RandomState(0)
    arrays = {'a': rs.randn(3, 4).astype('float32'),
              'b': rs.randint(0, 9, (5,)).astype('int64')}
    mine = resilience.build_manifest(
        {k: torch.from_numpy(v) for k, v in arrays.items()}, step=3)
    assert mine == jres.build_manifest(arrays, step=3)
    assert resilience.verify_manifest(mine, arrays) == []
    bad = dict(arrays, a=arrays['a'] + 1)
    assert resilience.verify_manifest(mine, bad) == ['a']


def test_save_vars_atomic_under_fault(tmp_path, monkeypatch):
    """io.save_persistables publishes atomically: a mid-write fault leaves
    the previous file intact and no temporary file behind."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        w = fluid.layers.create_global_var([4], value=0.0, dtype='float32',
                                           persistable=True, name='res_w')
        fluid.layers.increment(w)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    d = str(tmp_path / 'params')
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        fluid.io.save_persistables(exe, d, main, filename='params')
        first = np.load(os.path.join(d, 'params.npz'))['res_w'].copy()
        exe.run(main, scope=scope)
        monkeypatch.setenv('PADDLE_FAULT_SPEC', 'ckpt_write:always')
        resilience.clear_faults()
        with pytest.raises(resilience.InjectedFault):
            fluid.io.save_persistables(exe, d, main, filename='params')
        with pytest.raises(resilience.InjectedFault):
            fluid.io.save_persistables(exe, d, main)
        monkeypatch.delenv('PADDLE_FAULT_SPEC')
        resilience.clear_faults()
    assert sorted(os.listdir(d)) == ['params.npz']
    np.testing.assert_array_equal(
        np.load(os.path.join(d, 'params.npz'))['res_w'], first)


# ---------------------------------------------------------------------------
# (d) TrainingGuard


def test_nonfinite_step_skipped_bitwise_and_training_goes_on_as_jax():
    (jm, _, jl, je, jsc), (tm, _, tl, te, tsc) = _both_scopes()
    feed = _data()
    losses = []
    for pkg, main, loss, exe, scope in ((jfluid, jm, jl, je, jsc),
                                        (fluid, tm, tl, te, tsc)):
        guard = pkg.TrainingGuard(exe, main, loss_name=loss.name,
                                  scope=scope, max_bad_steps=3)
        guard.step(feed=feed, fetch_list=[loss])
        if pkg is fluid:
            held = {n: scope.get(n) for n in scope.names()}
            pre = _state(scope)
        guard.step(feed=_bad(feed), fetch_list=[loss])
        assert guard.last_step_skipped and guard.total_skipped == 1
        if pkg is fluid:
            for n, t in pre.items():
                assert scope.get(n) is held[n] and torch.equal(t, held[n]), n
            assert guard.snapshot_bytes == sum(
                t.nbytes for n, t in pre.items()
                if n in guard._written_names())
        losses.append([float(np.asarray(guard.step(
            feed=feed, fetch_list=[loss])[0]).reshape(())) for _ in range(4)])
        assert guard.bad_steps == 0
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert losses[1][-1] < losses[1][0]


def test_guarded_rollback_replays_rng_bit_identical():
    feeds = [_data(i) for i in range(4)]

    def run(inject):
        main, startup, loss = _train_model(fluid, seed=11, dropout=0.5)
        exe, scope = fluid.Executor(CPU), fluid.Scope()
        exe.run(startup, scope=scope)
        guard = fluid.TrainingGuard(exe, main, loss_name=loss.name,
                                    scope=scope, max_bad_steps=5)
        out = [guard.step(feed=feeds[0], fetch_list=[loss])[0]]
        if inject:
            guard.step(feed=_bad(feeds[0]), fetch_list=[loss])
            assert guard.last_step_skipped
        out += [guard.step(feed=f, fetch_list=[loss])[0] for f in feeds[1:]]
        return out, _state(scope), main._rng_run_counter

    clean, cstate, cruns = run(False)
    guarded, gstate, gruns = run(True)
    assert cruns == gruns
    assert [c.tolist() for c in clean] == [g.tolist() for g in guarded]
    for n in cstate:
        assert torch.equal(cstate[n], gstate[n]), n


def test_training_guard_loss_scale_backoff_and_growth():
    main, startup, loss = _train_model(fluid)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    scope.set('loss_scaling', np.float32(1024.0))
    guard = fluid.TrainingGuard(exe, main, loss_name=loss.name, scope=scope,
                                max_bad_steps=5,
                                loss_scale_name='loss_scaling',
                                backoff_factor=0.5, growth_interval=2)
    guard.step(feed=_bad(_data(), np.inf), fetch_list=[loss])
    assert float(np.asarray(scope.get('loss_scaling'))) == 512.0
    guard.step(feed=_data(), fetch_list=[loss])
    guard.step(feed=_data(), fetch_list=[loss])
    assert float(np.asarray(scope.get('loss_scaling'))) == 1024.0


def test_nonfinite_escalates_after_max_bad_steps():
    main, startup, loss = _train_model(fluid)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    guard = fluid.TrainingGuard(exe, main, loss_name=loss.name, scope=scope,
                                max_bad_steps=2)
    bad = _data()
    bad['x'][:] = np.nan
    before = monitor.counters()
    guard.step(feed=bad, fetch_list=[loss])
    assert guard.bad_steps == 1
    with pytest.raises(resilience.NonFiniteError, match='consecutive'):
        guard.step(feed=bad, fetch_list=[loss])
    delta = monitor.counter_delta(before)
    assert delta['nonfinite_skip_total'] == 2
    assert delta['nonfinite_escalate_total'] == 1


def test_guard_composes_with_check_nan_inf_and_localization(monkeypatch):
    """FLAGS_check_nan_inf raises inside the executor; the guard treats it
    as a bad step, rolls back, and keeps the executor's localization,
    which names the op the JAX guard names."""
    monkeypatch.setenv('PADDLE_NAN_LOCALIZE', '1')
    (jm, _, jl, je, jsc), (tm, _, tl, te, tsc) = _both_scopes()
    feed = _data()
    locs = []
    jfluid.set_flags({'FLAGS_check_nan_inf': True})
    flags.set_flags({'FLAGS_check_nan_inf': True})
    try:
        for pkg, main, loss, exe, scope in ((jfluid, jm, jl, je, jsc),
                                            (fluid, tm, tl, te, tsc)):
            guard = pkg.TrainingGuard(exe, main, loss_name=loss.name,
                                      scope=scope, max_bad_steps=3)
            guard.step(feed=feed, fetch_list=[loss])
            w_pre = np.asarray(scope.get('fc_0.w_0')).copy()
            out = guard.step(feed=_bad(feed), fetch_list=[loss])
            assert guard.last_step_skipped and np.isnan(out[0]).all()
            assert np.array_equal(np.asarray(scope.get('fc_0.w_0')), w_pre)
            loc = guard.last_localization
            locs.append((loc['op_index'], loc['op_type'],
                         loc['bad_outputs']))
    finally:
        jfluid.set_flags({'FLAGS_check_nan_inf': False})
    assert locs[0] == locs[1] and locs[1][1] == 'mul'
