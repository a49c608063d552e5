"""paddle_tpu_torch's training-health tier against the JAX package, on the
CPU: the aliasing rule of core/lowering.py, the ``health_stats`` op,
``health.instrument`` and the detector bank, NaN localization, the replay
CLI (tools/torch_blackbox.py) and the JAX package's tools/healthreport.py
over the port's ``FLAGS_monitor_log``.

Inputs are made from a seed with numpy; the port's scope takes the JAX
scope's initial arrays, so both packages start from one state.

(a) A copy of a parameter taken before ``minimize`` through an op whose
    lowering can return its input or a view (assign, a cast to the same
    dtype, reshape, transpose, squeeze after unsqueeze, flatten, slice,
    scale by 1) is the parameter before the step's update, as in the JAX
    executor: the port's ``run()``, ``bind`` calls and ``run_fused``
    windows against the JAX ``run()`` at the state limits (rtol 1e-5,
    atol 1e-6; the update it must not show is lr * gradient, O(0.1)).
(b) The stat vector of an instrumented step equals the JAX op's for the
    same program, state and feeds: the counts exactly, the norms, ratios
    and the loss within 1e-4 relative (each a float32 sum in another
    order); for an MLP, an ``is_sparse`` embedding (a SelectedRows
    gradient, reduced over its values) and the LM with its activation
    taps; ``instrument``'s program dict and schema equal the JAX
    package's; every update ratio of a step after the first is above 0.
(c) The detector bank gives the JAX bank's verdicts and counter deltas
    step for step on the same crafted stat sequences (held against the
    reference's live outputs, not its tests' thresholds).
(d) ``FLAGS_check_nan_inf`` with ``PADDLE_NAN_LOCALIZE=1`` names the same
    variables and localizes to the same op (index, type, outputs) as the
    JAX executor for a forward culprit (a scale overflow) and a backward
    one (sqrt's gradient at 0: the ``backward`` op); ``localize_from_scope``
    leaves the scope bitwise unchanged.
(e) The replay CLI prints REPRODUCED for a port bundle and for a JAX
    bundle of a program that draws nothing.
(f) tools/healthreport.py reads the port's FLAGS_monitor_log.
"""
import io
import contextlib
import json
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import blackbox as jblackbox
from paddle_tpu import goodput as jgoodput
from paddle_tpu import health as jhealth
from paddle_tpu import monitor as jmonitor
from paddle_tpu import resilience as jresilience
from paddle_tpu.core import serialization as jser

import paddle_tpu_torch as fluid
from paddle_tpu_torch import analysis, blackbox, flags, goodput, health
from paddle_tpu_torch import monitor, resilience
from paddle_tpu_torch.core import serialization as tser

CPU = fluid.CPUPlace()
RTOL = 1e-4


@pytest.fixture(scope='module', autouse=True)
def _reset_after():
    """The JAX executor arms process-wide goodput sentinels and both
    packages keep process-wide monitors, health state and faults: leave
    them as they were found."""
    yield
    for m in (jgoodput, jmonitor, jhealth, goodput, monitor, health):
        m.reset()
    jresilience.clear_faults()
    resilience.clear_faults()


@pytest.fixture(autouse=True)
def _fresh_health():
    jhealth.reset()
    health.reset()
    yield
    jhealth.reset()
    health.reset()
    jfluid.set_flags('check_nan_inf', False)
    flags.set_flags('check_nan_inf', False)


def _port_scope(jscope, startup):
    """A port scope holding the JAX scope's arrays (after the port's own
    startup run, for anything the JAX scope lacks)."""
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    for n in jscope.names():
        v = np.asarray(jscope.get(n))
        if scope.has(n):
            t = torch.from_numpy(v.copy())
            if t.dtype != scope.get(n).dtype:
                t = t.to(scope.get(n).dtype)
            scope.set(n, t)
    return scope


def _arrays(scope):
    return {n: (v.detach().clone() if isinstance(v, torch.Tensor)
                else np.array(v)) for n in scope.names()
            for v in [scope.get(n)] if hasattr(v, 'shape')}


# ---------------------------------------------------------------------------
# (a) the aliasing rule

ALIAS_KINDS = ['assign', 'cast', 'reshape', 'transpose', 'squeeze',
               'flatten', 'slice', 'scale']


def _alias_program(pkg, kind):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        y = pkg.layers.fc(x, size=3, param_attr=pkg.ParamAttr(name='w'),
                          bias_attr=False)
        w = main.global_block().var('w')
        L = pkg.layers
        copy = {'assign': lambda: L.assign(w),
                'cast': lambda: L.cast(w, 'float32'),
                'reshape': lambda: L.reshape(w, shape=[12]),
                'transpose': lambda: L.transpose(w, perm=[1, 0]),
                'squeeze': lambda: L.squeeze(L.unsqueeze(w, axes=[0]),
                                             axes=[0]),
                'flatten': lambda: L.flatten(w, axis=1),
                'slice': lambda: L.slice(w, axes=[0], starts=[1],
                                         ends=[3]),
                'scale': lambda: L.scale(w, scale=1.0)}[kind]()
        loss = L.mean(y)
        pkg.optimizer.SGD(1.0).minimize(loss)
    return main, startup, copy


_ALIAS_FEEDS = [{'x': np.random.RandomState(i).randn(2, 4)
                 .astype('float32')} for i in range(3)]
_jax_alias = {}


def _jax_alias_run(kind):
    """(init arrays, the copy's value at each of 3 JAX run() steps)."""
    if kind not in _jax_alias:
        main, startup, copy = _alias_program(jfluid, kind)
        exe, scope = jfluid.Executor(), jfluid.Scope()
        exe.run(startup, scope=scope)
        init = {n: np.asarray(scope.get(n)).copy() for n in scope.names()}
        vals = [np.asarray(exe.run(main, feed=f, fetch_list=[copy],
                                   scope=scope)[0]).copy()
                for f in _ALIAS_FEEDS]
        _jax_alias[kind] = (init, vals)
    return _jax_alias[kind]


@pytest.mark.parametrize('how', ['run', 'bind', 'run_fused'])
@pytest.mark.parametrize('kind', ALIAS_KINDS)
def test_copy_of_a_parameter_taken_before_minimize_is_the_pre_update_value(
        kind, how):
    init, want = _jax_alias_run(kind)
    main, startup, copy = _alias_program(fluid, kind)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    for n, v in init.items():
        scope.set(n, torch.from_numpy(v.copy()))
    if how == 'run':
        got = [exe.run(main, feed=f, fetch_list=[copy], scope=scope)[0]
               for f in _ALIAS_FEEDS]
    elif how == 'bind':
        bp = exe.bind(main, _ALIAS_FEEDS[0], fetch_list=[copy], scope=scope)
        got = [bp.first_out[0]] + [bp(f)[0] for f in _ALIAS_FEEDS[1:]]
    else:
        got = [exe.run_fused(main, [f], fetch_list=[copy], scope=scope)[0]
               for f in _ALIAS_FEEDS]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    # the update the copy must not show is O(0.1)
    assert np.abs(got[1] - got[0]).max() > 1e-3


def test_alias_checks_are_planned_only_where_an_update_follows():
    """The rule is decided once per plan: a program with no in-place
    writer checks nothing, and a training step checks only the ops whose
    outputs are read after the update (the copy and the fetched loss)."""
    from paddle_tpu_torch.core import lowering
    main, _, copy = _alias_program(fluid, 'assign')
    _, written = lowering.analyze_state(main, [copy.name])
    _, plan = lowering.build_fn(main, [copy.name], ['w', 'learning_rate_0'],
                                written, torch.device('cpu'))
    checked = sorted(n for names, _ in plan.alias_checks.values()
                     for n in names)
    assert checked == [copy.name] and 'w' in plan.inplace_names
    infer, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(infer, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        fluid.layers.fc(x, size=3, param_attr=fluid.ParamAttr(name='w'))
        copy = fluid.layers.assign(infer.global_block().var('w'))
    _, plan = lowering.build_fn(infer, [copy.name], ['w'], [],
                                torch.device('cpu'))
    assert plan.alias_checks == {} and plan.inplace_names == ()


# ---------------------------------------------------------------------------
# (b) health_stats and instrument against the JAX package


def _mlp(pkg, dropout=0.0, sparse=False):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if sparse:
            ids = pkg.layers.data(name='ids', shape=[3], dtype='int64')
            emb = pkg.layers.embedding(pkg.layers.reshape(ids, [-1, 3, 1]),
                                       size=[20, 4], is_sparse=True)
            h = pkg.layers.reshape(emb, [-1, 12])
        else:
            h = pkg.layers.data(name='x', shape=[12], dtype='float32')
        h = pkg.layers.fc(h, size=16, act='relu')
        if dropout:
            h = pkg.layers.dropout(h, dropout)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(h, size=1),
            pkg.layers.data(name='y', shape=[1], dtype='float32')))
        pkg.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss


def _mlp_feeds(n, sparse=False, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = {'y': rs.randn(8, 1).astype('float32')}
        if sparse:
            f['ids'] = rs.randint(0, 20, (8, 3)).astype('int64')
        else:
            f['x'] = rs.randn(8, 12).astype('float32')
        out.append(f)
    return out


def _lm(pkg):
    from paddle_tpu.models import transformer as jt
    from paddle_tpu_torch.models import transformer as tt
    tmod = jt if pkg is jfluid else tt
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, loss = tmod.build_lm(tmod.LMConfig(
            vocab_size=64, seq_len=8, d_model=32, n_head=2, n_layer=2,
            d_ff=64, dropout=0.0, attn_dropout=0.0,
            use_flash_attention=False))
        pkg.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def _lm_feeds(n):
    rs = np.random.RandomState(3)
    return [{k: rs.randint(0, 64, (2, 8)).astype('int64')
             for k in ('tokens', 'labels')} for _ in range(n)]


MODELS = {'mlp': (lambda pkg: _mlp(pkg), lambda: _mlp_feeds(2)),
          'sparse': (lambda pkg: _mlp(pkg, sparse=True),
                     lambda: _mlp_feeds(2, sparse=True)),
          'lm': (_lm, lambda: _lm_feeds(2))}


@pytest.mark.parametrize('model', sorted(MODELS))
def test_health_stats_equal_the_jax_op(model):
    build, feeds = MODELS[model]
    feeds = feeds()
    jmain, jstart, jloss = build(jfluid)
    jsch = jhealth.instrument(jmain, jloss.name)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    tmain, tstart, tloss = build(fluid)
    tsch = health.instrument(tmain, tloss.name)
    assert tsch == jsch
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    tscope = _port_scope(jscope, tstart)
    texe = fluid.Executor(CPU)
    kinds = [k for k, _ in tsch['entries']]
    for step, f in enumerate(feeds):
        want = np.asarray(jexe.run(jmain, feed=f, fetch_list=[
            jhealth.FETCH_NAME], scope=jscope)[0], np.float64)
        got = texe.run(tmain, feed=f, fetch_list=[health.FETCH_NAME],
                       scope=tscope)[0].astype(np.float64)
        assert got.shape == want.shape == (len(kinds),)
        for k, g, w in zip(tsch['entries'], got, want):
            if k[0] in ('nonfinite', 'large'):
                assert g == w, (step, k)
            else:
                assert abs(g - w) <= RTOL * max(abs(w), 1e-30), \
                    (step, k, g, w)
        if step:
            ratios = got[[i for i, k in enumerate(kinds) if k ==
                          'upd_ratio']]
            assert (ratios > 0).all(), ratios


def test_health_stats_reduce_a_selected_rows_gradient_over_its_values():
    """The ``health_stats`` function on a SelectedRows gradient: its
    values, duplicates unmerged, as the JAX op reduces them."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.ops.health_ops import health_stats
    rs = np.random.RandomState(0)
    vals = torch.from_numpy(rs.randn(5, 4).astype('float32'))
    vals[2, 1] = float('inf')
    vals[3, 0] = 2e3
    g = SelectedRows(torch.tensor([1, 3, 1, 0, 3]), vals, 6)
    p = torch.from_numpy(rs.randn(6, 4).astype('float32'))
    out = health_stats([g], [p], [p * 0.5], [], None, 1e3).numpy()
    # [grad norm, update ratio, global grad norm, global param norm,
    #  non-finite entries, entries past 1e3]
    assert out[0] == np.inf and out[2] == np.inf
    np.testing.assert_allclose(out[1], 1.0, rtol=1e-6)   # ||p - p/2|| / ||p/2||
    assert out[4] == 1 and out[5] == 2


# ---------------------------------------------------------------------------
# (c) the detector bank

def _stub(pkg_health, uid):
    entries = [('grad_norm', 'p0'), ('upd_ratio', 'p0'),
               ('act_rms', 'site0'), ('grad_norm_global', ''),
               ('param_norm_global', ''), ('nonfinite', ''), ('large', ''),
               ('loss', '')]
    sch = {'fetch': pkg_health.FETCH_NAME, 'entries': entries,
           'params': ['p0'], 'acts': ['site0'], 'loss': 'loss'}
    return types.SimpleNamespace(_uid=uid, _health_schema=sch)


def _series(kind):
    """A crafted stat sequence: 8 baseline steps, then the kind's; (grad,
    ratio, loss, nonfinite) a step."""
    base = [(1.0, 1e-3, 2.0, 0.0)] * 8
    return base + {
        'explosion': [(1.0, 1e-3, 2.0, 0.0), (20.0, 1e-3, 2.0, 0.0),
                      (30.0, 1e-3, 2.5, 0.0)] + [(1.0, 1e-3, 2.0, 0.0)] * 3,
        'vanish': [(1e-4, 1e-3, 2.0, 0.0)] * 16,
        'loss_spike': [(1.0, 1e-3, 9.0, 0.0)] * 2 + [(1.0, 1e-3, 2.0, 0.0)]
        * 4,
        'ratio_drift': [(1.0, 0.5, 2.0, 0.0)] * 6,
        'nonfinite': [(float('nan'), 1e-3, float('nan'), 3.0)] +
        [(1.0, 1e-3, 2.0, 0.0)] * 5}[kind]


@pytest.mark.parametrize('kind', ['explosion', 'vanish', 'loss_spike',
                                  'ratio_drift', 'nonfinite'])
def test_detector_bank_trips_as_the_jax_bank(kind, monkeypatch):
    monkeypatch.setenv('PADDLE_HEALTH_COOLDOWN_S', '0')
    got = []
    for pkg_health, mon in ((jhealth, jmonitor), (health, monitor)):
        pkg_health.reset()
        prog = _stub(pkg_health, 4242)
        before = mon.counters()
        verdicts = []
        for grad, ratio, loss, nonfinite in _series(kind):
            vec = np.array([grad, ratio, 1.0, grad, 10.0, nonfinite, 0.0,
                            loss], np.float32)
            verdicts.append(pkg_health.observe(prog, vec))
        delta = {k: v for k, v in mon.counter_delta(before).items()
                 if k.startswith('health_')}
        st = pkg_health.stats(prog)
        got.append((verdicts, delta, [a['kind'] for a in st['anomalies']],
                    st['steps']))
    assert got[0] == got[1]
    assert any(got[1][0]), got[1]


def test_goodput_nests_the_health_view():
    assert goodput.stats()['health'] is None
    health.observe(_stub(health, 99), np.ones(8, np.float32))
    assert goodput.stats()['health']['steps'] == 1


# ---------------------------------------------------------------------------
# (d) FLAGS_check_nan_inf and NaN localization against the JAX executor


def _culprit(pkg, where):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        z = pkg.layers.data(name='z', shape=[8], dtype='float32')
        h = pkg.layers.fc(x, size=8)
        if where == 'forward':
            h = pkg.layers.scale(pkg.layers.scale(h, scale=1e20),
                                 scale=1e20)
        else:
            # finite forward (sqrt(0) = 0), infinite gradient at 0
            h = pkg.layers.sqrt(pkg.layers.elementwise_mul(h, z))
        loss = pkg.layers.mean(h)
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize('where', ['forward', 'backward'])
def test_localization_names_the_jax_op_and_leaves_the_scope(where,
                                                             monkeypatch):
    monkeypatch.setenv('PADDLE_NAN_LOCALIZE', '1')
    feed = {'x': np.random.RandomState(1).randn(3, 4).astype('float32'),
            'z': np.zeros((3, 8), np.float32)}
    jmain, jstart, jloss = _culprit(jfluid, where)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    tmain, tstart, tloss = _culprit(fluid, where)
    tscope = _port_scope(jscope, tstart)
    before = _arrays(tscope)
    texe = fluid.Executor(CPU)
    info = analysis.localize_from_scope(texe, tmain, feed, tscope, None)
    after = _arrays(tscope)
    assert sorted(before) == sorted(after)
    for n in before:
        assert torch.equal(torch.as_tensor(before[n]),
                           torch.as_tensor(after[n])), n
    jfluid.set_flags('check_nan_inf', True)
    flags.set_flags('check_nan_inf', True)
    errs = []
    for exe, main, loss, scope in ((jexe, jmain, jloss, jscope),
                                   (texe, tmain, tloss, tscope)):
        with pytest.raises(RuntimeError, match='NaN/Inf') as e:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        errs.append(e.value)
    jinfo, tinfo = (getattr(e, 'nonfinite_localization') for e in errs)
    key = lambda i: (i['op_index'], i['op_type'], i['bad_outputs'])
    assert key(tinfo) == key(jinfo) == key(info)
    assert (tinfo['op_type'] == 'scale') == (where == 'forward')
    assert str(errs[1]).split(';')[0] == str(errs[0]).split(';')[0]


@pytest.mark.parametrize('how', ['run', 'bind', 'run_fused'])
def test_check_nan_inf_names_the_jax_variables(how):
    """A poisoned step (the scale overflow: NaN gradients, NaN weights)
    under ``run()``, a bound call and a ``run_fused`` window names the
    variables the JAX ``run()`` names."""
    good = {'x': np.random.RandomState(2).randn(3, 4).astype('float32'),
            'z': np.zeros((3, 8), np.float32)}
    bad = dict(good, x=good['x'] * 1e10)
    jmain, jstart, jloss = _culprit(jfluid, 'forward')
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    tmain, tstart, tloss = _culprit(fluid, 'forward')
    tscope = _port_scope(jscope, tstart)
    texe = fluid.Executor(CPU)
    jfluid.set_flags('check_nan_inf', True)
    flags.set_flags('check_nan_inf', True)
    with pytest.raises(RuntimeError, match='NaN/Inf') as je:
        jexe.run(jmain, feed=bad, fetch_list=[jloss], scope=jscope)
    with pytest.raises(RuntimeError, match='NaN/Inf') as te:
        if how == 'run':
            texe.run(tmain, feed=bad, fetch_list=[tloss], scope=tscope)
        elif how == 'bind':
            flags.set_flags('check_nan_inf', False)
            bp = texe.bind(tmain, good, fetch_list=[tloss], scope=tscope)
            flags.set_flags('check_nan_inf', True)
            bp(bad)
        else:
            texe.run_fused(tmain, [good, bad, good], fetch_list=[tloss],
                           scope=tscope)
    names = lambda e: str(e.value).split(' after ')[0]
    assert names(te) == names(je)


# ---------------------------------------------------------------------------
# (e) the replay CLI


def _cli(*argv):
    from tools import torch_blackbox
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            torch_blackbox.main(list(argv))
        except SystemExit as e:
            if e.code:
                raise
    return out.getvalue()


@pytest.mark.parametrize('source', ['port', 'jax'])
def test_replay_cli_reproduces_a_bundle(source, tmp_path, monkeypatch):
    d = str(tmp_path / 'bb')
    for k, v in (('PADDLE_BLACKBOX', '1'), ('PADDLE_BLACKBOX_DIR', d),
                 ('PADDLE_BLACKBOX_RATE', '0'),
                 ('PADDLE_NAN_LOCALIZE', '1')):
        monkeypatch.setenv(k, v)
    pkg, res, bb = (fluid, resilience, blackbox) if source == 'port' else \
        (jfluid, jresilience, jblackbox)
    bb.reset()
    try:
        main, startup, loss = _culprit(pkg, 'forward')
        exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        guard = res.TrainingGuard(exe, main, loss_name=loss.name,
                                  scope=scope, max_bad_steps=1)
        with pytest.raises(res.NonFiniteError):
            guard.step(feed={'x': np.ones((2, 4), np.float32),
                             'z': np.ones((2, 8), np.float32)},
                       fetch_list=[loss])
        assert guard.last_localization['op_type'] == 'scale'
        bb.flush(30.0)
        bundles = bb.bundles(d)
    finally:
        bb.reset()
    assert len(bundles) == 1
    listed = _cli('list', d)
    assert 'nonfinite_escalate' in listed and '1 bundle(s)' in listed
    assert 'localization:' in _cli('show', bundles[0])
    out = _cli('replay', bundles[0], '--device', 'cpu')
    assert "type='scale'" in out and '-> REPRODUCED' in out, out
    if source == 'jax':
        assert 'foreign' in out


# ---------------------------------------------------------------------------
# (f) tools/healthreport.py over the port's FLAGS_monitor_log


def test_healthreport_reads_the_port_monitor_log(tmp_path):
    from tools import healthreport
    log = str(tmp_path / 'run.jsonl')
    flags.set_flags('monitor_log', log)
    try:
        main, startup, loss = _mlp(fluid)
        exe, scope = fluid.Executor(CPU), fluid.Scope()
        exe.run(startup, scope=scope)
        guard = resilience.TrainingGuard(exe, main, loss_name=loss.name,
                                         scope=scope, health='watch')
        for f in _mlp_feeds(3):
            guard.step(feed=f, fetch_list=[loss])
        monitor.log_snapshot(log)
    finally:
        flags.set_flags('monitor_log', '')
    assert flags.get_flags('monitor_log') == ''
    snaps, events, bundles = healthreport.read_log(log)
    rep = healthreport.report_from_logs([snaps], events, bundles)
    rows = {r['label'] for r in rep['grad_norms']}
    assert {p.name for p in main.all_parameters()} <= rows
    assert rep['global']['health_loss'] > 0
    with open(log) as f:
        assert json.loads(f.readline())
