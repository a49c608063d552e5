"""`Executor.bind` and `Executor.run_fused` of paddle_tpu_torch, the bounded
plan cache and the `io` save and load functions, on the CPU.

On the CPU a bound plan runs eagerly through the same staging as on the
card (the static feeds, the state check, the re-seeding of its own
generators, the static fetch copies), so what holds here holds for the
card's plumbing; the card's graphs are held in tests/test_torch_cuda.py
and chip_smoke.py.

(a) Against the port's own ``run()``, bitwise: a seeded LM program with
    dropout 0.1 (2 layers, d 64, V 128, L 16, B 4) over 6 steps through
    ``bind`` and its calls, through ``run_fused`` over K batches, with
    ``steps=`` cycling them and over two calls; the dropout mask of a
    bound call is the mask ``run()`` draws at the same run index (and
    moves from call to call); a fetch handed out with
    ``return_numpy=False`` stays valid after the next call; a
    ``scope.set`` after ``bind`` reaches the next call; state written
    without being read (the reference test's `create_global_var` +
    ``assign(reduce_sum(h))``) lands in the scope.
(b) Against the JAX package on the same numpy-seeded inputs, without
    dropout: the port's ``run_fused`` of the reference test's fc + SGD
    program (tests/test_run_fused.py) against `paddle_tpu`'s at that
    test's rtol 1e-5 / atol 1e-6, and the port's `BoundProgram` calls of
    the flash LM program against `paddle_tpu`'s at the limits of
    tests/test_torch_program.py's trajectories (losses rtol 1e-5,
    parameters and Adam state rtol 1e-4 / atol 1e-5, the K slice of each
    ``*.attn.qkv.b`` within STEPS * lr).
(c) The contracts: a feed of another name set, shape or dtype raises
    ValueError, and so does a ragged ``run_fused`` feed list, a LoD that
    does not cover its feed's leading dimension, and a bound call with a
    LoD the program was not bound at; the plan cache evicts past
    ``PADDLE_EXECUTOR_CACHE_SIZE`` and a hit refreshes an entry; a
    `BoundProgram` outlives its plan's eviction and ``close()``.
(d) `io`: ``save_params(exe, dirname, main)`` of one package is read by
    the other's ``load_params(exe, dirname, main)`` to the same arrays,
    in both layouts (one ``.npy`` a variable, one ``.npz``), both ways;
    ``load_params(exe, dirname)`` into `global_scope()` trains on from the
    loaded weights exactly as from the saved scope.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.models import transformer as jtrans

import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import transformer as ttrans

SMALL = dict(vocab_size=128, seq_len=16, d_model=64, n_head=4, n_layer=2,
             d_ff=128)
FLASH = dict(SMALL, dropout=0.1, attn_dropout=0.0)
FLASH0 = dict(SMALL, dropout=0.0, attn_dropout=0.0)
STEPS = 6
JAX_STEPS = 3
CPU = fluid.CPUPlace()


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels;
    restart the window after this module."""
    yield
    goodput.reset()
    # the monitor keeps at most 64 series a metric: leave it empty
    monitor.reset()


def _scope_arrays(scope):
    out = {}
    for n in scope.names():
        v = scope.get(n)
        if hasattr(v, 'shape'):
            out[n] = v.detach().cpu().numpy().copy() \
                if isinstance(v, torch.Tensor) else np.array(v)
    return out


def _build_lm(pkg, tmod, kw, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, loss = tmod.build_lm(tmod.LMConfig(**kw))
        pkg.optimizer.Adam(1e-3, fuse=True).minimize(loss)
    return main, startup, loss


def _lm_feeds(n=STEPS, batch=4, seed=0):
    rs = np.random.RandomState(seed)
    V, L = SMALL['vocab_size'], SMALL['seq_len']
    return [{'tokens': rs.randint(0, V, (batch, L)).astype('int64'),
             'labels': rs.randint(0, V, (batch, L)).astype('int64')}
            for _ in range(n)]


def _build_fc(pkg, seed=5):
    """tests/test_run_fused.py's program: fc + relu, fc, square error,
    SGD(0.05)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name='x', shape=[8], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        h = pkg.layers.fc(x, size=16, act='relu')
        p = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(p, y))
        pkg.optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss


def _fc_batches(k=6, n=16):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(k):
        X = rng.randn(n, 8).astype('float32')
        out.append({'x': X,
                    'y': (X.sum(1, keepdims=True) * 0.3).astype('float32')})
    return out


def _port_lm(kw=FLASH, init=None):
    """(exe, main, loss, scope) of a fresh build, the scope from its startup
    program or from ``init``."""
    main, startup, loss = _build_lm(fluid, ttrans, kw)
    exe = fluid.Executor(CPU)
    if init is None:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
    else:
        scope = scope_from_numpy(init, device='cpu')
    return exe, main, loss, scope


@pytest.fixture(scope='module')
def lm_init():
    return _scope_arrays(_port_lm()[3])


@pytest.fixture(scope='module')
def run_trajectory(lm_init):
    """The losses and final state of STEPS ``run()`` steps of the seeded
    dropout program."""
    exe, main, loss, scope = _port_lm(init=lm_init)
    losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
              for f in _lm_feeds()]
    return losses, _scope_arrays(scope)


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


# ---------------------------------------------------------------------------
# (a) against the port's own run()


def test_bind_calls_equal_run_calls_bitwise(lm_init, run_trajectory):
    exe, main, loss, scope = _port_lm(init=lm_init)
    feeds = _lm_feeds()
    bp = exe.bind(main, feeds[0], fetch_list=[loss], scope=scope)
    losses = [bp.first_out[0]] + [bp(f)[0] for f in feeds[1:]]
    np.testing.assert_array_equal(losses, run_trajectory[0])
    _assert_same_state(_scope_arrays(scope), run_trajectory[1])
    assert bp.fetch_names == (loss.name,)
    assert bp.replays == 0 and bp.captures == 0 and bp.graph is None
    # the example feed is the prepared one, a call takes it back
    assert set(bp.example_feed) == {'tokens', 'labels'}
    assert np.isfinite(bp(bp.example_feed)[0]).all()


def test_run_fused_over_k_batches_equals_k_run_calls(lm_init,
                                                     run_trajectory):
    exe, main, loss, scope = _port_lm(init=lm_init)
    out = exe.run_fused(main, _lm_feeds(), fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(out[0], run_trajectory[0][-1])
    _assert_same_state(_scope_arrays(scope), run_trajectory[1])


def test_run_fused_steps_cycle_the_staged_batches(lm_init):
    feeds = _lm_feeds(n=3)
    exe, main, loss, scope = _port_lm(init=lm_init)
    want = [exe.run(main, feed=feeds[i % 3], fetch_list=[loss],
                    scope=scope)[0] for i in range(7)]
    want_state = _scope_arrays(scope)
    exe, main, loss, scope = _port_lm(init=lm_init)
    stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    out = exe.run_fused(main, stacked, fetch_list=[loss], scope=scope,
                        steps=7)
    np.testing.assert_array_equal(out[0], want[-1])
    _assert_same_state(_scope_arrays(scope), want_state)


def test_two_run_fused_calls_continue_one_trajectory(lm_init,
                                                     run_trajectory):
    exe, main, loss, scope = _port_lm(init=lm_init)
    feeds = _lm_feeds()
    stacked = {k: torch.from_numpy(np.stack([f[k] for f in feeds[:2]]))
               for k in feeds[0]}
    first = exe.run_fused(main, stacked, fetch_list=[loss], scope=scope)
    last = exe.run_fused(main, feeds[2:], fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(first[0], run_trajectory[0][1])
    np.testing.assert_array_equal(last[0], run_trajectory[0][-1])
    _assert_same_state(_scope_arrays(scope), run_trajectory[1])


def _dropout_program(seed_attr=None):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[1024], dtype='float32')
        fluid.layers.dropout(x, 0.1, seed=seed_attr,
                             dropout_implementation='upscale_in_train')
    mask = main.global_block().ops[-1].output('Mask')[0]
    return main, mask


@pytest.mark.parametrize('seed_attr', [None, 3], ids=['run_stream',
                                                       'op_seed'])
def test_bound_dropout_masks_equal_run_masks(seed_attr):
    """The run's stream: each bound call draws the mask ``run()`` draws at
    the same run index, and the mask moves from call to call; an op with
    a ``seed`` attr draws the same mask at every run, bound or not."""
    feed = {'x': np.ones((64, 1024), 'float32')}
    main, mask = _dropout_program(seed_attr)
    exe = fluid.Executor(CPU)
    want = [exe.run(main, feed=feed, fetch_list=[mask])[0]
            for _ in range(3)]
    main, mask = _dropout_program(seed_attr)
    exe = fluid.Executor(CPU)
    bp = exe.bind(main, feed, fetch_list=[mask])
    got = [bp.first_out[0]] + [bp(feed)[0] for _ in range(2)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0.05 < 1 - got[1].mean() < 0.15
    assert np.array_equal(got[1], got[2]) == bool(seed_attr)


def test_bound_fetches_on_the_device_are_copies(lm_init):
    exe, main, loss, scope = _port_lm(init=lm_init)
    feeds = _lm_feeds(n=3)
    bp = exe.bind(main, feeds[0], fetch_list=[loss, 'tok_emb.w'],
                  scope=scope)
    l1, w1 = bp(feeds[1], return_numpy=False)
    keep = (l1.clone(), w1.clone())
    l2, w2 = bp(feeds[2], return_numpy=False)
    assert torch.equal(l1, keep[0]) and torch.equal(w1, keep[1])
    assert not torch.equal(w1, w2)
    assert torch.equal(w2, scope.get('tok_emb.w'))


def test_scope_set_after_bind_reaches_the_next_call(lm_init):
    """A value the user sets after ``bind`` (numpy, as ``load_params``
    leaves it) is copied into the tensor the bound plan holds, and the
    scope is bound back to that tensor: the call equals ``run()`` after
    the same set."""
    feeds = _lm_feeds(n=3)
    new_w = np.random.RandomState(9).randn(
        SMALL['vocab_size'], SMALL['d_model']).astype('float32') * 0.02
    results = []
    for bound in (False, True):
        exe, main, loss, scope = _port_lm(init=lm_init)
        if bound:
            bp = exe.bind(main, feeds[0], fetch_list=[loss], scope=scope)
            held = scope.get('tok_emb.w')
            scope.set('tok_emb.w', new_w.copy())
            results.append(bp(feeds[1])[0])
            assert scope.get('tok_emb.w') is held
        else:
            exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
            scope.set('tok_emb.w', new_w.copy())
            results.append(exe.run(main, feed=feeds[1], fetch_list=[loss],
                                   scope=scope)[0])
    np.testing.assert_array_equal(results[0], results[1])


def _written_only_program(pkg):
    """tests/test_run_fused.py::test_fused_handles_written_only_state's
    program: a persistable step counter assigned ``reduce_sum(h)``."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name='x', shape=[4], dtype='float32')
        h = pkg.layers.fc(x, size=4)
        loss = pkg.layers.mean(h)
        gstep = pkg.layers.create_global_var(
            shape=[1], value=0.0, dtype='float32', persistable=True,
            name='gstep_counter')
        pkg.layers.assign(pkg.layers.reduce_sum(h), gstep)
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_run_fused_lands_written_only_state_in_the_scope():
    batches = [{'x': np.ones((2, 4), 'float32') * (i + 1)}
               for i in range(3)]
    main, startup, loss = _written_only_program(fluid)
    exe = fluid.Executor(CPU)
    ref, scope = fluid.Scope(), fluid.Scope()
    exe.run(startup, scope=ref)
    init = _scope_arrays(ref)
    assert init['gstep_counter'].tolist() == [0.0]
    want = [exe.run(main, feed=b, fetch_list=[loss, 'gstep_counter'],
                    scope=ref) for b in batches]
    scope = scope_from_numpy(init, device='cpu')
    out = exe.run_fused(main, batches, fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(out[0], want[-1][0])
    got = scope.get('gstep_counter').numpy()
    # the last step's sum(h), not the first's
    np.testing.assert_array_equal(got, want[-1][1])
    assert got != want[0][1]
    _assert_same_state(_scope_arrays(scope), _scope_arrays(ref))


def test_create_global_var_and_reduce_sum_match_the_jax_program():
    """The program dicts equal the JAX package's, and so do the step's
    loss and counter (one SGD step from the JAX startup scope)."""
    from paddle_tpu.core import serialization as jser
    from paddle_tpu_torch.core import serialization as tser
    jm, js, jl = _written_only_program(jfluid)
    tm, ts, tl = _written_only_program(fluid)
    assert tser.program_to_dict(tm) == jser.program_to_dict(jm)
    assert tser.program_to_dict(ts) == jser.program_to_dict(js)
    feed = {'x': np.random.RandomState(1).randn(2, 4).astype('float32')}
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(js, scope=jscope)
    init = _scope_arrays(jscope)
    want = jexe.run(jm, feed=feed, fetch_list=[jl, 'gstep_counter'],
                    scope=jscope)
    got = fluid.Executor(CPU).run(tm, feed=feed, fetch_list=[
        tl, 'gstep_counter'], scope=scope_from_numpy(init, device='cpu'))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# (b) against the JAX package


def test_run_fused_matches_the_jax_run_fused():
    batches = _fc_batches()
    jmain, jstartup, jloss = _build_fc(jfluid)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup, scope=jscope)
        init = _scope_arrays(jscope)
        want, = jexe.run_fused(jmain, batches, fetch_list=[jloss],
                               scope=jscope)
    want_state = _scope_arrays(jscope)
    main, _, loss = _build_fc(fluid)
    scope = scope_from_numpy(init, device='cpu')
    got, = fluid.Executor(CPU).run_fused(main, batches, fetch_list=[loss],
                                         scope=scope)
    np.testing.assert_allclose(float(got.reshape(())),
                               float(np.asarray(want).reshape(())),
                               rtol=1e-5, atol=1e-6)
    for p in main.all_parameters():
        np.testing.assert_allclose(scope.get(p.name).numpy(),
                                   want_state[p.name], rtol=1e-5,
                                   atol=1e-6, err_msg=p.name)


def _k_bias_apart(name, have, want, tol):
    """The K slice of a qkv bias within ``tol``; returns the rest."""
    if not name.endswith('.attn.qkv.b'):
        return have, want
    d = SMALL['d_model']
    assert np.abs(have[d:2 * d] - want[d:2 * d]).max() <= tol, name
    return (np.delete(have, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d]))


def test_bound_program_calls_match_the_jax_bound_program(monkeypatch):
    """Three steps (``bind`` and two calls) of the flash LM program, no
    dropout, the JAX side at the interpret tier (its Pallas kernels
    through the interpreter, as tests/test_torch_program.py runs it)."""
    feeds = _lm_feeds(n=JAX_STEPS)
    jfeeds = [{k: v.astype('int32') for k, v in f.items()} for f in feeds]
    monkeypatch.setenv('PADDLE_FUSED_TIER', 'interpret')
    jmain, jstartup, jloss = _build_lm(jfluid, jtrans, FLASH0, seed=5)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    init = _scope_arrays(jscope)
    jbp = jexe.bind(jmain, feeds[0], fetch_list=[jloss], scope=jscope)
    want = [float(np.asarray(jbp.first_out[0]).reshape(-1)[0])] + [
        float(np.asarray(jbp(f)[0]).reshape(-1)[0]) for f in jfeeds[1:]]
    want_state = _scope_arrays(jscope)
    monkeypatch.delenv('PADDLE_FUSED_TIER')
    exe, main, loss, scope = _port_lm(FLASH0, init)
    bp = exe.bind(main, feeds[0], fetch_list=[loss], scope=scope)
    got = [float(bp.first_out[0][0])] + [float(bp(f)[0][0])
                                         for f in feeds[1:]]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    have = _scope_arrays(scope)
    assert sorted(have) == sorted(want_state)
    for name, w in want_state.items():
        h = have[name]
        if '_moment' not in name:
            h, w = _k_bias_apart(name, h, w, JAX_STEPS * 1e-3)
        np.testing.assert_allclose(h, w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (c) the contracts


def test_bound_call_of_another_signature_raises(lm_init):
    exe, main, loss, scope = _port_lm(init=lm_init)
    f = _lm_feeds(n=1)[0]
    bp = exe.bind(main, f, fetch_list=[loss], scope=scope)
    bad = [{'tokens': f['tokens']},
           dict(f, extra=f['tokens']),
           dict(f, tokens=f['tokens'][:2]),
           dict(f, labels=f['labels'].astype('int32')),
           dict(f, tokens=torch.from_numpy(f['tokens']).float())]
    before = _scope_arrays(scope)
    for feed in bad:
        with pytest.raises(ValueError, match='bound'):
            bp(feed)
    # a refused call changes nothing
    _assert_same_state(_scope_arrays(scope), before)
    with pytest.raises(ValueError):
        exe.run_fused(main, [f, dict(f, tokens=f['tokens'][:2])],
                      fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match='LoD'):
        exe.run_fused(main, [dict(f, tokens=(f['tokens'], [[0, 1]]))],
                      fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match='LoD'):
        bp(dict(f, tokens=(f['tokens'], [[0, len(f['tokens'])]])))
    assert exe.run_fused(main, [], fetch_list=[loss], scope=scope) == []


def _quick_start(pkg=fluid):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name='x', shape=[13], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='float32')
        cost = pkg.layers.square_error_cost(pkg.layers.fc(x, size=1), y)
        avg = pkg.layers.mean(cost)
        pkg.optimizer.SGD(0.01).minimize(avg)
    return main, startup, avg


def _qs_feed(batch):
    rs = np.random.RandomState(batch)
    return {'x': rs.randn(batch, 13).astype('float32'),
            'y': rs.randn(batch, 1).astype('float32')}


def test_plan_cache_evicts_past_its_cap_and_a_hit_refreshes(monkeypatch):
    monkeypatch.setenv('PADDLE_EXECUTOR_CACHE_SIZE', '2')
    main, startup, avg = _quick_start()
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    exe._cache.clear()

    def batches():
        # the key's feed signature: sorted (name, shape, dtype) triples
        return sorted(dict((n, shape) for n, shape, _ in k[2])['x'][0]
                      for k in exe._cache)

    for b in (3, 5):
        exe.run(main, feed=_qs_feed(b), fetch_list=[avg], scope=scope)
    assert batches() == [3, 5]
    exe.run(main, feed=_qs_feed(3), fetch_list=[avg], scope=scope)   # hit
    exe.run(main, feed=_qs_feed(7), fetch_list=[avg], scope=scope)
    assert batches() == [3, 7] and len(exe._cache) == 2
    monkeypatch.setenv('PADDLE_EXECUTOR_CACHE_SIZE', '1')
    exe.run(main, feed=_qs_feed(9), fetch_list=[avg], scope=scope)
    assert batches() == [9]


def test_bound_program_outlives_eviction_and_close(monkeypatch):
    monkeypatch.setenv('PADDLE_EXECUTOR_CACHE_SIZE', '1')
    main, startup, avg = _quick_start()
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    bp = exe.bind(main, _qs_feed(4), fetch_list=[avg], scope=scope)
    exe.run(main, feed=_qs_feed(6), fetch_list=[avg], scope=scope)
    assert len(exe._cache) == 1        # the bound plan was evicted
    first = bp(_qs_feed(4))[0]
    exe.close()
    assert len(exe._cache) == 0
    second = bp(_qs_feed(4))[0]
    assert np.isfinite(first).all() and second[0] < first[0]


# ---------------------------------------------------------------------------
# (d) io


@pytest.mark.parametrize('filename', [None, 'params'], ids=['npy', 'npz'])
@pytest.mark.parametrize('direction', ['port_to_jax', 'jax_to_port'])
def test_save_params_loads_in_the_other_package(tmp_path, filename,
                                                direction):
    jmain, _, _ = _build_fc(jfluid)
    tmain, _, _ = _build_fc(fluid)
    rs = np.random.RandomState(4)
    arrays = {p.name: rs.randn(*p.shape).astype('float32')
              for p in tmain.all_parameters()}
    assert sorted(arrays) == sorted(p.name for p in jmain.all_parameters())
    src, dst = (fluid, jfluid) if direction == 'port_to_jax' else \
        (jfluid, fluid)
    src_main, dst_main = (tmain, jmain) if src is fluid else (jmain, tmain)
    src_scope, dst_scope = src.Scope(), dst.Scope()
    for n, a in arrays.items():
        src_scope.set(n, torch.from_numpy(a.copy()) if src is fluid else a)
    with src.scope_guard(src_scope):
        src.io.save_params(None, str(tmp_path), src_main, filename=filename)
    files = sorted(os.listdir(tmp_path))
    assert files == (['params.npz'] if filename else
                     sorted(n.replace('/', '%2F') + '.npy' for n in arrays))
    with dst.scope_guard(dst_scope):
        dst.io.load_params(None, str(tmp_path), dst_main, filename=filename)
    for n, a in arrays.items():
        got = dst_scope.get(n)
        assert isinstance(got, np.ndarray), n
        np.testing.assert_array_equal(got, a, err_msg=n)


def test_load_params_into_the_global_scope_trains_on(tmp_path):
    """``save_params`` after two steps, ``load_params(exe, dirname)`` of a
    fresh build into `global_scope()`: the next steps' losses (one batch,
    three times) equal the saved scope's own, bitwise, and fall."""
    feeds = _fc_batches(3)
    feeds += [feeds[-1]] * 2
    main, startup, loss = _build_fc(fluid)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for f in feeds[:2]:
            exe.run(main, feed=f, fetch_list=[loss])
        tio.save_params(exe, str(tmp_path), main)
        want = [exe.run(main, feed=f, fetch_list=[loss])[0]
                for f in feeds[2:]]
    main, startup, loss = _build_fc(fluid)
    fresh = fluid.Scope()
    with fluid.scope_guard(fresh):
        exe.run(startup)
        tio.load_params(exe, str(tmp_path), main)
        assert isinstance(fresh.get('fc_0.w_0'), np.ndarray)
        got = [exe.run(main, feed=f, fetch_list=[loss])[0]
               for f in feeds[2:]]
    np.testing.assert_array_equal(got, want)
    assert got[-1][0] < got[0][0]


def test_load_params_of_a_missing_variable_raises(tmp_path):
    main, _, _ = _build_fc(fluid)
    with fluid.scope_guard(fluid.Scope()):
        with pytest.raises(RuntimeError, match='not found'):
            tio.load_params(None, str(tmp_path), main)
