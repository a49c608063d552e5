"""Ragged (LoD) feeds and fetches of paddle_tpu_torch against the JAX
package, on the CPU.

(a) The port's copies of `core.lod` and `lod_tensor` (LoDTensor,
    create_lod_tensor, create_random_int_lodtensor) give the JAX
    package's results on the same inputs.
(b) Feeds: an ``(array, offsets)`` pair, an ``(array, lengths)`` pair, a
    `LoDTensor` and a fetched `FetchedTensor` fed back give the same run;
    a LoD that does not end at the array's leading dimension raises
    ValueError; the run plans are keyed by the LoD (two LoDs of one shape,
    two plans). Fetches: a LoD-carrying fetch is a `FetchedTensor` with
    the JAX fetch's ``lod()`` and ``recursive_sequence_lengths()``, with
    ``return_numpy`` on and off; the scope keeps the LoD of a persistable
    a run wrote, as the JAX scope does.
(c) `bind` binds one LoD: its calls equal ``run()`` calls bitwise, and a
    call at another LoD raises ValueError. ``run_fused`` over a list of
    mixed LoDs equals as many ``run()`` calls bitwise (which
    tests/test_torch_rnn.py holds to the JAX package), one bound plan a
    LoD; ``steps=`` on a mixed list raises ValueError; a uniform list
    with ``steps`` and a stacked ``{name: (array [K, ...], lod)}`` equal
    their ``run()`` calls.
(d) `DataFeeder` gives the JAX feeder's dense feeds, and a ragged
    variable's rows as ``(array, lod)``.
(e) The deploy path: a program with LoD data round-trips through
    `program_to_dict` as the JAX package's, and an inference model that
    either package saved serves in the other's predictor on an ``(array,
    lod)`` feed, to the same outputs within 1e-5.
"""
import functools

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.core import lod as jlod
from paddle_tpu.core import serialization as jser

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import lod as tlod
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.io import scope_from_numpy
from test_torch_rnn import ragged_batches, stacked_lstm

CPU = fluid.CPUPlace()


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels;
    restart the window after this module."""
    yield
    goodput.reset()
    monitor.reset()


# ---------------------------------------------------------------------------
# (a)


def test_lod_helpers_match_the_jax_package():
    for lod in ([[0, 2, 5]], [[2, 3]], [[0, 1, 3], [0, 2, 2, 6]], None, []):
        assert tlod.normalize_lod(lod) == jlod.normalize_lod(lod)
        assert tlod.LoD(lod or ()) == jlod.LoD(lod or ())
    assert tlod.LoD([[3, 0, 2]]).lengths() == jlod.LoD([[3, 0, 2]]).lengths()
    assert tlod.lod_from_lengths([[3, 0, 2], [1, 1, 1, 2, 0]]) == \
        jlod.lod_from_lengths([[3, 0, 2], [1, 1, 1, 2, 0]])
    assert tlod.lengths_from_offsets((0, 3, 3, 7)) == \
        jlod.lengths_from_offsets((0, 3, 3, 7))
    np.testing.assert_array_equal(tlod.segment_ids((0, 3, 3, 7)),
                                  jlod.segment_ids((0, 3, 3, 7)))
    for got, want in zip(tlod.context_maps((0, 3, 3, 7), 3, -1),
                         jlod.context_maps((0, 3, 3, 7), 3, -1)):
        np.testing.assert_array_equal(got, want)
    assert tlod.check_lod([[0, 2], [0, 1, 4]], first_dim=4) == \
        jlod.check_lod([[0, 2], [0, 1, 4]], first_dim=4)
    for bad, dim in (([[0, 3, 2]], None), ([[0, 2], [0, 1]], None),
                     ([[0, 2, 5]], 4)):
        for mod in (tlod, jlod):
            with pytest.raises(ValueError):
                mod.check_lod(bad, first_dim=dim)


def test_lod_tensor_helpers_match_the_jax_package():
    data = np.arange(12, dtype='float32').reshape(6, 2)
    for pkg in (fluid, jfluid):
        t = pkg.create_lod_tensor(data, [[2, 0, 4]], None)
        assert t.lod() == [[0, 2, 2, 6]]
        assert t.recursive_sequence_lengths() == [[2, 0, 4]]
        assert t.has_valid_recursive_sequence_lengths()
        t.set_recursive_sequence_lengths([[1, 1, 4]])
        assert t.lod() == [[0, 1, 2, 6]]
        t.set_lod([[0, 7]])
        assert not t.has_valid_recursive_sequence_lengths()
        seqs = pkg.create_lod_tensor([[1, 2, 3], [4], [5, 6]], None, None)
        assert seqs.lod() == [[0, 3, 4, 6]] and seqs.shape == (6, 1)
    np.random.seed(3)
    want = jfluid.create_random_int_lodtensor([[2, 3]], [1], None, 0, 9)
    np.random.seed(3)
    got = fluid.create_random_int_lodtensor([[2, 3]], [1], None, 0, 9)
    assert got.lod() == want.lod()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# (b)


def _pool_program(pkg, keep=True):
    """Embedding rows, their fc, a summed pool and (``keep``) a copy of the
    fc into a persistable (a written state variable with a LoD)."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        words = pkg.layers.data(name='words', shape=[1], dtype='int64',
                                lod_level=1)
        hid = pkg.layers.fc(pkg.layers.embedding(words, size=[20, 4]),
                            size=3)
        pooled = pkg.layers.sequence_pool(hid, 'sum')
    if keep:
        keep = main.global_block().create_var(
            name='keep', shape=(-1, 3), dtype='float32', persistable=True)
        main.global_block().append_op(type='assign', inputs={'X': [hid]},
                                      outputs={'Out': [keep]}, attrs={})
    return main, startup, [hid, pooled]


def _port_and_jax(build):
    jmain, jstart, jouts = build(jfluid)
    main, start, outs = build(fluid)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    init = {n: np.array(jscope.get(n)) for n in jscope.names()}
    return (jexe, jmain, jouts, jscope), (main, outs, init)


WORDS = np.random.RandomState(0).randint(0, 20, (7, 1)).astype('int64')


def test_feed_forms_fetches_and_scope_lods():
    (jexe, jmain, jouts, jscope), (main, outs, init) = \
        _port_and_jax(_pool_program)
    exe = fluid.Executor(CPU)
    scope = scope_from_numpy(init, device='cpu')
    want = jexe.run(jmain, feed={'words': (WORDS, [[0, 2, 2, 7]])},
                    fetch_list=jouts, scope=jscope)
    forms = [(WORDS, [[0, 2, 2, 7]]), (WORDS, [[2, 0, 5]]),
             fluid.create_lod_tensor(WORDS, [[2, 0, 5]], CPU)]
    runs = [exe.run(main, feed={'words': f}, fetch_list=outs, scope=scope)
            for f in forms]
    # a fetched FetchedTensor carries its LoD back in as a feed
    words = exe.run(main, feed={'words': forms[2]}, fetch_list=['words'],
                    scope=scope)[0]
    assert isinstance(words, fluid.executor.FetchedTensor)
    fed_back = exe.run(main, feed={'words': words}, fetch_list=outs,
                       scope=scope)
    runs.append(fed_back)
    for got in runs:
        for g, w in zip(got, want):
            assert isinstance(g, fluid.executor.FetchedTensor) == \
                isinstance(w, jfluid.executor.FetchedTensor)
            assert getattr(g, 'lod', list)() == getattr(w, 'lod', list)()
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(got[0]),
                                      np.asarray(runs[0][0]))
    h = runs[0][0]
    assert h.lod() == [[0, 2, 2, 7]]
    assert h.recursive_sequence_lengths() == [[2, 0, 5]]
    assert h.recursive_sequence_lengths() == \
        want[0].recursive_sequence_lengths()
    # pooling consumed the level: a plain array
    assert not isinstance(runs[0][1], fluid.executor.FetchedTensor)
    dev = exe.run(main, feed={'words': forms[0]}, fetch_list=outs,
                  scope=scope, return_numpy=False)
    assert isinstance(dev[0], fluid.executor.FetchedTensor) and \
        dev[0].lod() == [[0, 2, 2, 7]]
    assert not isinstance(dev[1], np.ndarray)       # a tensor
    # the written persistable's LoD, in both scopes
    assert scope._lods['keep'] == jscope._lods['keep'] == ((0, 2, 2, 7),)
    assert scope.find_var('keep').get_tensor().lod() == [[0, 2, 2, 7]]


def test_lod_keys_the_plan_and_must_cover_the_feed():
    main, start, outs = _pool_program(fluid, keep=False)
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(start, scope=scope)
    n0 = len(exe._cache)
    for lod in ([[0, 2, 2, 7]], [[0, 2, 2, 7]], [[0, 7]], [[0, 3, 7]]):
        exe.run(main, feed={'words': (WORDS, lod)}, fetch_list=outs,
                scope=scope)
    assert len(exe._cache) - n0 == 3
    for bad in ([[0, 2, 6]], [[3, 3]]):
        with pytest.raises(ValueError, match='LoD'):
            exe.run(main, feed={'words': (WORDS, bad)}, fetch_list=outs,
                    scope=scope)
    with pytest.raises(ValueError, match='requires a LoD'):
        exe.run(main, feed={'words': WORDS}, fetch_list=outs, scope=scope)


# ---------------------------------------------------------------------------
# (c)


@functools.lru_cache(maxsize=None)
def _jax_init(build):
    """{name: array} of the JAX startup scope of ``build``'s program."""
    _, jstart, _ = build(jfluid)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    return {n: np.array(jscope.get(n)) for n in jscope.names()}


def _trained(build, batches, how):
    """(losses, state) of the port's program from the JAX startup scope,
    run by ``how(exe, main, loss, scope, batches)``."""
    main, _, loss = build(fluid)
    init = _jax_init(build)
    exe = fluid.Executor(CPU)
    scope = scope_from_numpy(init, device='cpu')
    out = how(exe, main, loss, scope, batches)
    return out, {n: scope.get(n).detach().numpy().copy() for n in init}


def _runs(exe, main, loss, scope, batches):
    return [float(exe.run(main, feed=b, fetch_list=[loss],
                          scope=scope)[0][0]) for b in batches]


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


# two steps of one LoD, one of another, one of the first again
MIXED = [[3, 0, 1, 9], [3, 0, 1, 9], [2, 5, 1, 1], [3, 0, 1, 9]]


def test_bind_binds_one_lod():
    batches = ragged_batches(3, [MIXED[0]])
    batches.append(batches[0])
    want, wstate = _trained(stacked_lstm, batches, _runs)

    def bound(exe, main, loss, scope, batches):
        bp = exe.bind(main, batches[0], fetch_list=[loss], scope=scope)
        out = [float(bp.first_out[0][0])]
        out += [float(bp(b)[0][0]) for b in batches[1:3]]
        other = ragged_batches(1, [MIXED[2]])[0]
        with pytest.raises(ValueError, match='LoD'):
            bp(other)
        # a bare array takes the bound LoD
        bare = dict(batches[3], words=batches[3]['words'][0])
        out.append(float(bp(bare)[0][0]))
        return out

    got, gstate = _trained(stacked_lstm, batches, bound)
    assert got == want
    _assert_same(gstate, wstate)


def test_run_fused_over_mixed_lods_equals_run_calls():
    batches = ragged_batches(len(MIXED), MIXED)
    want, wstate = _trained(stacked_lstm, batches, _runs)

    def fused(exe, main, loss, scope, batches):
        last = exe.run_fused(main, batches, fetch_list=[loss], scope=scope)
        plans = [e for _, e in exe._cache.items() if scope in e.bound]
        assert len(plans) == 2          # one bound plan a LoD
        with pytest.raises(ValueError, match='steps'):
            exe.run_fused(main, batches, fetch_list=[loss], scope=scope,
                          steps=8)
        return float(last[0][0])

    got, gstate = _trained(stacked_lstm, batches, fused)
    assert got == want[-1]
    _assert_same(gstate, wstate)


def test_run_fused_one_lod_with_steps_and_stacked():
    batches = ragged_batches(2, [MIXED[2]])
    want, wstate = _trained(stacked_lstm, batches * 2, _runs)

    def cycled(exe, main, loss, scope, batches):
        return float(exe.run_fused(main, batches, fetch_list=[loss],
                                   scope=scope, steps=4)[0][0])

    def stacked(exe, main, loss, scope, batches):
        lod = batches[0]['words'][1]
        feed = {'words': (np.stack([b['words'][0] for b in batches]), lod),
                'label': np.stack([b['label'] for b in batches])}
        return float(exe.run_fused(main, feed, fetch_list=[loss],
                                   scope=scope, steps=4)[0][0])

    for how in (cycled, stacked):
        got, gstate = _trained(stacked_lstm, batches, how)
        assert got == want[-1]
        _assert_same(gstate, wstate)


# ---------------------------------------------------------------------------
# (d)


def test_data_feeder_dense_and_ragged():
    rows = [([1, 2, 3], [0.5, 1.5], 1), ([4], [2.5, 3.5], 0),
            ([5, 6], [4.5, 5.5], 1)]
    feeds = {}
    for pkg in (fluid, jfluid):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            w = pkg.layers.data(name='w', shape=[1], dtype='int64',
                                lod_level=1)
            x = pkg.layers.data(name='x', shape=[2], dtype='float32')
            y = pkg.layers.data(name='y', shape=[1], dtype='int64')
        feeder = pkg.DataFeeder([w, x, y] if pkg is fluid else [x, y],
                                None, main)
        feeds[pkg] = feeder.feed(
            rows if pkg is fluid else [r[1:] for r in rows])
    for n in ('x', 'y'):
        got, want = feeds[fluid][n], feeds[jfluid][n]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    arr, lod = feeds[fluid]['w']
    ref = fluid.create_lod_tensor([r[0] for r in rows], None, None)
    assert lod == ref.lod() == [[0, 3, 4, 6]]
    np.testing.assert_array_equal(arr, np.asarray(ref))
    assert arr.dtype == np.int64 and arr.shape == (6, 1)


# ---------------------------------------------------------------------------
# (e)


def _classifier(pkg):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 4
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        words = pkg.layers.data(name='words', shape=[1], dtype='int64',
                                lod_level=1)
        proj = pkg.layers.fc(pkg.layers.embedding(words, size=[20, 4]),
                             size=8)
        h, _ = pkg.layers.dynamic_lstm(input=proj, size=8)
        pred = pkg.layers.fc(pkg.layers.sequence_last_step(h), size=2,
                             act='softmax')
    return main, startup, pred


def test_lod_models_serve_across_packages(tmp_path):
    (jexe, jmain, jpred, jscope), (main, pred, init) = \
        _port_and_jax(_classifier)
    assert tser.program_to_dict(main) == jser.program_to_dict(jmain)
    assert tser.program_from_dict(tser.program_to_dict(main)) \
        .global_block().var('words').lod_level == 1
    exe = fluid.Executor(CPU)
    scope = scope_from_numpy(init, device='cpu')
    jdir, tdir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(jdir, ['words'], [jpred], jexe,
                                       main_program=jmain)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(tdir, ['words'], [pred], exe,
                                      main_program=main)
    feed = {'words': (WORDS, [[0, 2, 2, 7]])}
    outs = []
    for d in (jdir, tdir):
        outs.append(jfluid.create_predictor(
            jfluid.PredictorConfig(model_dir=d)).run(feed)[0])
        outs.append(fluid.create_predictor(fluid.PredictorConfig(
            d, place=CPU)).run(feed)[0])
    for o in outs[1:]:
        np.testing.assert_allclose(np.asarray(o), np.asarray(outs[0]),
                                   rtol=1e-5, atol=1e-6)
    assert np.asarray(outs[0]).shape == (3, 2)
