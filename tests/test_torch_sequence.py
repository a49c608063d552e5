"""The sequence (LoD) ops of paddle_tpu_torch against the JAX package, on the
CPU.

Every input comes from a numpy seed and goes through both packages' one-op
programs (`_run_seq_op`): a ragged input is a persistable variable whose
LoD the scope holds, so that ``append_backward`` takes its gradient; the
op's float outputs are weighted by fixed random tensors and summed into
the loss. Held to the JAX Executor: each output's values within 1e-5 of
its largest magnitude and its LoD exactly, each input's gradient within
1e-4 of its largest magnitude. The batches hold an empty sequence and one
of length 1; MAX pooling runs on rows with ties (a ReLU's zeros and
repeated maxima), where a tie's gradient is split evenly in both
packages. Also held: the default LoD propagation through ``fc``,
``lookup_table`` and ``sequence_pool``, none through ``transpose2`` and
``gather`` (registered ``share_lod=False``) even where the leading
dimension matches, and the ``share_lod`` and ``static_inputs`` flags of
every op type the two registries share.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.core import registry as jregistry

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.io import scope_from_numpy

CPU = fluid.CPUPlace()
# lengths 3, 0, 1, 4, 2: an empty sequence and one of length 1
LOD_A = [[0, 3, 3, 4, 8, 10]]
LOD_B = [[0, 1, 3, 3, 3, 6]]


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels;
    restart the window after this module."""
    yield
    goodput.reset()
    monitor.reset()


def _f(rs, *shape, scale=1.0):
    return (scale * rs.randn(*shape)).astype('float32')


def _build(pkg, case, weights):
    """(program, feed, scope, fetch names, gradient names) of a one-op
    program of ``case`` in ``pkg``; ``weights`` {output: array} are the
    loss's weights (None: a forward-only program)."""
    main = pkg.Program()
    block = main.global_block()
    feed, scope, wrt = {}, pkg.Scope(), []
    for items in case['inputs'].values():
        for item in items:
            name, arr = item[0], item[1]
            lod = item[2] if len(item) > 2 else None
            train = len(item) > 3 and item[3]
            block.create_var(name=name, shape=arr.shape, dtype=arr.dtype,
                             persistable=train, stop_gradient=not train,
                             lod_level=1 if lod else 0)
            if train:
                scope.set(name, arr.copy())
                if lod:
                    scope._lods[name] = tuple(tuple(l) for l in lod)
                wrt.append(name)
            else:
                feed[name] = (arr, lod) if lod else arr
    outs = []
    for slot_outs in case['outputs'].values():
        for n in slot_outs:
            block.create_var(name=n, dtype='float32')
            outs.append(n)
    block.append_op(type=case['op'],
                    inputs={k: [i[0] for i in v]
                            for k, v in case['inputs'].items()},
                    outputs=case['outputs'], attrs=dict(case['attrs']))
    grads = []
    if weights and wrt:
        terms = []
        for n, w in weights.items():
            wn = n + '@w'
            block.create_var(name=wn, shape=w.shape, dtype='float32',
                             persistable=True)
            scope.set(wn, w)
            prod = block.create_var(name=n + '@wx', dtype='float32')
            block.append_op(type='elementwise_mul',
                            inputs={'X': [n], 'Y': [wn]},
                            outputs={'Out': [prod]}, attrs={'axis': -1})
            s = block.create_var(name=n + '@s', dtype='float32')
            block.append_op(type='reduce_sum', inputs={'X': [prod]},
                            outputs={'Out': [s]},
                            attrs={'dim': [0], 'keep_dim': False,
                                   'reduce_all': True})
            terms.append(s)
        loss = block.create_var(name='loss', dtype='float32')
        block.append_op(type='sum', inputs={'X': terms},
                        outputs={'Out': [loss]}, attrs={})
        pairs = pkg.append_backward(loss, parameter_list=wrt)
        grads = [g.name for _, g in pairs]
    return main, feed, scope, outs, grads


def _run(pkg, case, weights=None):
    main, feed, scope, outs, grads = _build(pkg, case, weights)
    exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
    got = exe.run(main, feed=feed, fetch_list=outs + grads, scope=scope)
    return {n: g for n, g in zip(outs + grads, got)}


def _lod(v):
    return v.lod() if hasattr(v, 'lod') else []


def _run_seq_op(case, seed=0):
    """Run ``case`` in both packages, forward and backward, and hold the
    port to the JAX package (module docstring)."""
    # the loss's weights take the outputs' shapes from the port's forward
    # (one JAX compile a case; a wrong shape fails the comparison below)
    fwd = _run(fluid, case)
    rs = np.random.RandomState(seed + 100)
    weights = {n: _f(rs, *np.shape(v)) for n, v in fwd.items()
               if np.asarray(v).dtype.kind == 'f'}
    want = _run(jfluid, case, weights)
    got = _run(fluid, case, weights)
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        g = got[n]
        w_arr, g_arr = np.asarray(w), np.asarray(g)
        assert g_arr.shape == w_arr.shape, n
        assert _lod(g) == _lod(w), n
        if w_arr.dtype.kind != 'f':
            np.testing.assert_array_equal(g_arr, w_arr, err_msg=n)
            continue
        tol = (1e-4 if n.endswith('@GRAD') else 1e-5) * \
            max(float(np.abs(w_arr).max()) if w_arr.size else 0.0, 1e-30)
        np.testing.assert_allclose(g_arr, w_arr, rtol=0, atol=tol,
                                   err_msg=n)
    return got, want


def _cases():
    rs = np.random.RandomState(0)
    x = _f(rs, 10, 6)
    # a ReLU's zeros and repeated maxima: ties inside every sequence
    ties = np.maximum(np.round(rs.randn(10, 6)), 0).astype('float32')
    c = {}
    for pool in ('SUM', 'AVERAGE', 'SQRT', 'MAX', 'LAST', 'FIRST'):
        c['pool_' + pool] = dict(
            op='sequence_pool', inputs={'X': [('x', x, LOD_A, True)]},
            outputs={'Out': ['out'], 'MaxIndex': ['midx']},
            attrs={'pooltype': pool, 'is_test': False})
    c['pool_MAX_ties'] = dict(c['pool_MAX'],
                              inputs={'X': [('x', ties, LOD_A, True)]})
    c['pool_SUM_ties'] = dict(c['pool_SUM'],
                              inputs={'X': [('x', ties, LOD_A, True)]})
    c['softmax'] = dict(op='sequence_softmax',
                        inputs={'X': [('x', _f(rs, 10, 1), LOD_A, True)]},
                        outputs={'Out': ['out']}, attrs={})
    c['expand_dense_x'] = dict(
        op='sequence_expand',
        inputs={'X': [('x', _f(rs, 5, 6), None, True)],
                'Y': [('y', _f(rs, 6, 2), LOD_B)]},
        outputs={'Out': ['out']}, attrs={'ref_level': -1})
    c['expand_lod_x'] = dict(
        op='sequence_expand',
        inputs={'X': [('x', x, LOD_A, True)],
                'Y': [('y', _f(rs, 6, 2), LOD_B)]},
        outputs={'Out': ['out']}, attrs={'ref_level': -1})
    c['expand_as'] = dict(
        op='sequence_expand_as',
        inputs={'X': [('x', _f(rs, 5, 6), None, True)],
                'Y': [('y', _f(rs, 10, 2), LOD_A)]},
        outputs={'Out': ['out']}, attrs={})
    c['concat'] = dict(
        op='sequence_concat',
        inputs={'X': [('x', x, LOD_A, True),
                      ('x2', _f(rs, 6, 6), LOD_B, True)]},
        outputs={'Out': ['out']}, attrs={})
    c['slice'] = dict(
        op='sequence_slice',
        inputs={'X': [('x', x, LOD_A, True)],
                'Offset': [('off', np.array([[1], [0], [0], [1], [0]],
                                            'int64'))],
                'Length': [('len', np.array([[2], [0], [1], [2], [2]],
                                            'int64'))]},
        outputs={'Out': ['out']}, attrs={})
    for dim in (3, 2):
        c['reshape_%d' % dim] = dict(
            op='sequence_reshape', inputs={'X': [('x', x, LOD_A, True)]},
            outputs={'Out': ['out']}, attrs={'new_dim': dim})
    for padded in (-1, 6):
        c['pad_%d' % padded] = dict(
            op='sequence_pad',
            inputs={'X': [('x', x, LOD_A, True)],
                    'PadValue': [('pv', np.array([0.5], 'float32'), None,
                                  True)]},
            outputs={'Out': ['out'], 'Length': ['length']},
            attrs={'padded_length': padded})
    c['unpad'] = dict(
        op='sequence_unpad',
        inputs={'X': [('x', _f(rs, 5, 4, 6), None, True)],
                'Length': [('len', np.array([3, 0, 1, 4, 2], 'int64'))]},
        outputs={'Out': ['out']}, attrs={})
    c['reverse'] = dict(op='sequence_reverse',
                        inputs={'X': [('x', x, LOD_A, True)]},
                        outputs={'Y': ['out']}, attrs={})
    c['conv'] = dict(
        op='sequence_conv',
        inputs={'X': [('x', x, LOD_A, True)],
                'Filter': [('filt', _f(rs, 18, 5), None, True)]},
        outputs={'Out': ['out']},
        attrs={'contextLength': 3, 'contextStart': -1, 'contextStride': 1})
    c['conv_padding_trainable'] = dict(
        op='sequence_conv',
        inputs={'X': [('x', x, LOD_A, True)],
                'Filter': [('filt', _f(rs, 24, 5), None, True)],
                'PaddingData': [('pad', _f(rs, 3, 6), None, True)]},
        outputs={'Out': ['out']},
        attrs={'contextLength': 4, 'contextStart': -2, 'contextStride': 1,
               'paddingTrainable': True})
    c['lod_reset_target'] = dict(
        op='lod_reset', inputs={'X': [('x', x, LOD_A, True)]},
        outputs={'Out': ['out']}, attrs={'target_lod': [0, 4, 10]})
    c['lod_reset_y'] = dict(
        op='lod_reset',
        inputs={'X': [('x', x, None, True)],
                'Y': [('y', _f(rs, 10, 1), LOD_A)]},
        outputs={'Out': ['out']}, attrs={})
    for dt in ('int64', 'float32'):
        c['mask_' + dt] = dict(
            op='sequence_mask',
            inputs={'X': [('x', np.array([3, 0, 1, 6, 2], 'int64'))]},
            outputs={'Y': ['out']},
            attrs={'maxlen': 6, 'out_dtype': np.dtype(dt)})
    return c


CASES = _cases()


@pytest.mark.parametrize('key', sorted(CASES))
def test_sequence_op_matches_the_jax_executor(key):
    _run_seq_op(CASES[key])


def test_max_pool_splits_a_tie_evenly():
    """Two rows of one sequence tie at its max: each takes half the
    cotangent, in both packages (the JAX ``segment_max`` VJP)."""
    x = np.array([[1.0], [3.0], [3.0], [2.0]], 'float32')
    case = dict(op='sequence_pool', inputs={'X': [('x', x, [[0, 4]], True)]},
                outputs={'Out': ['out']}, attrs={'pooltype': 'MAX'})
    got, want = _run_seq_op(case)
    w = 2 * np.asarray(want['out'])     # the weight is out's cotangent
    g = np.asarray(got['x@GRAD']).reshape(-1)
    assert g[0] == 0 and g[3] == 0 and g[1] == g[2] != 0


# ---------------------------------------------------------------------------
# LoD propagation


def _propagation_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        words = pkg.layers.data(name='words', shape=[1], dtype='int64',
                                lod_level=1)
        sq = pkg.layers.data(name='sq', shape=[6], dtype='float32',
                             lod_level=1)
        ids = pkg.layers.data(name='ids', shape=[1], dtype='int64')
        emb = pkg.layers.embedding(words, size=[20, 6])
        hid = pkg.layers.fc(emb, size=4)
        pooled = pkg.layers.sequence_pool(hid, 'sum')
        tr = pkg.layers.transpose(sq, perm=[1, 0])
        ga = pkg.layers.gather(sq, ids)
    return main, startup, [emb, hid, pooled, tr, ga]


def test_lod_propagates_through_fc_lookup_table_and_pool_not_transpose():
    """A [6, 6] ragged input: ``transpose2`` and ``gather`` give outputs of
    the same leading dimension, which take no LoD (``share_lod=False``);
    the embedding rows and the fc take the ids' LoD; the pool drops it."""
    rs = np.random.RandomState(4)
    feed = {'words': (rs.randint(0, 20, (6, 1)).astype('int64'),
                      [[0, 2, 2, 6]]),
            'sq': (_f(rs, 6, 6), [[0, 1, 6]]),
            'ids': np.array([[5], [0], [1], [2], [3], [4]], 'int64')}
    res, init = {}, None
    for pkg in (jfluid, fluid):
        main, startup, outs = _propagation_program(pkg)
        exe = pkg.Executor(CPU)
        if init is None:
            scope = pkg.Scope()
            exe.run(startup, scope=scope)
            init = {n: np.array(scope.get(n)) for n in scope.names()}
        else:
            scope = scope_from_numpy(init, device='cpu')
        res[pkg] = exe.run(main, feed=feed, fetch_list=outs, scope=scope)
    lods = [[_lod(v) for v in res[pkg]] for pkg in (jfluid, fluid)]
    assert lods[0] == lods[1] == [[[0, 2, 2, 6]], [[0, 2, 2, 6]], [], [], []]
    for g, w in zip(res[fluid], res[jfluid]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_registry_flags_match_the_jax_package():
    """``share_lod`` and ``static_inputs`` of every op type both packages
    register: a wrong flag gives a silent wrong LoD downstream."""
    shared = sorted(set(tregistry.all_ops()) & set(jregistry.all_ops()))
    assert 'lstm' in shared and 'transpose2' in shared and \
        'sequence_pool' in shared
    for t in shared:
        j, p = jregistry.get_op(t), tregistry.get_op(t)
        assert (p.share_lod, p.static_inputs) == \
            (j.share_lod, j.static_inputs), t
    # every op type the port registers is one the JAX package registers,
    # but the backward meta-op's own
    assert set(tregistry.all_ops()) - set(jregistry.all_ops()) <= \
        {'backward'}
