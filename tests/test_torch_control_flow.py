"""Control flow of paddle_tpu_torch against the JAX package, on the CPU:
``While`` with tensor arrays, ``StaticRNN``, ``DynamicRNN`` (ragged),
``Switch``, ``ConditionalBlock``, ``IfElse``, ``beam_search``,
``beam_search_decode`` and ``tensor_array_to_tensor``'s length rule, the
18 cases of tests/test_control_flow.py.

Each case builds one program in both packages (the program dicts equal,
sub-blocks included), runs the JAX startup program, carries its scope
into the port (``io.scope_from_numpy``) and runs the same numpy-seeded
feeds through both executors: float fetches within 1e-5 relative (and
1e-6 absolute, for values near 0), ids, lengths and flags equal. The
training cases take 3 steps and hold the losses and the trained state
the same way. The two raising cases raise in both packages with the JAX
message. A control-flow program saved by the JAX package loads in the
port with an equal dict. A While under ``Executor.bind`` equals ``run()``
bitwise, and under ``bind`` and ``run_fused`` one with no bound, and one
whose condition holds past its ``max_trip_count``, equal the JAX
executor (``lax.while_loop``, which the bound does not cut).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.core import serialization as jser

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.core.registry import all_ops
from paddle_tpu_torch.io import scope_from_numpy

import torch_loop_cases

CPU = fluid.CPUPlace()
RTOL, ATOL = 1e-5, 1e-6
CONTROL_FLOW_OPS = (
    'while', 'conditional_block', 'recurrent', 'drnn_boot_memory',
    'create_tensor_array', 'write_to_array', 'read_from_array',
    'lod_array_length', 'tensor_array_to_tensor', 'lod_rank_table',
    'max_sequence_len', 'lod_tensor_to_array', 'array_to_lod_tensor',
    'shrink_rnn_memory', 'reorder_lod_tensor_by_rank', 'split_lod_tensor',
    'merge_lod_tensor', 'beam_search', 'beam_search_decode')


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels and
    fills monitor series; leave both empty after this module."""
    yield
    goodput.reset()
    monitor.reset()


def _build(pkg, fn):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        fetch = fn(pkg, pkg.layers)
    return main, startup, fetch


def _state(scope):
    return {n: np.array(scope.get(n)) for n in scope.names()
            if hasattr(scope.get(n), 'shape')}


def _port_state(scope):
    return {n: scope.get(n).detach().cpu().numpy() for n in scope.names()}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind == 'f':
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        # x64 is off on the JAX side: an int64 fetch comes back int32
        assert got.dtype.kind == want.dtype.kind, (what, got.dtype,
                                                    want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# the cases: fn(pkg, layers) -> fetch list, the feeds of each step

def while_counter_and_array(pkg, layers):
    i = layers.fill_constant(shape=[1], dtype='int64', value=0)
    n = layers.fill_constant(shape=[1], dtype='int64', value=5)
    acc = layers.fill_constant(shape=[1], dtype='float32', value=0.0)
    arr = layers.create_array('float32', capacity=8)
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        nxt = layers.elementwise_add(
            acc, layers.fill_constant([1], 'float32', 2.0))
        layers.assign(nxt, acc)
        arr = layers.array_write(acc, i, array=arr)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(i, n, cond=cond)
    length = layers.array_length(arr)
    third = layers.array_read(arr, layers.fill_constant([], 'int32', 2))
    out, idx = layers.tensor_array_to_tensor(arr, axis=0)
    return [acc, length, third, i, out, idx]


def while_nested_in_program(pkg, layers):
    x = layers.data(name='x', shape=[4], append_batch_size=False)
    i = layers.fill_constant(shape=[1], dtype='int64', value=0)
    n = layers.fill_constant(shape=[1], dtype='int64', value=3)
    s = layers.fill_constant(shape=[4], dtype='float32', value=0.0)
    cond = layers.less_than(i, n)
    w = layers.While(cond)
    with w.block():
        layers.assign(layers.elementwise_add(s, x), s)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(i, n, cond=cond)
    return [s]


def static_rnn_forward(pkg, layers):
    x = layers.data(name='x', shape=[3, 2, 4], append_batch_size=False)
    h0 = layers.data(name='h0', shape=[2, 4], append_batch_size=False)
    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(init=h0)
        h = layers.elementwise_add(layers.scale(h_prev, scale=2.0), x_t)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    return [rnn()]


def static_rnn_memory_batch_ref(pkg, layers):
    x = layers.data(name='x', shape=[4, 3, 5], append_batch_size=False)
    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(shape=[5], batch_ref=x, value=0.0,
                            ref_batch_dim_idx=1)
        h = layers.elementwise_add(h_prev, x_t)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    return [rnn()]


def static_rnn_trains(pkg, layers):
    T, N, D = 5, 4, 8
    x = layers.data(name='x', shape=[T, N, D], append_batch_size=False)
    y = layers.data(name='y', shape=[N, D], append_batch_size=False)
    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(shape=[D], batch_ref=x, value=0.0,
                            ref_batch_dim_idx=1)
        h = layers.fc(input=[x_t, h_prev], size=D, act='tanh')
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    seq = rnn()
    last = layers.slice(seq, axes=[0], starts=[T - 1], ends=[T])
    last = layers.reshape(last, shape=[N, D])
    loss = layers.reduce_mean(layers.square_error_cost(last, y))
    pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return [loss, seq]


def dynamic_rnn_ragged_cumsum(pkg, layers):
    x = layers.data(name='x', shape=[4], lod_level=1)
    drnn = layers.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(x)
        mem = drnn.memory(shape=[4], value=0.0)
        h = layers.elementwise_add(mem, x_t)
        drnn.update_memory(mem, h)
        drnn.output(h)
    # the last memory: each sequence's state at its own last step
    return [drnn(), drnn._last_mems[0]]


def dynamic_rnn_with_fc_trains(pkg, layers):
    x = layers.data(name='x', shape=[6], lod_level=1)
    y = layers.data(name='y', shape=[3, 8], append_batch_size=False)
    drnn = layers.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(x)
        mem = drnn.memory(shape=[8], value=0.0)
        h = layers.fc(input=[x_t, mem], size=8, act='tanh')
        drnn.update_memory(mem, h)
        drnn.output(h)
    out = drnn()
    last = layers.sequence_last_step(out)
    loss = layers.reduce_mean(layers.square_error_cost(last, y))
    pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return [loss, out]


def switch_piecewise(pkg, layers):
    step = layers.data(name='step', shape=[1], append_batch_size=False)
    lr = layers.create_global_var(shape=[1], value=0.0, dtype='float32',
                                  persistable=True, name='lr_sw')
    b1 = layers.fill_constant([1], 'float32', 5.0)
    b2 = layers.fill_constant([1], 'float32', 10.0)
    with layers.Switch() as switch:
        with switch.case(layers.less_than(step, b1)):
            layers.assign(layers.fill_constant([1], 'float32', 1.0), lr)
        with switch.case(layers.less_than(step, b2)):
            layers.assign(layers.fill_constant([1], 'float32', 0.5), lr)
        with switch.default():
            layers.assign(layers.fill_constant([1], 'float32', 0.1), lr)
    return [lr]


def conditional_block_scalar(pkg, layers):
    flag = layers.data(name='flag', shape=[1], dtype='bool',
                       append_batch_size=False)
    out = layers.create_global_var(shape=[2], value=-1.0, dtype='float32',
                                   persistable=True, name='cb_out')
    cb = layers.ConditionalBlock([flag], is_scalar_condition=True)
    with cb.block():
        layers.assign(layers.fill_constant([2], 'float32', 7.0), out)
    return [out]


def ifelse_rowwise(pkg, layers):
    x = layers.data(name='x', shape=[4, 1], append_batch_size=False)
    cond = layers.greater_than(
        x, layers.fill_constant([4, 1], 'float32', 0.0))
    ie = layers.IfElse(cond)
    with ie.true_block():
        d = ie.input(x)
        ie.output(layers.scale(d, scale=2.0))
    with ie.false_block():
        d = ie.input(x)
        ie.output(layers.scale(d, scale=-1.0))
    return [ie()]


def beam_search_step(pkg, layers):
    pre_ids = layers.data(name='pre_ids', shape=[4, 1],
                          append_batch_size=False, dtype='int64')
    pre_scores = layers.data(name='pre_scores', shape=[4, 1],
                             append_batch_size=False)
    ids = layers.data(name='ids', shape=[4, 3], append_batch_size=False,
                      dtype='int64')
    scores = layers.data(name='scores', shape=[4, 3],
                         append_batch_size=False)
    return list(layers.beam_search(pre_ids, pre_scores, ids, scores,
                                   beam_size=2, end_id=0))


def beam_search_decode_backtrack(pkg, layers):
    ids_arr = layers.create_array('int64', capacity=4)
    par_arr = layers.create_array('int32', capacity=4)
    sc_arr = layers.create_array('float32', capacity=4)
    i0 = layers.fill_constant([], 'int32', 0)
    i1 = layers.fill_constant([], 'int32', 1)
    t0 = layers.assign(np.array([[3], [4]], 'int64'))
    t1 = layers.assign(np.array([[5], [6]], 'int64'))
    p0 = layers.assign(np.array([0, 1], 'int32'))
    p1 = layers.assign(np.array([1, 0], 'int32'))
    s0 = layers.assign(np.array([[-1.], [-2.]], 'float32'))
    s1 = layers.assign(np.array([[-3.], [-4.]], 'float32'))
    ids_arr = layers.array_write(t0, i0, ids_arr)
    ids_arr = layers.array_write(t1, i1, ids_arr)
    par_arr = layers.array_write(p0, i0, par_arr)
    par_arr = layers.array_write(p1, i1, par_arr)
    sc_arr = layers.array_write(s0, i0, sc_arr)
    sc_arr = layers.array_write(s1, i1, sc_arr)
    return list(layers.beam_search_decode(ids_arr, sc_arr, par_arr,
                                          beam_size=2, end_id=0))


def _weighted_loop(pkg, layers, bound, name, cap=None, n_trips=3):
    x = layers.data(name='x', shape=[4], append_batch_size=False)
    w = layers.create_parameter(
        [4], 'float32', name=name,
        default_initializer=pkg.initializer.ConstantInitializer(0.5))
    i = layers.fill_constant(shape=[1], dtype='int64', value=0)
    n = layers.fill_constant(shape=[1], dtype='int64', value=n_trips)
    s = layers.fill_constant(shape=[4], dtype='float32', value=0.0)
    s.stop_gradient = False
    arr = layers.create_array('float32', capacity=cap) if cap else None
    zero = layers.fill_constant([], 'int32', 0)
    cond = layers.less_than(i, n)
    loop = layers.While(cond, max_trip_count=bound)
    with loop.block():
        layers.assign(layers.elementwise_add(
            s, layers.elementwise_mul(x, w)), s)
        if arr is not None:
            layers.array_write(s, zero, array=arr)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(i, n, cond=cond)
    loss = layers.reduce_sum(s)
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss, s, i]


def while_differentiable_with_max_trip_count(pkg, layers):
    return _weighted_loop(pkg, layers, 8, 'w')


def while_in_training_without_bound_raises(pkg, layers):
    return _weighted_loop(pkg, layers, None, 'w2')


def while_inferred_bound_too_small_errors(pkg, layers):
    return _weighted_loop(pkg, layers, None, 'w3', cap=2, n_trips=5)


def tensor_array_to_tensor_written_length_only(pkg, layers):
    arr = layers.create_array('float32', capacity=8)
    for k in range(3):
        v = layers.fill_constant([2], 'float32', float(k + 1))
        arr = layers.array_write(
            v, layers.fill_constant([], 'int32', k), array=arr)
    return list(layers.tensor_array_to_tensor(arr, axis=0))


def var_first_written_inside_block_is_carried(pkg, layers):
    flag = layers.fill_constant([1], 'bool', True)
    out = pkg.default_main_program().current_block().create_var(
        name='cb_out', shape=[2], dtype='float32')
    cb = layers.ConditionalBlock([flag], is_scalar_condition=True)
    with cb.block():
        layers.assign(layers.fill_constant([2], 'float32', 7.0), out)
    return ['cb_out']


def conditional_block_nonscalar_numel_semantics(pkg, layers):
    xs = layers.fill_constant([2], 'float32', 0.0)
    acc = layers.fill_constant([1], 'float32', 0.0)
    cb = layers.ConditionalBlock([xs], is_scalar_condition=False)
    with cb.block():
        layers.assign(layers.fill_constant([1], 'float32', 5.0), acc)
    return [acc]


_R = np.random.RandomState(27)
_X5 = _R.rand(5, 4, 8).astype('float32')
_Y5 = _R.rand(4, 8).astype('float32')
_XD = _R.rand(7, 6).astype('float32')
_YD = _R.rand(3, 8).astype('float32')
_BEAM_FEED = {
    'pre_ids': np.array([[5], [6], [7], [0]], 'int64'),
    'pre_scores': np.array([[-1.], [-2.], [-1.], [-0.5]], 'float32'),
    'ids': np.tile(np.array([[1, 2, 3]], 'int64'), (4, 1)),
    'scores': np.array([[-1.5, -2.5, -9.], [-2.1, -2.2, -9.],
                        [-3.0, -1.2, -9.], [-4.0, -4.1, -9.]], 'float32'),
}
# name: (builder, feeds of each step, raise (message) or None)
CASES = {
    'while_counter_and_array': (while_counter_and_array, [{}], None),
    'while_nested_in_program': (
        while_nested_in_program, [{'x': np.arange(4).astype('float32')}],
        None),
    'static_rnn_forward': (static_rnn_forward, [{
        'x': _R.rand(3, 2, 4).astype('float32'),
        'h0': _R.rand(2, 4).astype('float32')}], None),
    'static_rnn_memory_batch_ref': (static_rnn_memory_batch_ref, [{
        'x': _R.rand(4, 3, 5).astype('float32')}], None),
    'static_rnn_trains': (static_rnn_trains, [{'x': _X5, 'y': _Y5}] * 3,
                          None),
    'dynamic_rnn_ragged_cumsum': (dynamic_rnn_ragged_cumsum, [{
        'x': (_R.rand(6, 4).astype('float32'), [[0, 3, 4, 6]])}], None),
    'dynamic_rnn_with_fc_trains': (dynamic_rnn_with_fc_trains, [{
        'x': (_XD, [[0, 2, 5, 7]]), 'y': _YD}] * 3, None),
    'switch_piecewise': (switch_piecewise, [
        {'step': np.array([v], 'float32')} for v in (3.0, 7.0, 20.0)],
        None),
    'conditional_block_scalar': (conditional_block_scalar, [
        {'flag': np.array([False])}, {'flag': np.array([True])}], None),
    'ifelse_rowwise': (ifelse_rowwise, [{'x': np.array(
        [[1.], [-2.], [3.], [-4.]], 'float32')}], None),
    'beam_search_step': (beam_search_step, [_BEAM_FEED], None),
    # exact ties (dead lanes at -1e9 absorb log p in float32): the lower
    # candidate index first, as lax.top_k takes them
    'beam_search_ties': (beam_search_step, [dict(
        _BEAM_FEED, scores=np.array([[-1e9, -1e9, -1e9], [-2., -1e9, -2.],
                                     [-1e9, -1e9, -1e9], [-1e9, -1e9, -1e9]],
                                    'float32'))], None),
    'beam_search_decode_backtrack': (beam_search_decode_backtrack, [{}],
                                     None),
    'while_differentiable_with_max_trip_count': (
        while_differentiable_with_max_trip_count,
        [{'x': np.ones(4, 'float32')}] * 3, None),
    'while_in_training_without_bound_raises': (
        while_in_training_without_bound_raises,
        [{'x': np.ones(4, 'float32')}], 'trip-count bound'),
    'tensor_array_to_tensor_written_length_only': (
        tensor_array_to_tensor_written_length_only, [{}], None),
    'var_first_written_inside_block_is_carried': (
        var_first_written_inside_block_is_carried, [{}], None),
    'conditional_block_nonscalar_numel_semantics': (
        conditional_block_nonscalar_numel_semantics, [{}], None),
    'while_inferred_bound_too_small_errors': (
        while_inferred_bound_too_small_errors,
        [{'x': np.ones(4, 'float32')}], 'too small'),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_control_flow_matches_the_jax_executor(name):
    fn, feeds, raises = CASES[name]
    jmain, jstart, jfetch = _build(jfluid, fn)
    tmain, tstart, tfetch = _build(fluid, fn)
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    assert tser.program_to_dict(tstart) == jser.program_to_dict(jstart)
    assert len(tmain.blocks) == len(jmain.blocks)
    jexe, texe = jfluid.Executor(), fluid.Executor(CPU)
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    tscope = scope_from_numpy(_state(jscope), device='cpu')
    if raises:
        for exe, main, fetch, scope in ((jexe, jmain, jfetch, jscope),
                                        (texe, tmain, tfetch, tscope)):
            with pytest.raises(Exception, match=raises):
                exe.run(main, feed=feeds[0], fetch_list=fetch, scope=scope)
        return
    for step, feed in enumerate(feeds):
        want = jexe.run(jmain, feed=feed, fetch_list=jfetch, scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=tfetch, scope=tscope)
        for k, (g, w) in enumerate(zip(got, want)):
            _close(g, w, '%s step %d fetch %d' % (name, step, k))
            if hasattr(w, 'lod') and w.lod():
                assert [list(l) for l in g.lod()] == \
                    [list(l) for l in w.lod()]
    jstate, tstate = _state(jscope), _port_state(tscope)
    for n in sorted(jstate):
        _close(tstate[n], jstate[n], '%s state %s' % (name, n))


def test_the_control_flow_ops_and_layers_are_ported():
    assert set(CONTROL_FLOW_OPS) <= set(all_ops())
    for name in ('While', 'StaticRNN', 'DynamicRNN', 'ConditionalBlock',
                 'Switch', 'IfElse', 'create_array', 'array_write',
                 'array_read', 'array_length', 'tensor_array_to_tensor',
                 'lod_rank_table', 'max_sequence_len', 'lod_tensor_to_array',
                 'array_to_lod_tensor', 'shrink_memory',
                 'reorder_lod_tensor_by_rank', 'split_lod_tensor',
                 'merge_lod_tensor', 'beam_search', 'beam_search_decode',
                 'topk', 'create_parameter'):
        assert name in fluid.layers.__all__, name
        assert name in jfluid.layers.__all__, name


def test_a_jax_control_flow_program_loads_in_the_port(tmp_path):
    """A program with sub-blocks saved by the JAX package loads in the port
    with an equal dict, and saved back by the port it loads in the JAX
    package with an equal dict."""
    jmain, _, _ = _build(jfluid, dynamic_rnn_with_fc_trains)
    path = str(tmp_path / 'prog.json')
    jser.save_program(jmain, path)
    tmain = tser.load_program(path)
    assert len(tmain.blocks) == 2
    assert tmain.block(1).parent_idx == 0
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    back = str(tmp_path / 'back.json')
    tser.save_program(tmain, back)
    assert jser.program_to_dict(jser.load_program(back)) == \
        jser.program_to_dict(jmain)


def test_while_an_empty_loop_sizes_its_arrays_as_the_jax_package():
    """A loop whose condition is false from the start leaves an array it
    would write as zeros of the written element's shape, length 0 (the
    JAX package's abstract probe); one it never writes becomes
    [capacity, 1] float32."""
    def fn(pkg, layers):
        i = layers.fill_constant(shape=[1], dtype='int64', value=3)
        n = layers.fill_constant(shape=[1], dtype='int64', value=2)
        arr = layers.create_array('float32', capacity=4)
        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            v = layers.fill_constant([3], 'float32', 1.0)
            layers.array_write(v, i, array=arr)
            layers.increment(i, value=1, in_place=True)
            layers.less_than(i, n, cond=cond)
        out, idx = layers.tensor_array_to_tensor(arr, axis=0,
                                                 use_stack=True)
        return [out, idx, layers.array_length(arr)]

    jmain, jstart, jfetch = _build(jfluid, fn)
    tmain, tstart, tfetch = _build(fluid, fn)
    want = jfluid.Executor().run(jmain, fetch_list=jfetch,
                                 scope=jfluid.Scope())
    got = fluid.Executor(CPU).run(tmain, fetch_list=tfetch,
                                  scope=fluid.Scope())
    assert got[0].shape == (4, 3)
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 'fetch %d' % k)


def _never_run(body):
    """A program whose While never runs ``body(layers, arr, i)`` (its
    condition false from the start), an unwritten array beside it, then a
    uniform_random; with ``body`` None, the program without the loop."""
    def fn(pkg, layers):
        s = layers.data(name='s', shape=[1], dtype='float32', lod_level=1)
        x = layers.fill_constant(shape=[6, 1], dtype='float32', value=2.0)
        i = layers.fill_constant(shape=[1], dtype='int64', value=3)
        n = layers.fill_constant(shape=[1], dtype='int64', value=2)
        arr = layers.create_array('float32', capacity=4)
        if body:
            cond = layers.less_than(i, n)
            w = layers.While(cond)
            with w.block():
                body(layers, s, x, arr, i)
                layers.increment(i, value=1, in_place=True)
                layers.less_than(i, n, cond=cond)
        return [x, layers.uniform_random([5], min=-1.0, max=1.0)]
    return fn


_NEVER_RUN_FEED = {'s': (np.arange(6, dtype='float32').reshape(6, 1),
                         [[0, 2, 6]])}


def _drawing_body(layers, s, x, arr, i):
    layers.assign(s, output=x)
    layers.array_write(layers.uniform_random([3]), i, array=arr)


def _faulty_body(layers, s, x, arr, i):
    layers.lod_rank_table(x)
    layers.array_write(layers.fill_constant([3], 'float32', 1.0), i,
                       array=arr)


def test_while_an_empty_loop_probe_raises_a_fault_of_its_body():
    """The run of a never-run body that sizes its arrays lets an op's fault
    through (here a rank table of a tensor with no LoD), as the JAX
    package's trace of the body raises it."""
    for pkg, exe in ((jfluid, jfluid.Executor()),
                     (fluid, fluid.Executor(CPU))):
        main, _, fetch = _build(pkg, _never_run(_faulty_body))
        with pytest.raises(ValueError, match='lod_rank_table: input has no '
                                             'LoD'):
            exe.run(main, feed=_NEVER_RUN_FEED, fetch_list=fetch,
                    scope=pkg.Scope())


def test_while_an_empty_loop_probe_leaves_the_run_as_it_found_it():
    """The run of a never-run body that sizes its arrays draws nothing from
    the run's generator (the uniform_random after the loop equals the
    program's without the loop) and leaves the values as they were; the
    LoDs it records are the JAX trace's: ``x``, which only the body
    assigns a LoD tensor, keeps its value and takes the LoD of ``s``, as
    the JAX executor gives it."""
    outs = []
    for body in (None, _drawing_body):
        main, _, fetch = _build(fluid, _never_run(body))
        outs.append(fluid.Executor(CPU).run(
            main, feed=_NEVER_RUN_FEED, fetch_list=fetch,
            scope=fluid.Scope()))
    (_, r0), (x1, r1) = outs
    np.testing.assert_array_equal(r1, r0)
    np.testing.assert_array_equal(x1, np.full((6, 1), 2.0, 'float32'))
    jmain, _, jfetch = _build(jfluid, _never_run(_drawing_body))
    jx, _ = jfluid.Executor().run(jmain, feed=_NEVER_RUN_FEED,
                                  fetch_list=jfetch, scope=jfluid.Scope())
    np.testing.assert_array_equal(x1, np.asarray(jx))
    assert [list(l) for l in jx.lod()] == [[0, 2, 6]]
    assert [list(l) for l in x1.lod()] == [list(l) for l in jx.lod()]


# ---------------------------------------------------------------------------
# loops under Executor.bind and run_fused (on the CPU a bound plan runs the
# step eagerly, as its first step on the card; tests/test_torch_cuda.py
# holds the captured replays)

def _loop_runs(train):
    """Each feed's fetches through run() and through one bind and its
    calls, from the same startup state; and both scopes."""
    main, startup, fetch = torch_loop_cases.loop_program(fluid, 8, train)
    exe = fluid.Executor(CPU)
    scopes = [fluid.Scope(), fluid.Scope()]
    for s in scopes:
        exe.run(startup, scope=s)
    feeds = torch_loop_cases.loop_feeds((3, 5, 8, 1))
    ref = [exe.run(main, feed=f, fetch_list=fetch, scope=scopes[0])
           for f in feeds]
    bp = exe.bind(main, feeds[0], fetch_list=fetch, scope=scopes[1])
    got = [bp.first_out] + [bp(f) for f in feeds[1:]]
    return ref, got, scopes


@pytest.mark.parametrize('train', [False, True])
def test_bound_while_equals_run_calls(train):
    """A While(max_trip_count=8) at 3, 5, 8 and 1 trips: the bound step
    (the bound's iterations, finished ones masked) equals run() (a host
    loop, or under the backward the same bounded loop) bitwise, state
    included."""
    ref, got, scopes = _loop_runs(train)
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert [int(np.asarray(r[2])[0]) for r in ref] == [3, 5, 8, 1]
    np.testing.assert_array_equal(scopes[1].get('loop.w').numpy(),
                                  scopes[0].get('loop.w').numpy())


def _jax_loop_refs(bound, trips):
    """The JAX executor's fetches of the loop program (bound ``bound``) at
    each of ``trips``, and the feeds."""
    main, startup, fetch = torch_loop_cases.loop_program(jfluid, bound)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    feeds = torch_loop_cases.loop_feeds(trips)
    return [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds], feeds


def _bound_and_fused_hold_jax(bound, trips):
    """``bind`` (its first step and a call a feed) and ``run_fused`` over
    the same feeds against the JAX executor's ``run()``, fetch by fetch."""
    want, feeds = _jax_loop_refs(bound, trips)
    main, startup, fetch = torch_loop_cases.loop_program(fluid, bound)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    bp = exe.bind(main, feeds[0], fetch_list=fetch, scope=scope)
    got = [bp.first_out] + [bp(f) for f in feeds[1:]]
    fused = exe.run_fused(main, feeds, fetch_list=fetch, scope=scope)
    for step, (g, w) in enumerate(zip(got, want)):
        for k, (a, b) in enumerate(zip(g, w)):
            _close(a, b, 'bind step %d fetch %d' % (step, k))
    for k, (a, b) in enumerate(zip(fused, want[-1])):
        _close(a, b, 'run_fused fetch %d' % k)
    assert [int(np.asarray(w[2])[0]) for w in want] == list(trips)


def test_bound_and_fused_unbounded_while_equal_the_jax_executor():
    """A While with no max_trip_count under ``bind`` and ``run_fused`` runs
    to its condition (``lax.while_loop``), at 3, 6, 0 and 8 trips."""
    _bound_and_fused_hold_jax(None, (3, 6, 0, 8))


def test_bound_while_past_its_max_trip_count_equals_the_jax_executor():
    """A While(max_trip_count=4) whose condition holds for 6 and 7 trips:
    without a gradient the JAX package runs ``lax.while_loop`` and does not
    cut it, and neither do ``bind`` and ``run_fused``."""
    _bound_and_fused_hold_jax(4, (6, 2, 7))


_CUT = 'inferred trip-count bound 8'


def test_bound_training_while_past_its_inferred_bound_raises():
    """A differentiated While with no max_trip_count, bounded by its
    array's capacity of 8: a feed that needs 10 trips raises in the JAX
    executor (its check on every step) and in the port's ``run()``, a
    call of ``bind`` and ``run_fused``, each naming the inferred bound;
    the bound program then runs a feed of 5 trips as ``run()`` does."""
    feeds = torch_loop_cases.loop_feeds((5, 10))
    jmain, jstartup, jfetch = torch_loop_cases.loop_program(
        jfluid, None, train=True)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    with pytest.raises(Exception, match=_CUT):
        jexe.run(jmain, feed=feeds[1], fetch_list=jfetch, scope=jscope)
    main, startup, fetch = torch_loop_cases.loop_program(fluid, None,
                                                         train=True)
    exe = fluid.Executor(CPU)
    scopes = [fluid.Scope(), fluid.Scope()]
    for sc in scopes:
        exe.run(startup, scope=sc)
    with pytest.raises(RuntimeError, match=_CUT):
        exe.run(main, feed=feeds[1], fetch_list=fetch, scope=scopes[0])
    bp = exe.bind(main, feeds[0], fetch_list=fetch, scope=scopes[1])
    with pytest.raises(RuntimeError, match=_CUT):
        bp(feeds[1])
    with pytest.raises(RuntimeError, match=_CUT):
        exe.run_fused(main, feeds, fetch_list=fetch, scope=scopes[1])
    for sc in scopes:
        sc.set('loop.w', np.full(4, 0.5, 'float32'))
    want = exe.run(main, feed=feeds[0], fetch_list=fetch, scope=scopes[0])
    for a, b in zip(want, bp(feeds[0])):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def _draw_runs(bound, trips, noise):
    """The loop program with ``noise`` at ``bound``: ``run()`` at each of
    ``trips``, then ``bind`` (its first step and a call a feed) and
    ``run_fused`` over the same feeds on a second executor, which counts
    the same run indices (so the run's generator draws the same)."""
    main, startup, fetch = torch_loop_cases.loop_program(fluid, bound,
                                                         noise=noise)
    feeds = torch_loop_cases.loop_feeds(trips)
    exes = [fluid.Executor(CPU), fluid.Executor(CPU)]
    scopes = [fluid.Scope(), fluid.Scope()]
    for exe, sc in zip(exes, scopes):
        exe.run(startup, scope=sc)
    ref = [exes[0].run(main, feed=f, fetch_list=fetch, scope=scopes[0])
           for f in feeds]
    ref.append([exes[0].run(main, feed=f, fetch_list=fetch,
                            scope=scopes[0]) for f in feeds][-1])
    bp = exes[1].bind(main, feeds[0], fetch_list=fetch, scope=scopes[1])
    got = [bp.first_out] + [bp(f) for f in feeds[1:]]
    got.append(exes[1].run_fused(main, feeds, fetch_list=fetch,
                                 scope=scopes[1]))
    return ref, got, feeds


@pytest.mark.parametrize('bound,noise', [(8, True), (None, 'run')],
                         ids=['bound_8_seeded', 'no_bound_run_generator'])
def test_bound_while_that_draws_equals_run_calls(bound, noise):
    """A While whose body draws (a seeded uniform; with no bound, also one
    from the run's generator) at 3, 5, 8 and 1 trips (with no bound 3, 0,
    12 and 1): ``bind`` and ``run_fused`` equal ``run()`` bitwise (each
    run reseeds the generators; on the card the loop is one WHILE node
    whose trips draw what ``run()`` draws in them,
    tests/test_torch_cuda.py), each trip draws anew, and the draws move
    the sum off the noiseless program's. With no bound the JAX executor
    (``lax.while_loop``) runs the same trips: the counters and lengths
    equal, and its draws lie in the same range (the two packages' bits
    differ, core/lowering.py). The JAX package folds only the op index
    into a drawing op's key, so its body draws one value in every trip:
    the port draws anew in each trip, as an eager loop of torch draws
    (ROADMAP Queue 3, noted)."""
    trips = (3, 5, 8, 1) if bound else (3, 0, 12, 1)
    ref, got, feeds = _draw_runs(bound, trips, noise)
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    half = 0.2 if noise == 'run' else 0.1
    n = min(trips[2], 8)
    for drawn in (np.asarray(ref[2][-1]),):
        assert len(np.unique(drawn[:n], axis=0)) == n
        assert np.all(np.abs(drawn[:n]) < half)
    main, startup, fetch = torch_loop_cases.loop_program(fluid, bound)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    noiseless = exe.run(main, feed=feeds[0], fetch_list=fetch, scope=scope)
    assert not np.array_equal(np.asarray(noiseless[0]),
                              np.asarray(ref[0][0]))
    if bound is not None:
        return
    jmain, jstartup, jfetch = torch_loop_cases.loop_program(
        jfluid, bound, noise=noise)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    want = [jexe.run(jmain, feed=f, fetch_list=jfetch, scope=jscope)
            for f in feeds]
    for w, r in zip(want, ref):
        for k in (2, 4):
            np.testing.assert_array_equal(np.asarray(r[k]),
                                          np.asarray(w[k]))
        assert np.asarray(r[-1]).shape == np.asarray(w[-1]).shape
    jdrawn = np.asarray(want[2][-1])
    assert len(np.unique(jdrawn[:n], axis=0)) == 1
    assert np.all(np.abs(jdrawn[:n]) < half)


def test_tensor_array_matches_the_jax_tensor_array():
    """core/tensor_array.py against the JAX package's TensorArray: from_list
    into a larger capacity, writes out of range (the index clamped, the
    length counting it unclamped), reads, the static length and the masked
    stack."""
    import jax.numpy as jnp
    import torch
    from paddle_tpu.core.tensor_array import TensorArray as JArray
    from paddle_tpu_torch.core.tensor_array import TensorArray as TArray
    rs = np.random.RandomState(9)
    elems = [rs.randn(2, 3).astype('float32') for _ in range(3)]
    j = JArray.from_list([jnp.asarray(e) for e in elems], capacity=5)
    t = TArray.from_list([torch.from_numpy(e) for e in elems], capacity=5)
    new = rs.randn(2, 3).astype('float32')
    for i, static in ((1, 1), (7, None), (-2, None)):
        j = j.write(i, jnp.asarray(new), static_i=static)
        t = t.write(torch.tensor([i]), torch.from_numpy(new),
                    static_i=static)
        assert t.static_length == j.static_length
        assert int(t.length) == int(j.length)
        for k in range(-1, 7):
            np.testing.assert_array_equal(t.read(k).numpy(),
                                          np.asarray(j.read(k)))
    np.testing.assert_array_equal(t.stack().numpy(), np.asarray(j.stack()))
    short = JArray.from_list([jnp.asarray(e) for e in elems], capacity=5)
    tshort = TArray.from_list([torch.from_numpy(e) for e in elems],
                              capacity=5)
    np.testing.assert_array_equal(tshort.masked_stack().numpy(),
                                  np.asarray(short.masked_stack()))
    assert t.clear_static().static_length is None
