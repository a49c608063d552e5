"""A bounded ``While`` program for the tests of Executor.bind and
run_fused over loops (tests/test_torch_control_flow.py on the CPU,
tests/test_torch_cuda.py on the card). It imports only the package it is
handed."""
import numpy as np


def loop_program(fluid, bound, train=False):
    """(main, startup, fetch list): s = sum of x * w over n iterations (n
    fed), each partial sum written to an array at the counter; with
    ``train`` an SGD step on sum(s)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data(name='x', shape=[4], append_batch_size=False)
        n = L.data(name='n', shape=[1], dtype='int64',
                   append_batch_size=False)
        w = L.create_parameter(
            [4], 'float32', name='loop.w',
            default_initializer=fluid.initializer.ConstantInitializer(0.5))
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        s = L.fill_constant(shape=[4], dtype='float32', value=0.0)
        s.stop_gradient = False
        arr = L.create_array('float32', capacity=8)
        cond = L.less_than(i, n)
        loop = L.While(cond, max_trip_count=bound)
        with loop.block():
            L.assign(L.tanh(L.elementwise_add(s, L.elementwise_mul(x, w))),
                     s)
            L.array_write(s, i, array=arr)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=cond)
        stacked, _ = L.tensor_array_to_tensor(arr, axis=0, use_stack=True)
        fetch = [L.reduce_sum(s), s, i, stacked, L.array_length(arr)]
        if train:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(fetch[0])
    return main, startup, fetch


def loop_feeds(trips, seed=0):
    rs = np.random.RandomState(seed)
    return [{'x': rs.randn(4).astype('float32'),
             'n': np.array([k], 'int64')} for k in trips]
