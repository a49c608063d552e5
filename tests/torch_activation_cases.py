"""One-op programs of the activation and math op types of
paddle_tpu_torch (ops/activations.py, ops/math_ops.py), built the same way
in the JAX package and in the port, with their inputs made from a numpy
seed. tests/test_torch_activations.py holds each to the JAX executor on
the CPU, and tests/test_torch_cuda.py the card to the CPU. This module
imports neither package: each function takes the package as ``pkg``.

Every case feeds its inputs as data variables of their exact shape and
fetches the op's outputs and the gradient of ``sum(out * ct)`` (``ct`` a
seeded cotangent of the first output's shape) with respect to every float
input and every parameter, through ``calc_gradient`` and
``Executor.run``. The activations' inputs hold the points where the two
libraries could part: ties at the clips' bounds (0 and 6 for ``relu6``, 0
and 24 for ``brelu``, -2.5 and 2.5 for ``hard_sigmoid``, +-40 for
``soft_relu``), the shrinks' thresholds, and the halves that ``round``
takes to even.
"""
import zlib

import numpy as np

ACTIVATIONS = [
    'logsigmoid', 'exp', 'rsqrt', 'abs', 'ceil', 'floor', 'cos', 'sin',
    'round', 'reciprocal', 'log', 'softplus', 'softsign', 'tanh_shrink',
    'softshrink', 'brelu', 'soft_relu', 'pow', 'stanh', 'relu6',
    'leaky_relu', 'elu', 'hard_shrink', 'hard_sigmoid', 'swish',
    'thresholded_relu', 'selu', 'prelu_simple', 'prelu', 'maxout']
MATH = [
    'minus', 'cumsum', 'l1_norm', 'squared_l2_distance', 'cos_sim', 'norm',
    'bilinear_tensor_product', 'huber_loss', 'hinge_loss', 'rank_loss',
    'margin_rank_loss', 'smooth_l1_loss', 'bpr_loss',
    'teacher_student_sigmoid_loss']

# ties, thresholds and halves (module docstring), then random values
SPECIAL = np.array([0.0, 6.0, 24.0, -2.5, 2.5, 0.5, -0.5, 1.5, -1.5, 1.0,
                    40.0, -40.0, 3.5, -1.0], 'float32')


def _rs(key):
    return np.random.RandomState(zlib.crc32(key.encode()) & 0xffff)


def _act_input(key, positive=False):
    x = np.concatenate([SPECIAL, (3 * _rs(key).randn(10)).astype('float32')])
    if positive:
        x = np.abs(x) + 0.25
    return x.reshape(4, 6)


def _op(pkg, op_type, inputs, outputs, attrs=None):
    """Append ``op_type`` with ``inputs`` ({slot: var}) and float32
    outputs ({slot: shape}); returns {slot: var}."""
    helper = pkg.layer_helper.LayerHelper(op_type)
    outs = {s: helper.create_variable_for_type_inference('float32',
                                                         shape=shape)
            for s, shape in outputs.items()}
    helper.append_op(type=op_type,
                     inputs={s: [v] for s, v in inputs.items()},
                     outputs={s: [v] for s, v in outs.items()},
                     attrs=attrs or {})
    return outs


def _act(op_type, **attrs):
    """The activation's layer, or the op itself where it has none."""
    def build(pkg, v):
        fn = getattr(pkg.layers, op_type, None)
        if fn is not None:
            return {'Out': fn(v['x'], **attrs)}
        return _op(pkg, op_type, {'X': v['x']}, {'Out': v['x'].shape}, attrs)
    return build


def _layer(name, *args, **kw):
    """A layer of layers/nn.py on the inputs named in ``args``."""
    def build(pkg, v):
        return {'Out': getattr(pkg.layers, name)(*[v[a] for a in args],
                                                 **kw)}
    return build


def cases():
    """{key: (build, feeds, wrt)}: ``build(pkg, inputs)`` appends the op
    and returns its outputs by slot (the first is the one ``ct`` weighs),
    ``feeds`` the numpy inputs by name, ``wrt`` the names to
    differentiate. A key is the op type, with ``:variant`` for more than
    one case of a type."""
    c = {}
    for t in ACTIVATIONS:
        if t in ('prelu', 'maxout', 'hard_sigmoid'):
            continue
        positive = t in ('rsqrt', 'log', 'pow')
        c[t] = (_act(t), {'x': _act_input(t, positive)}, ['x'])
    # at the default slope 0.2, x = -2.5 is no tie in float32: two
    # roundings give 0.2f * -2.5 + 0.5 = 0, while XLA's CPU backend fuses
    # the product and the sum into one FMA and gets -7.45e-9 (below the
    # bound, gradient 0). The exact ties are held at slope 0.5 below;
    # tests/test_torch_activations.py pins the difference at -2.5.
    x = _act_input('hard_sigmoid')
    x[x == -2.5] = -3.0
    c['hard_sigmoid'] = (_act('hard_sigmoid'), {'x': x}, ['x'])
    # attributes off their defaults
    c['pow:2.5'] = (_act('pow', factor=2.5), {'x': _act_input('pow', True)},
                    ['x'])
    c['leaky_relu:0.1'] = (_layer('leaky_relu', 'x', alpha=0.1),
                           {'x': _act_input('leaky_relu')}, ['x'])
    c['brelu:1_3'] = (_layer('brelu', 'x', t_min=1.0, t_max=3.5),
                      {'x': _act_input('brelu')}, ['x'])
    c['soft_relu:1.5'] = (_layer('soft_relu', 'x', threshold=1.5),
                          {'x': _act_input('soft_relu')}, ['x'])
    c['selu:layer'] = (_layer('selu', 'x', scale=1.5, alpha=0.5),
                       {'x': _act_input('selu')}, ['x'])
    c['swish:2'] = (_layer('swish', 'x', beta=2.0),
                    {'x': _act_input('swish')}, ['x'])
    c['hard_sigmoid:attrs'] = (_act('hard_sigmoid', slope=0.5, offset=0.25),
                               {'x': _act_input('hard_sigmoid')}, ['x'])
    img = _act_input('prelu').reshape(1, 6, 2, 2)
    img = np.concatenate([img, -img[:, ::-1]]).astype('float32')
    for mode in ('all', 'channel', 'element'):
        c['prelu:' + mode] = (_layer('prelu', 'x', mode=mode), {'x': img},
                              ['x'])
    # maxout ties: a channel repeated inside its group
    tied = img.copy()
    tied[:, 1] = tied[:, 0]
    c['maxout'] = (_layer('maxout', 'x', groups=2), {'x': tied}, ['x'])
    c['maxout:3'] = (_layer('maxout', 'x', groups=3), {'x': img}, ['x'])

    rs = _rs('math')
    f = lambda *s: rs.randn(*s).astype('float32')
    c['minus'] = (lambda pkg, v: _op(pkg, 'minus', {'X': v['x'], 'Y': v['y']},
                                     {'Out': (4, 5)}),
                  {'x': f(4, 5), 'y': f(4, 5)}, ['x', 'y'])
    for ex in (False, True):
        for rev in (False, True):
            key = 'cumsum' + ('' if not (ex or rev) else
                              ':%s%s' % ('exclusive' * ex, '_reverse' * rev))
            c[key] = (_layer('cumsum', 'x', axis=1, exclusive=ex,
                             reverse=rev), {'x': f(3, 7)}, ['x'])
    c['cumsum:axis0'] = (_layer('cumsum', 'x', axis=0), {'x': f(5, 3)},
                         ['x'])
    c['l1_norm'] = (lambda pkg, v: _op(pkg, 'l1_norm', {'X': v['x']},
                                       {'Out': ()}),
                    {'x': f(4, 5)}, ['x'])
    c['squared_l2_distance'] = (
        lambda pkg, v: _op(pkg, 'squared_l2_distance',
                           {'X': v['x'], 'Y': v['y']},
                           {'Out': (4, 1), 'sub_result': (4, 5)}),
        {'x': f(4, 5), 'y': f(4, 5)}, ['x', 'y'])
    c['cos_sim'] = (_layer('cos_sim', 'x', 'y'), {'x': f(4, 6),
                                                  'y': f(4, 6)}, ['x', 'y'])
    c['norm'] = (_layer('l2_normalize', 'x', axis=1), {'x': f(4, 6)}, ['x'])
    c['norm:axis0'] = (_layer('l2_normalize', 'x', axis=0, epsilon=1e-6),
                       {'x': f(4, 6)}, ['x'])
    btp = {'x': f(3, 4), 'y': f(3, 5), 'w': f(2, 4, 5), 'b': f(1, 2)}
    c['bilinear_tensor_product'] = (
        lambda pkg, v: _op(pkg, 'bilinear_tensor_product',
                           {'X': v['x'], 'Y': v['y'], 'Weight': v['w'],
                            'Bias': v['b']}, {'Out': (3, 2)}),
        btp, ['x', 'y', 'w', 'b'])
    c['bilinear_tensor_product:no_bias'] = (
        lambda pkg, v: _op(pkg, 'bilinear_tensor_product',
                           {'X': v['x'], 'Y': v['y'], 'Weight': v['w']},
                           {'Out': (3, 2)}),
        {k: btp[k] for k in 'xyw'}, ['x', 'y', 'w'])
    # |y - x| at delta exactly in the first two rows
    hx, hy = f(6, 3), f(6, 3)
    hy[:2] = hx[:2] + np.array([[1.0], [-1.0]], 'float32')
    c['huber_loss'] = (lambda pkg, v: {'Out': pkg.layers.huber_loss(
        v['x'], v['y'], 1.0)}, {'x': hx, 'y': hy}, ['x', 'y'])
    lab01 = rs.randint(0, 2, (8, 1)).astype('float32')
    # 1 - (2l - 1) x = 0 where x = 2l - 1
    logits = f(8, 1)
    logits[:2] = 2 * lab01[:2] - 1
    c['hinge_loss'] = (_layer('hinge_loss', 'x', 'label'),
                       {'x': logits, 'label': lab01}, ['x'])
    c['rank_loss'] = (_layer('rank_loss', 'label', 'left', 'right'),
                      {'label': lab01, 'left': f(8, 1), 'right': f(8, 1)},
                      ['left', 'right'])
    pm = (2 * lab01 - 1).astype('float32')
    x1, x2 = f(8, 1), f(8, 1)
    x2[:2] = x1[:2] - 0.1 * pm[:2]         # at the margin: a tie
    c['margin_rank_loss'] = (_layer('margin_rank_loss', 'label', 'x1', 'x2',
                                    margin=0.1),
                             {'label': pm, 'x1': x1, 'x2': x2},
                             ['x1', 'x2'])
    c['margin_rank_loss:activated'] = (
        lambda pkg, v: _op(pkg, 'margin_rank_loss',
                           {'Label': v['label'], 'X1': v['x1'],
                            'X2': v['x2']},
                           {'Out': (8, 1), 'Activated': (8, 1)},
                           {'margin': 0.3}),
        {'label': pm, 'x1': x1, 'x2': x2}, ['x1', 'x2'])
    sx, sy = f(4, 3), f(4, 3)
    sy[0, 0] = sx[0, 0] - 1.0
    c['smooth_l1_loss'] = (_layer('smooth_l1', 'x', 'y'),
                           {'x': sx, 'y': sy}, ['x', 'y'])
    c['smooth_l1_loss:weights'] = (
        _layer('smooth_l1', 'x', 'y', 'iw', 'ow', sigma=2.0),
        {'x': sx, 'y': sy, 'iw': np.abs(f(4, 3)), 'ow': np.abs(f(4, 3))},
        ['x', 'y', 'iw', 'ow'])
    c['bpr_loss'] = (_layer('bpr_loss', 'x', 'label'),
                     {'x': 4 * f(4, 5),
                      'label': rs.randint(0, 5, (4, 1)).astype('int64')},
                     ['x'])
    tx = 10 * f(8, 1)
    tx[:2, 0] = [15.0, -15.0]
    c['teacher_student_sigmoid_loss'] = (
        _layer('teacher_student_sigmoid_loss', 'x', 'label'),
        {'x': tx, 'label': rs.uniform(0, 1, (8, 1)).astype('float32')},
        ['x'])
    c['teacher_student_sigmoid_loss:bounds'] = (
        _layer('teacher_student_sigmoid_loss', 'x', 'label',
               soft_max_up_bound=5.0, soft_max_lower_bound=-2.0),
        {'x': tx, 'label': rs.uniform(0, 1, (8, 1)).astype('float32')},
        ['x'])
    return c


def build_case(pkg, key, case):
    """(main, startup, fetch vars, names, feed) of one case in ``pkg``:
    the op's outputs, then the gradients of sum(out * ct) w.r.t. ``wrt``
    and every parameter."""
    build, feeds, wrt = case
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        v = {n: L.data(n, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False)
             for n, a in feeds.items()}
        outs = build(pkg, v)
        first = next(iter(outs.values()))
        shape = tuple(first.shape) or (1,)
        ct = L.data('ct', shape=list(shape), dtype='float32',
                    append_batch_size=False)
        loss = L.reduce_sum(L.elementwise_mul(first, ct))
        params = main.global_block().all_parameters()
        grads = pkg.calc_gradient(loss, [v[n] for n in wrt] + params)
    feed = dict(feeds, ct=_rs(key + ':ct').randn(*shape).astype('float32'))
    names = list(outs) + ['d' + n for n in wrt] + \
        ['d' + p.name for p in params]
    return main, startup, list(outs.values()) + grads, names, feed


def run_case(pkg, exe, key, case):
    """{name: numpy} of one case through the Executor ``exe``."""
    main, startup, fetch, names, feed = build_case(pkg, key, case)
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return dict(zip(names, [np.asarray(g) for g in got]))
