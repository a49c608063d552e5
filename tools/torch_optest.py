"""Replay the recorded op cases (``optest_cases/``) through the PyTorch port.

Each case is a pickle written by paddle_tpu/core/optest_collect.py: a
Program, its feeds (with their LoDs in ``static_lods``), its read-only and
read-write state, the fetch names and the JAX package's CPU fetches. This
module loads a case without the JAX package: the pickled paddle_tpu
objects (Program, Block, Variable, Parameter, Operator, initializers) are
read into plain stand-ins, and :func:`program_dict` writes them in the
shared program format (``paddle_tpu.program``), which the port's
``core.serialization.program_from_dict`` reads. It then runs the case
through the port's ``Executor.run`` on a device and holds each fetch to
the recorded one under the corpus's own rule (tools/tpu_optest.py,
constants in TPU_OPTEST.json):

    |got - cpu| <= loosen * (atol + rtol * |cpu|)   elementwise,

rtol 1e-3, atol 1e-4 and ``loosen`` the largest per-op factor over the
case's op types (default 1); shapes equal; dtype kinds (bool, int, float)
equal, values compared and not widths (the JAX package runs with x64 off,
so an int64 program's fetch was recorded as int32).

A case is skipped, with the reason, when it has an op type the port does
not register, an op whose JAX lowering draws from the JAX key stream
(:data:`RNG_OPS`; its draws follow JAX's keys), or when tools/tpu_optest.py
cannot replay it either (``py_func``, save/load outside the fixture path).

Run on the CPU or the card:

    python tools/torch_optest.py [--device cuda]

prints one JSON line per op type (cases run, worst normalised violation),
one per failing case (its fetches' rows or the exception) and a summary
line, and exits 1 when a case fails. ``chip_smoke.py``
phase 23 calls :func:`replay_all` on the card;
``tests/test_torch_optest_replay.py`` replays every case on the CPU.
"""
import glob
import json
import os
import pickle
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE_DIR = os.path.join(ROOT, 'optest_cases')
FORMAT = 'paddle_tpu.program'

# the ops whose JAX lowering draws from ctx.rng(): the needs_rng
# registrations of paddle_tpu/ops/random_ops.py, and sampling_id
# (paddle_tpu/ops/tensor_ops.py:458)
RNG_OPS = frozenset(('uniform_random', 'uniform_random_batch_size_like',
                     'gaussian_random', 'truncated_gaussian_random',
                     'dropout', 'random_crop', 'sampling_id'))
# save/load ops replay only from the fixture directory that
# tools/tailcases.py writes (tools/tpu_optest.py `_FIX_PREFIX`)
SAVELOAD = frozenset(('save', 'load', 'save_combine', 'load_combine'))
FIXTURE_PREFIX = '/tmp/paddle_optest_fixtures'


def constants():
    """(rtol, atol, {op type: loosen factor}) from TPU_OPTEST.json."""
    with open(os.path.join(ROOT, 'TPU_OPTEST.json')) as f:
        rep = json.load(f)
    return rep['rtol'], rep['atol'], rep['per_op_loosen']


# -- loading without the JAX package -----------------------------------------

class Stub(object):
    """A pickled paddle_tpu object: its instance dict, nothing else."""


_STUBS = {}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == 'paddle_tpu' or module.startswith('paddle_tpu.'):
            cls = _STUBS.get((module, name))
            if cls is None:
                cls = _STUBS[(module, name)] = type(
                    name, (Stub,), {'__module__': 'stub.' + module})
            return cls
        return super().find_class(module, name)


def case_paths():
    """Every case pickle, forward cases then gradient cases, by name."""
    return sorted(glob.glob(os.path.join(CASE_DIR, 'case_*.pkl'))) + \
        sorted(glob.glob(os.path.join(CASE_DIR, 'gradcase_*.pkl')))


def load_case(path):
    """The case dict of one pickle, its ``program`` as stand-ins."""
    with open(path, 'rb') as f:
        return _Unpickler(f).load()


def _dtype_str(dt):
    if dt is None:
        return None
    if isinstance(dt, str):
        return dt
    return np.dtype(dt).name


def _encode_attr(value):
    """paddle_tpu/core/serialization.py `encode_attr` over plain values."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.dtype):
        return {'__kind__': 'dtype', 'v': _dtype_str(value)}
    if isinstance(value, type) and issubclass(value, np.generic):
        return {'__kind__': 'dtype', 'v': _dtype_str(np.dtype(value))}
    if isinstance(value, np.ndarray):
        return {'__kind__': 'ndarray', 'dtype': _dtype_str(value.dtype),
                'shape': list(value.shape),
                'v': value.astype(np.float64).ravel().tolist()
                if value.dtype.kind == 'f' else value.ravel().tolist()}
    if isinstance(value, (list, tuple)):
        return {'__kind__': 'list', 'v': [_encode_attr(v) for v in value]} \
            if any(isinstance(v, (list, tuple, dict, np.generic, np.dtype,
                                  np.ndarray)) for v in value) \
            else list(value)
    if isinstance(value, dict):
        return {'__kind__': 'dict',
                'v': {str(k): _encode_attr(v) for k, v in value.items()}}
    raise TypeError('attr value %r (%s) is not serializable'
                    % (value, type(value).__name__))


_REGULARIZERS = ('L2DecayRegularizer', 'L1DecayRegularizer')


def _encode_var(v):
    d = v.__dict__
    param = type(v).__name__ == 'Parameter'
    out = {'name': d['name'], 'kind': 'param' if param else 'var',
           'shape': list(d['shape']) if d.get('shape') is not None else None,
           'dtype': _dtype_str(d.get('dtype')),
           'lod_level': d.get('lod_level', 0),
           'persistable': bool(d.get('persistable', False)),
           'stop_gradient': bool(d.get('stop_gradient', False)),
           'type': d.get('type', 'lod_tensor'),
           'is_data': bool(d.get('is_data', False))}
    if param:
        out['trainable'] = bool(d.get('trainable', True))
        out['optimize_attr'] = _encode_attr(d.get('optimize_attr') or {})
        reg = d.get('regularizer')
        if reg is not None and type(reg).__name__ in _REGULARIZERS:
            out['regularizer'] = {
                'type': type(reg).__name__,
                'coeff': float(reg.__dict__['_regularization_coeff'])}
    return out


def program_dict(program):
    """The stand-in Program in the shared program format, as
    paddle_tpu/core/serialization.py `program_to_dict` writes it."""
    p = program.__dict__
    return {'format': FORMAT, 'version': 1,
            'random_seed': p['random_seed'],
            'is_test': bool(p['_is_test']),
            'blocks': [
                {'idx': b.__dict__['idx'],
                 'parent_idx': b.__dict__['parent_idx'],
                 'vars': [_encode_var(v) for v in b.__dict__['vars'].values()],
                 'ops': [{'type': op.__dict__['type'],
                          'inputs': {k: list(v) for k, v in
                                     op.__dict__['inputs'].items()},
                          'outputs': {k: list(v) for k, v in
                                      op.__dict__['outputs'].items()},
                          'attrs': {k: _encode_attr(v) for k, v in
                                    op.__dict__['attrs'].items()}}
                         for op in b.__dict__['ops']]}
                for b in p['blocks']]}


def _ops_of(pdict):
    return [op for b in pdict['blocks'] for op in b['ops']]


# -- what is replayed ----------------------------------------------------------

def skip_reason(case, pdict, registered):
    """Why the port does not replay ``case`` (None when it does)."""
    ops = set(case['ops'])
    missing = sorted(ops - set(registered) - {'feed', 'fetch'})
    if missing:
        return 'op types the port does not register: %s' % missing
    rng = sorted(ops & RNG_OPS)
    if rng:
        return 'draws from the JAX key stream: %s' % rng
    if 'py_func' in ops:
        return 'py_func replays a callable of the recording process'
    for op in _ops_of(pdict):
        if op['type'] in SAVELOAD and not str(
                op['attrs'].get('file_path', '')).startswith(FIXTURE_PREFIX):
            return '%s outside the fixture path' % op['type']
    return None


def run_case(case, pdict, device='cpu'):
    """The port's fetches (numpy) of one case through ``Executor.run`` on
    ``device``: its state in a new Scope, its LoD feeds rebuilt as (array,
    lod) from ``static_lods`` (tools/tpu_optest.py `_run_via_executor`)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.serialization import program_from_dict
    program = program_from_dict(pdict)
    dev = torch.device(device)
    place = fluid.CPUPlace() if dev.type == 'cpu' else \
        fluid.CUDAPlace(dev.index or 0)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    scope.update(dict(case['ro']))
    scope.update(dict(case['rw']))
    feed = dict(case['feed'])
    for n, lod in (case['static_lods'] or {}).items():
        if n in feed:
            arr = feed[n][0] if isinstance(feed[n], tuple) else feed[n]
            feed[n] = (arr, [list(l) for l in lod])
        else:
            scope._lods[n] = lod
    return exe.run(program, feed=feed, fetch_list=list(case['fetch_names']),
                   scope=scope, return_numpy=True)


_KIND = {'b': 'bool', 'i': 'int', 'u': 'int', 'f': 'float'}


def compare(case, got, rtol, atol, loosen_by_op):
    """(passed, rows): each fetch against the recorded CPU fetch. ``viol``
    is the largest |got - cpu| / (atol + rtol |cpu|); a fetch passes when
    it is at most the case's loosen factor (exact for bool and int)."""
    loosen = max([loosen_by_op.get(t, 1) for t in case['ops']] or [1])
    rows, ok = [], True
    for name, want, have in zip(case['fetch_names'], case['cpu_fetches'],
                                got):
        want, have = np.asarray(want), np.asarray(have)
        row = dict(fetch=name, loosen=loosen)
        kinds = (_KIND.get(want.dtype.kind), _KIND.get(have.dtype.kind))
        if want.shape != have.shape or kinds[0] != kinds[1]:
            row['error'] = 'shape %s %s, got %s %s' % (
                want.shape, want.dtype, have.shape, have.dtype)
            ok = False
        elif kinds[0] != 'float':
            row['viol'] = 0.0 if np.array_equal(want, have) else float('inf')
        else:
            c, t = want.astype(np.float64), have.astype(np.float64)
            with np.errstate(invalid='ignore'):
                d = np.abs(c - t)
                # NaN and inf where the recording has them, and only there
                same = (np.isnan(c) & np.isnan(t)) | (c == t)
                v = np.where(same, 0.0, d / (atol + rtol * np.abs(c)))
            v = np.where(np.isnan(v), np.inf, v)
            row['viol'] = float(v.max()) if v.size else 0.0
        if 'viol' in row:
            row['pass'] = row['viol'] <= loosen
            ok = ok and row['pass']
        rows.append(row)
    if len(got) != len(case['cpu_fetches']):
        ok = False
    return ok, rows


def replay_all(device='cpu'):
    """Replay every case on ``device``: ({case file: (status, detail)},
    {op type: [cases run, worst violation]}), status 'pass', 'fail' or
    'skip'. A failing case's detail is its rows or the exception."""
    from paddle_tpu_torch.core.registry import all_ops
    rtol, atol, loosen = constants()
    registered = set(all_ops())
    results, by_op = {}, {}
    for path in case_paths():
        name = os.path.basename(path)
        case = load_case(path)
        pdict = program_dict(case['program'])
        why = skip_reason(case, pdict, registered)
        if why:
            results[name] = ('skip', why)
            continue
        try:
            ok, rows = compare(case, run_case(case, pdict, device), rtol,
                               atol, loosen)
        except Exception as e:  # a fault of the port: reported, counted
            ok, rows = False, '%s: %s' % (type(e).__name__, e)
        results[name] = ('pass' if ok else 'fail', rows)
        worst = max([r.get('viol', float('inf')) for r in rows]
                    if isinstance(rows, list) else [float('inf')])
        for t in set(case['ops']) - {'feed', 'fetch'}:
            cur = by_op.setdefault(t, [0, 0.0])
            cur[0] += 1
            cur[1] = max(cur[1], worst)
    return results, by_op


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cpu')
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    results, by_op = replay_all(args.device)
    for t in sorted(by_op):
        print(json.dumps(dict(op=t, cases=by_op[t][0],
                              worst_viol=by_op[t][1])))
    failed = sorted(n for n, (s, _) in results.items() if s == 'fail')
    for n in failed:
        print(json.dumps(dict(failed=n, detail=results[n][1]), default=str))
    status = [s for s, _ in results.values()]
    print(json.dumps(dict(device=args.device, cases=len(results),
                          passed=status.count('pass'),
                          skipped=status.count('skip'), failed=failed)))
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
