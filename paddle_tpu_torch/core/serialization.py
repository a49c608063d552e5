"""Durable Program serialization: a versioned plain-dict schema as JSON.

The port's own copy of paddle_tpu/core/serialization.py, with the same
format tag (``paddle_tpu.program``) and version: a program saved by either
package loads in the other, and the same model built by each serializes to
the same dict. Nothing in the schema references live Python objects;
dtypes are strings, numpy values in attrs are tagged dicts and a
parameter's L1 or L2 decay is its class name and coefficient. An attr
value the schema cannot hold raises at save time.
"""
import json

import numpy as np

from .types import convert_np_dtype_to_dtype_, dtype_str

__all__ = ['FORMAT', 'VERSION', 'program_to_dict', 'program_from_dict',
           'save_program', 'load_program']

FORMAT = 'paddle_tpu.program'
VERSION = 1


def encode_attr(value):
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.dtype):
        return {'__kind__': 'dtype', 'v': dtype_str(value)}
    if isinstance(value, type) and issubclass(value, np.generic):
        return {'__kind__': 'dtype', 'v': dtype_str(np.dtype(value))}
    if isinstance(value, np.ndarray):
        return {'__kind__': 'ndarray', 'dtype': dtype_str(value.dtype),
                'shape': list(value.shape),
                'v': value.astype(np.float64).ravel().tolist()
                if value.dtype.kind == 'f'
                else value.ravel().tolist()}
    if isinstance(value, (list, tuple)):
        return {'__kind__': 'list', 'v': [encode_attr(v) for v in value]} \
            if any(isinstance(v, (list, tuple, dict, np.generic, np.dtype,
                                  np.ndarray)) for v in value) \
            else list(value)
    if isinstance(value, dict):
        return {'__kind__': 'dict',
                'v': {str(k): encode_attr(v) for k, v in value.items()}}
    raise TypeError(
        "attr value %r (%s) is not serializable" % (value,
                                                    type(value).__name__))


def decode_attr(value):
    if isinstance(value, list):
        return [decode_attr(v) for v in value]
    if isinstance(value, dict):
        kind = value.get('__kind__')
        if kind == 'dtype':
            return convert_np_dtype_to_dtype_(value['v'])
        if kind == 'ndarray':
            dt = convert_np_dtype_to_dtype_(value['dtype'])
            return np.asarray(value['v']).astype(dt).reshape(value['shape'])
        if kind == 'list':
            return [decode_attr(v) for v in value['v']]
        if kind == 'dict':
            return {k: decode_attr(v) for k, v in value['v'].items()}
        return {k: decode_attr(v) for k, v in value.items()}
    return value


# a parameter's regularizer is saved by class name and coefficient
_KNOWN_REGULARIZERS = ('L2DecayRegularizer', 'L1DecayRegularizer')


def _encode_var(v):
    from ..framework import Parameter
    d = {
        'name': v.name,
        'kind': 'param' if isinstance(v, Parameter) else 'var',
        'shape': list(v.shape) if v.shape is not None else None,
        'dtype': dtype_str(v.dtype) if v.dtype is not None else None,
        'lod_level': v.lod_level,
        'persistable': bool(v.persistable),
        'stop_gradient': bool(v.stop_gradient),
        'type': v.type,
        'is_data': bool(v.is_data),
    }
    if isinstance(v, Parameter):
        d['trainable'] = bool(v.trainable)
        d['optimize_attr'] = encode_attr(v.optimize_attr or {})
        reg = v.regularizer
        if reg is not None and type(reg).__name__ in _KNOWN_REGULARIZERS:
            d['regularizer'] = {'type': type(reg).__name__,
                                'coeff': float(reg._regularization_coeff)}
    return d


def _decode_var(block, d):
    kw = dict(name=d['name'], shape=d['shape'], dtype=d['dtype'],
              lod_level=d.get('lod_level', 0),
              persistable=d.get('persistable', False),
              stop_gradient=d.get('stop_gradient', False),
              type=d.get('type', 'lod_tensor'),
              is_data=d.get('is_data', False))
    if d.get('kind') == 'param':
        kw.pop('stop_gradient', None)  # Parameter pins stop_gradient=False
        kw['trainable'] = d.get('trainable', True)
        kw['optimize_attr'] = decode_attr(d.get('optimize_attr', {})) or \
            {'learning_rate': 1.0}
        reg = d.get('regularizer')
        if reg is not None:
            from .. import regularizer as _regmod
            cls = getattr(_regmod, reg['type'], None)
            if cls is not None:
                kw['regularizer'] = cls(reg['coeff'])
        if kw['dtype'] is None:
            kw['dtype'] = 'float32'
        shape = kw.pop('shape')
        dtype = kw.pop('dtype')
        return block.create_parameter(shape=shape, dtype=dtype, **kw)
    return block.create_var(**kw)


def _encode_op(op):
    return {
        'type': op.type,
        'inputs': {k: list(v) for k, v in op.inputs.items()},
        'outputs': {k: list(v) for k, v in op.outputs.items()},
        'attrs': {k: encode_attr(v) for k, v in op.attrs.items()},
    }


def program_to_dict(program):
    return {
        'format': FORMAT,
        'version': VERSION,
        'random_seed': program.random_seed,
        'is_test': bool(program._is_test),
        'blocks': [
            {'idx': b.idx, 'parent_idx': b.parent_idx,
             'vars': [_encode_var(v) for v in b.vars.values()],
             'ops': [_encode_op(op) for op in b.ops]}
            for b in program.blocks
        ],
    }


def program_from_dict(d):
    from ..framework import Program, Block
    if d.get('format') != FORMAT:
        raise ValueError("not a %s file (format=%r)" % (FORMAT,
                                                        d.get('format')))
    if d.get('version', 0) > VERSION:
        raise ValueError(
            "model format version %s is newer than this runtime (%s)"
            % (d['version'], VERSION))
    p = Program()
    p.random_seed = d.get('random_seed', 0)
    p._is_test = d.get('is_test', False)
    for bd in d['blocks'][1:]:
        p.blocks.append(Block(p, bd['idx'], bd['parent_idx']))
    for bd in d['blocks']:
        block = p.block(bd['idx'])
        block.parent_idx = bd['parent_idx']
        for vd in bd['vars']:
            _decode_var(block, vd)
        for od in bd['ops']:
            block.append_op(type=od['type'],
                            inputs={k: list(v)
                                    for k, v in od['inputs'].items()},
                            outputs={k: list(v)
                                     for k, v in od['outputs'].items()},
                            attrs={k: decode_attr(v)
                                   for k, v in od['attrs'].items()})
    p.current_block_idx = 0
    p._bump_version()
    return p


def save_program(program, path):
    with open(path, 'w') as f:
        json.dump(program_to_dict(program), f)


def load_program(path):
    with open(path, 'r') as f:
        return program_from_dict(json.load(f))
