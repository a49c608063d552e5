"""Persistence, and the JAX package's weights and training state in the
port.

`save_vars`, `save_params`, `save_persistables`, `load_vars`,
`load_params`, `load_persistables` and `get_program_parameter` are the
port's own copies of paddle_tpu/io.py's, with the same signatures
(``load_params(executor, dirname, main_program=None, filename=None)``)
and the same files: one ``.npy`` per variable, with ``/`` in a name
written as ``%2F``, or one ``.npz`` when ``filename=`` is given; so the
two packages read each other's. They save from and load into
`global_scope()`; a loaded value enters the scope as a numpy array, which
the executor uploads at its first read (or a bound program copies into
the tensor its graph holds).

`save_inference_model` writes a program pruned for inference (its
``Backward`` and ``Optimize`` ops stripped, then `Program._prune` to the
targets, then the persistables no remaining op touches dropped) as
``__model__``, `core/serialization.program_to_dict` with ``feed_names``
and ``fetch_names`` beside it, and every persistable it still touches
(batch norm's moving statistics too) in ``__params__.npz``;
`load_inference_model` reads it back as (program, feed_names,
fetch_vars). The files are the JAX package's: an artifact written by
either package loads in the other. `export_stablehlo_model` and
`load_stablehlo_model` (XLA formats) raise NotImplementedError.

`read_params` returns such a directory's arrays by name, and
`params_from_numpy` maps those names onto the port's `TransformerLM` or
`BertPretrain` state (a scope whose names start with ``bert.`` is BERT's),
checking every name and shape. `train_state_from_numpy` takes a whole
training scope (the parameters, the Adam accumulators and the learning
rate) apart for the model and `optimizer.TensorAdam`. `scope_from_numpy`
puts every array of a JAX scope, by name, into a port `Scope` for the
Executor.
"""
import collections
import json
import os
import re
import tempfile

import numpy as np
import torch

from .executor import Scope, _to_numpy, global_scope
from .core import serialization as _ser
from .framework import (Parameter, Variable, default_main_program,
                        resolve_device)
from .models import bert
from .models.transformer import LMConfig, param_shapes

__all__ = ['save_vars', 'save_params', 'save_persistables', 'load_vars',
           'load_params', 'load_persistables', 'get_program_parameter',
           'save_inference_model', 'load_inference_model',
           'export_stablehlo_model', 'load_stablehlo_model', 'read_params',
           'params_from_numpy', 'train_state_from_numpy', 'scope_from_numpy']

# decode-engine state the JAX package keeps in the same scope: not weights
_IGNORED = ('gen_kv_k', 'gen_kv_v')


def _is_persistable(var):
    return var.persistable


def _is_parameter(var):
    return isinstance(var, Parameter)


def _var_path(dirname, name):
    return os.path.join(dirname, name.replace('/', '%2F') + '.npy')


def _npz_name(filename):
    # np.savez appends the suffix anyway; keep the loader in step
    return filename if filename.endswith('.npz') else filename + '.npz'


def _publish(path, write):
    """``write(file)`` into a temporary file beside ``path``, then rename it
    there: a crash mid-save leaves the old file or none, never a torn
    one."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or '.',
                               prefix='.tmp_')
    try:
        with os.fdopen(fd, 'wb') as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _vars(main_program, vars, predicate):
    if main_program is None:
        main_program = default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    return [v.name if isinstance(v, Variable) else v for v in vars]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Save the `global_scope()` values of ``vars`` (or of the variables of
    ``main_program`` that ``predicate`` takes) under ``dirname``."""
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for name in _vars(main_program, vars, predicate):
        val = scope.get(name)
        if val is None:
            raise RuntimeError("variable %r has no value in scope" % name)
        arrays[name] = _to_numpy(val)
    if filename is not None:
        _publish(os.path.join(dirname, _npz_name(filename)),
                 lambda f: np.savez(f, **arrays))
    else:
        for name, arr in arrays.items():
            _publish(_var_path(dirname, name),
                     lambda f, arr=arr: np.save(f, arr))


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Load ``vars`` (or the variables of ``main_program`` that
    ``predicate`` takes) from ``dirname`` into `global_scope()`, each as a
    numpy array."""
    scope = global_scope()
    stored = None
    if filename is not None:
        with np.load(os.path.join(dirname, _npz_name(filename))) as data:
            stored = {k: data[k] for k in data.files}
    for name in _vars(main_program, vars, predicate):
        if stored is not None:
            if name not in stored:
                raise RuntimeError("variable %r not found in %s"
                                   % (name, filename))
            scope.set(name, stored[name])
        else:
            path = _var_path(dirname, name)
            if not os.path.exists(path):
                raise RuntimeError("variable file %r not found" % path)
            scope.set(name, np.load(path))


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def get_program_parameter(program):
    return program.all_parameters()


MODEL_FILENAME = '__model__'
PARAMS_FILENAME = '__params__.npz'


def _prune_for_inference(main_program, target_names):
    """``clone(for_test=True)``, the ``Backward`` and ``Optimize`` ops
    stripped, then `Program._prune`. The strip comes first: an optimizer
    op writes its parameter under the parameter's own name, so pruning by
    dependence alone would keep the whole backward and optimizer."""
    program = main_program.clone(for_test=True)
    gb = program.global_block()
    gb.ops = [op for op in gb.ops
              if op.role not in ('Backward', 'Optimize')]
    program._bump_version()
    return program._prune(target_names)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True):
    """Prune ``main_program`` (default: the default main program) to the
    feeds and ``target_vars`` and write it under ``dirname`` with the
    `global_scope()` values of the persistables it reads. Returns the
    target names."""
    if main_program is None:
        main_program = default_main_program()
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    target_names = [t.name for t in target_vars]
    pruned = _prune_for_inference(main_program, target_names)
    # _prune keeps every persistable: drop those no remaining op touches
    # (optimizer accumulators, the learning rate)
    used = set(target_names)
    for block in pruned.blocks:
        for op in block.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
    gb = pruned.global_block()
    gb.vars = collections.OrderedDict(
        (k, v) for k, v in gb.vars.items() if k in used or not v.persistable)
    pruned._bump_version()
    os.makedirs(dirname, exist_ok=True)
    blob = _ser.program_to_dict(pruned)
    blob['feed_names'] = list(feeded_var_names)
    blob['fetch_names'] = target_names
    _publish(os.path.join(dirname, model_filename or MODEL_FILENAME),
             lambda f: f.write(json.dumps(blob).encode()))
    save_persistables(executor, dirname, pruned,
                      filename=params_filename or PARAMS_FILENAME)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, pserver_endpoints=None):
    """Read what `save_inference_model` (of either package) wrote: the
    persistables go into `global_scope()` as numpy arrays; returns
    (program, feed_names, fetch_vars)."""
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        blob = json.load(f)
    program = _ser.program_from_dict(blob)
    load_persistables(executor, dirname, program,
                      filename=params_filename or PARAMS_FILENAME)
    fetch_vars = [program.global_block().var(n) for n in blob['fetch_names']]
    return program, blob['feed_names'], fetch_vars


def export_stablehlo_model(*args, **kwargs):
    raise NotImplementedError(
        'export_stablehlo_model writes an XLA (StableHLO) artifact; its '
        'counterpart in paddle_tpu_torch (a torch.export one, or none) is '
        'still to be decided (ROADMAP Queue 1 item 7)')


def load_stablehlo_model(*args, **kwargs):
    raise NotImplementedError(
        'load_stablehlo_model reads an XLA (StableHLO) artifact; its '
        'counterpart in paddle_tpu_torch (a torch.export one, or none) is '
        'still to be decided (ROADMAP Queue 1 item 7)')


def read_params(dirname, filename=None):
    """{name: numpy array} of every variable in a directory written by
    `save_params` or `save_vars` of either package."""
    if filename is not None:
        with np.load(os.path.join(dirname, _npz_name(filename))) as data:
            return {k: data[k] for k in data.files}
    out = {}
    for fn in sorted(os.listdir(dirname)):
        if fn.endswith('.npy'):
            out[fn[:-4].replace('%2F', '/')] = np.load(
                os.path.join(dirname, fn))
    if not out:
        raise FileNotFoundError('no .npy parameter files in %r' % dirname)
    return out


def scope_from_numpy(arrays, scope=None, device=None):
    """Put every array of ``arrays`` ({name: numpy array or tensor}, such as
    a JAX scope's parameters, ``<param>_moment1_<k>`` ...,
    ``<param>_beta1_pow_acc_<k>`` ... and ``learning_rate_<k>``) into
    ``scope`` (a new `Scope` when None) by name, each a tensor of its own
    dtype on ``device`` (None: ``cuda:0``, raising without a card).
    Returns the scope."""
    dev = resolve_device(device)
    scope = Scope() if scope is None else scope
    for name, a in arrays.items():
        t = a.detach().clone() if isinstance(a, torch.Tensor) else \
            torch.from_numpy(np.array(a))
        scope.set(name, t.to(dev))
    return scope


def _is_bert(names):
    return any(n.startswith('bert.') for n in names)


def _infer_config(arrays):
    """The LMConfig, or for a ``bert.`` scope the BertConfig, that the
    arrays' shapes imply (head count aside: it shapes no parameter, so it
    does not matter for the check)."""
    pre = 'bert.' if _is_bert(arrays) else ''
    try:
        V, d = np.shape(arrays[pre + 'tok_emb.w'])
        d_ff = np.shape(arrays[pre + 'layer_0.ffn1.w'])[1]
        kw = {'type_vocab_size': np.shape(arrays['bert.seg_emb.w'])[0]} \
            if pre else {}
    except KeyError as e:
        raise ValueError('parameter %s is missing' % e) from None
    n_layer = 0
    while '%slayer_%d.ln1.w' % (pre, n_layer) in arrays:
        n_layer += 1
    return (bert.BertConfig if pre else LMConfig)(
        vocab_size=V, d_model=d, n_head=1, n_layer=n_layer, d_ff=d_ff, **kw)


def _want_shapes(cfg):
    return bert.param_shapes(cfg) if isinstance(cfg, bert.BertConfig) \
        else param_shapes(cfg)


def params_from_numpy(arrays, device=None, config=None):
    """{name: float32 tensor on ``device``} for `TransformerLM` or
    `BertPretrain`, from a {JAX parameter name: array} mapping (numpy
    arrays or tensors). The LM's names are ``tok_emb.w``,
    ``layer_{i}.{ln1,ln2}.{w,b}``, ``layer_{i}.attn.{qkv,proj}.{w,b}``,
    ``layer_{i}.{ffn1,ffn2}.{w,b}``, ``final_ln.{w,b}`` and ``lm_head.w``;
    BERT's are those of `models.bert.param_shapes` (``bert.tok_emb.w``,
    ``bert.layer_{i}...``, ``bert.mlm.out.w``, ...); ``gen_kv_k`` and
    ``gen_kv_v`` are ignored. Shapes are checked against ``config`` (an
    LMConfig or a BertConfig), or against the config the arrays imply when
    it is None. Raises ValueError
    on a missing, unexpected or mis-shaped name. ``device`` goes through
    `framework.resolve_device` once every name and shape has been checked:
    None means ``cuda:0`` (and raises without a card), ``'cpu'`` the
    CPU."""
    arrays = {k: v for k, v in arrays.items() if k not in _IGNORED}
    cfg = config if config is not None else _infer_config(arrays)
    want = _want_shapes(cfg)
    missing = [k for k in want if k not in arrays]
    extra = sorted(k for k in arrays if k not in want)
    if missing or extra:
        raise ValueError('parameter names do not match the %s: missing %s, '
                         'unexpected %s'
                         % ('BERT model' if isinstance(cfg, bert.BertConfig)
                            else 'LM', missing, extra))
    checked = {name: _tensor(arrays[name], shape, 'parameter %r' % name)
               for name, shape in want.items()}
    dev = resolve_device(device)
    return {name: t.to(dev) for name, t in checked.items()}


def _tensor(a, shape, what):
    """``a`` (an array or a tensor) as a contiguous float32 tensor, after
    checking its shape."""
    t = a.detach() if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.array(a, dtype=np.float32))
    if tuple(t.shape) != tuple(shape):
        raise ValueError('%s has shape %s, the model needs %s'
                         % (what, tuple(t.shape), tuple(shape)))
    return t.to(dtype=torch.float32).contiguous()


# the names `paddle_tpu.optimizer.AdamOptimizer` gives its accumulators
# (unique_name.generate(param + '_' + kind)) and its learning rate
_ACC = re.compile(r'^(.+)_(moment1|moment2|beta1_pow_acc|beta2_pow_acc)_'
                  r'\d+$')
_LR = re.compile(r'^learning_rate_\d+$')
_ACC_KEYS = {'moment1': 'moment1', 'moment2': 'moment2',
             'beta1_pow_acc': 'beta1_pow', 'beta2_pow_acc': 'beta2_pow'}


def train_state_from_numpy(arrays, device=None, config=None):
    """Take a JAX training scope of the LM or of BERT with Adam apart:
    returns (params, adam_state, learning_rate) with ``params`` as
    `params_from_numpy` gives them, ``adam_state`` as {parameter name:
    {'moment1', 'moment2', 'beta1_pow', 'beta2_pow'}} float32 tensors on
    ``device`` (None: ``cuda:0``, as in `params_from_numpy`; the form
    `optimizer.TensorAdam.load_state` takes) and ``learning_rate`` a
    one-element tensor there. The accumulators are
    ``<param>_moment1_<k>``, ``<param>_moment2_<k>``,
    ``<param>_beta1_pow_acc_<k>`` and ``<param>_beta2_pow_acc_<k>``; the
    learning rate is ``learning_rate_<k>``. Raises ValueError on a missing
    or unexpected name, a parameter with a missing or repeated
    accumulator, or a mis-shaped one."""
    plain, accs, lrs = {}, {}, []
    for name, a in arrays.items():
        m = _ACC.match(name)
        if _LR.match(name):
            lrs.append(name)
        elif m:
            slot = accs.setdefault(m.group(1), {})
            key = _ACC_KEYS[m.group(2)]
            if key in slot:
                raise ValueError('parameter %r has two %s accumulators'
                                 % (m.group(1), key))
            slot[key] = a
        else:
            plain[name] = a
    if len(lrs) != 1:
        raise ValueError('expected one learning_rate_<k> variable, found %s'
                         % sorted(lrs))
    params = params_from_numpy(plain, 'cpu', config)
    extra = sorted(set(accs) - set(params))
    if extra:
        raise ValueError('accumulators of unknown parameters %s' % extra)
    state = {}
    for name, p in params.items():
        slot = accs.get(name, {})
        missing = sorted(set(_ACC_KEYS.values()) - set(slot))
        if missing:
            raise ValueError('parameter %r lacks its Adam accumulators %s'
                             % (name, missing))
        state[name] = {
            key: _tensor(slot[key], p.shape if key.startswith('moment')
                         else (1,), '%s %s' % (name, key))
            for key in ('moment1', 'moment2', 'beta1_pow', 'beta2_pow')}
    lr = _tensor(np.reshape(np.asarray(arrays[lrs[0]], np.float32), (1,)),
                 (1,), lrs[0])
    # every name and shape checked: now the device (None: cuda:0)
    dev = resolve_device(device)
    return ({n: p.to(dev) for n, p in params.items()},
            {n: {k: t.to(dev) for k, t in s.items()}
             for n, s in state.items()}, lr.to(dev))
