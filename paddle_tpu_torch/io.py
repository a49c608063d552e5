"""Carry the JAX package's weights and training state into the port.

`load_params` reads what `paddle_tpu.io.save_params` writes — one combined
``.npz`` (``filename=``) or one ``.npy`` per variable, with ``/`` in a name
written as ``%2F`` — and `params_from_numpy` maps those names onto the
port's `TransformerLM` or `BertPretrain` state (a scope whose names start
with ``bert.`` is BERT's), checking every name and shape.
`train_state_from_numpy` takes a whole training scope (the parameters, the
Adam accumulators and the learning rate) apart for the model and
`optimizer.TensorAdam`. `scope_from_numpy` puts every array of a JAX scope,
by name, into a port `Scope` for the Executor (``load_params(...,
scope=)`` does the same from a saved directory).
"""
import os
import re

import numpy as np
import torch

from .executor import Scope
from .framework import resolve_device
from .models import bert
from .models.transformer import LMConfig, param_shapes

__all__ = ['load_params', 'params_from_numpy', 'train_state_from_numpy',
           'scope_from_numpy']

# decode-engine state the JAX package keeps in the same scope: not weights
_IGNORED = ('gen_kv_k', 'gen_kv_v')


def load_params(dirname, filename=None, scope=None, device=None):
    """{name: numpy array} from a directory written by
    `paddle_tpu.io.save_params` (or `save_vars`); with ``scope`` (a port
    `Scope`) the arrays also go into it, as `scope_from_numpy` puts them
    (tensors on ``device``: None means ``cuda:0``)."""
    if filename is not None:
        if not filename.endswith('.npz'):
            filename += '.npz'
        with np.load(os.path.join(dirname, filename)) as data:
            out = {k: data[k] for k in data.files}
    else:
        out = {}
        for fn in sorted(os.listdir(dirname)):
            if fn.endswith('.npy'):
                out[fn[:-4].replace('%2F', '/')] = np.load(
                    os.path.join(dirname, fn))
        if not out:
            raise FileNotFoundError('no .npy parameter files in %r'
                                    % dirname)
    if scope is not None:
        scope_from_numpy(out, scope, device)
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
