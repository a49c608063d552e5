"""Carry the JAX package's LM weights and training state into the port.

`load_params` reads what `paddle_tpu.io.save_params` writes — one combined
``.npz`` (``filename=``) or one ``.npy`` per variable, with ``/`` in a name
written as ``%2F`` — and `params_from_numpy` maps those names onto the
port's `TransformerLM` state, checking every name and shape.
`train_state_from_numpy` takes a whole training scope (the parameters, the
Adam accumulators and the learning rate) apart for `TransformerLM` and
`optimizer.Adam`.
"""
import os
import re

import numpy as np
import torch

from .framework import resolve_device
from .models.transformer import LMConfig, param_shapes

__all__ = ['load_params', 'params_from_numpy', 'train_state_from_numpy']

# decode-engine state the JAX package keeps in the same scope: not weights
_IGNORED = ('gen_kv_k', 'gen_kv_v')


def load_params(dirname, filename=None):
    """{name: numpy array} from a directory written by
    `paddle_tpu.io.save_params` (or `save_vars`)."""
    if filename is not None:
        if not filename.endswith('.npz'):
            filename += '.npz'
        with np.load(os.path.join(dirname, filename)) as data:
            return {k: data[k] for k in data.files}
    out = {}
    for fn in sorted(os.listdir(dirname)):
        if fn.endswith('.npy'):
            out[fn[:-4].replace('%2F', '/')] = np.load(
                os.path.join(dirname, fn))
    if not out:
        raise FileNotFoundError('no .npy parameter files in %r' % dirname)
    return out


def _infer_config(arrays):
    """The LMConfig the arrays' shapes imply (head count aside: it shapes no
    parameter, so it does not matter for the check)."""
    try:
        V, d = np.shape(arrays['tok_emb.w'])
        d_ff = np.shape(arrays['layer_0.ffn1.w'])[1]
    except KeyError as e:
        raise ValueError('parameter %s is missing' % e) from None
    n_layer = 0
    while 'layer_%d.ln1.w' % n_layer in arrays:
        n_layer += 1
    return LMConfig(vocab_size=V, d_model=d, n_head=1, n_layer=n_layer,
                    d_ff=d_ff)


def params_from_numpy(arrays, device=None, config=None):
    """{name: float32 tensor on ``device``} for `TransformerLM`, from a
    {JAX parameter name: array} mapping (numpy arrays or tensors). The
    names are ``tok_emb.w``, ``layer_{i}.{ln1,ln2}.{w,b}``,
    ``layer_{i}.attn.{qkv,proj}.{w,b}``, ``layer_{i}.{ffn1,ffn2}.{w,b}``,
    ``final_ln.{w,b}`` and ``lm_head.w``; ``gen_kv_k``/``gen_kv_v`` are
    ignored. Shapes are checked against ``config`` (an LMConfig), or
    against the config the arrays imply when it is None. Raises ValueError
    on a missing, unexpected or mis-shaped name. ``device`` goes through
    `framework.resolve_device` once every name and shape has been checked:
    None means ``cuda:0`` (and raises without a card), ``'cpu'`` the
    CPU."""
    arrays = {k: v for k, v in arrays.items() if k not in _IGNORED}
    cfg = config if config is not None else _infer_config(arrays)
    want = param_shapes(cfg)
    missing = [k for k in want if k not in arrays]
    extra = sorted(k for k in arrays if k not in want)
    if missing or extra:
        raise ValueError('parameter names do not match the LM: missing %s, '
                         'unexpected %s' % (missing, extra))
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
        raise ValueError('%s has shape %s, the LM needs %s'
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
    """Take a JAX training scope of the LM with Adam apart: returns
    (params, adam_state, learning_rate) with ``params`` as
    `params_from_numpy` gives them, ``adam_state`` as {parameter name:
    {'moment1', 'moment2', 'beta1_pow', 'beta2_pow'}} float32 tensors on
    ``device`` (None: ``cuda:0``, as in `params_from_numpy`; the form
    `optimizer.Adam.load_state` takes) and ``learning_rate`` a one-element
    tensor there. The accumulators are
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
