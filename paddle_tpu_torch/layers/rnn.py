"""Recurrent layers: the port's own copy of paddle_tpu/layers/rnn.py.

``dynamic_lstm``, ``dynamic_lstmp``, ``dynamic_gru`` and ``gru_unit``
create the recurrent weights and emit the JAX layer's op, letter for
letter; the lowerings are in ops/rnn_ops.py. ``row_conv`` waits for a
later slice.
"""
from ..layer_helper import LayerHelper

__all__ = ['dynamic_lstm', 'dynamic_lstmp', 'dynamic_gru', 'gru_unit']


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation='sigmoid', cell_activation='tanh',
                 candidate_activation='tanh', dtype='float32', name=None):
    """input: (T, 4D) pre-projected (reference requires an fc before);
    size = 4*D. Returns (hidden, cell), both (T, D) with input's LoD."""
    assert size % 4 == 0, "dynamic_lstm size must be 4*hidden_dim"
    helper = LayerHelper('lstm', param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    d = size // 4
    weight = helper.create_parameter(attr=helper.param_attr, shape=(d, size),
                                     dtype=dtype, is_bias=False)
    bias_size = (1, 7 * d) if use_peepholes else (1, 4 * d)
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype, shape=(-1, d))
    cell = helper.create_variable_for_type_inference(dtype, shape=(-1, d))
    batch_gate = helper.create_variable_for_type_inference(dtype)
    batch_cell_pre = helper.create_variable_for_type_inference(dtype)
    inputs = {'Input': [input], 'Weight': [weight], 'Bias': [bias]}
    if h_0 is not None:
        inputs['H0'] = [h_0]
    if c_0 is not None:
        inputs['C0'] = [c_0]
    helper.append_op(
        type='lstm', inputs=inputs,
        outputs={'Hidden': [hidden], 'Cell': [cell],
                 'BatchGate': [batch_gate],
                 'BatchCellPreAct': [batch_cell_pre]},
        attrs={'use_peepholes': use_peepholes, 'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'cell_activation': cell_activation,
               'candidate_activation': candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation='sigmoid', cell_activation='tanh',
                  candidate_activation='tanh', proj_activation='tanh',
                  dtype='float32', name=None):
    """LSTM with recurrent projection (reference lstmp_op.cc).
    Returns (projection (T,P), cell (T,D))."""
    assert size % 4 == 0
    helper = LayerHelper('lstmp', param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    d = size // 4
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=(proj_size, size),
                                     dtype=dtype, is_bias=False)
    proj_weight = helper.create_parameter(attr=helper.param_attr,
                                          shape=(d, proj_size),
                                          dtype=dtype, is_bias=False)
    bias_size = (1, 7 * d) if use_peepholes else (1, 4 * d)
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype,
                                                     shape=(-1, proj_size))
    cell = helper.create_variable_for_type_inference(dtype, shape=(-1, d))
    helper.append_op(
        type='lstmp',
        inputs={'Input': [input], 'Weight': [weight],
                'ProjWeight': [proj_weight], 'Bias': [bias]},
        outputs={'Projection': [proj], 'Cell': [cell]},
        attrs={'use_peepholes': use_peepholes, 'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'cell_activation': cell_activation,
               'candidate_activation': candidate_activation,
               'proj_activation': proj_activation})
    return proj, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation='sigmoid',
                candidate_activation='tanh', h_0=None, origin_mode=False,
                name=None):
    """input: (T, 3D) pre-projected; size = D. Returns hidden (T, D)."""
    helper = LayerHelper('gru', param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = input.dtype
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=(size, 3 * size), dtype=dtype,
                                     is_bias=False)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=(1, 3 * size), dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype,
                                                       shape=(-1, size))
    batch_gate = helper.create_variable_for_type_inference(dtype)
    batch_reset = helper.create_variable_for_type_inference(dtype)
    batch_hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {'Input': [input], 'Weight': [weight], 'Bias': [bias]}
    if h_0 is not None:
        inputs['H0'] = [h_0]
    helper.append_op(
        type='gru', inputs=inputs,
        outputs={'Hidden': [hidden], 'BatchGate': [batch_gate],
                 'BatchResetHiddenPrev': [batch_reset],
                 'BatchHidden': [batch_hidden]},
        attrs={'is_reverse': is_reverse, 'origin_mode': origin_mode,
               'gate_activation': gate_activation,
               'activation': candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation='tanh', gate_activation='sigmoid',
             origin_mode=False):
    """One GRU step (reference layers/nn.py gru_unit). size = 3*D.
    Returns (updated_hidden, reset_hidden_prev, gate)."""
    assert size % 3 == 0
    d = size // 3
    helper = LayerHelper('gru_unit', param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = input.dtype
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=(d, 3 * d), dtype=dtype,
                                     is_bias=False)
    bias = helper.create_parameter(attr=helper.bias_attr, shape=(1, 3 * d),
                                   dtype=dtype, is_bias=True)
    act_ids = {'identity': 0, 'sigmoid': 1, 'tanh': 2, 'relu': 3}
    gate = helper.create_variable_for_type_inference(dtype,
                                                     shape=(-1, 3 * d))
    reset_hidden = helper.create_variable_for_type_inference(dtype,
                                                             shape=(-1, d))
    updated = helper.create_variable_for_type_inference(dtype,
                                                        shape=(-1, d))
    helper.append_op(
        type='gru_unit',
        inputs={'Input': [input], 'HiddenPrev': [hidden],
                'Weight': [weight], 'Bias': [bias]},
        outputs={'Gate': [gate], 'ResetHiddenPrev': [reset_hidden],
                 'Hidden': [updated]},
        attrs={'activation': act_ids[activation],
               'gate_activation': act_ids[gate_activation],
               'origin_mode': origin_mode})
    return updated, reset_hidden, gate
