"""Neural-net layers.

The port's own copy of the layers of paddle_tpu/layers/nn.py that this
slice's programs call: ``fc``, ``embedding``, ``square_error_cost``,
``softmax_with_cross_entropy``, ``layer_norm``,
``fused_layer_norm_residual``, ``fused_ffn_tail``, ``matmul``, ``mean``,
``reduce_sum``, ``dropout``, ``add_position_encoding``, ``scale``, ``reshape``,
``transpose``, ``squeeze``, ``slice``, ``gather``, ``softmax`` and
``elementwise_add``/``_sub``. Each appends the JAX layer's op with the same
slots, attrs and static output shapes; the computation is the op's
lowering (ops/*).
"""
from ..layer_helper import LayerHelper
from ..initializer import Constant
from ..param_attr import ParamAttr

__all__ = [
    'fc', 'embedding', 'dropout', 'softmax', 'square_error_cost',
    'softmax_with_cross_entropy', 'layer_norm', 'fused_layer_norm_residual',
    'fused_ffn_tail', 'matmul', 'reshape', 'squeeze', 'transpose', 'mean',
    'reduce_sum',
    'elementwise_add', 'elementwise_sub', 'slice', 'gather', 'scale',
    'add_position_encoding',
]


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def _simple(helper, op_type, x, out_shape=None, out_dtype=None, inputs=None,
            outputs_extra=None, attrs=None, out_slot='Out'):
    out = helper.create_variable_for_type_inference(
        dtype=out_dtype or x.dtype,
        shape=out_shape if out_shape is not None else x.shape)
    outputs = {out_slot: [out]}
    if outputs_extra:
        outputs.update(outputs_extra)
    helper.append_op(type=op_type, inputs=inputs or {'X': [x]},
                     outputs=outputs, attrs=attrs or {})
    return out


# ---------------------------------------------------------------------------
# Dense / embedding
# ---------------------------------------------------------------------------

def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully connected: ``mul`` + ``elementwise_add`` (+ the activation)."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    inputs = helper.multiple_input()
    param_attrs = helper.multiple_param_attr(len(inputs))
    mul_results = []
    for inp, p_attr in zip(inputs, param_attrs):
        input_shape = inp.shape
        in_features = _prod(input_shape[num_flatten_dims:])
        w = helper.create_parameter(attr=p_attr,
                                    shape=[in_features, size], dtype=dtype)
        out_shape = tuple(input_shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_variable_for_type_inference(dtype,
                                                        shape=out_shape)
        helper.append_op(
            type='mul', inputs={'X': [inp], 'Y': [w]},
            outputs={'Out': [tmp]},
            attrs={'x_num_col_dims': num_flatten_dims, 'y_num_col_dims': 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            dtype, shape=mul_results[0].shape)
        helper.append_op(type='sum', inputs={'X': mul_results},
                         outputs={'Out': [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype='float32'):
    """Embedding lookup (``lookup_table``). ``is_sparse`` gradients wait for
    a later slice: append_backward raises on them."""
    helper = LayerHelper('embedding', param_attr=param_attr)
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    ish = input.shape
    out_shape = (ish[:-1] if ish and ish[-1] == 1 else ish) + (size[1],)
    tmp = helper.create_variable_for_type_inference(dtype, shape=out_shape)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        type='lookup_table', inputs={'Ids': [input], 'W': [w]},
        outputs={'Out': [tmp]},
        attrs={'is_sparse': is_sparse, 'is_distributed': is_distributed,
               'padding_idx': padding_idx})
    return tmp


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def square_error_cost(input, label):
    helper = LayerHelper('square_error_cost')
    minus_out = _simple(helper, 'elementwise_sub', input,
                        inputs={'X': [input], 'Y': [label]})
    return _simple(helper, 'square', minus_out)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=False,
                               return_softmax=False):
    helper = LayerHelper('softmax_with_cross_entropy')
    softmax = helper.create_variable_for_type_inference(
        dtype=logits.dtype, shape=logits.shape)
    loss = helper.create_variable_for_type_inference(
        dtype=logits.dtype, shape=tuple(logits.shape[:-1]) + (1,))
    helper.append_op(
        type='softmax_with_cross_entropy',
        inputs={'Logits': [logits], 'Label': [label]},
        outputs={'Softmax': [softmax], 'Loss': [loss]},
        attrs={'soft_label': soft_label, 'ignore_index': ignore_index,
               'numeric_stable_mode': numeric_stable_mode})
    if return_softmax:
        return loss, softmax
    return loss


# ---------------------------------------------------------------------------
# Normalization and the fused transformer units
# ---------------------------------------------------------------------------

def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper('layer_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_shape = [_prod(input.shape[begin_norm_axis:])]
    inputs = {'X': [input]}
    if scale:
        s = helper.create_parameter(attr=helper.param_attr,
                                    shape=norm_shape, dtype=dtype,
                                    default_initializer=Constant(1.0))
        inputs['Scale'] = [s]
    if shift:
        b = helper.create_parameter(attr=helper.bias_attr or ParamAttr(),
                                    shape=norm_shape, dtype=dtype,
                                    is_bias=True)
        inputs['Bias'] = [b]
    mean = helper.create_variable_for_type_inference(
        dtype, shape=(_prod(input.shape[:begin_norm_axis]),))
    variance = helper.create_variable_for_type_inference(
        dtype, shape=(_prod(input.shape[:begin_norm_axis]),))
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)
    helper.append_op(type='layer_norm', inputs=inputs,
                     outputs={'Y': [out], 'Mean': [mean],
                              'Variance': [variance]},
                     attrs={'epsilon': epsilon,
                            'begin_norm_axis': begin_norm_axis})
    return helper.append_activation(out)


def fused_layer_norm_residual(input, residual, begin_norm_axis=1,
                              epsilon=1e-5, param_attr=None,
                              bias_attr=None, name=None):
    """The fused residual-add + LayerNorm pair: returns ``(normed,
    summed)`` with ``summed = input + residual`` and ``normed =
    LN(summed) * scale + bias``."""
    helper = LayerHelper('fused_ln_residual', param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = input.dtype
    norm_shape = [_prod(input.shape[begin_norm_axis:])]
    s = helper.create_parameter(attr=helper.param_attr, shape=norm_shape,
                                dtype=dtype,
                                default_initializer=Constant(1.0))
    b = helper.create_parameter(attr=helper.bias_attr or ParamAttr(),
                                shape=norm_shape, dtype=dtype,
                                is_bias=True)
    out = helper.create_variable_for_type_inference(dtype,
                                                    shape=input.shape)
    summed = helper.create_variable_for_type_inference(dtype,
                                                       shape=input.shape)
    helper.append_op(type='fused_ln_residual',
                     inputs={'X': [input], 'Residual': [residual],
                             'Scale': [s], 'Bias': [b]},
                     outputs={'Y': [out], 'ResidualOut': [summed]},
                     attrs={'epsilon': epsilon,
                            'begin_norm_axis': begin_norm_axis})
    return out, summed


def fused_ffn_tail(input, inner_size, size, num_flatten_dims=1,
                   dropout_prob=0.0, is_test=False, seed=None,
                   inner_param_attr=None, inner_bias_attr=None,
                   param_attr=None, bias_attr=None, name=None):
    """The transformer FFN sublayer as one op:
    ``dropout(gelu(input @ W1 + b1) @ W2 + b2)`` with ``upscale_in_train``
    dropout. Parameters are created as the two ``fc`` calls would."""
    helper = LayerHelper('fused_ffn_tail', name=name)
    dtype = input.dtype
    d_in = _prod(input.shape[num_flatten_dims:])
    w1 = helper.create_parameter(attr=inner_param_attr or ParamAttr(),
                                 shape=[d_in, inner_size], dtype=dtype)
    b1 = helper.create_parameter(attr=inner_bias_attr or ParamAttr(),
                                 shape=[inner_size], dtype=dtype,
                                 is_bias=True)
    w2 = helper.create_parameter(attr=param_attr or ParamAttr(),
                                 shape=[inner_size, size], dtype=dtype)
    b2 = helper.create_parameter(attr=bias_attr or ParamAttr(),
                                 shape=[size], dtype=dtype, is_bias=True)
    out_shape = tuple(input.shape[:num_flatten_dims]) + (size,)
    out = helper.create_variable_for_type_inference(dtype,
                                                    shape=out_shape)
    helper.append_op(
        type='fused_ffn_tail',
        inputs={'X': [input], 'W1': [w1], 'B1': [b1],
                'W2': [w2], 'B2': [b2]},
        outputs={'Out': [out]},
        attrs={'x_num_col_dims': num_flatten_dims,
               'dropout_prob': dropout_prob, 'is_test': is_test,
               'seed': seed if seed is not None else 0,
               'dropout_implementation': 'upscale_in_train'})
    return out


# ---------------------------------------------------------------------------
# Products and shapes
# ---------------------------------------------------------------------------

def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper('matmul', name=name)
    xs = list(x.shape)
    ys = list(y.shape)
    if transpose_x and len(xs) >= 2:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) >= 2:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) >= 2 and len(ys) >= 2:
        out_shape = xs[:-1] + [ys[-1]]
    else:
        out_shape = [1]
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=out_shape)
    helper.append_op(type='matmul', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]},
                     attrs={'transpose_X': transpose_x,
                            'transpose_Y': transpose_y, 'alpha': alpha})
    return out


def _infer_reshape_shape(x, shape):
    shape = list(shape)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    if -1 in shape and all(d is not None and d >= 0 for d in x.shape):
        known = _prod([s for s in shape if s != -1])
        shape[shape.index(-1)] = _prod(x.shape) // max(known, 1)
    return shape


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper('reshape2', name=name)
    if x.shape is not None:
        out_shape = _infer_reshape_shape(x, shape)
    elif all(isinstance(d, int) and d > 0 for d in shape):
        out_shape = tuple(shape)
    else:
        out_shape = None
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=out_shape)
    xshape = helper.create_variable_for_type_inference(
        dtype=x.dtype,
        shape=((0,) + tuple(x.shape)) if x.shape is not None else None)
    helper.append_op(type='reshape2', inputs={'X': [x]},
                     outputs={'Out': [out], 'XShape': [xshape]},
                     attrs={'shape': list(shape)})
    return helper.append_activation(out) if act else out


def squeeze(input, axes, name=None):
    helper = LayerHelper('squeeze2', name=name)
    shape = [s for i, s in enumerate(input.shape)
             if not (i in axes and s == 1)]
    out = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    shape=shape)
    xshape = helper.create_variable_for_type_inference(
        dtype=input.dtype, shape=(0,) + tuple(input.shape))
    helper.append_op(type='squeeze2', inputs={'X': [input]},
                     outputs={'Out': [out], 'XShape': [xshape]},
                     attrs={'axes': list(axes)})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper('transpose2', name=name)
    shape = [x.shape[p] for p in perm]
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=shape)
    xshape = helper.create_variable_for_type_inference(
        dtype=x.dtype, shape=(0,) + tuple(x.shape))
    helper.append_op(type='transpose2', inputs={'X': [x]},
                     outputs={'Out': [out], 'XShape': [xshape]},
                     attrs={'axis': list(perm)})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper('slice')
    shape = list(input.shape)
    for a, s, e in zip(axes, starts, ends):
        dim = input.shape[a]
        if dim is None or dim < 0:
            shape[a] = -1
            continue
        s2 = max(s + dim, 0) if s < 0 else min(s, dim)
        e2 = max(e + dim, 0) if e < 0 else min(e, dim)
        shape[a] = max(e2 - s2, 0)
    return _simple(helper, 'slice', input, out_shape=shape,
                   inputs={'Input': [input]},
                   attrs={'axes': list(axes), 'starts': list(starts),
                          'ends': list(ends)})


def gather(input, index):
    helper = LayerHelper('gather')
    shape = (index.shape[0],) + tuple(input.shape[1:])
    return _simple(helper, 'gather', input, out_shape=shape,
                   inputs={'X': [input], 'Index': [index]})


# ---------------------------------------------------------------------------
# Elementwise, reductions, activations, randomness
# ---------------------------------------------------------------------------

def mean(x, name=None):
    helper = LayerHelper('mean', name=name)
    return _simple(helper, 'mean', x, out_shape=(1,))


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    """The sum of ``input`` over ``dim`` (an int or a list; None: every
    axis, to shape [1])."""
    helper = LayerHelper('reduce_sum', name=name)
    if dim is None:
        reduce_all = True
        dims = [0]
        shape = [1]
    else:
        reduce_all = False
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        dims = [d % len(input.shape) for d in dims]
        if keep_dim:
            shape = [1 if i in dims else s
                     for i, s in enumerate(input.shape)]
        else:
            shape = [s for i, s in enumerate(input.shape) if i not in dims]
            shape = shape or [1]
    out = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    shape=shape)
    helper.append_op(type='reduce_sum', inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'dim': dims, 'keep_dim': keep_dim,
                            'reduce_all': reduce_all})
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name, act=act)
    if x.shape is None or y.shape is None:
        shape = None
    else:
        shape = x.shape if len(x.shape) >= len(y.shape) else y.shape
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=shape)
    helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]}, attrs={'axis': axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_add', x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_sub', x, y, axis, act, name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper('scale', name=name, act=act)
    out = _simple(helper, 'scale', x,
                  attrs={'scale': float(scale), 'bias': float(bias),
                         'bias_after_scale': bias_after_scale})
    return helper.append_activation(out)


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper('softmax', name=name)
    return _simple(helper, 'softmax', input)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper('dropout', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    mask = helper.create_variable_for_type_inference(
        dtype=x.dtype, shape=x.shape, stop_gradient=True)
    helper.append_op(
        type='dropout', inputs={'X': [x]},
        outputs={'Out': [out], 'Mask': [mask]},
        attrs={'dropout_prob': dropout_prob, 'is_test': is_test,
               'seed': seed if seed is not None else 0,
               'dropout_implementation': dropout_implementation})
    return out


def add_position_encoding(input, alpha, beta, name=None):
    helper = LayerHelper('add_position_encoding', name=name)
    return _simple(helper, 'add_position_encoding', input,
                   attrs={'alpha': alpha, 'beta': beta})
