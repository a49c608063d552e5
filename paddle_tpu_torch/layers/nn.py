"""Neural-net layers.

The port's own copy of the layers of paddle_tpu/layers/nn.py that this
slice's programs call: ``fc``, ``embedding``, ``square_error_cost``,
``log_loss``, ``softmax_with_cross_entropy``, ``layer_norm``,
``fused_layer_norm_residual``, ``fused_ffn_tail``, ``matmul``, ``mean``,
``reduce_sum``, ``dropout``, ``add_position_encoding``, ``scale``, ``reshape``,
``transpose``, ``squeeze``, ``slice``, ``gather``, ``softmax``,
``elementwise_add``/``_sub``/``_mul``/``_div``/``_max``/``_min``, and the
image layers ``conv2d``, ``pool2d``, ``batch_norm`` and ``cross_entropy``
(models/resnet.py, models/se_resnext.py, models/vgg.py); and the op
library's shape, compare and reduce layers: ``unsqueeze``, ``flatten``,
``split``, ``reduce_mean``/``_max``/``_min``/``_prod``,
``elementwise_pow``/``_mod``/``_floordiv``, ``logical_*``, ``one_hot``,
``pad``, ``pad2d``, ``pad_constant_like``, ``label_smooth``, ``stack``,
``unstack``, ``expand``, ``gather_nd``, ``scatter``, ``crop``, ``shape``,
``increment``, ``multiplex``, ``where``, ``space_to_depth``,
``shuffle_channel``, ``sampling_id`` and ``hash``; the layers of op
types lowered earlier (``mul``, ``sum``, ``clip``, ``clip_by_norm``,
``sign``, ``gaussian_random``, ``lstm_unit``, ``merge_selected_rows``,
``get_tensor_from_selected_rows``, ``flash_attention``); the activations
with attributes or a parameter (``log``, ``prelu``, ``brelu``,
``leaky_relu``, ``soft_relu``, ``selu``, ``swish``, ``maxout``); the
losses, norms and distances of ops/math_ops.py;
``autoincreased_step_counter``, which the learning-rate schedules read;
and ``topk``, which the beam-search decoder reads.
Each appends the JAX layer's op with the same slots, attrs and static
output shapes; the computation is the op's lowering (ops/*).
"""
from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import Constant, Normal
from ..param_attr import ParamAttr

__all__ = [
    'fc', 'embedding', 'dropout', 'softmax', 'cross_entropy',
    'square_error_cost', 'log_loss', 'softmax_with_cross_entropy',
    'conv2d', 'pool2d',
    'batch_norm', 'layer_norm', 'fused_layer_norm_residual',
    'fused_ffn_tail', 'matmul', 'reshape', 'squeeze', 'unsqueeze',
    'flatten', 'transpose', 'split', 'mean', 'reduce_sum', 'reduce_mean',
    'reduce_max', 'reduce_min', 'reduce_prod',
    'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'elementwise_max', 'elementwise_min',
    'elementwise_pow', 'elementwise_mod', 'elementwise_floordiv',
    'logical_and', 'logical_or', 'logical_xor', 'logical_not', 'one_hot',
    'pad', 'pad2d', 'pad_constant_like', 'label_smooth', 'stack', 'unstack',
    'expand', 'slice', 'gather', 'gather_nd', 'scatter', 'crop', 'shape',
    'scale', 'increment', 'multiplex', 'where', 'space_to_depth',
    'shuffle_channel', 'sampling_id', 'hash', 'add_position_encoding',
    'mul', 'sum', 'sums_', 'clip', 'clip_by_norm', 'sign',
    'gaussian_random', 'lstm_unit', 'merge_selected_rows',
    'get_tensor_from_selected_rows', 'flash_attention', 'log', 'prelu',
    'brelu', 'leaky_relu', 'soft_relu', 'selu', 'swish', 'maxout',
    'huber_loss', 'smooth_l1', 'bpr_loss', 'rank_loss', 'margin_rank_loss',
    'hinge_loss', 'teacher_student_sigmoid_loss', 'l2_normalize', 'cos_sim',
    'bilinear_tensor_product', 'autoincreased_step_counter', 'topk',
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
    """Embedding lookup (``lookup_table``). An ``is_sparse`` table gets a
    SelectedRows gradient (backward.py); ``is_distributed`` is the plain
    lookup on one device."""
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

def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper('cross_entropy')
    out_shape = tuple(input.shape[:-1]) + (1,)
    return _simple(helper, 'cross_entropy', input, out_shape=out_shape,
                   inputs={'X': [input], 'Label': [label]},
                   attrs={'soft_label': soft_label,
                          'ignore_index': ignore_index}, out_slot='Y')


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper('log_loss', name=name)
    return _simple(helper, 'log_loss', input,
                   inputs={'Predicted': [input], 'Labels': [label]},
                   attrs={'epsilon': epsilon}, out_slot='Loss')


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
# Convolution, pooling and batch norm
# ---------------------------------------------------------------------------

def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def _conv_out(i, k, p, s, d=1):
    if i is None or i < 0:
        return -1
    return (i + 2 * p - (d * (k - 1) + 1)) // s + 1


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """NCHW convolution with an OIHW filter (default initializer
    ``Normal(0, (2 / fan_in) ** 0.5)``), then the bias over dim 1, then
    ``act``."""
    helper = LayerHelper('conv2d', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    n, c = input.shape[0], input.shape[1]
    groups = groups or 1
    fsize = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    filter_shape = [num_filters, c // groups] + fsize
    fan_in = (c // groups) * fsize[0] * fsize[1]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=Normal(0.0, (2.0 / fan_in) ** 0.5))
    oh = _conv_out(input.shape[2], fsize[0], padding[0], stride[0],
                   dilation[0])
    ow = _conv_out(input.shape[3], fsize[1], padding[1], stride[1],
                   dilation[1])
    pre_bias = helper.create_variable_for_type_inference(
        dtype, shape=(n, num_filters, oh, ow))
    helper.append_op(
        type='conv2d', inputs={'Input': [input], 'Filter': [w]},
        outputs={'Output': [pre_bias]},
        attrs={'strides': stride, 'paddings': padding, 'dilations': dilation,
               'groups': groups, 'use_cudnn': use_cudnn})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type='max', pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper('pool2d', name=name)
    ksize = _pair(pool_size)
    stride = _pair(pool_stride)
    padding = _pair(pool_padding)
    n, c, h, w = input.shape
    if global_pooling:
        oh = ow = 1
    else:
        def _po(i, k, p, s):
            if i is None or i < 0:
                return -1
            if ceil_mode:
                return -(-(i + 2 * p - k) // s) + 1
            return (i + 2 * p - k) // s + 1
        oh = _po(h, ksize[0], padding[0], stride[0])
        ow = _po(w, ksize[1], padding[1], stride[1])
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=(n, c, oh, ow))
    helper.append_op(
        type='pool2d', inputs={'X': [input]}, outputs={'Out': [out]},
        attrs={'pooling_type': pool_type, 'ksize': ksize,
               'global_pooling': global_pooling, 'strides': stride,
               'paddings': padding, 'ceil_mode': ceil_mode,
               'exclusive': exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout='NCHW',
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Batch norm over the channel axis. The moving mean and variance are
    global persistable variables ``<name>.mean`` and ``<name>.variance``
    (initialized to 0 and 1), which the op reads as ``Mean`` and
    ``Variance`` and writes back in place as ``MeanOut`` and
    ``VarianceOut``."""
    helper = LayerHelper('batch_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    c = input.shape[1] if data_layout == 'NCHW' else input.shape[-1]
    scale = helper.create_parameter(attr=helper.param_attr, shape=[c],
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr or ParamAttr(),
                                   shape=[c], dtype=dtype, is_bias=True)
    mean = helper.create_or_get_global_variable(
        name=moving_mean_name or helper.name + '.mean',
        dtype=dtype, shape=(c,))
    helper.set_variable_initializer(mean, Constant(0.0))
    variance = helper.create_or_get_global_variable(
        name=moving_variance_name or helper.name + '.variance',
        dtype=dtype, shape=(c,))
    helper.set_variable_initializer(variance, Constant(1.0))
    saved_mean = helper.create_variable_for_type_inference(dtype, shape=(c,))
    saved_var = helper.create_variable_for_type_inference(dtype, shape=(c,))
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)
    helper.append_op(
        type='batch_norm',
        inputs={'X': [input], 'Scale': [scale], 'Bias': [bias],
                'Mean': [mean], 'Variance': [variance]},
        outputs={'Y': [out], 'MeanOut': [mean], 'VarianceOut': [variance],
                 'SavedMean': [saved_mean], 'SavedVariance': [saved_var]},
        attrs={'momentum': momentum, 'epsilon': epsilon, 'is_test': is_test,
               'data_layout': data_layout,
               'use_global_stats': use_global_stats})
    return helper.append_activation(out)


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


def unsqueeze(input, axes, name=None):
    helper = LayerHelper('unsqueeze2', name=name)
    shape = list(input.shape)
    for a in sorted(axes):
        shape.insert(a, 1)
    out = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    shape=shape)
    xshape = helper.create_variable_for_type_inference(
        dtype=input.dtype, shape=(0,) + tuple(input.shape))
    helper.append_op(type='unsqueeze2', inputs={'X': [input]},
                     outputs={'Out': [out], 'XShape': [xshape]},
                     attrs={'axes': list(axes)})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper('flatten2', name=name)
    lead = _prod(x.shape[:axis]) if axis > 0 else 1
    tail = _prod(x.shape[axis:])
    out = helper.create_variable_for_type_inference(
        dtype=x.dtype, shape=(lead, tail))
    xshape = helper.create_variable_for_type_inference(
        dtype=x.dtype, shape=(0,) + tuple(x.shape))
    helper.append_op(type='flatten2', inputs={'X': [x]},
                     outputs={'Out': [out], 'XShape': [xshape]},
                     attrs={'axis': axis})
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


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper('split', name=name)
    axis = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
        sizes = [input.shape[axis] // num] * num
    else:
        sections = list(num_or_sections)
        num = 0
        sizes = sections
    outs = []
    for s in sizes:
        shape = list(input.shape)
        shape[axis] = s
        outs.append(helper.create_variable_for_type_inference(
            dtype=input.dtype, shape=shape))
    helper.append_op(type='split', inputs={'X': [input]},
                     outputs={'Out': outs},
                     attrs={'axis': axis, 'num': num, 'sections': sections})
    return outs


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


def _reduce(op_type, input, dim, keep_dim, name):
    """The reduction of ``input`` over ``dim`` (an int or a list; None:
    every axis, to shape [1])."""
    helper = LayerHelper(op_type, name=name)
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
    helper.append_op(type=op_type, inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'dim': dims, 'keep_dim': keep_dim,
                            'reduce_all': reduce_all})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_sum', input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_mean', input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_max', input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_min', input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce('reduce_prod', input, dim, keep_dim, name)


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


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_mul', x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_div', x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_max', x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_min', x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_pow', x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_mod', x, y, axis, act, name)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _elementwise('elementwise_floordiv', x, y, axis, act, name)


def _logical(op_type, x, y, out, name):
    helper = LayerHelper(op_type, name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype='bool',
                                                        shape=x.shape)
    inputs = {'X': [x]} if y is None else {'X': [x], 'Y': [y]}
    helper.append_op(type=op_type, inputs=inputs, outputs={'Out': [out]})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical('logical_and', x, y, out, name)


def logical_or(x, y, out=None, name=None):
    return _logical('logical_or', x, y, out, name)


def logical_xor(x, y, out=None, name=None):
    return _logical('logical_xor', x, y, out, name)


def logical_not(x, out=None, name=None):
    return _logical('logical_not', x, None, out, name)


def topk(input, k, name=None):
    """(values, indices) of the ``k`` largest entries of each row of
    ``input`` (a ``top_k`` op); neither carries a gradient."""
    helper = LayerHelper('top_k', name=name)
    shape = tuple(input.shape[:-1]) + (k,)
    values = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                       shape=shape)
    indices = helper.create_variable_for_type_inference(dtype='int64',
                                                        shape=shape)
    helper.append_op(type='top_k', inputs={'X': [input]},
                     outputs={'Out': [values], 'Indices': [indices]},
                     attrs={'k': k})
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


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


# ---------------------------------------------------------------------------
# Shape, padding, index and misc layers
# ---------------------------------------------------------------------------

def one_hot(input, depth):
    helper = LayerHelper('one_hot')
    shape = (tuple(input.shape[:-1]) if input.shape[-1] == 1
             else tuple(input.shape)) + (depth,)
    return _simple(helper, 'one_hot', input, out_shape=shape,
                   out_dtype='float32', attrs={'depth': depth})


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper('pad', name=name)
    shape = [s + paddings[2 * i] + paddings[2 * i + 1]
             for i, s in enumerate(x.shape)]
    return _simple(helper, 'pad', x, out_shape=shape,
                   attrs={'paddings': list(paddings),
                          'pad_value': pad_value})


def pad2d(input, paddings=(0, 0, 0, 0), mode='constant', pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper('pad2d', name=name)
    n, c, h, w = input.shape
    shape = (n, c, h + paddings[0] + paddings[1],
             w + paddings[2] + paddings[3])
    return _simple(helper, 'pad2d', input, out_shape=shape,
                   attrs={'paddings': list(paddings), 'mode': mode,
                          'pad_value': pad_value,
                          'data_format': data_format})


def pad_constant_like(x, y, pad_value=0.0, name=None):
    helper = LayerHelper('pad_constant_like', name=name)
    return _simple(helper, 'pad_constant_like', y, out_shape=x.shape,
                   inputs={'X': [x], 'Y': [y]},
                   attrs={'pad_value': pad_value})


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype='float32',
                 name=None):
    helper = LayerHelper('label_smooth', name=name)
    inputs = {'X': [label]}
    if prior_dist is not None:
        inputs['PriorDist'] = [prior_dist]
    return _simple(helper, 'label_smooth', label, inputs=inputs,
                   attrs={'epsilon': float(epsilon)})


def stack(x, axis=0):
    helper = LayerHelper('stack')
    xs = x if isinstance(x, (list, tuple)) else [x]
    shape = list(xs[0].shape)
    shape.insert(axis % (len(shape) + 1), len(xs))
    out = helper.create_variable_for_type_inference(dtype=xs[0].dtype,
                                                    shape=shape)
    helper.append_op(type='stack', inputs={'X': xs}, outputs={'Y': [out]},
                     attrs={'axis': axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper('unstack')
    if num is None:
        num = x.shape[axis]
    shape = [s for i, s in enumerate(x.shape) if i != axis % len(x.shape)]
    outs = [helper.create_variable_for_type_inference(dtype=x.dtype,
                                                      shape=shape)
            for _ in range(num)]
    helper.append_op(type='unstack', inputs={'X': [x]}, outputs={'Y': outs},
                     attrs={'axis': axis, 'num': num})
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper('expand', name=name)
    shape = [(s * t if s is not None and s >= 0 else -1)
             for s, t in zip(x.shape, expand_times)]
    return _simple(helper, 'expand', x, out_shape=shape,
                   attrs={'expand_times': list(expand_times)})


def gather_nd(input, index, name=None):
    helper = LayerHelper('gather_nd', name=name)
    shape = tuple(index.shape[:-1]) + tuple(input.shape[index.shape[-1]:])
    return _simple(helper, 'gather_nd', input, out_shape=shape,
                   inputs={'X': [input], 'Index': [index]})


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper('scatter', name=name)
    return _simple(helper, 'scatter', input,
                   inputs={'X': [input], 'Ids': [index],
                           'Updates': [updates]},
                   attrs={'overwrite': overwrite})


def crop(x, shape=None, offsets=None, name=None):
    helper = LayerHelper('crop', name=name)
    if isinstance(shape, Variable):
        shape = shape.shape
    offsets = offsets or [0] * len(x.shape)
    return _simple(helper, 'crop', x, out_shape=shape,
                   inputs={'X': [x]},
                   attrs={'shape': list(shape), 'offsets': list(offsets)})


def shape(input):
    helper = LayerHelper('shape')
    out = helper.create_variable_for_type_inference(
        'int32', shape=(len(input.shape),))
    helper.append_op(type='shape', inputs={'Input': [input]},
                     outputs={'Out': [out]})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper('increment')
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                        shape=x.shape)
    helper.append_op(type='increment', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'step': float(value)})
    return out


def where(condition, x, y):
    helper = LayerHelper('where')
    return _simple(helper, 'where', x,
                   inputs={'Condition': [condition], 'X': [x], 'Y': [y]})


def multiplex(inputs, index):
    helper = LayerHelper('multiplex')
    out = helper.create_variable_for_type_inference(
        dtype=inputs[0].dtype, shape=inputs[0].shape)
    helper.append_op(type='multiplex',
                     inputs={'X': inputs, 'Ids': [index]},
                     outputs={'Out': [out]})
    return out


def space_to_depth(x, blocksize, name=None):
    helper = LayerHelper('space_to_depth', name=name)
    n, c, h, w = x.shape
    return _simple(helper, 'space_to_depth', x,
                   out_shape=(n, c * blocksize * blocksize,
                              h // blocksize, w // blocksize),
                   attrs={'blocksize': blocksize})


def shuffle_channel(x, group, name=None):
    helper = LayerHelper('shuffle_channel', name=name)
    return _simple(helper, 'shuffle_channel', x, attrs={'group': group})


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype='float32'):
    helper = LayerHelper('sampling_id')
    out = helper.create_variable_for_type_inference('int64',
                                                    shape=(x.shape[0],))
    helper.append_op(type='sampling_id', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'seed': seed})
    return out


def hash(input, hash_size, num_hash=1, name=None):
    helper = LayerHelper('hash', name=name)
    out = helper.create_variable_for_type_inference(
        'int64', shape=(input.shape[0], num_hash, 1))
    helper.append_op(type='hash', inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'num_hash': num_hash, 'mod_by': hash_size})
    return out


# ---------------------------------------------------------------------------
# Products, sums and clips whose op the port lowers
# ---------------------------------------------------------------------------

def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper('mul', name=name)
    out_shape = tuple(x.shape[:x_num_col_dims]) + tuple(
        y.shape[y_num_col_dims:])
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=out_shape)
    helper.append_op(type='mul', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]},
                     attrs={'x_num_col_dims': x_num_col_dims,
                            'y_num_col_dims': y_num_col_dims})
    return out


def sum(x):
    helper = LayerHelper('sum')
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(dtype=xs[0].dtype,
                                                    shape=xs[0].shape)
    helper.append_op(type='sum', inputs={'X': xs}, outputs={'Out': [out]})
    return out


sums_ = sum


def clip(x, min, max, name=None):
    helper = LayerHelper('clip', name=name)
    return _simple(helper, 'clip', x, attrs={'min': min, 'max': max})


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper('clip_by_norm', name=name)
    return _simple(helper, 'clip_by_norm', x, attrs={'max_norm': max_norm})


def sign(x):
    helper = LayerHelper('sign')
    return _simple(helper, 'sign', x)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype='float32'):
    helper = LayerHelper('gaussian_random')
    out = helper.create_variable_for_type_inference(dtype, shape=shape)
    helper.append_op(type='gaussian_random', outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'mean': mean, 'std': std,
                            'seed': seed, 'dtype': out.dtype})
    return out


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """fc([x_t, h_prev]) to the 4 gates, then the ``lstm_unit`` op (gate
    order i, f, o, j)."""
    from .tensor import concat
    helper = LayerHelper('lstm_unit', param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = cell_t_prev.shape[-1]
    concat_out = concat([x_t, hidden_t_prev], axis=1)
    fc_out = fc(input=concat_out, size=4 * size,
                param_attr=helper.param_attr, bias_attr=helper.bias_attr)
    h = helper.create_variable_for_type_inference(
        x_t.dtype, shape=cell_t_prev.shape)
    c = helper.create_variable_for_type_inference(
        x_t.dtype, shape=cell_t_prev.shape)
    helper.append_op(
        type='lstm_unit',
        inputs={'X': [fc_out], 'C_prev': [cell_t_prev]},
        outputs={'H': [h], 'C': [c]},
        attrs={'forget_bias': forget_bias})
    return h, c


def merge_selected_rows(x, name=None):
    helper = LayerHelper('merge_selected_rows', name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type='merge_selected_rows', inputs={'X': [x]},
                     outputs={'Out': [out]})
    return out


def get_tensor_from_selected_rows(x, name=None):
    helper = LayerHelper('get_tensor_from_selected_rows', name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type='get_tensor_from_selected_rows',
                     inputs={'X': [x]}, outputs={'Out': [out]})
    return out


def flash_attention(q, k, v, scale=None, causal=True, name=None):
    """Fused multi-head attention over q, k, v [B, H, L, dh]; without
    ``scale`` the op takes dh ** -0.5, a given scale (even 0.0) is taken
    as it is."""
    helper = LayerHelper('flash_attention', name=name)
    out = helper.create_variable_for_type_inference(q.dtype, shape=q.shape)
    attrs = {'causal': bool(causal)}
    if scale is not None:
        attrs['scale'] = float(scale)
    helper.append_op(
        type='flash_attention',
        inputs={'Q': [q], 'K': [k], 'V': [v]},
        outputs={'Out': [out]},
        attrs=attrs)
    return out


# ---------------------------------------------------------------------------
# Activations with attributes or a parameter
# ---------------------------------------------------------------------------

def log(x, name=None):
    helper = LayerHelper('log', name=name)
    return _simple(helper, 'log', x)


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper('prelu', param_attr=param_attr, name=name)
    if mode == 'all':
        alpha_shape = [1]
    elif mode == 'channel':
        alpha_shape = [1, x.shape[1], 1, 1]
    else:
        alpha_shape = [1] + list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=helper.param_attr, shape=alpha_shape, dtype='float32',
        is_bias=False, default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(type='prelu', inputs={'X': [x], 'Alpha': [alpha]},
                     outputs={'Out': [out]}, attrs={'mode': mode})
    return out


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    helper = LayerHelper('brelu', name=name)
    return _simple(helper, 'brelu', x,
                   attrs={'t_min': t_min, 't_max': t_max})


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper('leaky_relu', name=name)
    return _simple(helper, 'leaky_relu', x, attrs={'alpha': alpha})


def soft_relu(x, threshold=40.0, name=None):
    helper = LayerHelper('soft_relu', name=name)
    return _simple(helper, 'soft_relu', x, attrs={'threshold': threshold})


def selu(x, scale=None, alpha=None, name=None):
    helper = LayerHelper('selu', name=name)
    attrs = {}
    if scale is not None:
        attrs['scale'] = scale
    if alpha is not None:
        attrs['alpha'] = alpha
    return _simple(helper, 'selu', x, attrs=attrs)


def swish(x, beta=1.0, name=None):
    helper = LayerHelper('swish', name=name)
    return _simple(helper, 'swish', x, attrs={'beta': beta})


def maxout(x, groups, name=None):
    helper = LayerHelper('maxout', name=name)
    n, c, h, w = x.shape
    return _simple(helper, 'maxout', x, out_shape=(n, c // groups, h, w),
                   attrs={'groups': groups})


# ---------------------------------------------------------------------------
# Norms, distances and losses
# ---------------------------------------------------------------------------

def huber_loss(input, label, delta):
    helper = LayerHelper('huber_loss')
    residual = helper.create_variable_for_type_inference(
        dtype=input.dtype, shape=input.shape)
    out = helper.create_variable_for_type_inference(
        dtype=input.dtype, shape=input.shape)
    helper.append_op(type='huber_loss',
                     inputs={'X': [input], 'Y': [label]},
                     outputs={'Out': [out], 'Residual': [residual]},
                     attrs={'delta': delta})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper('smooth_l1_loss')
    diff = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     shape=x.shape)
    loss = helper.create_variable_for_type_inference(
        dtype=x.dtype, shape=(x.shape[0], 1))
    inputs = {'X': [x], 'Y': [y]}
    if inside_weight is not None:
        inputs['InsideWeight'] = [inside_weight]
    if outside_weight is not None:
        inputs['OutsideWeight'] = [outside_weight]
    helper.append_op(type='smooth_l1_loss', inputs=inputs,
                     outputs={'Diff': [diff], 'Out': [loss]},
                     attrs={'sigma': sigma if sigma is not None else 1.0})
    return loss


def bpr_loss(input, label, name=None):
    helper = LayerHelper('bpr_loss', name=name)
    return _simple(helper, 'bpr_loss', input,
                   out_shape=(input.shape[0], 1),
                   inputs={'X': [input], 'Label': [label]}, out_slot='Y')


def rank_loss(label, left, right, name=None):
    helper = LayerHelper('rank_loss', name=name)
    return _simple(helper, 'rank_loss', left,
                   inputs={'Label': [label], 'Left': [left],
                           'Right': [right]})


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper('margin_rank_loss', name=name)
    act = helper.create_variable_for_type_inference(dtype=left.dtype,
                                                    shape=left.shape)
    out = helper.create_variable_for_type_inference(dtype=left.dtype,
                                                    shape=left.shape)
    helper.append_op(type='margin_rank_loss',
                     inputs={'Label': [label], 'X1': [left], 'X2': [right]},
                     outputs={'Out': [out], 'Activated': [act]},
                     attrs={'margin': margin})
    return out


def hinge_loss(input, label, name=None):
    helper = LayerHelper('hinge_loss', name=name)
    return _simple(helper, 'hinge_loss', input,
                   inputs={'Logits': [input], 'Labels': [label]},
                   out_slot='Loss')


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    helper = LayerHelper('teacher_student_sigmoid_loss')
    return _simple(helper, 'teacher_student_sigmoid_loss', input,
                   inputs={'X': [input], 'Label': [label]},
                   attrs={'soft_max_up_bound': soft_max_up_bound,
                          'soft_max_lower_bound': soft_max_lower_bound},
                   out_slot='Y')


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper('l2_normalize', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    norm = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     shape=x.shape)
    helper.append_op(type='norm', inputs={'X': [x]},
                     outputs={'Out': [out], 'Norm': [norm]},
                     attrs={'axis': axis, 'epsilon': epsilon})
    return out


def cos_sim(X, Y):
    helper = LayerHelper('cos_sim')
    out = helper.create_variable_for_type_inference(
        dtype=X.dtype, shape=(X.shape[0], 1))
    xnorm = helper.create_variable_for_type_inference(
        dtype=X.dtype, shape=(X.shape[0], 1))
    ynorm = helper.create_variable_for_type_inference(
        dtype=X.dtype, shape=(X.shape[0], 1))
    helper.append_op(type='cos_sim', inputs={'X': [X], 'Y': [Y]},
                     outputs={'Out': [out], 'XNorm': [xnorm],
                              'YNorm': [ynorm]})
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper('bilinear_tensor_product', name=name,
                         param_attr=param_attr, bias_attr=bias_attr, act=act)
    dtype = x.dtype
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[size, x.shape[1], y.shape[1]],
        dtype=dtype)
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(x.shape[0], size))
    inputs = {'X': [x], 'Y': [y], 'Weight': [w]}
    if helper.bias_attr:
        bias = helper.create_parameter(
            attr=helper.bias_attr, shape=[1, size], dtype=dtype,
            is_bias=True)
        inputs['Bias'] = [bias]
    helper.append_op(type='bilinear_tensor_product', inputs=inputs,
                     outputs={'Out': [out]})
    return helper.append_activation(out)


# ---------------------------------------------------------------------------
# The step counter the learning-rate schedules read
# ---------------------------------------------------------------------------

def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """An int64 persistable [1] (``@STEP_COUNTER@`` by default), ``begin -
    1`` at startup and advanced by ``step`` at the top of each run. Only
    the call that creates it appends the ``increment``, so a counter
    shared by several schedules advances once a step."""
    helper = LayerHelper('global_step_counter')
    counter_name = counter_name or '@STEP_COUNTER@'
    gb = helper.main_program.global_block()
    is_new_var = not gb.has_var(counter_name)
    counter = helper.create_or_get_global_variable(
        name=counter_name, dtype='int64', shape=(1,))
    if is_new_var:
        helper.set_variable_initializer(counter,
                                        initializer=Constant(begin - 1))
        helper.append_op(type='increment', inputs={'X': [counter]},
                         outputs={'Out': [counter]},
                         attrs={'step': float(step)})
    counter.stop_gradient = True
    return counter
