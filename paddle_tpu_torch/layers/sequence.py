"""Sequence (LoD) layers: the port's own copy of paddle_tpu/layers/sequence.py.

Each layer emits the JAX layer's op, letter for letter; the lowerings are
in ops/sequence_ops.py. ``sequence_enumerate``, ``sequence_erase`` and
``sequence_scatter`` wait for a later slice.
"""
from ..layer_helper import LayerHelper

__all__ = [
    'sequence_conv', 'sequence_pool', 'sequence_softmax',
    'sequence_first_step', 'sequence_last_step', 'sequence_expand',
    'sequence_expand_as', 'sequence_concat', 'sequence_slice',
    'sequence_reshape', 'sequence_pad', 'sequence_unpad',
    'sequence_reverse', 'sequence_mask', 'lod_reset',
]


def _out(helper, dtype=None, shape=None):
    return helper.create_variable_for_type_inference(
        dtype=dtype, shape=shape)


def _keep_features(v):
    """Build-time shape for ops that keep trailing feature dims but change
    the ragged leading dim: (-1, features...)."""
    if v.shape is None:
        return None
    return (-1,) + tuple(v.shape[1:])


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    """Reference layers/nn.py sequence_conv -> sequence_conv_op.cc."""
    helper = LayerHelper('sequence_conv', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    d = input.shape[-1]
    filter_shape = (filter_size * d, num_filters)
    filt = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                   dtype=input.dtype, is_bias=False)
    out = _out(helper, dtype=input.dtype,
               shape=input.shape[:-1] + (num_filters,))
    helper.append_op(
        type='sequence_conv',
        inputs={'X': [input], 'Filter': [filt]},
        outputs={'Out': [out]},
        attrs={'contextStride': filter_stride,
               'contextStart': -int(filter_size // 2),
               'contextLength': filter_size})
    out = helper.append_bias_op(out)
    return helper.append_activation(out)


def sequence_pool(input, pool_type, is_test=False):
    helper = LayerHelper('sequence_pool')
    out = _out(helper, dtype=input.dtype, shape=_keep_features(input))
    max_index = _out(helper, dtype='int32')
    helper.append_op(type='sequence_pool', inputs={'X': [input]},
                     outputs={'Out': [out], 'MaxIndex': [max_index]},
                     attrs={'pooltype': pool_type.upper(),
                            'is_test': is_test})
    return out


def sequence_first_step(input):
    return sequence_pool(input, 'first')


def sequence_last_step(input):
    return sequence_pool(input, 'last')


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper('sequence_softmax', name=name)
    out = _out(helper, dtype=input.dtype, shape=input.shape)
    helper.append_op(type='sequence_softmax', inputs={'X': [input]},
                     outputs={'Out': [out]}, attrs={})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper('sequence_expand', name=name)
    out = _out(helper, dtype=x.dtype, shape=_keep_features(x))
    helper.append_op(type='sequence_expand', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]}, attrs={'ref_level': ref_level})
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper('sequence_expand_as', name=name)
    out = _out(helper, dtype=x.dtype, shape=_keep_features(x))
    helper.append_op(type='sequence_expand_as', inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]}, attrs={})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper('sequence_concat', name=name)
    out = _out(helper, dtype=input[0].dtype, shape=_keep_features(input[0]))
    helper.append_op(type='sequence_concat', inputs={'X': list(input)},
                     outputs={'Out': [out]}, attrs={})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper('sequence_slice', name=name)
    out = _out(helper, dtype=input.dtype, shape=_keep_features(input))
    helper.append_op(type='sequence_slice',
                     inputs={'X': [input], 'Offset': [offset],
                             'Length': [length]},
                     outputs={'Out': [out]}, attrs={})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper('sequence_reshape')
    out = _out(helper, dtype=input.dtype, shape=(-1, new_dim))
    helper.append_op(type='sequence_reshape', inputs={'X': [input]},
                     outputs={'Out': [out]}, attrs={'new_dim': new_dim})
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    helper = LayerHelper('sequence_pad', name=name)
    out = _out(helper, dtype=x.dtype)
    length = _out(helper, dtype='int64')
    helper.append_op(type='sequence_pad',
                     inputs={'X': [x], 'PadValue': [pad_value]},
                     outputs={'Out': [out], 'Length': [length]},
                     attrs={'padded_length': -1 if maxlen is None
                            else int(maxlen)})
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper('sequence_unpad', name=name)
    out = _out(helper, dtype=x.dtype,
               shape=(-1,) + tuple(x.shape[2:]) if x.shape else None)
    helper.append_op(type='sequence_unpad',
                     inputs={'X': [x], 'Length': [length]},
                     outputs={'Out': [out]}, attrs={})
    return out


def sequence_reverse(x, name=None):
    helper = LayerHelper('sequence_reverse', name=name)
    out = _out(helper, dtype=x.dtype, shape=x.shape)
    helper.append_op(type='sequence_reverse', inputs={'X': [x]},
                     outputs={'Y': [out]}, attrs={})
    return out


def sequence_mask(x, maxlen=None, dtype='int64', name=None):
    helper = LayerHelper('sequence_mask', name=name)
    out = _out(helper, dtype=dtype)
    helper.append_op(type='sequence_mask', inputs={'X': [x]},
                     outputs={'Y': [out]},
                     attrs={'maxlen': -1 if maxlen is None else int(maxlen),
                            'out_dtype': dtype})
    return out


def lod_reset(x, y=None, target_lod=None):
    helper = LayerHelper('lod_reset')
    out = _out(helper, dtype=x.dtype, shape=x.shape)
    inputs = {'X': [x]}
    attrs = {}
    if y is not None:
        inputs['Y'] = [y]
    elif target_lod is not None:
        attrs['target_lod'] = [int(v) for v in target_lod]
    else:
        raise ValueError("lod_reset needs y or target_lod")
    helper.append_op(type='lod_reset', inputs=inputs, outputs={'Out': [out]},
                     attrs=attrs)
    return out
