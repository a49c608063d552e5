"""Composite networks: the port's own copy of the image blocks of
paddle_tpu/nets.py, `simple_img_conv_pool` (a conv2d then a pool2d) and
`img_conv_group` (VGG's block: conv2d layers, each with an optional batch
norm and dropout, then one pool2d). Each appends the JAX composite's ops.
The sequence and attention composites wait for their layers."""
from . import layers

__all__ = ['simple_img_conv_pool', 'img_conv_group']


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type='max',
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type='max', use_cudnn=True):
    """One conv2d for each entry of ``conv_num_filter`` (a list); where
    ``conv_with_batchnorm`` (one flag, or one a conv) a batch norm takes the
    activation and then a dropout of ``conv_batchnorm_drop_rate`` (skipped
    at 0) follows it; then one pool2d."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _to_list(v):
        if isinstance(v, (list, tuple)):
            return list(v)
        return [v] * len(conv_num_filter)

    conv_padding = _to_list(conv_padding)
    conv_filter_size = _to_list(conv_filter_size)
    param_attr = _to_list(param_attr)
    conv_with_batchnorm = _to_list(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _to_list(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)
