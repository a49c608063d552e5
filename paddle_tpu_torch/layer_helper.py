"""LayerHelper: the plumbing the layers share.

The port's own copy of paddle_tpu/layer_helper.py: a parameter is created
in the main program's global block and, with its init op, in the startup
program; temporaries are named ``<layer>_<k>.tmp_<j>`` as in the JAX
package.
"""
import copy

from . import unique_name
from .framework import default_main_program, default_startup_program
from .param_attr import ParamAttr
from .initializer import Xavier, Constant
from .core.types import convert_np_dtype_to_dtype_, is_float_dtype

__all__ = ['LayerHelper']


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get('name')
        if name is None:
            self.name = unique_name.generate(layer_type)
        else:
            self.name = name

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def main_block(self):
        return self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.main_block.append_op(*args, **kwargs)

    def multiple_input(self, input_param_name='input'):
        inputs = self.kwargs.get(input_param_name)
        if inputs is None:
            return []
        if not isinstance(inputs, (list, tuple)):
            return [inputs]
        return list(inputs)

    def input_dtype(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for i in inputs:
            if dtype is None:
                dtype = i.dtype
            elif dtype != i.dtype:
                raise ValueError("all inputs must have the same dtype")
        return dtype

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get('param_attr'))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get('bias_attr'))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr]
        if len(attr) != length:
            attr = [copy.deepcopy(attr[0]) for _ in range(length)]
        return attr

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        assert isinstance(attr, ParamAttr)
        if attr.name is None:
            suffix = 'b' if is_bias else 'w'
            attr.name = unique_name.generate(".".join([self.name, suffix]))
        init = attr.initializer or default_initializer
        if init is None:
            if is_bias:
                init = Constant(0.0)
            elif is_float_dtype(dtype):
                init = Xavier()
            else:
                init = Constant(0.0)
        main_gb = self.main_program.global_block()
        param = main_gb.create_parameter(
            shape=shape, dtype=dtype, initializer=init,
            **attr._to_kwargs())
        start_gb = self.startup_program.global_block()
        if not start_gb.has_var(param.name):
            sp = start_gb.create_parameter(
                shape=shape, dtype=dtype, name=param.name,
                initializer=init, **{k: v for k, v in
                                     attr._to_kwargs().items()
                                     if k != 'name'})
            init(sp, start_gb)
        return param

    def create_variable_for_type_inference(self, dtype, shape=None,
                                           stop_gradient=False):
        return self.main_block.create_var(
            name=unique_name.generate(".".join([self.name, 'tmp'])),
            dtype=convert_np_dtype_to_dtype_(dtype) if dtype else None,
            shape=tuple(shape) if shape is not None else None,
            persistable=False, stop_gradient=stop_gradient)

    create_tmp_variable = create_variable_for_type_inference

    def create_global_variable(self, persistable=True, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def create_or_get_global_variable(self, name, *args, **kwargs):
        gb = self.main_program.global_block()
        if gb.has_var(name):
            return gb.var(name)
        return gb.create_var(name=name, persistable=True, *args, **kwargs)

    def set_variable_initializer(self, var, initializer):
        """Create ``var`` in the startup program and initialize it there."""
        start_gb = self.startup_program.global_block()
        if not start_gb.has_var(var.name):
            sv = start_gb.create_var(
                name=var.name, shape=var.shape, dtype=var.dtype,
                persistable=True)
            initializer(sv, start_gb)
        return var

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr or bias_attr is False:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(
            dtype=input_var.dtype, shape=input_var.shape)
        self.append_op(
            type='elementwise_add',
            inputs={'X': [input_var], 'Y': [b]},
            outputs={'Out': [tmp]},
            attrs={'axis': dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get('act')
        if act is None:
            return input_var
        if isinstance(act, dict):
            act_type = act.pop('type')
            act_attrs = act
        else:
            act_type = act
            act_attrs = {}
        tmp = self.create_variable_for_type_inference(
            dtype=input_var.dtype, shape=input_var.shape)
        self.append_op(type=act_type, inputs={'X': [input_var]},
                       outputs={'Out': [tmp]}, attrs=act_attrs)
        return tmp
